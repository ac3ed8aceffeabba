"""The merge path's share of its roofline, in %: the least time the
window's batches need at the card's memory bandwidth
(the kind's ``least_bytes``) over the device time of every kernel launched
inside the benchmark's ranges around the calls into ``merge_score_topk``."""

from portbench.peaks import least_seconds

LAYER = "merge"
# the calls into the layer (module, attribute): the served engine's merge
# dispatch and the flagship's merge step; a traced run wraps each in a
# ``portbench.merge`` range
SPANS = [("nrtsearch_tpu_torch.core.maxscore", "merge_score_topk"),
         ("nrtsearch_tpu_torch.models.flagship", "bm25_search_step")]


def read(run):
    s = run.summary
    if s is None or not run.batches or s.layer_s.get(LAYER, 0.0) <= 0.0:
        return None
    return 100.0 * least_seconds(run) / s.layer_s[LAYER]
