"""The bucket path's share of its roofline, in %: the least time the
window's batches need at the card's memory bandwidth (the kind's
``least_bytes``; for BM25 the plan covers the postings of the batch's
distinct query terms) over the device time of every kernel launched inside
the benchmark's ranges around the calls into ``bucket_search_topk``."""

from portbench.peaks import least_seconds

LAYER = "bucket"
SPANS = [("nrtsearch_tpu_torch.ops.bucket_retrieval", "bucket_search_topk")]


def read(run):
    s = run.summary
    if s is None or not run.batches or s.layer_s.get(LAYER, 0.0) <= 0.0:
        return None
    return 100.0 * least_seconds(run) / s.layer_s[LAYER]
