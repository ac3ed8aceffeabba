"""``_hierarchical_topk`` calls that failed their check and sorted the
whole stream (``ops/merge_scoring.py`` ``TOPK_FALLBACKS``), per batch of
the traced window."""


def counter() -> int:
    from nrtsearch_tpu_torch.ops import merge_scoring

    return sum(merge_scoring.TOPK_FALLBACKS.values())


def read(run):
    n = run.counters.get(__name__)
    return None if n is None or not run.batches else n / len(run.batches)
