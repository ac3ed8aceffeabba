"""Host syncs the port counts (the sum of its ``HOST_SYNCS`` counters:
``ops/merge_scoring.py``, ``ops/dense_fused.py``, ``ops/dense_head.py``),
per batch of the traced window."""


def counter() -> int:
    from nrtsearch_tpu_torch.ops import dense_fused, dense_head, merge_scoring

    return sum(sum(m.HOST_SYNCS.values()) for m in (merge_scoring, dense_fused, dense_head))


def read(run):
    n = run.counters.get(__name__)
    return None if n is None or not run.batches else n / len(run.batches)
