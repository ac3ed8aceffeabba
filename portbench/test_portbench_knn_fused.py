"""The reader of ``knn_fused_segments_per_batch``: the program's count of kNN
segments answered by its kernel, per batch; 0 for a program without it."""

from portbench import harness
from portbench.metrics import knn_fused_segments_per_batch as reader


def test_fused_segments_reader(monkeypatch):
    from nrtsearch_tpu_torch.ops import knn

    monkeypatch.setattr(knn, "KNN_SEGMENTS", {"fused": 24, "plain": 3})
    assert reader.counter() == 24
    run = harness.Run(batch=32, k=100)
    run.batches = [None] * 3
    run.counters = {reader.__name__: 24}
    assert reader.read(run) == 8.0
    run.batches = []
    assert reader.read(run) is None
    monkeypatch.delattr(knn, "KNN_SEGMENTS")
    assert reader.counter() == 0
