"""Virtual shards: the index sharded over a (shard, data) grid of devices
(counterpart: nrtsearch_tpu/parallel).

- Virtual shards (the reference's MyIndexSearcher.slicesForShards) -> docs
  sharded round-robin over the ``shard`` axis, each shard scored by the
  port's merge or fused path, the candidates merged into one top k;
- read replication inside one host -> the query batch split over the
  ``data`` axis;
- the reduce step (the per-slice collector merge) -> each shard's top k
  gathered on the grid's first device and merged there.

One process drives every device (no ``torch.distributed``).
"""

from nrtsearch_tpu_torch.parallel.distributed import (
    DistributedBM25,
    DistributedKNN,
    SearchMesh,
    make_search_mesh,
)

__all__ = ["DistributedBM25", "DistributedKNN", "SearchMesh", "make_search_mesh"]
