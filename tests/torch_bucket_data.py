"""Bucket plan tables drawn in torch on any device, for the bucket kernels'
card tests and ``chip_smoke.py`` (imports neither package).

The default shape is the benchmark's bucket cell (``batch-8m.bucket-b32``):
B = 32 queries of T = 4 slots over m = 1024 buckets of 2^14 docs. Each
(query, slot) run holds the docs whose uniform draw falls under its
density: ``densities[t]`` times a per-query scale of 1, 0.1, 0.01 or 0.001
in turn, so some queries' rows hold thousands of hits and others a few, and
the per-row selection both prunes and passes rows through. A tenth of the
postings are deleted (impact 0); the last query has weight 0 in every slot
(its rows hold no hit). ``ties`` makes every impact 0.5 and every weight
1000, so each posting adds 500 and a query's keys take at most T values:
its k-th key is shared by docs in many buckets.
"""

import torch

CELL = {"B": 32, "T": 4, "m": 1024, "bits": 14}
DENSITIES = (0.2, 0.05, 0.01, 0.002)
QUERY_SCALES = (1.0, 0.1, 0.01, 0.001)


def bucket_tables(dev, seed: int, *, B: int = CELL["B"], T: int = CELL["T"],
                  m: int = CELL["m"], bits: int = CELL["bits"], ties: bool = False,
                  densities=DENSITIES):
    """((post_docs, post_impacts, toffs, bounds, wts), n_terms, tile): the
    plan tables on ``dev``, n_terms = each query's slots of nonzero weight,
    and the key tile the plain version needs (the largest row's live
    postings, rounded up to a power of two, at least 1024)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = m << bits
    runs = []
    for q in range(B):
        for t in range(T):
            density = densities[t % len(densities)] * QUERY_SCALES[q % len(QUERY_SCALES)]
            hit = torch.rand(D, generator=g, device=dev) < density
            runs.append(torch.nonzero(hit).flatten().to(torch.int32))
    lens = torch.tensor([len(r) for r in runs], dtype=torch.int64)
    P = int(lens.sum())
    docs = torch.zeros(P + 4, dtype=torch.int32, device=dev)   # 16-byte rounding
    docs[:P] = torch.cat(runs)
    imps = torch.zeros(P + 4, dtype=torch.float32, device=dev)
    if ties:
        imps[:P] = 0.5
    else:
        imps[:P] = torch.rand(P, generator=g, device=dev) * 0.9 + 0.1
        imps[:P][torch.rand(P, generator=g, device=dev) < 0.1] = 0.0
    toffs = (torch.cumsum(lens, 0) - lens).to(torch.int32).reshape(B, T).to(dev)
    edges = torch.arange(m + 1, device=dev, dtype=torch.int32) << bits
    bounds = torch.stack([torch.searchsorted(r, edges) for r in runs])
    bounds = bounds.to(torch.int32).reshape(B, T, m + 1)
    if ties:
        wts = torch.full((B, T), 1000.0, dtype=torch.float32, device=dev)
    else:
        wts = (torch.rand((B, T), generator=g, device=dev) * 8900.0 + 100.0)
    wts[B - 1] = 0.0
    n_terms = (wts != 0).sum(dim=1, dtype=torch.int32)
    live = torch.where((wts != 0)[..., None], bounds[..., 1:] - bounds[..., :-1], 0)
    tile = 1024
    while tile < int(live.sum(dim=1).max()):
        tile *= 2
    return (docs, imps, toffs, bounds, wts), n_terms, tile
