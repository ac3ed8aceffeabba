"""The parts of the check that decides ``correct`` that every kind uses
(``kinds/<kind>.py`` ``check`` reads the program's answers against its
reference with them):

- ``sample_positions``: the window's answers the check compares, drawn
  from the seed;
- ``hits_wrong``: queries whose total hit count differs from the reference's;
- ``short_lists``: queries that return another number of hits than
  min(k, total hits), or whose hits are not all in front;
- ``order_faults``: adjacent pairs out of (score descending, doc id
  ascending) order, and repeated docs;
- ``verdict`` and ``lines``: every number within its limit, and one line
  per number beside its limit.
"""

from __future__ import annotations

import numpy as np

BLOCK = 32   # queries the reference scores at once


def sample_positions(n_batches: int, batch: int, count: int, seed: int) -> list[tuple[int, int]]:
    """``count`` (batch, query) positions of the window's answers, drawn
    without replacement from ``seed``'s sample stream; all when fewer."""
    from portbench.generate import sub_seed

    total = n_batches * batch
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    flat = np.arange(total) if count >= total else np.sort(rng.choice(total, count, replace=False))
    return [(int(i // batch), int(i % batch)) for i in flat]


def hits_wrong(p_hits: np.ndarray, r_hits: np.ndarray) -> int:
    return int(np.count_nonzero(np.asarray(p_hits) != np.asarray(r_hits)))


def short_lists(p_scores: np.ndarray, r_hits: np.ndarray, k: int) -> int:
    """Rows of ``p_scores`` ([Q, k], a hit has a finite score) that hold
    another number of hits than min(k, ``r_hits``), or a hit behind an
    empty slot."""
    valid = np.isfinite(p_scores)
    n = valid.sum(axis=1)
    front = valid == (np.arange(valid.shape[1]) < n[:, None])
    return int(np.count_nonzero((n != np.minimum(k, r_hits)) | ~front.all(axis=1)))


def order_faults(scores: np.ndarray, docs: np.ndarray, n: int) -> int:
    s, d = scores[:n].astype(np.float64), docs[:n]
    bad = int(np.count_nonzero((s[1:] > s[:-1]) | ((s[1:] == s[:-1]) & (d[1:] <= d[:-1]))))
    return bad + (n - len(np.unique(d)))


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[name] <= limits[name] for name in numbers)


def lines(numbers: dict, limits: dict) -> list[str]:
    """One line per number compared: name, number, limit."""
    return [f"check {name} {numbers[name]!r} limit {limits[name]!r}" for name in numbers]
