"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the full 700 W power limit), and the least bytes a
batch's retrieval moves, which the roofline shares read against them. A
share of a peak is stated beside the card's power limit, which the run
prints."""

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # HBM3
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12


def least_bytes(batch: np.ndarray, df: np.ndarray, k: int) -> int:
    """Least bytes of one batch of term-id queries (int [B, T]): each posting
    entry of the batch's distinct query terms read once (doc id and impact,
    8 B; ``df`` gives each term's entries) and the results written once (B x
    k scores or rank keys and doc ids, 8 B each, and B hit counts, 4 B). The
    count is of the work, not of the launches, so a redesigned kernel is
    read against the same work."""
    terms = np.unique(batch)
    return int(df[terms].sum()) * 8 + batch.shape[0] * (k * 8 + 4)


def least_seconds(batches, df: np.ndarray, k: int) -> float:
    """The least time of ``batches`` at the card's memory bandwidth."""
    return sum(least_bytes(b, df, k) for b in batches) / HBM_BYTES_PER_S
