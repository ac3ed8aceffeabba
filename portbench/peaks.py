"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the full 700 W power limit), and the least time a
window's batches need at the card's memory bandwidth, which the roofline
shares read against them (the bytes are the kind's ``least_bytes``). A
share of a peak is stated beside the card's power limit, which the run
prints."""

HBM_BYTES_PER_S = 3.35e12      # HBM3
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12


def least_seconds(run) -> float:
    """The least time of ``run``'s batches at the card's memory bandwidth."""
    return sum(run.kind.least_bytes(run.data, b, run.k) for b in run.batches) / HBM_BYTES_PER_S
