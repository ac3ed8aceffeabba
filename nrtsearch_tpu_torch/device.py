"""Explicit device resolution.

Every constructor in the port takes a ``torch.device``; nothing reads a global
default device and nothing silently moves to the CPU. Path choices (the fused
dense search, the CUDA kernels) follow where the index tensors live, the
counterpart of the reference's ``_on_tpu()`` (nrtsearch_tpu/core/maxscore.py).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """A concrete ``torch.device``. Asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cpu' or 'cuda'")
    return dev


def on_cuda(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device (the accelerator path)."""
    return t.device.type == "cuda"


def exact_cuda_matmul() -> None:
    """Keep CUDA matmuls at full f32: no TF32, and f32 accumulation inside
    bf16 products. The fused head scores rely on it (the Dekker
    correction's f32-grade contract)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


def scalar_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` rounded to f32 (as the reference's ``np.float32`` constants and
    JAX's weakly typed scalars round) as a 0-d tensor on ``device``. A
    divisor on CUDA must be one: a Python-number divisor makes CUDA's
    ``div`` multiply by its rounded reciprocal. Made by a fill on the
    device: ``torch.tensor(x, device=cuda)`` copies from pageable host
    memory, which waits for the stream."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32, device=device)


def search_devices() -> list[torch.device]:
    """The devices a virtual-shard mesh may span (the reference counts
    ``jax.devices()``): every CUDA device when a card is present, else the
    CPU alone. With fewer than two, ``virtualShards`` serves on the local
    path. Tests and the smoke run replace this function to lay a mesh over
    one device repeated (``[cpu] * 8``, ``[cuda:0] * 4``)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]
