"""Frozen copy of Lucene's SmallFloat length norm, for the reference.

The benchmark keeps its own copy so that a change to the program's norm
shows as a wrong answer instead of moving both sides together.

Lucene-compatible small-float norm quantization.

Lucene's BM25 stores each document's field length as a single byte using
``SmallFloat.intToByte4`` (exact for lengths < 24, 4-bit-mantissa float above).
Exact BM25 score parity with the reference engine (BASELINE.md: "exact-match
parity vs Lucene" on MS MARCO) requires reproducing this quantization, so the
decoded-quantized length — not the true length — feeds the BM25 length norm.

This is a clean-room reimplementation of the published SmallFloat encoding
semantics (monotone byte code: identity below 24, then 3-bit mantissa with
implicit leading bit + shift). Pure numpy.
"""

from __future__ import annotations

import numpy as np

# longToInt4(Integer.MAX_VALUE) == 231, so 255 - 231 == 24 codes are "free"
# and encode small lengths exactly.
_NUM_FREE_VALUES = 24


def long_to_int4(i: np.ndarray | int) -> np.ndarray:
    """Monotone lossy encode of non-negative int64 to a 4-bit-mantissa code."""
    i = np.asarray(i, dtype=np.int64)
    if np.any(i < 0):
        raise ValueError("long_to_int4 requires non-negative input")
    num_bits = np.where(i == 0, 0, 64 - _clz64(i))
    shift = np.maximum(num_bits - 4, 0)
    encoded = (i >> shift).astype(np.int64)
    small = num_bits < 4
    enc_large = (encoded & 0x07) | ((shift + 1) << 3)
    return np.where(small, i, enc_large).astype(np.int64)


def int4_to_long(b: np.ndarray | int) -> np.ndarray:
    """Inverse of :func:`long_to_int4` (lower bound of the encoded bucket)."""
    b = np.asarray(b, dtype=np.int64)
    bits = b & 0x07
    shift = (b >> 3) - 1
    return np.where(shift == -1, bits, (bits | 0x08) << np.maximum(shift, 0))


def int_to_byte4(i: np.ndarray | int) -> np.ndarray:
    """Encode a non-negative int to one byte: exact below 24, lossy above."""
    i = np.asarray(i, dtype=np.int64)
    if np.any(i < 0):
        raise ValueError("int_to_byte4 requires non-negative input")
    large = long_to_int4(np.maximum(i - _NUM_FREE_VALUES, 0)) + _NUM_FREE_VALUES
    return np.where(i < _NUM_FREE_VALUES, i, large).astype(np.uint8)


def byte4_to_int(b: np.ndarray | int) -> np.ndarray:
    """Decode a byte4 code back to its representative integer."""
    v = np.asarray(b, dtype=np.int64) & 0xFF
    return np.where(
        v < _NUM_FREE_VALUES, v, int4_to_long(v - _NUM_FREE_VALUES) + _NUM_FREE_VALUES
    ).astype(np.int64)


def quantize_length(length: np.ndarray | int) -> np.ndarray:
    """Round-trip a field length through the 1-byte norm encoding.

    Returns the decoded length Lucene's BM25 would actually use.
    """
    return byte4_to_int(int_to_byte4(length))


def _clz64(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of positive int64 values (vectorized)."""
    x = np.asarray(x, dtype=np.uint64)
    n = np.zeros(x.shape, dtype=np.int64)
    v = x.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = v >= (np.uint64(1) << np.uint64(shift))
        v = np.where(mask, v >> np.uint64(shift), v)
        n = np.where(mask, n + shift, n)
    # n is floor(log2(x)); clz = 63 - n for x > 0
    return 63 - n
