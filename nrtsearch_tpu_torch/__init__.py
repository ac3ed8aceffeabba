"""nrtsearch_tpu_torch — the PyTorch + CUDA port of nrtsearch_tpu's search path.

The JAX package ``nrtsearch_tpu`` is the reference. This package re-expresses
its BM25 text-search slice on torch tensors: segments (``core/segment.py``),
the packed multi-segment view with the fused dense-head search
(``core/packed_view.py``, ``ops/dense_fused.py``), the exact merge path
(``core/maxscore.py``, ``ops/merge_scoring.py``) and the engine entry point
``core.searcher.Searcher``.

Every Pallas kernel on that path is a hand-written CUDA C++ kernel for Hopper
(``csrc/``), built at first use and bound with ctypes (``kernels/``). Each
kernel has a plain torch twin in the module that calls it; the twin runs only
for tensors that live on the CPU.

The package imports torch and never jax, and nothing of ``nrtsearch_tpu``:
the reference's backend-free modules it needs are copied whole under the
same layout (``analysis/``, ``schema/fields.py``, ``query/plan.py``,
``utils/smallfloat.py``), each naming the file it copies.

Tests: ``python -m pytest tests/test_torch_*.py`` on the CPU (JAX present
for the reference side); on a machine with an H100, ``python3 chip_smoke.py``
and ``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
