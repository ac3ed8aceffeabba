"""script.expr on torch against the reference's, on the CPU.

Every operator and function of the expression grammar runs through both
packages' ``compile_expression`` over the same f32 columns, drawn from a
seed with numpy. Arithmetic, comparisons, logic, the ternary, ``abs``,
``floor``, ``ceil``, ``min``, ``max`` and ``%`` give bit-equal results.
The transcendental functions are torch's and XLA's own (sqrt, log, ln,
log10, exp, pow, the trigonometric and hyperbolic functions, and haversin,
nrtsearch_tpu/script/expr.py:33-68): their results are held within 4 f32
ulps relative, on inputs away from their zeros (XLA's f32 sqrt on the CPU
is off by one ulp from the correctly rounded torch sqrt on about 0.6% of
these inputs). Also: the tokenizer and
parser (the same ASTs and the same errors), a numpy score (the host
callers' form) handed back as numpy, and plugin script engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nrtsearch_tpu.script import expr as ref_expr
from nrtsearch_tpu_torch.script import expr as port_expr

ULPS4 = 4 * 2.0**-23
N = 4096


def _columns():
    rng = np.random.default_rng(2024)
    w = rng.integers(-50, 50, N).astype(np.float32)
    w[::7] = 0.0
    return {
        "x": rng.uniform(0.05, 1.4, N).astype(np.float32),
        "y": rng.uniform(1.0, 100.0, N).astype(np.float32),
        "z": rng.uniform(-0.9, 0.9, N).astype(np.float32),
        "w": w,
        "v": np.where(rng.random(N) < 0.5, w, rng.integers(-50, 50, N)).astype(np.float32),
        "lat1": rng.uniform(37.0, 38.5, N).astype(np.float32),
        "lon1": rng.uniform(-123.0, -121.5, N).astype(np.float32),
        "doc.price": rng.uniform(0.0, 1000.0, N).astype(np.float32),
    }, rng.uniform(0.1, 20.0, N).astype(np.float32)


EXACT = [
    "x + y", "y - x * 2", "y / 3", "x * y / (w + 100)", "w % 7", "-w % 3.5", "y % x",
    "x < y / 50", "w <= v", "w > v", "w >= v", "w == v", "w != v",
    "w || v", "w && v", "!w", "-x", "- -y", "w > 0 ? x : y", "w ? 1 : 2.5",
    "abs(w)", "floor(y / 7)", "ceil(z * 10)", "min(x, y / 60)", "max(w, v)",
    "_score * 2 + 1", "_score / y", "(w + v) * (x - 0.5)", "1.5e2 * x",
    "3 / 7 * y", "doc.price * 0.01", "2 * 3 + x",
]
TRANSCENDENTAL = [
    "sqrt(y)", "log(y)", "ln(x + 1)", "log10(y)", "exp(z)", "pow(x, 2.5)", "pow(y, 0.5)",
    "sin(x)", "cos(x)", "tan(x)", "asin(z)", "acos(z)", "atan(z)", "atan2(y, x)",
    "sinh(z)", "cosh(z)", "tanh(x)", "_score * log(y + 1)",
    "haversin(lat1, lon1, 37.75, -122.4)", "haversinKilometers(37.75, -122.4, lat1, lon1)",
    "haversinMeters(lat1, lon1, 37.7, -122.5)",
]


def _run(source: str):
    cols, score = _columns()
    ref = np.asarray(ref_expr.compile_expression(source)(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(score)))
    port = port_expr.compile_expression(source)(
        {k: torch.from_numpy(v) for k, v in cols.items()}, torch.from_numpy(score))
    return ref, port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)


@pytest.mark.parametrize("source", EXACT)
def test_exact_operators_bit_equal(source):
    ref, port = _run(source)
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(port.view(np.int32), ref.view(np.int32), err_msg=source)


@pytest.mark.parametrize("source", TRANSCENDENTAL)
def test_transcendental_functions_within_4_ulps(source):
    ref, port = _run(source)
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=ULPS4, atol=0, err_msg=source)


@pytest.mark.parametrize("source", ["x + (y", "1 +", "foo(x)", "x $ y", "x y"])
def test_errors_as_the_reference(source):
    with pytest.raises(ValueError) as ref_err:
        ref_expr.compile_expression(source)({"x": jnp.ones(2), "y": jnp.ones(2)},
                                            jnp.zeros(2))
    with pytest.raises(ValueError) as port_err:
        port_expr.compile_expression(source)({"x": torch.ones(2), "y": torch.ones(2)},
                                             torch.zeros(2))
    assert str(port_err.value) == str(ref_err.value)


def test_parser_builds_the_reference_ast():
    for source in EXACT + TRANSCENDENTAL:
        assert port_expr._Parser(port_expr._tokenize(source)).parse() == \
            ref_expr._Parser(ref_expr._tokenize(source)).parse(), source


def test_numpy_score_comes_back_as_numpy():
    """Field fetch and the handlers call with a numpy score and a numpy
    column view: the result is a numpy array, as np.asarray of the
    reference's."""
    cols, score = _columns()
    fn = port_expr.compile_expression("x * 2 + _score")
    out = fn({"x": cols["x"][:5]}, score[:5])
    assert isinstance(out, np.ndarray)
    ref = np.asarray(ref_expr.compile_expression("x * 2 + _score")(
        {"x": jnp.asarray(cols["x"][:5])}, jnp.asarray(score[:5])))
    np.testing.assert_array_equal(out, ref)


def test_plugin_engine_dispatch():
    port_expr.register_script_engine("const7", lambda src: lambda dv, s: 7.0)
    try:
        assert port_expr.compile_expression("anything", "const7")(None, None) == 7.0
        with pytest.raises(ValueError, match="unknown script lang"):
            port_expr.compile_expression("x", "nope")
    finally:
        port_expr.SCRIPT_ENGINES.pop("const7", None)
