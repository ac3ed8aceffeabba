"""Compiler for the javascript-expression subset used by scores and virtual
fields (counterpart: nrtsearch_tpu/script/expr.py).

Grammar (the reference's, unchanged):

    expr     := ternary
    ternary  := or ('?' expr ':' expr)?
    or       := and ('||' and)*
    and      := cmp ('&&' cmp)*
    cmp      := add (('<'|'<='|'>'|'>='|'=='|'!=') add)?
    add      := mul (('+'|'-') mul)*
    mul      := unary (('*'|'/'|'%') unary)*
    unary    := ('-'|'!') unary | atom
    atom     := NUMBER | IDENT | IDENT '(' args ')' | '(' expr ')'

Identifiers resolve to doc-value columns (dense f32 [D] tensors) or
``_score``. ``compile_expression(source)`` returns ``fn(doc_values,
score)``. The operations are the reference's, in its order and in f32:
a number literal stays a Python float until it meets a column (then it is
rounded to f32, as JAX rounds a weakly typed scalar), two literals combine
in Python's f64, a divisor that is a literal goes to the device as a 0-d
f32 tensor (CUDA would multiply by its rounded reciprocal), and ``log10``
and the degree conversion in ``haversin`` are the products and quotients
JAX builds them from. The transcendental functions are torch's: their
results may differ from XLA's in the last bits.

``fn`` runs on the device of ``doc_values.device`` (the port's
``_ScriptDocValues``) or of a tensor ``score``. A caller that passes a numpy
``score`` (field fetch, the handlers' virtual fields and script facets)
gets a numpy array back, as ``np.asarray`` of the reference's result.
"""

from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch

from nrtsearch_tpu_torch.device import scalar_f32

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?)|(?P<ident>[A-Za-z_][A-Za-z0-9_.]*)"
    r"|(?P<op>\|\||&&|<=|>=|==|!=|[-+*/%<>?:!(),]))"
)


class _Env:
    """The device an expression runs on."""

    def __init__(self, device: torch.device):
        self.device = device

    def t(self, v) -> torch.Tensor:
        """``v`` as a tensor on the device: a Python number becomes a 0-d
        f32 tensor (JAX's weak-type rounding), a numpy array moves over."""
        if isinstance(v, torch.Tensor):
            return v
        if isinstance(v, np.ndarray):
            return torch.as_tensor(v, device=self.device)
        return scalar_f32(v, self.device)


def _radians(env: _Env, x):
    # jnp.radians: x * f32(pi / 180)
    return env.t(x) * env.t(np.pi / 180)


def _haversin_km(env: _Env, lat1, lon1, lat2, lon2):
    """Great-circle distance in KILOMETERS (reference: Lucene expressions
    haversin(); ExpressionsJavascriptFunctions haversinKilometers)."""
    r1, g1 = _radians(env, lat1), _radians(env, lon1)
    r2, g2 = _radians(env, lat2), _radians(env, lon2)
    two = env.t(2.0)
    s1 = torch.sin((r2 - r1) / two)
    s2 = torch.sin((g2 - g1) / two)
    h = s1 * s1 + torch.cos(r1) * torch.cos(r2) * (s2 * s2)
    h = torch.clamp(h, 0.0, 1.0)
    return env.t(2 * 6371.0087714) * torch.asin(torch.sqrt(h))


def _unary(op):
    return lambda env, x: op(env.t(x))


def _binary(op):
    return lambda env, a, b: op(env.t(a), env.t(b))


def _log10(env: _Env, x):
    # jnp.log10: log(x) / log(f32(10))
    return torch.log(env.t(x)) / torch.log(env.t(10.0))


_FUNCS = {
    "abs": _unary(torch.abs),
    "log": _unary(torch.log),
    "ln": _unary(torch.log),
    "log10": _log10,
    "sqrt": _unary(torch.sqrt),
    "exp": _unary(torch.exp),
    "floor": _unary(torch.floor),
    "ceil": _unary(torch.ceil),
    "pow": _binary(torch.pow),
    "min": _binary(torch.minimum),
    "max": _binary(torch.maximum),
    "sin": _unary(torch.sin),
    "cos": _unary(torch.cos),
    "tan": _unary(torch.tan),
    "asin": _unary(torch.asin),
    "acos": _unary(torch.acos),
    "atan": _unary(torch.atan),
    "atan2": _binary(torch.atan2),
    "sinh": _unary(torch.sinh),
    "cosh": _unary(torch.cosh),
    "tanh": _unary(torch.tanh),
    # geo (Lucene expressions: haversin is km; haversinMeters for meters)
    "haversin": _haversin_km,
    "haversinKilometers": _haversin_km,
    "haversinMeters": lambda env, a, b, c, d: _haversin_km(env, a, b, c, d) * env.t(1000.0),
}


def _tokenize(src: str) -> list[str]:
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip() == "":
                break
            raise ValueError(f"bad expression near: {src[pos:pos+20]!r}")
        tokens.append(m.group("num") or m.group("ident") or m.group("op"))
        pos = m.end()
    return tokens


class _Parser:
    def __init__(self, tokens: list[str]):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def expect(self, tok: str):
        got = self.next()
        if got != tok:
            raise ValueError(f"expected {tok!r}, got {got!r}")

    def parse(self):
        node = self.ternary()
        if self.peek() is not None:
            raise ValueError(f"trailing tokens: {self.tokens[self.i:]}")
        return node

    def ternary(self):
        cond = self.or_()
        if self.peek() == "?":
            self.next()
            a = self.ternary()
            self.expect(":")
            b = self.ternary()
            return ("?", cond, a, b)
        return cond

    def or_(self):
        node = self.and_()
        while self.peek() == "||":
            self.next()
            node = ("||", node, self.and_())
        return node

    def and_(self):
        node = self.cmp()
        while self.peek() == "&&":
            self.next()
            node = ("&&", node, self.cmp())
        return node

    def cmp(self):
        node = self.add()
        if self.peek() in ("<", "<=", ">", ">=", "==", "!="):
            op = self.next()
            node = (op, node, self.add())
        return node

    def add(self):
        node = self.mul()
        while self.peek() in ("+", "-"):
            op = self.next()
            node = (op, node, self.mul())
        return node

    def mul(self):
        node = self.unary()
        while self.peek() in ("*", "/", "%"):
            op = self.next()
            node = (op, node, self.unary())
        return node

    def unary(self):
        if self.peek() == "-":
            self.next()
            return ("neg", self.unary())
        if self.peek() == "!":
            self.next()
            return ("!", self.unary())
        return self.atom()

    def atom(self):
        tok = self.next()
        if tok is None:
            raise ValueError("unexpected end of expression")
        if tok == "(":
            node = self.ternary()
            self.expect(")")
            return node
        if re.fullmatch(r"\d+\.?\d*(?:[eE][+-]?\d+)?", tok):
            return ("num", float(tok))
        if re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.]*", tok):
            if self.peek() == "(":
                self.next()
                args = []
                if self.peek() != ")":
                    args.append(self.ternary())
                    while self.peek() == ",":
                        self.next()
                        args.append(self.ternary())
                self.expect(")")
                return ("call", tok, args)
            return ("var", tok)
        raise ValueError(f"unexpected token: {tok!r}")


def _is_num(v) -> bool:
    return isinstance(v, float)


def _arith(op):
    """An arithmetic operator: Python's f64 between two literals, torch's
    f32 once a column takes part."""

    def apply(env: _Env, a, b):
        if _is_num(a) and _is_num(b):
            return op(a, b)
        if op is _div and _is_num(b):
            b = env.t(b)
        return op(a, b) if not _is_num(a) else op(env.t(a), b)

    return apply


def _div(a, b):
    return a / b


def _compare(op):
    return lambda env, a, b: op(env.t(a), env.t(b)).to(torch.float32)


_BINOPS = {
    "+": _arith(lambda a, b: a + b),
    "-": _arith(lambda a, b: a - b),
    "*": _arith(lambda a, b: a * b),
    "/": _arith(_div),
    "%": _arith(lambda a, b: a % b),
    "<": _compare(lambda a, b: a < b),
    "<=": _compare(lambda a, b: a <= b),
    ">": _compare(lambda a, b: a > b),
    ">=": _compare(lambda a, b: a >= b),
    "==": _compare(lambda a, b: a == b),
    "!=": _compare(lambda a, b: a != b),
    "||": _compare(lambda a, b: (a != 0) | (b != 0)),
    "&&": _compare(lambda a, b: (a != 0) & (b != 0)),
}


def _eval_ast(node, doc_values, score, env: _Env):
    kind = node[0]
    if kind == "num":
        return node[1]
    if kind == "var":
        name = node[1]
        if name == "_score":
            return env.t(score)
        return env.t(doc_values[name])
    if kind == "neg":
        return -_eval_ast(node[1], doc_values, score, env)
    if kind == "!":
        v = _eval_ast(node[1], doc_values, score, env)
        return (env.t(v) == 0).to(torch.float32)
    if kind == "?":
        cond = env.t(_eval_ast(node[1], doc_values, score, env))
        a = _eval_ast(node[2], doc_values, score, env)
        b = _eval_ast(node[3], doc_values, score, env)
        return torch.where(cond != 0, env.t(a), env.t(b))
    if kind == "call":
        fn = _FUNCS.get(node[1])
        if fn is None:
            raise ValueError(f"unknown function: {node[1]!r}")
        args = [_eval_ast(a, doc_values, score, env) for a in node[2]]
        return fn(env, *args)
    if kind in _BINOPS:
        return _BINOPS[kind](
            env,
            _eval_ast(node[1], doc_values, score, env),
            _eval_ast(node[2], doc_values, score, env),
        )
    raise ValueError(f"bad AST node: {node!r}")


# plugin script engines: lang -> compile(source) -> fn(doc_values, score)
# (reference: ScriptPlugin engines registered by lang beside the built-in
# js-expression engine, server/script/ScriptService)
SCRIPT_ENGINES: dict[str, Callable[[str], Callable]] = {}


def register_script_engine(lang: str, compile_fn: Callable[[str], Callable]) -> None:
    SCRIPT_ENGINES[lang] = compile_fn


def _device_of(doc_values, score) -> torch.device:
    dev = getattr(doc_values, "device", None)
    if dev is not None:
        return dev
    if isinstance(score, torch.Tensor):
        return score.device
    return torch.device("cpu")


def compile_expression(source: str, lang: str = "") -> Callable:
    """Compile script source -> ``fn(doc_values, score)``.

    The default/"js" lang uses the built-in vectorized expression compiler;
    other langs dispatch to a registered plugin engine."""
    if lang and lang not in ("js", "expression"):
        engine = SCRIPT_ENGINES.get(lang)
        if engine is None:
            raise ValueError(f"unknown script lang {lang!r}")
        return engine(source)
    ast = _Parser(_tokenize(source)).parse()

    def fn(doc_values, score):
        out = _eval_ast(ast, doc_values, score, _Env(_device_of(doc_values, score)))
        if isinstance(score, np.ndarray) and isinstance(out, torch.Tensor):
            return out.cpu().numpy()
        return out

    return fn
