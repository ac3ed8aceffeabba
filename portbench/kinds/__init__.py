"""What a configuration's data, queries, reference and check are: one
module per configuration ``kind`` key (``portbench/kinds/<kind>.py``).
The harness and the control reach them only through the kind, so a new
kind of deployment (vectors, a log, a table) is a new file here.

A kind module defines:

- ``make_data(cfg, seed, device) -> (data, columns)``: the data the
  engine is given (``Engine(cfg, traffic, data, columns, device)``) and
  its doc-value columns, drawn from the seed;
- ``QueryStream(cfg, traffic, seed, stream, n_batches, device)`` with
  ``__len__`` and ``batch(i)``: a host array whose first axis is the
  batch, drawn at set-up from the seed's ``stream`` (``generate.STREAMS``);
- ``Reference(data, cfg, control=None)``: the plain reference, which
  imports nothing of the program; with ``control`` (the traffic's
  ``check.control``) the check's deliberately coarser control. It has
  ``dense(queries) -> (scores [Q, N], matched [Q, N])`` and
  ``topk(scores, matched, k) -> (scores [Q, k], docs [Q, k], hits [Q])``,
  which the control answers with;
- ``check(ref, queries, prog, k, chk) -> {name: number}``: the numbers
  that decide ``correct`` for the program's answers ``prog`` = (scores
  f32 [S, k], docs int32 [S, k], hits int64 [S]) to ``queries``, under
  the traffic's ``check`` ``chk``; ``chk["limits"]`` holds a limit for
  each. The parts that do not depend on the kind are in ``compare.py``;
- ``least_bytes(data, batch, k) -> int``: the least bytes one batch's
  work moves, which the roofline readers count;
- ``TINY``: the overrides (``{"config": ..., "traffic": ...}``) that cut
  a cell of this kind to a CPU test's size.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.kinds.{name}")
