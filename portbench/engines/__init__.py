"""The systems under test, one module per configuration ``engine`` key.

An engine module defines ``Engine(cfg, traffic, data, columns, device)``
(``data`` and ``columns`` from the configuration's kind, ``kinds/<kind>.py``
``make_data``) with:

- ``setup_split``: seconds per set-up stage it ran (ingest, warm, ...);
- ``run_batch(queries)``: the timed call for one batch of the kind's
  queries (``QueryStream.batch``: term ids int64 [B, T] for BM25), from the
  request to its results on the host; returns the raw results;
- ``answers(raw)``: (scores f32 [B, k], docs int32 [B, k], hits int64 [B])
  as numpy, -inf / -1 in empty slots (a hit count that is no exact count
  reads -1); the harness keeps these arrays of every batch of the window;
- ``describe()``: a line on what served the window (paths, route);
- ``close()``: drops every reference to the program's state.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.engines.{name}")
