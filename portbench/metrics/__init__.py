"""One reader per metric, found by the metric's name in BENCHMARK.json
(``portbench.metrics.<name>``, dots as underscores). A name split by kind
of cell, ``<base>.<kind>`` (``qps.served``, ``qps.search``: one quantity
whose cells keep bounds or move end-to-end metrics of their own), is read
by ``<base>``'s reader unless it has a reader of its own.

A reader is ``read(run) -> float | None``; ``run`` is the harness's
``Run``: the window's batches and latencies, set-up seconds, counter
deltas, the trace's ``Summary`` in a traced run. End-to-end readers are
called in untraced runs, per-layer readers in traced ones. A reader that
finds nothing to read returns None; where BENCHMARK.json lists the metric
for the cell, the run then fails rather than leave the metric out (a
device-trace metric on a run without a CUDA device excepted: the CPU
tests have no device).

- A reader of a program counter defines ``counter() -> number``, which
  reads the program's count; the harness calls it before and after the
  window and puts the difference in ``run.counters[<reader's module
  name>]``.
- A reader of a layer's device time names the layer in ``LAYER`` and
  lists in ``SPANS`` the program's calls into it, (module, attribute): a
  traced run wraps each in a ``portbench.<layer>`` range, and the trace
  sums the device time of the kernels launched inside.
"""

from __future__ import annotations

import importlib


def load(name: str):
    own = f"portbench.metrics.{name.replace('.', '_')}"
    try:
        return importlib.import_module(own)
    except ModuleNotFoundError as e:
        if e.name != own or "." not in name:
            raise
    return importlib.import_module(f"portbench.metrics.{name.split('.', 1)[0]}")
