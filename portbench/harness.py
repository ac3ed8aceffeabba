"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix; each has a file of its
own (``BENCHMARK.json`` names the configuration's; the traffic's is
``portbench/traffic/<traffic>.json``). The configuration's ``kind`` key
picks what its data, queries, reference and check are
(``portbench/kinds/<kind>.py``), its ``engine`` key the engine that runs
the program (``portbench/engines/<engine>.py``); every metric has a
reader of its own (``portbench/metrics/<name>.py``). Nothing here changes
for a new cell, configuration, kind, traffic or metric.

A run: the data and the batches are drawn on the card from the seed;
the engine builds the program's index; the traffic's warm-up batches run;
then the window, a closed loop with one batch in flight, for ``--seconds``
(under ``torch.profiler`` with ``--trace 1``). After the window the
program's state is freed and the kind's plain reference checks a sample
of the window's answers. Standard error ends with each number
compared beside its limit; the last line of standard output is the
result, whose last key ``check`` repeats them.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

T_START = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nrtsearch_tpu")
TRACE_TRIES = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of one workload."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    if "kind" not in cfg:
        raise ValueError(f"{conf['file']}: a configuration names its kind "
                         "(portbench/kinds/<kind>.py) under 'kind'")
    traffic = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def cell_metrics(bench: dict, cell: dict, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with a trace its per-layer metrics."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) and isinstance(base.get(k), dict) else v
    return out


@dataclass
class Run:
    """What the metric readers read."""

    batch: int
    k: int
    kind: object = None   # the configuration's kind module (its ``least_bytes``)
    data: object = None   # the kind's data the engine was given
    setup_s: float = 0.0
    window_s: float = 0.0
    queries_done: int = 0
    latencies: list = field(default_factory=list)
    batches: list = field(default_factory=list)
    plan_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    summary: object = None
    gc: tuple = (0.0, 0)   # the window's seconds in garbage collection, full collections


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters(readers) -> dict:
    """The program's counts that the readers declare (their ``counter``)."""
    return {r.__name__: r.counter() for r in readers if hasattr(r, "counter")}


def _launches() -> dict:
    from nrtsearch_tpu_torch import kernels

    return dict(kernels.LAUNCHES)


class _Spans:
    """Wraps the program's calls that the per-layer readers name (their
    ``LAYER`` and ``SPANS``) in ``record_function`` ranges for the traced
    window, and restores them."""

    def __init__(self, readers):
        self.targets = [(mod, attr, r.LAYER) for r in readers if hasattr(r, "LAYER")
                        for mod, attr in r.SPANS]
        self.saved: list = []

    def __enter__(self):
        import importlib

        from torch.profiler import record_function

        for mod, attr, layer in self.targets:
            m = importlib.import_module(mod)
            fn = getattr(m, attr)

            def wrapped(*a, _fn=fn, _name=f"portbench.{layer}", **kw):
                with record_function(_name):
                    return _fn(*a, **kw)

            self.saved.append((m, attr, fn))
            setattr(m, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for m, attr, fn in reversed(self.saved):
            setattr(m, attr, fn)
        self.saved.clear()


def _window(engine, stream, start: int, seconds: float, device, run: Run, answers: list):
    """The closed loop: batches from ``stream`` until ``seconds`` have
    passed. Returns the next batch index."""
    from torch.profiler import record_function

    from portbench.trace import WINDOW

    i = start
    failed = 0
    gc_s = [0.0, 0, 0.0]   # seconds in collections, full collections, last start

    def on_gc(phase, info):
        if phase == "start":
            gc_s[2] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[2]
            gc_s[1] += info["generation"] == 2

    gc.callbacks.append(on_gc)
    with record_function(WINDOW):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ids = stream.batch(i)
            t = time.perf_counter()
            try:
                raw = engine.run_batch(ids)
            except Exception as e:  # noqa: BLE001  (a request that fails is counted)
                log(f"batch {i} failed: {type(e).__name__}: {e}")
                raw, failed = None, failed + len(ids)
            run.latencies.append(time.perf_counter() - t)
            run.batches.append(ids)
            # kept as a few arrays, so that the window's answers add no
            # objects for the collector to scan
            answers.append((ids, None if raw is None else engine.answers(raw)))
            i += 1
        sync(device)
        run.window_s = time.perf_counter() - t0
    gc.callbacks.remove(on_gc)
    run.gc = (gc_s[0], gc_s[1])
    run.queries_done = sum(len(ids) for ids, raw in answers if raw is not None)
    return i, failed


def _traced_window(engine, stream, warm, seconds, device, run: Run, readers):
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from portbench.trace import events_from_kineto, lost_kernels, summarize

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    i = 0
    layers = sorted({r.LAYER for r in readers if hasattr(r, "LAYER")})
    with _Spans(readers):
        for attempt in range(TRACE_TRIES):
            answers: list = []
            run.latencies, run.batches = [], []
            plan0 = len(getattr(engine, "plan_s", []))
            with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                engine.run_batch(warm.batch(attempt % len(warm)))
                sync(device)
                prof.step()
                c0, l0 = _counters(readers), _launches()
                i, failed = _window(engine, stream, i, seconds, device, run, answers)
                c1, l1 = _counters(readers), _launches()
                prof.step()
            run.counters = {n: c1[n] - c0[n] for n in c0}
            run.plan_s = list(getattr(engine, "plan_s", [])[plan0 + 1:])
            t = time.perf_counter()
            evs = events_from_kineto(prof.profiler.kineto_results.events())
            t_read = time.perf_counter() - t
            run.summary = summarize(evs, layers)
            launched = {n: l1[n] - l0[n] for n in l0}
            lost = lost_kernels(launched, run.summary.kernel_items) if device.type == "cuda" else []
            log(f"trace {attempt + 1}: {len(run.batches)} batches, {run.summary.busy_s:.6f} s "
                f"busy of {run.summary.window_s:.6f}, launches {launched}, layers "
                f"{run.summary.layer_s}; {len(evs)} events read in {t_read:.1f} s, reduced in "
                f"{time.perf_counter() - t - t_read:.1f} s")
            if not lost and (run.summary.busy_s > 0 or device.type != "cuda"):
                return answers, failed
            log(f"trace {attempt + 1} lacks launched kernels {lost}; tracing the window again")
            del prof
            torch.cuda.empty_cache()
    raise RuntimeError(f"{TRACE_TRIES} traces lacked kernels the window launched")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             overrides: dict | None = None) -> tuple[dict, list[str]]:
    """One run of one cell on ``device``; ``overrides`` (tests) replace keys
    of the configuration and the traffic. Returns (result, check lines)."""
    import numpy as np
    import torch

    from portbench import compare, engines, kinds, metrics

    bench, cell, cfg, traffic = load_cell(workload)
    overrides = overrides or {}
    cfg = _merge(cfg, overrides.get("config", {}))
    traffic = _merge(traffic, overrides.get("traffic", {}))
    wanted = cell_metrics(bench, cell, trace)
    readers = {m["name"]: metrics.load(m["name"]) for m in wanted}
    kind = kinds.load(cfg["kind"])

    split = {}
    t = time.perf_counter()
    data, columns = kind.make_data(cfg, seed, device)
    stream = kind.QueryStream(cfg, traffic, seed, "queries", int(traffic["max_batches"]), device)
    warm = kind.QueryStream(cfg, traffic, seed, "warmup", int(traffic["warmup_batches"]), device)
    sync(device)
    split["generate"] = time.perf_counter() - t
    if device.type == "cuda":
        from nrtsearch_tpu_torch import kernels

        t = time.perf_counter()
        kernels.build()
        split["build"] = time.perf_counter() - t
    engine = engines.load(cfg["engine"]).Engine(cfg, traffic, data, columns, device)
    split.update(engine.setup_split)
    t = time.perf_counter()
    for j in range(len(warm)):
        engine.run_batch(warm.batch(j))
    sync(device)
    split["warmup"] = time.perf_counter() - t
    del columns

    run = Run(batch=int(traffic["batch"]), k=int(traffic["k"]), kind=kind, data=data)
    run.setup_s = time.perf_counter() - T_START
    log(f"setup: {run.setup_s:.3f} s; " + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        answers, failed = _traced_window(engine, stream, warm, seconds, device, run,
                                         list(readers.values()))
    else:
        answers = []
        c0 = _counters(readers.values())
        _, failed = _window(engine, stream, 0, seconds, device, run, answers)
        c1 = _counters(readers.values())
        run.counters = {n: c1[n] - c0[n] for n in c0}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    half = max(1, len(run.latencies) // 2)
    first, second = run.latencies[:half], run.latencies[half:] or run.latencies[:half]
    log(f"window: {len(answers)} batches in {run.window_s:.3f} s; mean batch ms, first half "
        f"{1e3 * sum(first) / len(first):.3f}, second {1e3 * sum(second) / len(second):.3f}; "
        f"garbage collection {run.gc[0]:.3f} s, {run.gc[1]} full; "
        f"{engine.describe()}")

    # the answers of a sample of the window's queries, then the program goes
    chk = traffic["check"]
    pos = compare.sample_positions(len(answers), run.batch, int(chk["sample"]), seed)
    by_batch: dict[int, list[int]] = {}
    for bi, qi in pos:
        by_batch.setdefault(bi, []).append(qi)
    K = run.k
    qs, ps, pd, ph = [], [], [], []
    for bi, rows in by_batch.items():
        ids, got = answers[bi]
        s, d, h = got if got is not None else (
            np.full((len(ids), K), -np.inf, np.float32), np.full((len(ids), K), -1, np.int32),
            np.full(len(ids), -1, np.int64))
        qs.append(ids[rows]), ps.append(s[rows]), pd.append(d[rows]), ph.append(h[rows])
    described = engine.describe()
    engine.close()
    del engine, answers
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = kind.Reference(data, cfg)
    numbers = kind.check(ref, np.concatenate(qs), (np.concatenate(ps), np.concatenate(pd),
                                                   np.concatenate(ph)), K, chk)
    numbers["failed_queries"] = failed
    limits = {**chk["limits"], "failed_queries": 0}
    log(f"check: {len(pos)} queries against the reference in {time.perf_counter() - t:.3f} s; "
        f"{described}; host peak {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB")

    values, unread = {}, []
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        elif device.type == "cuda" or m["source"] != "device_trace":
            unread.append(m["name"])
    if unread:
        # a metric the cell lists that reads nothing has lost its yardstick
        # (a layer's calls renamed, a counter gone): no result
        raise RuntimeError(f"{workload}: the metrics {unread} read nothing in this run")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": compare.verdict(numbers, limits), "attempted": len(run.batches) * run.batch,
              "failed": failed, "metrics": values, "device": dev}
    if trace:
        s = run.summary
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    result["check"] = {n: {"value": numbers[n], "limit": limits[n]} for n in numbers}
    return result, compare.lines(numbers, limits)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for name in [n for n in os.environ if n.startswith("NRT_")]:
        del os.environ[name]   # the program runs its defaults
    _bench, cell, _cfg, _traffic = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}")
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {bad}; the benchmark may load none of {FORBIDDEN}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0
