"""The traced window: ``torch.profiler`` over the timed loop, and the
reduction of its events to spans, device busy time and layer times.

The profiler runs a schedule of one warm-up step, traced and discarded
(without it the tracer drops more of a call's kernels the longer the
process has run), and one active step that covers the whole window. The
trace fails, rather than give a share, when it holds fewer items of one of
the port's kernels than ``nrtsearch_tpu_torch.kernels.LAUNCHES`` counted
in the window; the harness then traces the window once more.

Events are reduced to plain tuples first (``Ev``), so that the arithmetic
below is tested on the CPU with made-up events:

- device busy time: the union of every device operation's interval
  (kernels, copies, sets) inside the window's host span;
- a layer's device time: the summed durations of the kernels whose launch
  (a `cudaLaunchKernel` or `cuLaunchKernel` call, matched by correlation id) lies inside
  one of that layer's ``record_function`` ranges;
- idle gaps: each gap of the union inside the window, named by the
  innermost benchmark range and host operation running at its middle.
"""

from __future__ import annotations

import bisect
import itertools
import re
from dataclasses import dataclass, field

WINDOW = "portbench.window"


@dataclass(frozen=True)
class Ev:
    kind: str      # "device", "launch", "range" (benchmark annotation), "op" (host op)
    name: str
    start: int     # ns
    end: int       # ns
    corr: int = 0  # correlation id (device items and launches)


@dataclass
class Summary:
    window_s: float
    busy_s: float
    layer_s: dict = field(default_factory=dict)        # layer -> kernel seconds
    kernel_items: dict = field(default_factory=dict)   # device item name -> count
    device_ops: list = field(default_factory=list)     # [[name, seconds]] top 10
    idle_gaps: list = field(default_factory=list)      # [[name, seconds]] top 10


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or "LaunchCooperativeKernel" in name


def events_from_kineto(kineto_events) -> list[Ev]:
    """The profiler's raw events as ``Ev`` tuples."""
    from torch.autograd import DeviceType

    out = []
    for e in kineto_events:
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() == DeviceType.CUDA:
            # a range's span on the device timeline is no device work
            if not (e.is_user_annotation() or name.startswith(("portbench.", "ProfilerStep"))):
                out.append(Ev("device", name, start, end, e.correlation_id()))
        elif name.startswith("portbench."):
            out.append(Ev("range", name, start, end))
        elif _is_launch(name):
            out.append(Ev("launch", name, start, end, e.correlation_id()))
        elif not name.startswith("ProfilerStep") and not name.startswith("cuda"):
            out.append(Ev("op", name, start, end))
    return out


def union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class _Cover:
    """The innermost of nested host intervals that covers a time: the one
    with the latest start among those still running."""

    def __init__(self, evs: list[Ev]):
        self.evs = sorted(evs, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.evs]
        # the latest end among the first i intervals: below t, none covers t
        self.reach = list(itertools.accumulate((e.end for e in self.evs), max))

    def at(self, t: int) -> str:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.reach[j] >= t:
            if self.evs[j].end >= t:
                return self.evs[j].name
            j -= 1
        return "-"


def summarize(evs: list[Ev], layers: list[str], top: int = 10) -> Summary:
    """Reduce one traced window's events (see the module's docstring)."""
    windows = [e for e in evs if e.kind == "range" and e.name == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} range")
    w0, w1 = windows[0].start, windows[0].end
    dev = [e for e in evs if e.kind == "device" and e.end > w0 and e.start < w1]
    busy = union((max(e.start, w0), min(e.end, w1)) for e in dev)
    s = Summary(window_s=(w1 - w0) / 1e9, busy_s=sum(e - b for b, e in busy) / 1e9)

    per_name: dict[str, float] = {}
    for e in dev:
        per_name[e.name] = per_name.get(e.name, 0.0) + (e.end - e.start) / 1e9
        s.kernel_items[e.name] = s.kernel_items.get(e.name, 0) + 1
    s.device_ops = [[n, v] for n, v in sorted(per_name.items(), key=lambda x: -x[1])[:top]]

    launches = sorted((e.start, e.corr) for e in evs if e.kind == "launch")
    kernels_by_corr: dict[int, list[Ev]] = {}
    for e in dev:
        if _is_kernel(e.name):
            kernels_by_corr.setdefault(e.corr, []).append(e)
    starts = [t for t, _ in launches]
    for layer in layers:
        name = f"portbench.{layer}"
        total = 0.0
        for r in (e for e in evs if e.kind == "range" and e.name == name):
            i = bisect.bisect_left(starts, r.start)
            while i < len(launches) and launches[i][0] <= r.end:
                for k in kernels_by_corr.get(launches[i][1], ()):
                    total += (k.end - k.start) / 1e9
                i += 1
        s.layer_s[layer] = total

    # idle gaps inside the window, named by what the host was doing
    host = [e for e in evs if e.kind in ("range", "op") and e.name != WINDOW]
    ranges = _Cover([e for e in host if e.kind == "range"])
    ops = _Cover([e for e in host if e.kind == "op"])
    edges = [w0] + [t for b, e in busy for t in (b, e)] + [w1]
    gaps: dict[str, float] = {}
    for b, e in zip(edges[::2], edges[1::2]):
        if e <= b:
            continue
        mid = (b + e) // 2
        key = f"{ranges.at(mid)}/{ops.at(mid)}"
        gaps[key] = gaps.get(key, 0.0) + (e - b) / 1e9
    s.idle_gaps = [[n, v] for n, v in sorted(gaps.items(), key=lambda x: -x[1])[:top]]
    return s


def lost_kernels(launched: dict, items: dict) -> list[str]:
    """The port's kernels (``LAUNCHES`` deltas) with fewer trace items than
    launches: a device item ``<name>_kernel`` or ``<name>_wide_kernel``."""
    lost = []
    for name, n in launched.items():
        if n <= 0:
            continue
        pat = re.compile(rf"\b{name}(_wide)?_kernel\b")
        if sum(c for item, c in items.items() if pat.search(item)) < n:
            lost.append(name)
    return lost
