#!/usr/bin/env python3
"""The merge kernels, B=32 merge batches and fused singles of one checkout of
the port, for an A/B of two checkouts on one card.

    python3 tools/torch_ab.py [--root DIR]

DIR is a checkout's root (default: this repository); the script imports
``nrtsearch_tpu_torch`` from there and builds its kernels. The work is
chip_smoke.py's own (this repository's copy), run on that package: phase 4's
index (1M docs in 4 segments), phase 5's queries, phase 3's merge kernels
against their twins at the first B = 32 batch's shapes (CUDA events, the L2
evicted before each launch), the 4 batches through ``fast_search_batch`` and
the 8 singles (the fused path) through ``search`` for 8 rounds after a
warm-up round (p50 and p90 on the host clock), and the smoke's profiles of
the first batch and of the first single (``fused_single``: its device time).
It prints one JSON line, labelled with DIR's name. Compare two checkouts
only inside one call, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
ROUNDS = 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from nrtsearch_tpu_torch import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {kernels.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    kernels.build()
    corpus, _columns, searcher = cs.phase_index(dev, cs.NUM_DOCS, cs.VOCAB, cs.DRAWS,
                                                cs.SEGMENTS)
    singles, batches = cs.sample_search_queries(corpus)
    offs, _lens, _w, run_len = cs.batch_plan(searcher, batches[0])
    batch_n = offs.shape[1] * run_len
    stats = cs.phase_kernels(dev, [batch_n], batch_n, head=False)
    stats.update(cs.phase_accel_kernels(dev, searcher, batches[0]))
    torch.cuda.empty_cache()
    cs._timed_searches(searcher, singles, batches, reps=1)
    timed = cs._timed_searches(searcher, singles, batches, reps=ROUNDS)
    lat, lat1 = timed["lat32"], timed["lat1"]
    single = cs.profile_call(lambda: searcher.search(cs._match(singles[0]), cs.TOP_K))
    out = {
        "label": root.name, "card": cs.card_line(),
        "kernels": {name: {"ms": st["ms"], "bound_ms": cs.bound(st["bytes"], st["ops"])[0],
                           "shape": st["shape"]} for name, st in stats.items()},
        "p50_ms": 1e3 * float(np.median(lat)), "p90_ms": 1e3 * float(np.percentile(lat, 90)),
        "n": len(lat), **cs.profile_batch(searcher, batches[0]),
        "p50_1_ms": 1e3 * float(np.median(lat1)), "n_1": len(lat1),
        "fused_single": {k: single[k] for k in ("device_busy_ms", "device_items", "top")},
    }
    out["busy_share_of_p50"] = out["device_busy_ms"] / out["p50_ms"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
