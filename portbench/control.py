"""The check's control: the reference put in the program's place, computed
in the nearest precision below the one the configuration states, and
judged by the same check. It has to come out as not correct.

    python3 -m portbench.control --workload <name> --seeds 11,12,13

For each seed it draws the cell's data and the batches a run would send,
answers as many queries as a run's check compares with the control (the
configuration's kind's ``Reference`` built with the traffic's
``check.control``; for BM25, ``{"dtype": "bfloat16"}`` computes the
impacts, products and sums in bf16, for the f32 merge path, and
``{"qmax": 127}`` quantizes each contribution to 7 bits, int8's range,
for the bucket path's 15-bit contract), checks them with the kind's
check against its exact reference and prints the numbers beside the
cell's limits, one JSON line per seed. The benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def control_numbers(workload: str, seed: int, device, overrides: dict | None = None) -> dict:
    from portbench import compare, kinds
    from portbench.harness import _merge, load_cell

    _bench, _cell, cfg, traffic = load_cell(workload)
    overrides = overrides or {}
    cfg = _merge(cfg, overrides.get("config", {}))
    traffic = _merge(traffic, overrides.get("traffic", {}))
    kind = kinds.load(cfg["kind"])
    chk = traffic["check"]
    B, k = int(traffic["batch"]), int(traffic["k"])
    n_batches = -(-int(chk["sample"]) // B)
    data = kind.make_data(cfg, seed, device)[0]
    stream = kind.QueryStream(cfg, traffic, seed, "queries", n_batches, device)
    queries = np.concatenate([stream.batch(i) for i in range(n_batches)])
    ctl = chk["control"]
    low = kind.Reference(data, cfg, ctl)
    answers = []
    for lo in range(0, len(queries), compare.BLOCK):
        dense, matched = low.dense(queries[lo:lo + compare.BLOCK])
        s, d, h = low.topk(dense, matched, k)
        answers.append((s.astype(np.float32), d, h))
        del dense, matched
    prog = tuple(np.concatenate([a[i] for a in answers]) for i in range(3))
    ref = kind.Reference(data, cfg)
    numbers = kind.check(ref, queries, prog, k, chk)
    return {"seed": seed, "control": ctl, "numbers": numbers, "limits": chk["limits"],
            "correct": compare.verdict(numbers, chk["limits"])}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(control_numbers(args.workload, seed, torch.device("cuda", 0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
