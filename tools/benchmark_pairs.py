#!/usr/bin/env python3
"""Parent and change of the benchmark in turns: pairs of `benchmark/run.py`
runs, each a process of its own, from two trees of the repo.

    python3 tools/benchmark_pairs.py --parent _checkout/parent \\
        --change _checkout/change --pairs 10 --out _checkout/pairs

Pair i runs parent then change when i is even, change then parent when it is
odd. Each run is `python3 <tree>/benchmark/run.py --seed S` from the tree's
root; its standard output goes to OUT/<side>_<i>.log. Per workload the
summary gives each side's end-to-end metrics (every run, median and
quartiles), the change's wins over its pair partner (ties count for
neither), the parent's own spread (the distance between its quartiles) and
the claim rule: the change wins at least nine
tenths of the pairs and the medians differ by more than the parent's spread.
Beside them, per run: `correct`, the replay's reproduction, the live-volume
TSDF RMSE, the p50 of each span (`layer_ms_per_frame`), the device's busy ms
and busy share, the device operations a frame (in all and by span), the idle
ms by span, and the device ms a frame of each CUDA kernel among the top
device operations. The summary is OUT/pairs.json and the last stdout line.
Exit 1 if a run failed or a cell was not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

# end-to-end metrics and whether higher is better
METRICS = {"frame_ms_p50": False, "frame_ms_p90": False, "frames_per_s": True}


def run_once(tree: str, seed: int, log_path: str) -> dict:
    """One benchmark process; returns its cells' JSON (the lines with a
    "workload" key) and its wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--seed", str(seed)], cwd=tree,
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(proc.stdout)
        f.write(proc.stderr)
    cells = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{") and '"workload"' in line:
            cell = json.loads(line)
            cells[cell["workload"]] = cell
    return {"rc": proc.returncode, "seconds": secs, "cells": cells}


def readings(cell: dict) -> dict:
    """What PERF.md reads of one run's cell."""
    t = cell["traced"]
    dev = t["device"]
    b = dev.get("breakdown", {})
    ops = b.get("device_ops_per_frame_by_span", {})
    return {
        "correct": cell["correct"], "reproduced": cell["reproduced"],
        "metrics": cell["metrics"],
        "live_tsdf_rmse": cell["gate"]["live_volume"].get("live_tsdf_rmse"),
        "mesh_rmse_vox": cell["gate"]["mesh_rmse_vox"],
        "tracking_fraction": cell["gate"]["tracking_fraction"],
        "layer_ms_p50": {k: v.get("p50") for k, v in t["layer_ms_per_frame"].items()},
        "device_busy_ms_per_frame": dev.get("device_busy_ms_per_frame"),
        "busy_share": dev.get("busy_share"),
        "device_busy_ms_over_timed_p50": cell.get("device_busy_ms_over_timed_p50"),
        "device_ops_per_frame": sum(ops.values()),
        "device_ops_per_frame_by_span": ops,
        "idle_ms_per_frame_by_span": b.get("idle_ms_per_frame_by_span"),
        "top_device_ops": {o["name"][:60]: [o["device_ms_per_frame"], o["launches_per_frame"]]
                           for o in b.get("top_device_ops", [])},
        "host_launch_us_before_after": cell.get("host_launch_us_before_after"),
    }


def quartiles(values) -> dict:
    q1, med, q3 = np.percentile(np.asarray(values, np.float64), [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3), "runs": list(values)}


def summary(runs: list) -> dict:
    """runs: [(pair, side, result)] -> per workload the comparison."""
    out = {}
    names = sorted({w for _, _, r in runs for w in r["cells"]})
    pairs = sorted({i for i, _, _ in runs})
    for w in names:
        by = {(i, s): r["cells"][w] for i, s, r in runs if w in r["cells"]}
        res = {"metrics": {}}
        for m, higher in METRICS.items():
            vals = {s: [by[(i, s)]["metrics"][m] for i in pairs if (i, s) in by]
                    for s in ("parent", "change")}
            wins = losses = 0
            for i in pairs:
                if (i, "parent") in by and (i, "change") in by:
                    a, b = by[(i, "parent")]["metrics"][m], by[(i, "change")]["metrics"][m]
                    better = b > a if higher else b < a
                    wins += int(better and a != b)
                    losses += int(not better and a != b)
            p, c = quartiles(vals["parent"]), quartiles(vals["change"])
            spread = p["q3"] - p["q1"]
            gain = c["median"] - p["median"] if higher else p["median"] - c["median"]
            n = wins + losses
            res["metrics"][m] = {
                "parent": p, "change": c, "change_wins": wins, "change_losses": losses,
                "parent_spread": spread, "median_gain": gain,
                "median_gain_ratio": gain / p["median"] if p["median"] else None,
                "claimed": bool(n and wins >= 0.9 * len(pairs) and gain > spread)}
        res["runs"] = {f"{s}_{i}": readings(c) for (i, s), c in sorted(by.items())}
        out[w] = res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the parent's tree (a git archive)")
    ap.add_argument("--change", required=True, help="the change's tree (a git archive)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    runs, failed = [], []
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            tree = args.parent if side == "parent" else args.change
            r = run_once(tree, args.seed, os.path.join(args.out, f"{side}_{i}.log"))
            ok = r["rc"] == 0 and r["cells"] and all(c["correct"] for c in r["cells"].values())
            print(f"[pairs] pair {i} {side}: rc {r['rc']}, {r['seconds']:.1f} s, "
                  + ", ".join(f"{w} {json.dumps(c['metrics'])} correct {c['correct']}"
                              for w, c in r["cells"].items()), flush=True)
            if not ok:
                failed.append(f"{side}_{i}")
            runs.append((i, side, r))
    result = {"pairs": args.pairs, "seed": args.seed, "failed_runs": failed,
              "workloads": summary(runs)}
    with open(os.path.join(args.out, "pairs.json"), "w") as f:
        json.dump(result, f, indent=1)
    short = {w: {m: {k: v[k] for k in ("change_wins", "change_losses", "parent_spread",
                                       "median_gain", "median_gain_ratio", "claimed")}
                     | {"parent_median": v["parent"]["median"],
                        "change_median": v["change"]["median"]}
                 for m, v in r["metrics"].items()}
             for w, r in result["workloads"].items()}
    print(json.dumps({"failed_runs": failed, "workloads": short}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
