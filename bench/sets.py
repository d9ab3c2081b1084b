"""Run a cell several times, one process after another, and report the
spread of each metric: what a bound is set from.

    python3 bench/sets.py --workload <cell> --seconds <s> --seeds 11 12 13 \\
        [--trace 0|1] [--out FILE.jsonl]

Each run is ``bench/run.py`` in a process of its own; its result line is
appended to ``--out`` with the seed, exit code, wall and set-up.
The summary gives, per metric, the median and the spread: the distance
between the first and third quartiles of ``statistics.quantiles(values,
n=4)``, as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    lines = []
    for seed in args.seeds:
        t = time.perf_counter()
        p = subprocess.run([sys.executable, str(RUN), "--workload",
                            args.workload, "--seed", str(seed), "--seconds",
                            str(args.seconds), "--trace", str(args.trace)],
                           capture_output=True, text=True)
        wall = time.perf_counter() - t
        try:
            res = json.loads(p.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        entry = {"workload": args.workload, "seed": seed, "rc": p.returncode,
                 "wall_s": wall, "result": res}
        if res is None or p.returncode:
            entry["stderr"] = p.stderr[-3000:]
        lines.append(entry)
        print(json.dumps(entry), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(entry) + "\n")
    got = [e["result"] for e in lines if e["result"]]
    names = sorted({k for r in got for k in r["metrics"]})
    summary = {}
    for n in names:
        vals = [r["metrics"][n]["value"] for r in got if n in r["metrics"]]
        summary[n] = {"median": statistics.median(vals),
                      "spread": spread(vals), "values": vals}
    summary["correct"] = [r["correct"] for r in got]
    summary["checks"] = [r.get("checks") for r in got]
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
