"""Run one cell of the benchmark of ``repro_torch`` on this machine's cards.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in ``BENCHMARK.json`` at the root of the checkout;
its configuration, traffic mix, driver, limits and metrics are files under
``bench/`` found by name (``bench/README.md``). The driver builds the
program's system under test from the seed, warms it up, measures for
``--seconds`` seconds and checks what the window produced against the
plain reference. The last line of standard output is the result, one JSON
object; the last lines of standard error are the numbers compared, each
beside its limit. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (with a profiled stretch after the
window). Without the cards the cell asks for, the run prints no result and
exits with code 2.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches():
    """Every build and kernel cache inside the checkout, at fixed paths,
    so that only a checkout's first run builds."""
    build = ROOT / "build" / "bench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def metrics(specs, workload: str, rec: dict, need: bool) -> dict:
    """Each metric of the cell that its reader finds something for; a
    missing one raises where ``need`` says the cell must report it."""
    out = {}
    for m in harness.reported(specs, workload):
        value = harness.metric(m["name"]).read(rec)
        if value is None:
            if need:
                raise RuntimeError(f"{workload}: nothing to read for "
                                   f"{m['name']}")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    caches()
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cfg = harness.config(cell["config"])
    mix = harness.mix(cell["traffic"])
    ctx = {"config": cfg, "mix": mix, "seed": args.seed % 2 ** 63,
           "seconds": args.seconds, "trace": bool(args.trace),
           "device": torch.device("cuda", 0), "t0": T0,
           "limits": harness.limits(args.workload)}
    rec = harness.driver(mix["driver"]).run(ctx)

    foreign = harness.foreign_modules()
    if foreign:
        print(f"loaded modules the benchmark may not load: {foreign}",
              file=sys.stderr)
        return 3
    if args.trace:
        got = metrics(bench["per_layer"], args.workload, rec, need=False)
    else:
        got = metrics(bench["end_to_end"], args.workload, rec, need=True)
    device = harness.device_info(ctx["device"], cell["chips"])
    device["memory_peak_bytes"] = rec["memory_peak_bytes"]
    device["power_limit_w"] = harness.power_limit_w()
    line = {"correct": rec["correct"], "attempted": rec["attempted"],
            "failed": rec["failed"], "metrics": got, "device": device}
    tr = rec.get("trace")
    if tr:
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    # the parts of set-up, for the reader; the driver reads setup_s
    line["setup_parts"] = rec.get("setup_parts")
    line["checks"] = rec["checks"]
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
