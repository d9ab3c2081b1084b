"""Energy & reliability trade-off study on the PyTorch/CUDA port's device
subsystem, the counterpart of ``examples/energy_reliability.py``.

1. Price the four MatPIM algorithms (energy/EDP) under three device
   profiles — the trade-off axis latency tables alone can't show.
2. Monte-Carlo a fault-rate → accuracy curve (every sample is an
   independent fault realization packed into the engine's bit-planes).
3. Buy accuracy back with in-crossbar TMR (MIN3 majority vote) and show
   what it costs in cycles/energy.

    PYTHONPATH=src python examples/energy_reliability_torch.py [--full]
    PYTHONPATH=src python examples/energy_reliability_torch.py \\
        --device cpu --samples 32
"""
import argparse

from repro_torch.device import (PROFILES, binary_matvec_sweep, energy_table,
                                format_energy_rows, format_sweep,
                                tmr_binary_matvec)


def banner(title: str) -> None:
    print("=" * 70)
    print(title)
    print("=" * 70)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale plan configs (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="device the fault runs replay on (default cuda)")
    ap.add_argument("--samples", type=int, default=None,
                    help="fault samples per rate (default 256, 1024 with "
                         "--full)")
    args = ap.parse_args(argv)
    quick = not args.full

    banner("1. Energy/EDP of the four algorithms, three device corners")
    for name in PROFILES:
        rows = energy_table(name, quick=quick)
        print(format_energy_rows(rows, f"profile={name}"))
        print()

    banner("2. Monte-Carlo reliability: fault rate -> accuracy")
    rates = [1e-4, 3e-4, 1e-3, 3e-3, 1e-2]
    samples = args.samples or (256 if quick else 1024)
    points = binary_matvec_sweep(rates, samples=samples, device=args.device)
    print(format_sweep(points,
                       f"binary matvec, {samples} fault samples/rate"))
    print()

    banner("3. In-crossbar TMR (MIN3 vote over 3 re-executions)")
    for rate in (3e-4, 1e-3, 3e-3):
        r = tmr_binary_matvec(rate, samples=samples, device=args.device)
        print(f"rate {rate:.0e}: sign-err {r.err_raw:.4f} -> "
              f"{r.err_tmr:.4f}  (cycles x{r.cycle_overhead:.2f}, energy "
              f"x{r.energy_overhead:.2f})")
    print("\nreliability buys back accuracy at ~3x energy — the trade-off "
          "surface EXPERIMENTS.md §Mitigation quantifies.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
