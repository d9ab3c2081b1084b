"""Quickstart on the PyTorch/CUDA port: the MatPIM reproduction end-to-end
in one file, the counterpart of ``examples/quickstart.py``.

1. Run the paper's algorithms on the cycle-accurate crossbar simulator
   (Table I / II claims).
2. Scale past one 1024x1024 array: the compiled engine executes a grid of
   crossbar tiles as one bit-plane-packed batch.
3. Run the hand-written Hopper kernel for ±1 GEMM against its oracles:
   the dense product and the simulated crossbar engine itself.
4. Forward one assigned architecture (reduced config).
5. Compose plans into an end-to-end application pipeline
   (``repro_torch.apps``).

    PYTHONPATH=src python examples/quickstart_torch.py             # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu --small

On ``cuda`` section 3 launches the CUDA kernel (built with ``nvcc`` at
first use); on the CPU it runs the kernel's plain PyTorch version.
``--small`` shrinks sections 2 and 3 to one crossbar tile.
"""
import argparse

import numpy as np
import torch

from repro_torch.apps import BinaryMLP
from repro_torch.configs import get_config
from repro_torch.core import (matpim_binary_matvec, matpim_matvec,
                              tiled_binary_matvec)
from repro_torch.core.latency import build_table1, format_rows
from repro_torch.kernels import ref
from repro_torch.kernels.binary_matmul import binary_matmul
from repro_torch.models import build_model
from repro_torch.models.spec import init_params
from repro_torch.serve import PlanService


def banner(title: str) -> None:
    print("=" * 70)
    print(title)
    print("=" * 70)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device every section runs on (default cuda)")
    ap.add_argument("--small", action="store_true",
                    help="one crossbar tile in sections 2 and 3")
    args = ap.parse_args(argv)
    dev = args.device

    banner("1. MatPIM in-crossbar algorithms (cycle-accurate stateful logic)")
    rng = np.random.default_rng(0)
    A = rng.integers(0, 1 << 16, size=(128, 16)).astype(np.int64)
    x = rng.integers(0, 1 << 16, size=16).astype(np.int64)
    y, cycles = matpim_matvec(A, x, N=16, alpha=2, device=dev)
    ok = np.array_equal(np.asarray(y, dtype=object),
                        (A.astype(object) @ x.astype(object)) % (1 << 32))
    print(f"balanced matvec 128x16 N=16 α=2: {cycles} cycles, "
          f"correct={ok}")
    Ab = rng.choice([-1, 1], size=(256, 128))
    xb = rng.choice([-1, 1], size=128)
    yb, pop, cyc = matpim_binary_matvec(Ab, xb, device=dev)
    print(f"binary matvec 256x128: {cyc} cycles, majority output verified: "
          f"{np.array_equal(yb, np.where(((Ab * xb) > 0).sum(1) >= 64, 1, -1))}")
    print()
    print(format_rows(build_table1(), "Table I reproduction [cycles]"))

    print()
    banner("2. Multi-crossbar scale-out (compiled engine, tiled batch)")
    M, K = (1024, 416) if args.small else (4096, 2048)
    At = rng.choice([-1, 1], size=(M, K))
    xt = rng.choice([-1, 1], size=K)
    yt, info = tiled_binary_matvec(At, xt, device=dev)
    ok = np.array_equal(yt, np.where(At @ xt >= 0, 1, -1))
    print(f"binary matvec {M}x{K} on {info.n_tiles} crossbar tiles "
          f"(grid {info.grid}): {info.cycles} cycles in lockstep + "
          f"{info.reduce_depth}-level host tree reduction, correct={ok}")

    print()
    banner("3. Hopper kernel: XNOR-popcount GEMM against its oracles")
    M, N, K = (32, 8, 64) if args.small else (128, 128, 256)
    a = rng.choice([-1, 1], size=(M, K)).astype(np.float32)
    b = rng.choice([-1, 1], size=(N, K)).astype(np.float32)
    C = binary_matmul(ref.pack_bits(torch.from_numpy(a)).to(dev),
                      ref.pack_bits(torch.from_numpy(b)).to(dev)).cpu()
    dense = ref.binary_matmul_ref(torch.from_numpy(a), torch.from_numpy(b))
    crossbar = ref.crossbar_binary_matmul_ref(a, b, device=dev)
    route = "CUDA kernel" if torch.device(dev).type == "cuda" \
        else "plain version"
    print(f"binary_matmul {M}x{N}x{K} ({route}): equal to the dense product "
          f"{bool(torch.equal(C, dense))}, to the crossbar engine "
          f"{bool(np.array_equal(C.numpy(), crossbar))}, 32x packed memory "
          f"traffic vs dense int32")

    print()
    banner("4. Assigned architecture forward (granite-moe, reduced)")
    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model.specs(), gen, cfg.dtype, dev)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 32)),
                                       dtype=torch.long, device=dev)}
    with torch.no_grad():
        logits, _ = model.forward(params, batch)
    print(f"{cfg.name}: logits {tuple(logits.shape)}, finite="
          f"{bool(torch.isfinite(logits.float()).all())}")

    print()
    banner("5. Application pipeline: 2-layer BNN, every layer in-crossbar")
    svc = PlanService(device=dev)
    bnn = BinaryMLP.random([64, 64, 16], seed=0, plan_kw={"service": svc})
    xv = rng.choice([-1, 1], size=64)
    yv, report = bnn.forward(xv, device=dev)
    print(report)
    print(f"matches numpy reference: "
          f"{bool(np.array_equal(yv, bnn.reference(xv)[0]))}  "
          f"(see `python -m repro_torch.apps.bnn` / `.imaging` for the full "
          f"demos)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
