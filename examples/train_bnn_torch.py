"""End-to-end training script on the PyTorch/CUDA port: train the MatPIM BNN model
(binary XNOR FFNs — the paper's §II-B as a first-class layer) on
synthetic data, with checkpointing and the fault-tolerant loop, the
counterpart of ``examples/train_bnn.py``.

    PYTHONPATH=src python examples/train_bnn_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_bnn_torch.py --device cpu \\
        --steps 6 --ckpt-every 3

Checkpoints go to ``--ckpt-dir``, by default a temporary directory that
is removed at the end.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.fault_tolerance import run_resilient_loop
from repro_torch.models import build_model
from repro_torch.models.spec import init_params
from repro_torch.train import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--full", action="store_true",
                    help="full matpim-bnn config (default: reduced)")
    ap.add_argument("--device", default="cuda",
                    help="device the model trains on (default cuda)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    args = ap.parse_args(argv)

    cfg = get_config("matpim-bnn")
    if not args.full:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"binary_ffn={cfg.binary_ffn}")

    dev = torch.device(args.device)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(model.specs(), gen, cfg.dtype, dev)
    tc = TrainConfig(lr=3e-3, remat="none")
    step_fn, opt = make_train_step(model, tc)
    src = SyntheticLM(cfg, batch=8, seq=64, seed=0)

    def batch_at(i):
        return {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in src.at_step(i).items()}

    t0 = time.time()
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 25 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}  "
                  f"({(time.time() - t0) / (step + 1):.3f}s/step)",
                  flush=True)

    with tempfile.TemporaryDirectory(prefix="bnn_ckpt_") as tmp:
        ck = Checkpointer(args.ckpt_dir or tmp)
        run_resilient_loop(step_fn, (params, opt.init(params)), batch_at, ck,
                           n_steps=args.steps, ckpt_every=args.ckpt_every,
                           on_metrics=on_metrics)
        ck.wait()
    print(f"final loss {losses[-1]:.4f} (from {losses[0]:.4f}); "
          f"binary-FFN model trained through the straight-through estimator.")
    if not losses[-1] < losses[0]:
        raise SystemExit("the loss did not fall")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
