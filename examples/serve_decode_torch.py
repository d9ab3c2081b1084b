"""Serving example on the PyTorch/CUDA port: continuous-batching decode
with prefill handoff, the counterpart of ``examples/serve_decode.py``.

Each slot's prompt is prefilled once and its K/V (or SSM state) handed to
the engine's cache; every step then decodes one token for every live
slot.

    PYTHONPATH=src python examples/serve_decode_torch.py             # card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu \\
        --requests 2 --max-new 4
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.spec import init_params
from repro_torch.serve.engine import Engine, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on (default cuda)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=24)
    args = ap.parse_args(argv)

    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_params(model.specs(), gen, cfg.dtype, args.device)
    engine = Engine(model, params, max_batch=4, max_seq=96)

    rng = np.random.default_rng(0)
    requests = [Request(uid=i, prompt=rng.integers(1, cfg.vocab, (12,)
                                                   ).astype(np.int64),
                        max_new=args.max_new)
                for i in range(args.requests)]
    t0 = time.time()
    results = engine.run(requests)
    dt = time.time() - t0
    ntok = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests / {ntok} tokens in {dt:.1f}s "
          f"({ntok / dt:.1f} tok/s on {args.device})")
    for uid in sorted(results)[:3]:
        print(f"  req {uid}: {results[uid][:10]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
