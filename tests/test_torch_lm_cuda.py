"""The model stack on the card equals its CPU run (card only).

For the reduced config of every family, in float32 on the same seeded
parameters and inputs: forward logits and caches, and four decode steps
after it, on ``cuda`` agree with the CPU within 1e-3 of each tensor's
scale (its largest magnitude, at least 1; the hybrid's SSM states reach
the tens of thousands). Marked ``cuda``: the tests skip without a card.
They import nothing of the reference package, so they run where jax is
absent.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import (init_params, tree_leaves,  # noqa: E402
                                     tree_map)

FAMILIES = ["olmo-1b", "granite-moe-1b-a400m", "mamba2-370m", "qwen2-vl-2b",
            "whisper-tiny", "jamba-1.5-large-398b", "matpim-bnn"]
B, S, STEPS, TOL = 2, 32, 4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, what):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().cpu().numpy(), w.float().numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale,
                                   err_msg=f"{what}, leaf {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_card_equals_cpu(cuda, arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         "float32")
    rng = np.random.default_rng(FAMILIES.index(arch))
    seq = 288 if cfg.family == "vlm" else S
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, seq))).long()}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.1)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, 256, cfg.d_model)).astype(np.float32) * 0.1)
    on = {"cpu": (params, batch),
          "cuda": (tree_map(lambda t: t.to(cuda), params),
                   {k: v.to(cuda) for k, v in batch.items()})}
    out = {}
    with torch.no_grad():
        for dev, (p, b) in on.items():
            logits, caches = model.forward(p, b)
            cache = model.init_cache(B, STEPS, torch.float32, device=dev)
            if cfg.family == "encdec":
                cache["cross_kv"] = model.encoder_kv(
                    p, model.encode(p, b["frames"]))
            steps = []
            for t in range(STEPS):
                lg, cache = model.decode_step(
                    p, cache, b["tokens"][:, t:t + 1],
                    torch.full((B,), t, dtype=torch.long, device=dev))
                steps.append(lg)
            out[dev] = (logits, caches, steps, cache)
    assert out["cuda"][0].device.type == "cuda"
    _close(out["cuda"][0], out["cpu"][0], f"{arch} logits")
    _close(out["cuda"][1], out["cpu"][1], f"{arch} caches")
    _close(out["cuda"][2], out["cpu"][2], f"{arch} decode logits")
    _close(out["cuda"][3], out["cpu"][3], f"{arch} decode caches")
