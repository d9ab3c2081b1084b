"""CPU tests of the benchmark's model flops (``bench/flops.py``): a dense
configuration counts what it always did, each other family counts its
layers by hand at its published widths, and the layer pattern the
yardstick walks is the one the port builds.

    python3 -m pytest -q bench/tests/test_bench_flops.py
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import flops, harness  # noqa: E402

pytest.importorskip("torch")

from repro_torch.configs.registry import REGISTRY  # noqa: E402

COUNTED = [n for n, c in REGISTRY.items() if c.family in flops.COUNTED]
NOT_COUNTED = [n for n, c in REGISTRY.items()
               if c.family not in flops.COUNTED]


def as_dict(name: str) -> dict:
    return dataclasses.asdict(REGISTRY[name])


def test_dense_counts_equal_the_earlier_yardsticks():
    # the values the yardstick gave before it counted other families
    cfg = harness.config("olmo-1b")
    assert flops.prefill(cfg, 1024) == 2267949301760.0
    assert flops.decode(cfg, 32, 24576) == 78550925312
    assert flops.train_step(cfg, 8, 2048) == 122303488720896.0


# -- hand counts at the published widths --------------------------------------

def attn(T, ctx, D, H, KV, hd):
    return 2 * T * D * (2 * H * hd + 2 * KV * hd) + 4 * ctx * H * hd


def swiglu(T, D, F):
    return 2 * T * D * F * 3


def mamba(T, seq, D, DI, N, P, K=4):
    H = DI // P
    f = 2 * T * D * (2 * DI + 2 * N + H) + 2 * T * DI * D \
        + 2 * T * (DI + 2 * N) * K
    if seq is None:
        return f + 4 * T * H * P * N
    L = min(256, seq)
    return f + 2 * T * L * N + 2 * T * L * H * P + 4 * T * H * P * N


def counts(layer, unembed):
    """prefill(1024), decode(32 slots, 24,576 rows) and train_step(8,
    2048) from a layer count ``layer(T, ctx, seq)`` and the unembedding's
    ``unembed(T)``."""
    T = 8 * 2048
    return (layer(1024, 1024 * 1024 / 2, 1024) + unembed(1),
            layer(32, 24576, None) + unembed(32),
            3 * (layer(T, 8 * 2048 * 2048 / 2, 2048) + unembed(T)))


def mamba2_370m():
    # 48 Mamba-2 mixers, no FFN; d_model 1024, d_inner 2048, state 128,
    # 32 heads of 64; vocab 50280 padded to 50432
    return counts(lambda T, ctx, seq: 48 * mamba(T, seq, 1024, 2048, 128, 64),
                  lambda T: 2 * T * 1024 * 50432)


def granite_moe_1b_a400m():
    # 24 layers, each GQA (16 heads of 64, 8 KV) and an MoE of 32 experts,
    # top 8, width 512; vocab 49155 padded to 49408
    def layer(T, ctx, seq):
        return 24 * (attn(T, ctx, 1024, 16, 8, 64) + 2 * T * 1024 * 32
                     + 8 * swiglu(T, 1024, 512))
    return counts(layer, lambda T: 2 * T * 1024 * 49408)


def arctic_480b():
    # 35 layers, each GQA (56 heads of 128, 8 KV), an MoE of 128 experts,
    # top 2, width 4864, and a dense residual MLP of width 4864
    def layer(T, ctx, seq):
        return 35 * (attn(T, ctx, 7168, 56, 8, 128) + 2 * T * 7168 * 128
                     + 2 * swiglu(T, 7168, 4864) + swiglu(T, 7168, 4864))
    return counts(layer, lambda T: 2 * T * 7168 * 32000)


def jamba_1_5_large_398b():
    # 72 layers: attention at i % 8 == 4 (9 layers, all even, so all MLP),
    # Mamba-2 elsewhere (63); an MoE of 16 experts, top 2, at every odd
    # layer (36, all Mamba-2), an MLP at the even ones (27 Mamba-2, 9
    # attention); d_model 8192, d_ff 24576, d_inner 16384, state 16
    def layer(T, ctx, seq):
        moe = 2 * T * 8192 * 16 + 2 * swiglu(T, 8192, 24576)
        mlp = swiglu(T, 8192, 24576)
        mix = mamba(T, seq, 8192, 16384, 16, 64)
        return (9 * (attn(T, ctx, 8192, 64, 8, 128) + mlp)
                + 36 * (mix + moe) + 27 * (mix + mlp))
    return counts(layer, lambda T: 2 * T * 8192 * 65536)


@pytest.mark.parametrize("name,hand", [
    ("mamba2-370m", mamba2_370m),
    ("granite-moe-1b-a400m", granite_moe_1b_a400m),
    ("arctic-480b", arctic_480b),
    ("jamba-1.5-large-398b", jamba_1_5_large_398b),
])
def test_each_family_counts_its_layers_by_hand(name, hand):
    cfg = as_dict(name)
    got = (flops.prefill(cfg, 1024), flops.decode(cfg, 32, 24576),
           flops.train_step(cfg, 8, 2048))
    assert got == pytest.approx(hand(), rel=1e-12)


def test_the_experts_count_dropless_top_k():
    # doubling the experts moves only the router; doubling top-k doubles
    # the routed experts' work, whatever a capacity factor would drop
    cfg = as_dict("granite-moe-1b-a400m")
    T = 32
    base = flops.decode(cfg, T, 24576)
    more = flops.decode(dict(cfg, n_experts=64), T, 24576)
    assert more - base == pytest.approx(24 * 2 * T * 1024 * 32, rel=1e-12)
    topk = flops.decode(dict(cfg, experts_per_tok=16), T, 24576)
    assert topk - base == pytest.approx(24 * 8 * swiglu(T, 1024, 512),
                                        rel=1e-12)
    assert flops.decode(dict(cfg, capacity_factor=0.5), T, 24576) == base


# -- the layer pattern, tied to the program -------------------------------------

@pytest.mark.parametrize("name", COUNTED)
def test_the_layers_walked_are_the_ports(name):
    from repro_torch.models.lm import Model
    model = Model(REGISTRY[name])
    assert flops.layer_kinds(as_dict(name)) == model.kinds * model.n_groups


@pytest.mark.parametrize("name", COUNTED)
def test_every_counted_config_has_finite_positive_flops(name):
    cfg = as_dict(name)
    for f in (flops.prefill(cfg, 1000), flops.decode(cfg, 7, 5000.0),
              flops.train_step(cfg, 2, 300)):
        assert math.isfinite(f) and f > 0


@pytest.mark.parametrize("name", NOT_COUNTED)
def test_other_families_raise_naming_their_family(name):
    cfg = as_dict(name)
    for count in (lambda: flops.prefill(cfg, 64),
                  lambda: flops.decode(cfg, 2, 128),
                  lambda: flops.train_step(cfg, 1, 64)):
        with pytest.raises(ValueError, match=cfg["family"]):
            count()
