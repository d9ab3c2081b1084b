"""The port's float64 precision reference and its layer-by-layer drift
report (``repro_torch.launch.precision``), on the CPU at reduced size.

A model built with ``dtype="float64"`` computes every layer in float64
(``models.spec.wide``), so its decode steps equal its forward to float64
rounding, and a float32 run sits within float32 rounding of it; the report
gives a row per layer group whose drift stays at that rounding on the CPU.
The float32 and bfloat16 models keep computing in float32, as the
reference does. Imports nothing of the reference package.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.launch import precision  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import tree_leaves, wide  # noqa: E402


@pytest.mark.parametrize("dtype,want", [
    ("bfloat16", torch.float32), ("float32", torch.float32),
    ("float16", torch.float32), ("float64", torch.float64),
    (torch.float64, torch.float64)])
def test_wide_is_float32_but_for_float64(dtype, want):
    assert wide(dtype) == want


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m",
                                  "granite-moe-1b-a400m"])
def test_float64_reference_is_float64_throughout(arch):
    cfg, model, params = precision.seeded_f32(arch, smoke=True)
    toks = precision.prompt(cfg, 8)
    with torch.no_grad():
        f32 = model.forward(params, {"tokens": toks})[0]
        f64, dec = precision.f64_reference(cfg, params, toks, 8)
        cache = build_model(dataclasses.replace(cfg, dtype="float64")) \
            .init_cache(1, 8, torch.float64, device="cpu")
    assert f64.dtype == torch.float64 and f32.dtype == torch.float32
    assert all(t.dtype == torch.float64 for t in tree_leaves(cache))
    scale = float(f64.abs().max())
    if not cfg.n_experts:
        # a MoE forward drops tokens past an expert's capacity, a one-token
        # decode step none, so only the others' decode equals the forward
        assert dec <= 1e-9 * scale, dec
    err = float((f32.double() - f64).abs().max())
    assert 0 < err <= 1e-5 * scale, err


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m"])
def test_layer_drift_report_on_the_cpu(arch):
    rep = precision.layer_drift(arch, device="cpu", smoke=True, n_prompt=8)
    cfg = precision.seeded_f32(arch, smoke=True)[0]
    assert rep["groups"] == len(rep["rows"]) == cfg.n_layers
    for r in rep["rows"]:
        # one device: the "dev" run is the CPU run, bit for bit
        assert r["dev"] == r["cpu"]
        assert 0 < r["cpu"]["local"] < 1e-5 and r["cpu"]["acc"] < 1e-4
    assert rep["logits"]["dev"] == rep["logits"]["cpu"] < 1e-5
    assert rep["ops"]["calls"] > 10 and rep["ops"]["first"] is None


def test_layer_drift_refuses_other_families():
    with pytest.raises(ValueError, match="decoder-only"):
        precision.layer_drift("whisper-tiny", device="cpu", smoke=True)
