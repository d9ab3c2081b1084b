"""The port's one-card dry run (``launch/dryrun.py``) against the reference
and against its own accounting.

* ``n_params`` (total and active) and every cell's input shapes equal the
  reference's for all ten assigned archs. The reference's module sets
  ``XLA_FLAGS`` to 512 host devices when imported, which must never leak
  into a test process (``tests/conftest.py``), so its numbers come from
  one subprocess that imports it and prints JSON; it builds spec trees
  and shapes only and compiles nothing. Tokens are int32 there and int64
  in the port (its data pipeline's dtype); float inputs agree in dtype.
* The counted flops of a train step (remat "none", int8 moments, 8
  microbatches, the full ``train_4k`` shape on reduced widths) equal the
  analytic model's, exactly, once three known differences are added:
  the written-out causal attention multiplies the full S×S where the
  analytic model counts half of it; the depthwise causal conv is
  elementwise work, which the counter does not count; and the MoE's
  GShard dispatch and combine einsums are dense one-hot products, which
  the analytic model prices as a gather. The last is measured by counting
  those four einsums, forward and backward, on ``meta`` at the layer's
  group shapes. Each term is times three (forward and a backward of
  twice its cost), the MoE einsums as their operands need gradients.
* ``fits`` flips when the capacity passes the peak; the meter reads the
  same flops and peak on ``meta`` as on the CPU's real tensors, and the
  same operator bytes but for the MoE's ``one_hot`` (within 0.5%); the
  CLI writes one JSON per cell; ``multi_pod`` raises.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import (ASSIGNED, SHAPES, ShapeConfig,  # noqa: E402
                                 TrainConfig, get_config, shapes_for)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

_REF_SCRIPT = """
import json
import numpy as np
import jax
from repro.configs import get_config, shapes_for
from repro.configs.registry import ASSIGNED
from repro.launch import dryrun as R
mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
out = {}
for arch in ASSIGNED:
    cfg = get_config(arch)
    inputs = {}
    for s in shapes_for(cfg):
        specs, _ = R.input_specs(cfg, s, mesh)
        inputs[s.name] = {k: [list(v.shape), str(v.dtype)]
                          for k, v in specs.items()}
    out[arch] = {"total": R.n_params(cfg),
                 "active": R.n_params(cfg, active_only=True),
                 "inputs": inputs}
print(json.dumps(out))
"""
_REF = {}


def _reference():
    if not _REF:
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.abspath(src)]
                       + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        env.pop("XLA_FLAGS", None)
        run = subprocess.run([sys.executable, "-c", _REF_SCRIPT], env=env,
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-2000:]
        _REF.update(json.loads(run.stdout.strip().splitlines()[-1]))
    return _REF


def test_reference_import_does_not_leak_its_flag():
    _reference()
    assert "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", "")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_n_params_and_input_shapes_match_reference(arch):
    want = _reference()[arch]
    cfg = get_config(arch)
    assert D.n_params(cfg) == want["total"]
    assert D.n_params(cfg, active_only=True) == want["active"]
    assert sorted(want["inputs"]) == sorted(s.name for s in shapes_for(cfg))
    for s in shapes_for(cfg):
        got = D.input_specs(cfg, s)
        assert sorted(got) == sorted(want["inputs"][s.name]), s.name
        for k, t in got.items():
            shape, dtype = want["inputs"][s.name][k]
            assert list(t.shape) == shape and t.device.type == "meta"
            if dtype == "int32":
                assert t.dtype == torch.int64
            else:
                assert str(t.dtype) == "torch." + dtype, (s.name, k)


def _reduced(arch):
    cfg = get_config(arch).reduced()
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _moe_einsums_flops(G, Tg, k, E, C, Dm):
    """Counted flops of the MoE's dispatch, combine and the two one-hot
    products, forward and backward, as the layer runs them (the 0/1
    dispatch operands need no gradient; gates, tokens and expert outputs
    do)."""
    def m(*shape, grad=False):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta",
                           requires_grad=grad)
    disp, pos, gates = m(G, Tg, k, E), m(G, Tg, k, C), m(G, Tg, k, grad=True)
    xt, ye = m(G, Tg, Dm, grad=True), m(G, E, C, Dm, grad=True)
    count = FlopCounterMode(display=False)
    with count:
        dispatch = torch.einsum("gtke,gtkc->gtec", disp, pos)
        combine = torch.einsum("gtke,gtkc,gtk->gtec", disp, pos, gates)
        xe = torch.einsum("gtec,gtd->gecd", dispatch, xt)
        y = torch.einsum("gtec,gecd->gtd", combine, ye)
        torch.autograd.grad(xe.sum() + y.sum(), [gates, xt, ye])
    return count.get_total_flops()


@pytest.mark.parametrize("arch", ["olmo-1b", "mamba2-370m",
                                  "granite-moe-1b-a400m"])
def test_counted_flops_equal_analytic_plus_known_terms(arch):
    tc = TrainConfig(remat="none", opt_state_dtype="int8", microbatches=8)
    res = D.run_cell(arch, "train_4k", tc=tc, cfg_overrides=_reduced(arch))
    cfg = dataclasses.replace(get_config(arch), **_reduced(arch))
    shape = SHAPES["train_4k"]
    T, S = shape.global_batch * shape.seq_len, shape.seq_len
    extra = 0.0
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            extra += 3 * 2 * T * S * cfg.n_heads * cfg.hd
        else:
            extra -= 3 * 2 * T * (cfg.di + 2 * cfg.ssm_state) * cfg.conv_dim
        if cfg.is_moe_layer(i):
            E, k = cfg.n_experts, cfg.experts_per_tok
            Tm = T // tc.microbatches
            Tg = min(L.MOE_GROUP, Tm)
            C = max(int(k * Tg * cfg.capacity_factor / E), 1)
            extra += tc.microbatches * _moe_einsums_flops(
                Tm // Tg, Tg, k, E, C, cfg.d_model)
            extra -= 3 * 4 * T * k * cfg.capacity_factor * cfg.d_model
    want = res["flops_per_device"] + extra
    assert res["raw_cost_analysis"]["flops"] == pytest.approx(want,
                                                              rel=1e-12)
    assert res["chips"] == 1 and res["mesh"] == "1" and res["ok"]
    assert res["collective_total"] == 0.0
    assert res["roofline"]["collective_s"] == 0.0
    assert res["dominant"] in ("compute_s", "memory_s")
    assert res["raw_cost_analysis"]["bytes"] > res["memory"]["args_bytes"]


def test_fits_flips_at_the_capacity():
    ov = _reduced("mamba2-370m")
    peak = D.run_cell("mamba2-370m", "decode_32k",
                      cfg_overrides=ov)["memory"]["peak_bytes"]
    assert peak > 0
    at = D.run_cell("mamba2-370m", "decode_32k", cfg_overrides=ov,
                    capacity_bytes=peak)["memory"]
    below = D.run_cell("mamba2-370m", "decode_32k", cfg_overrides=ov,
                       capacity_bytes=peak - 1)["memory"]
    assert at["fits"] and not below["fits"]
    assert at["peak_bytes"] == at["args_bytes"] + at["temp_bytes"]


@pytest.mark.parametrize("arch,kind", [("olmo-1b", "prefill"),
                                       ("mamba2-370m", "decode"),
                                       ("granite-moe-1b-a400m", "train")])
def test_meter_reads_meta_as_real_tensors(arch, kind):
    """The same step on ``meta`` and on the CPU's real tensors: equal
    counted flops, peak of created storages, output bytes and operator
    bytes. The MoE's operator bytes differ by 0.2%: on the CPU
    ``F.one_hot`` checks its input's range (``aminmax`` and a host read)
    and scatters, where ``meta`` runs its decomposition (a compare against
    an ``arange``); they are held within 0.5%."""
    cfg = dataclasses.replace(get_config(arch),
                              **{**_reduced(arch), "dtype": "float32"})
    shape = ShapeConfig("small", 32, 4, kind)
    tc = TrainConfig(remat="full", opt_state_dtype="int8", microbatches=2)
    meta = D.measure_step(*D.build_step(cfg, shape, tc, "meta"))
    real = D.measure_step(*D.build_step(cfg, shape, tc, "cpu"))
    for k in ("flops", "temp_bytes", "output_bytes"):
        assert meta[k] == real[k], k
    if cfg.n_experts:
        assert meta["bytes"] == pytest.approx(real["bytes"], rel=5e-3)
    else:
        assert meta["bytes"] == real["bytes"]
    assert meta["flops"] > 0 and meta["temp_bytes"] > 0


def test_cli_writes_a_cell_and_refuses_multi_pod(tmp_path):
    D.main(["--arch", "mamba2-370m", "--shape", "long_500k",
            "--out", str(tmp_path)])
    res = json.loads((tmp_path / "mamba2-370m__long_500k__1.json")
                     .read_text())
    assert res["ok"] and res["memory"]["fits"]
    assert res["params_total"] == D.n_params(get_config("mamba2-370m"))
    with pytest.raises(NotImplementedError):
        D.run_cell("mamba2-370m", "decode_32k", multi_pod=True)
    with pytest.raises(SystemExit):
        D.main(["--all", "--multi-pod", "--out", str(tmp_path)])
    assert len(D.all_cells()) == sum(len(shapes_for(get_config(a)))
                                     for a in ASSIGNED)
