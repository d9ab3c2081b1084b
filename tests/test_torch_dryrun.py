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
  CLI writes one JSON per cell.
* Sharded: reduced olmo-1b's cells on the 16×16 mesh (a fake process
  group) have the reference's per-device argument bytes; one dense
  layer's collectives are the closed form of its FSDP all-gathers and
  its tensor-parallel all-reduce; ``multi_pod`` runs the 2×16×16 mesh.
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
from repro_torch.distributed.sharding import (distribute_tree,  # noqa: E402
                                              use_mesh)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.hlo_analysis import (H100_NVLINK_BW,  # noqa: E402
                                             CollectiveMeter,
                                             collective_bytes)
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.spec import abstract_params, axes_tree  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

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
# per-device argument bytes of reduced olmo-1b's cells on the 16x16 mesh:
# XLA's memory analysis of a program taking the cell's arguments placed as
# R.run_cell places them
import jax.numpy as jnp
from repro.configs import SHAPES, TrainConfig
from repro.distributed.sharding import tree_shardings
from repro.launch.mesh import make_production_mesh
from repro.models.lm import build_model
from repro.models.spec import abstract_params, axes_tree
from repro.train.train_step import make_train_step
cfg = get_config("olmo-1b").reduced()
pmesh = make_production_mesh()
args_bytes = {}
for name in ("prefill_32k", "train_4k", "decode_32k"):
    shape = SHAPES[name]
    model = build_model(cfg)
    specs = model.specs()
    ap = abstract_params(specs, cfg.dtype)
    psh = tree_shardings(axes_tree(specs), ap, pmesh, params=True)
    ins, insh = R.input_specs(cfg, shape, pmesh)
    if shape.kind == "train":
        _, opt = make_train_step(model, TrainConfig(
            remat="full", opt_state_dtype="int8", microbatches=8))
        ao = opt.abstract_init(ap)
        args = (ap, ao, ins)
        shs = (psh, R.opt_state_shardings(ao, psh, pmesh), insh)
    elif shape.kind == "prefill":
        args, shs = (ap, ins), (psh, insh)
    else:
        cache = jax.eval_shape(lambda: model.init_cache(
            shape.global_batch, shape.seq_len, jnp.dtype(cfg.dtype)))
        csh = tree_shardings(model.cache_axes(), cache, pmesh)
        args = (ap, cache, ins["tokens"], ins["pos"])
        shs = (psh, csh, insh["tokens"], insh["pos"])
    f = jax.jit(lambda *a: 0, in_shardings=shs, keep_unused=True)
    args_bytes[name] = int(f.lower(*args).compile().memory_analysis()
                           .argument_size_in_bytes)
out["args_bytes_16x16"] = args_bytes
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
    """The CLI writes one JSON per cell; ``multi_pod`` is no longer
    refused: it runs the cell as rank 0 of the 2×16×16 mesh."""
    D.main(["--arch", "mamba2-370m", "--shape", "long_500k",
            "--out", str(tmp_path)])
    res = json.loads((tmp_path / "mamba2-370m__long_500k__1.json")
                     .read_text())
    assert res["ok"] and res["memory"]["fits"]
    assert res["params_total"] == D.n_params(get_config("mamba2-370m"))
    pod = D.run_cell("mamba2-370m", "decode_32k", multi_pod=True,
                     cfg_overrides=_reduced("mamba2-370m"))
    assert pod["ok"] and pod["mesh"] == "2x16x16" and pod["chips"] == 512
    with pytest.raises(SystemExit):
        D.main(["--all", "--mesh", "4x4", "--out", str(tmp_path)])
    D.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--multi-pod",
            "--out", str(tmp_path)])
    res = json.loads((tmp_path / "mamba2-370m__long_500k__2x16x16.json")
                     .read_text())
    assert res["ok"] and res["chips"] == 512
    assert len(D.all_cells()) == sum(len(shapes_for(get_config(a)))
                                     for a in ASSIGNED)


def _token_bytes(cfg, shape, chips_batch: int) -> int:
    """Per-device bytes of a cell's integer inputs in int32 (the
    reference's token dtype), over ``chips_batch`` batch shards."""
    return sum(t.numel() * 4 for t in D.input_specs(cfg, shape).values()
               if not t.is_floating_point()) // chips_batch


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k", "decode_32k"])
def test_sharded_args_bytes_equal_reference(shape):
    """Reduced olmo-1b on the 16×16 mesh (a fake group of 256 ranks):
    every cell runs, and its per-device ``args_bytes`` equal XLA's
    argument bytes for the same arguments placed as the reference's
    ``run_cell`` places them, once the port's int64 tokens (the
    reference's are int32) are counted at 4 bytes more each. The
    reference's ``run_cell`` itself cannot compile a sharded step with
    this jax (its mesh's explicit axes refuse the model's
    ``with_sharding_constraint``), so the reference side compiles a
    program that only takes the arguments, in one subprocess."""
    want = _reference()["args_bytes_16x16"][shape]
    ov = _reduced("olmo-1b")
    res = D.run_cell("olmo-1b", shape, cfg_overrides=ov, mesh="16x16")
    cfg = dataclasses.replace(get_config("olmo-1b"), **ov)
    assert res["ok"] and res["chips"] == 256 and res["mesh"] == "16x16"
    assert res["memory"]["args_bytes"] == \
        want + _token_bytes(cfg, SHAPES[shape], 16)
    assert res["memory"]["temp_bytes"] > 0
    assert res["collective_total"] > 0
    assert res["collective_bytes"] == res["collective_bytes_uncorrected"]
    assert res["roofline"]["collective_s"] == pytest.approx(
        res["collective_total"] / H100_NVLINK_BW)


def test_dense_layer_collectives_closed_form():
    """One dense SwiGLU layer's forward on the 16×16 mesh: the FSDP
    all-gathers of its two weights over 'data' and the all-reduce over
    'model' of its output's partial sums, and nothing else."""
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              dtype="float32")
    Dm, F, B, S = cfg.d_model, cfg.d_ff, 32, 8
    with D.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with use_mesh(mesh):
            p = distribute_tree(
                abstract_params(L.mlp_specs(cfg), "float32"),
                axes_tree(L.mlp_specs(cfg)), mesh, params=True)
            x = distribute_tree(torch.empty(B, S, Dm, device="meta"),
                                ("batch", None, None), mesh)
            meter = CollectiveMeter()
            with meter:
                y = L.apply_mlp(p, cfg, x)
    assert y.placements == (Shard(0), Replicate())
    f32 = 4
    wi_gathered = Dm * 2 * (F // 16) * f32     # (D, 2, F/16) over data
    wo_gathered = (F // 16) * Dm * f32         # (F/16, D) over data
    y_local = (B // 16) * S * Dm * f32         # summed over model
    assert sorted(meter.records) == sorted([
        ("all-gather", wi_gathered, 16), ("all-gather", wo_gathered, 16),
        ("all-reduce", y_local, 16)])
    raw, corr, wire = collective_bytes(meter.records)
    assert raw == corr == {"all-gather": (wi_gathered + wo_gathered) // 16,
                           "all-reduce": y_local}
    assert wire == {"all-gather": int(wi_gathered * 15 / 16)
                    + int(wo_gathered * 15 / 16),
                    "all-reduce": int(2 * y_local * 15 / 16)}


def test_split_k_decode_reduces_the_logits_closed_form():
    """One ``attention_decode`` of reduced olmo-1b on the 16×16 mesh, its
    cache split over the sequence ('cache_seq' over 'model'): the logits
    stay split, so no all-gather of their local (B/16, KV, rep, 1, S/16)
    float32 block (nor of that block gathered whole) is issued, and
    exactly two all-reduces of their (B/16, KV, rep, 1, 1) maximum and
    sum."""
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              dtype="float32")
    B, S, f32 = 32, 64, 4
    KV, rep = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    specs = L.attn_specs(cfg)
    with D.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with use_mesh(mesh):
            p = distribute_tree(abstract_params(specs, "float32"),
                                axes_tree(specs), mesh, params=True)
            cache = [distribute_tree(
                torch.empty(B, S, KV, cfg.hd, device="meta"),
                ("batch", "cache_seq", "kv_heads", None), mesh)
                for _ in range(2)]
            x = distribute_tree(torch.empty(B, 1, cfg.d_model, device="meta"),
                                ("batch", None, None), mesh)
            pos = torch.full((B,), 5, dtype=torch.long, device="meta")
            meter = CollectiveMeter()
            with meter:
                y = L.attention_decode(p, cfg, x, *cache, pos)
    assert cache[0].placements == (Shard(0), Shard(1))
    assert y.placements == (Shard(0), Replicate())
    logits_local = (B // 16) * KV * rep * (S // 16) * f32
    stat = (B // 16) * KV * rep * 1 * 1 * f32
    assert not [r for r in meter.records if r[0] == "all-gather"
                and r[1] in (logits_local, 16 * logits_local)], meter.records
    assert [r for r in meter.records if r[:2] == ("all-reduce", stat)] == \
        [("all-reduce", stat, 16)] * 2
