"""The port's training substrate against the reference: data pipeline,
checkpointing (in both directions), fault tolerance, gradient compression
and the training launcher (the port of ``tests/test_substrate.py``).

* ``SyntheticLM`` and ``FileTokens`` batches equal the reference's bit for
  bit, every family (encoder frames and patch embeddings included).
* A checkpoint written by the reference restores in the port and one
  written by the port restores in the reference: parameters plus
  optimizer state, float32 and int8 moments, every leaf equal, and the
  next step's loss on the restored state equal to the other side's
  within 1e-4 of its scale (the train step's tolerance,
  ``tests/test_torch_train.py``).
* ``run_resilient_loop`` on the port's train step recovers from an
  injected failure and ends bit-equal to an uninterrupted run on the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.checkpoint.checkpointer import \
    Checkpointer as RefCheckpointer  # noqa: E402
from repro.configs import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data.pipeline import FileTokens as RefFileTokens  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.spec import init_params as ref_init_params  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import ASSIGNED, TrainConfig, get_config  # noqa: E402
from repro_torch.data import (FileTokens, SyntheticLM,  # noqa: E402
                              make_global_batch)
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    ElasticScaler, HeartbeatMonitor, StragglerDetector, run_resilient_loop)
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import (init_params,  # noqa: E402
                                     params_from_numpy, tree_leaves)
from repro_torch.optim import grad_compress  # noqa: E402
from repro_torch.optim.optimizer import QTensor  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILY_ARCHS = sorted(ASSIGNED + ["matpim-bnn"])
LOSS_TOL = 1e-4


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_synthetic_batches_equal_reference(arch):
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    src = SyntheticLM(cfg, batch=3, seq=16, seed=7)
    ref = RefSyntheticLM(ref_cfg, batch=3, seq=16, seed=7)
    for step in (0, 5, 123):
        got, want = src.at_step(step), ref.at_step(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    a = next(iter(src))
    np.testing.assert_array_equal(a["tokens"], src.at_step(0)["tokens"])
    assert not np.array_equal(src.at_step(1)["tokens"], a["tokens"])


def test_file_tokens_equal_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 900, 5000).astype(
        np.int32).tofile(path)
    cfg, ref_cfg = get_config("olmo-1b").reduced(), \
        ref_get_config("olmo-1b").reduced()
    src = FileTokens(str(path), cfg, batch=4, seq=32, seed=2)
    ref = RefFileTokens(str(path), ref_cfg, batch=4, seq=32, seed=2)
    for step in (0, 1, 77):
        got, want = src.at_step(step), ref.at_step(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert got["tokens"].max() < cfg.vocab      # clipped to the vocab


def test_make_global_batch_dtypes():
    cfg = get_config("qwen2-vl-2b").reduced()
    b = SyntheticLM(cfg, batch=2, seq=300).at_step(0)
    out = make_global_batch(b, make_local_mesh("cpu"), "bfloat16")
    assert out["tokens"].dtype == out["targets"].dtype == torch.int64
    assert out["patch_embeds"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["tokens"].numpy(), b["tokens"])
    with pytest.raises(RuntimeError):
        make_local_mesh()              # the card by default; none here


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16),
                  torch.zeros((), dtype=torch.int32)],
            "q": QTensor(torch.tensor([1, -2], dtype=torch.int8),
                         torch.tensor([0.5]))}
    ck.save(10, tree, extra={"seed": 3}, block=True)
    ck.save(20, tree, block=True)
    ck.save(30, tree, block=True)
    assert ck.steps() == [20, 30]  # keep=2 garbage-collects
    leaf = np.load(tmp_path / "step_20" / "leaf_1.npy")
    assert leaf.dtype == np.float32     # bf16 stored as float32
    restored, manifest = ck.restore(tree, 20)
    assert manifest["step"] == 20 and manifest["n_leaves"] == 5
    assert restored["b"][0].dtype == torch.bfloat16
    assert isinstance(restored["q"], QTensor)
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ck.latest_step() == 30
    with pytest.raises(ValueError):
        ck.restore({"a": tree["a"]}, 20)


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A write that dies part-way leaves ``.tmp_step_N`` and no step;
    ``wait`` raises what the writer raised."""
    ck = Checkpointer(str(tmp_path))
    tree = {"a": torch.ones(3), "b": torch.zeros(2)}
    ck.save(1, tree, block=True)
    real_save = np.save

    def dying_save(path, arr):
        if str(path).endswith("leaf_1.npy"):
            raise OSError("disk full")
        real_save(path, arr)

    monkeypatch.setattr(np, "save", dying_save)
    ck.save(2, tree)
    with pytest.raises(OSError):
        ck.wait()
    assert ck.steps() == [1]
    assert sorted(os.listdir(tmp_path)) == [".tmp_step_2", "step_1"]
    ck.wait()                          # the error is raised once


def test_save_snapshots_before_returning(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = torch.ones(4)
    ck.save(1, {"t": t})
    t.add_(1)                           # after save returns
    ck.wait()
    assert torch.equal(ck.restore({"t": t}, 1)[0]["t"], torch.ones(4))


def _trained(opt_dtype):
    """Both sides' reduced float32 olmo-1b, one step trained from the
    reference's parameters on the same batch."""
    ref_cfg = ref_get_config("olmo-1b").reduced(dtype="float32")
    cfg = get_config("olmo-1b").reduced(dtype="float32")
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_params = ref_init_params(ref_model.specs(), jax.random.PRNGKey(0),
                                 "float32")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    kw = dict(lr=1e-3, remat="none", opt_state_dtype=opt_dtype)
    ref_step, ref_opt = ref_make_train_step(ref_model, RefTrainConfig(**kw))
    step, opt = make_train_step(model, TrainConfig(**kw))
    src = SyntheticLM(cfg, batch=2, seq=16, seed=1)
    ref_step = jax.jit(ref_step)
    b0 = src.at_step(0)
    ref_state = ref_step(ref_params, ref_opt.init(ref_params),
                         {k: jnp.asarray(v) for k, v in b0.items()})[:2]
    state = step(params, opt.init(params), make_global_batch(
        b0, make_local_mesh("cpu"), "float32"))[:2]
    return ref_step, ref_state, step, state, src.at_step(1)


def _next_losses(ref_step, ref_state, step, state, b1):
    want = ref_step(*ref_state, {k: jnp.asarray(v) for k, v in b1.items()})
    got = step(*state, make_global_batch(b1, make_local_mesh("cpu"),
                                         "float32"))
    return float(got[2]["loss"]), float(want[2]["loss"])


@pytest.mark.parametrize("opt_dtype", ["float32", "int8"])
def test_checkpoints_cross_between_reference_and_port(tmp_path, opt_dtype):
    ref_step, ref_state, step, state, b1 = _trained(opt_dtype)
    # reference -> port
    RefCheckpointer(str(tmp_path / "ref")).save(1, ref_state, block=True)
    got, manifest = Checkpointer(str(tmp_path / "ref")).restore(state, 1)
    assert manifest["n_leaves"] == len(jax.tree.leaves(ref_state))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref_state)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    loss, want = _next_losses(ref_step, ref_state, step, got, b1)
    assert abs(loss - want) <= LOSS_TOL * max(1.0, abs(want))
    # port -> reference
    Checkpointer(str(tmp_path / "port")).save(1, state, block=True)
    back, _ = RefCheckpointer(str(tmp_path / "port")).restore(ref_state, 1)
    for a, b in zip(jax.tree.leaves(back), tree_leaves(state)):
        assert a.dtype == jnp.dtype(str(b.dtype).split(".")[-1])
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    loss, want = _next_losses(ref_step, back, step, state, b1)
    assert abs(loss - want) <= LOSS_TOL * max(1.0, abs(want))


def test_heartbeat_and_straggler():
    hb = HeartbeatMonitor(["h0", "h1"], timeout_s=10)
    hb.beat("h0", t=1000.0)
    hb.beat("h1", t=1000.0)
    assert hb.dead_hosts(now=1005.0) == []
    assert hb.dead_hosts(now=1011.0) == ["h0", "h1"]
    sd = StragglerDetector(window=16, threshold=2.0)
    for _ in range(10):
        assert not sd.record(1.0)
    assert sd.record(5.0)


def test_elastic_scaler():
    es = ElasticScaler(data_axis=16, model_axis=16)
    assert es.next_mesh_shape(256) == {"data": 16, "model": 16}
    assert es.next_mesh_shape(255) == {"data": 8, "model": 16}
    assert es.next_mesh_shape(130) == {"data": 8, "model": 16}
    assert es.next_mesh_shape(100) == {"data": 4, "model": 16}
    assert es.next_mesh_shape(10) is None


def test_resilient_loop_recovers(tmp_path):
    """Inject a crash mid-training; the loop restores and ends at the
    same state as an uninterrupted run, bit for bit (deterministic
    pipeline, CPU arithmetic)."""
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         cfg.dtype)
    step_fn, opt = make_train_step(model, TrainConfig(lr=1e-3))
    src = SyntheticLM(cfg, batch=2, seq=16, seed=0)
    mesh = make_local_mesh("cpu")

    def batch_at(i):
        return make_global_batch(src.at_step(i), mesh, cfg.dtype)

    def run(ckdir, fail_at):
        ck = Checkpointer(ckdir)
        state = (params, opt.init(params))
        ck.save(0, state, block=True)
        return run_resilient_loop(step_fn, state, batch_at, ck, n_steps=12,
                                  ckpt_every=4, fail_at=fail_at)

    clean = run(str(tmp_path / "clean"), None)
    faulty = run(str(tmp_path / "faulty"), {7: RuntimeError("node died")})
    assert sorted(os.listdir(tmp_path / "faulty")) == \
        ["step_12", "step_4", "step_8"]
    for a, b in zip(tree_leaves(clean), tree_leaves(faulty)):
        assert torch.equal(a, b)


class FakeCkpt:
    def __init__(self):
        self.saved = {}
        self.restores = 0

    def save(self, step, state, block=False):
        self.saved[step] = state

    def wait(self):
        pass

    def latest_step(self):
        return max(self.saved) if self.saved else None

    def restore(self, state, step):
        self.restores += 1
        return self.saved[step], {"step": step}


def _fake_run(fail_at, ck):
    def step_fn(params, opt_state, batch):
        return params + batch, opt_state, {}
    if ck is not None:
        ck.save(0, (0, 0))
    return run_resilient_loop(step_fn, (0, 0), lambda i: i, ck,
                              n_steps=6, ckpt_every=2, fail_at=fail_at)


def test_resilient_loop_does_not_mutate_callers_fail_at():
    """Injection bookkeeping pops fired entries; the loop pops from its
    own copy, so a reused injection config re-injects on the next run."""
    fail_at = {3: RuntimeError("injected")}
    clean = _fake_run(None, FakeCkpt())
    ck1 = FakeCkpt()
    assert _fake_run(fail_at, ck1) == clean and ck1.restores == 1
    assert fail_at == {3: fail_at[3]}, \
        "run_resilient_loop consumed the caller's fail_at dict"
    ck2 = FakeCkpt()
    assert _fake_run(fail_at, ck2) == clean and ck2.restores == 1


def test_resilient_loop_without_checkpointer():
    assert _fake_run(None, None) == (15, 0)
    with pytest.raises(RuntimeError, match="injected"):
        _fake_run({3: RuntimeError("injected")}, None)


def test_grad_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(64)
                         .astype(np.float32))
    grads = {"w": g}
    err = grad_compress.init_error(grads)
    total = torch.zeros(64)
    # accumulated compressed estimates converge to the true gradient
    for _ in range(50):
        comp, err = grad_compress.compress_decompress(grads, err)
        total = total + comp["w"]
    corr = np.corrcoef(np.stack([(total / 50).numpy(), g.numpy()]))[0, 1]
    assert corr > 0.95
    assert grad_compress.compression_stats(grads)["ratio"] > 20


def test_train_launcher_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--smoke", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
        env=env, timeout=300, check=True).stdout.splitlines()
    line = r"step +{}  loss \d+\.\d{{4}}  gnorm \d+\.\d{{3}}  \d+\.\d\ds/step"
    assert re.fullmatch(line.format(0), out[0]), out
    assert re.fullmatch(line.format(2), out[1]), out
    assert out[2:] == ["done."], out
    assert os.listdir(tmp_path) == ["step_3"]


def test_train_profile_helpers():
    from repro_torch.launch.train_profile import busy_ms, peak_sites
    assert busy_ms([(30, 40), (0, 10), (5, 20)]) == 0.03
    assert busy_ms([]) == 0.0
    frame = {"filename": "/x/src/repro_torch/optim/optimizer.py",
             "line": 7, "name": "one"}
    events = [{"action": "alloc", "addr": 1, "size": 10, "frames": [frame]},
              {"action": "alloc", "addr": 2, "size": 5},
              {"action": "free_requested", "addr": 1, "size": 10},
              {"action": "free_completed", "addr": 1, "size": 10},
              {"action": "alloc", "addr": 3, "size": 2}]
    rep = peak_sites(events)
    assert rep["peak_bytes"] == 15
    assert rep["sites"] == [("optimizer.py:7:one", 10), ("?", 5)]


def test_train_profile_needs_the_card():
    from repro_torch.launch.train_profile import profile_step
    with pytest.raises(RuntimeError):
        profile_step(batch=1, seq=8)
    with pytest.raises(ValueError):
        profile_step(batch=1, seq=8, device="cpu")
