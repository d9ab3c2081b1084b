"""Sharded checkpoints on real gloo CPU ranks, in the reference's layout.

The test process trains reduced olmo-1b in float32 on the reference's own
parameters (``init_params(PRNGKey(0))``), with float32 and with int8
moments, on plain tensors for four steps (a checkpoint every two) and
writes its step-2 state once more through the reference's
``Checkpointer``. Then four processes form one gloo group (a free local
port, one torch thread each, a hard time limit) on a 2×2
``("data", "model")`` mesh, and after them two form another on the mesh
``ElasticScaler(data_axis=2, model_axis=2).next_mesh_shape(2)`` gives
(data 1, model 2): the job rescaled after losing two ranks. The test
process compares what they return:

1. the files of a four-rank save are every leaf's ``full_tensor()``, as
   many and in the order of the plain run's, and the reference's
   ``Checkpointer.restore`` reads them with equal values;
2. ``run_resilient_loop`` with a failure injected at step 3 on every rank
   restores step 2 and ends bit-equal to the clean run on the same mesh;
3. the two ranks restore the four-rank step-2 checkpoint (with
   ``shardings=`` onto plain ``like`` leaves, and without, onto ``like``'s
   placements): each local shard is its slice of the file's leaf, bit for
   bit; two more steps stay within 5e-4 of scale (``TRAIN_TOL`` of
   ``tests/test_torch_dist.py``) of the four-rank run and of the plain
   run;
4. the plain port's and the reference's step-2 checkpoints restore onto
   the four ranks shard for shard, and the four-rank checkpoint onto
   plain tensors, in the test process and on every rank of the two;
5. ``launch.train.train(ckpt_dir=...)`` on the mesh and through
   ``mesh_from_env`` (``WORLD_SIZE`` set) writes its step directories and
   trains to the losses of the same run without checkpoints;
6. a write, a snapshot or a read that fails on rank 0 raises on every
   rank, and no rank is left waiting;
7. a remat "full" step whose backward runs on another thread, as the
   card's does, recomputes each group under the forward's mesh and gives
   the same loss and gradients.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

MOMENTS = ("float32", "int8")
B, S = 4, 16
STEPS, CKPT_EVERY, FAIL_AT = 4, 2, 3
TRAIN_TOL = 5e-4
TIME_LIMIT_S = 300
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


# ---------------------------------------------------------------------------
# What the ranks run (and, on plain tensors, the test process)
# ---------------------------------------------------------------------------


def _cfg():
    from repro_torch.configs import get_config
    return get_config("olmo-1b").reduced(dtype="float32")


def _setup(moments, params_np, mesh=None):
    """The train step, its optimizer and the reference's parameters:
    DTensors placed by ``PARAM_RULES`` on ``mesh``, plain without."""
    from repro_torch.configs import TrainConfig
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.models import build_model
    from repro_torch.models.spec import axes_tree, params_from_numpy
    from repro_torch.train import make_train_step
    model = build_model(_cfg())
    step_fn, opt = make_train_step(model, TrainConfig(
        lr=1e-3, remat="none", opt_state_dtype=moments))
    params = params_from_numpy(params_np, device="cpu")
    if mesh is not None:
        params = distribute_tree(params, axes_tree(model.specs()), mesh,
                                 params=True)
    return model, step_fn, opt, params


def _batches(mesh=None):
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.launch.mesh import make_local_mesh
    src = SyntheticLM(_cfg(), batch=B, seq=S, seed=0)
    mesh = mesh or make_local_mesh("cpu")
    return lambda i: make_global_batch(src.at_step(i), mesh, torch.float32)


def _full(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def _blocks(tree) -> list:
    """Each leaf's local block, where it starts, and its placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import shard_offset
    from repro_torch.models.spec import tree_leaves
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            out.append((x.to_local().numpy(),
                        tuple(shard_offset(x, d) for d in range(x.ndim)),
                        tuple(x.placements)))
        else:
            out.append((x.numpy(), (0,) * x.ndim, None))
    return out


def _recording():
    """A ``Checkpointer`` that keeps every saved leaf whole (on every rank,
    a collective) and the steps it restored."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.spec import tree_leaves

    class Recording(Checkpointer):
        def __init__(self, directory):
            super().__init__(directory)
            self.fulls, self.restored = {}, []

        def save(self, step, tree, extra=None, block=False):
            self.fulls[step] = [_full(x) for x in tree_leaves(tree)]
            super().save(step, tree, extra, block)

        def restore(self, like, step=None, shardings=None):
            self.restored.append(step)
            return super().restore(like, step, shardings)
    return Recording


def _train(step_fn, state, batch_at, ck, fail_at=None):
    """``run_resilient_loop`` for ``STEPS`` steps: the final state and each
    step's loss."""
    from repro_torch.distributed.fault_tolerance import run_resilient_loop
    losses = {}
    state = run_resilient_loop(
        step_fn, state, batch_at, ck, n_steps=STEPS, ckpt_every=CKPT_EVERY,
        fail_at=fail_at,
        on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
    return state, [losses[s] for s in sorted(losses)]


def _four(rank, mesh, wd, params_np) -> dict:
    """On the 2×2 mesh: the clean and the faulty run, and the plain port's
    and the reference's checkpoints restored."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.spec import tree_leaves
    Recording = _recording()
    res = {}
    for mom in MOMENTS:
        _, step_fn, opt, params = _setup(mom, params_np, mesh)
        state = (params, opt.init(params))
        batch_at = _batches(mesh)
        ck = Recording(os.path.join(wd, f"four_{mom}"))
        clean, losses = _train(step_fn, state, batch_at, ck)
        fck = Recording(os.path.join(wd, f"faulty_{mom}"))
        faulty, _ = _train(step_fn, state, batch_at, fck,
                           {FAIL_AT: RuntimeError("injected at step 3")})
        equal = [bool(torch.equal(a.to_local(), b.to_local()))
                 and a.placements == b.placements
                 if isinstance(a, DTensor) else bool(torch.equal(a, b))
                 for a, b in zip(tree_leaves(clean), tree_leaves(faulty))]
        final = [_full(x) for x in tree_leaves(clean[0])]
        out = {"losses": losses, "restored": fck.restored,
               "resume_equal": equal,
               "sharded": sum(isinstance(x, DTensor) and any(
                   p.is_shard() for p in x.placements)
                   for x in tree_leaves(state))}
        for src in ("plain", "ref"):
            got, _ = Checkpointer(os.path.join(wd, f"{src}_{mom}")).restore(
                state, 2)
            out[f"from_{src}"] = _blocks(got)
        if rank == 0:
            out.update(saved=ck.fulls, final=final)
        res[mom] = out
    return res


def _remat_elsewhere(mesh, params_np) -> dict:
    """One remat-"full" gradient with its backward on another thread, as
    the autograd engine runs the backward of the card's tensors (on its
    device thread): which thread ran each MLP and whether it saw the mesh,
    and whether loss and gradients equal the same step's on this thread.
    The simulated engine thread gets the caller's implicit replication
    (per thread in this torch, process-wide in the card's)."""
    import threading

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import TrainConfig
    from repro_torch.distributed.sharding import current_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.spec import tree_leaves
    from repro_torch.train import make_grad_fn
    model, _, _, params = _setup("float32", params_np, mesh)
    grad_fn = make_grad_fn(model, TrainConfig(remat="full"))
    batch = _batches(mesh)(0)
    here = grad_fn(params, batch)
    real_grad, real_mlp, seen = torch.autograd.grad, L.apply_mlp, []

    def spy(*a, **k):
        seen.append((threading.current_thread() is threading.main_thread(),
                     current_mesh() is mesh))
        return real_mlp(*a, **k)

    def elsewhere(*a, **k):
        box = {}

        def run():
            try:
                with implicit_replication():
                    box["out"] = real_grad(*a, **k)
            except Exception as e:  # noqa: BLE001 — re-raised by the caller
                box["err"] = e
        t = threading.Thread(target=run)
        t.start()
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"]
    L.apply_mlp, torch.autograd.grad = spy, elsewhere
    try:
        there = grad_fn(params, batch)
    finally:
        L.apply_mlp, torch.autograd.grad = real_mlp, real_grad

    def local(t):
        return t.to_local() if isinstance(t, DTensor) else t
    return {"seen": seen, "equal": bool(torch.equal(here[0], there[0])) and
            all(torch.equal(local(a), local(b)) for a, b in
                zip(tree_leaves(here[1]), tree_leaves(there[1])))}


def _launch(wd) -> dict:
    """``launch.train.train`` on the 2×2 mesh and on ``mesh_from_env``'s,
    each without and with checkpoints."""
    from repro_torch.launch.mesh import make_mesh, mesh_from_env
    from repro_torch.launch.train import train
    kw = dict(smoke=True, steps=3, batch=4, seq=16, device="cpu",
              ckpt_every=2)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {"mesh": [train("olmo-1b", mesh=mesh, ckpt_dir=d, **kw)["losses"]
                    for d in (None, os.path.join(wd, "train_mesh"))]}
    os.environ["WORLD_SIZE"] = "4"
    out["env_mesh"] = dict(mesh_from_env("cpu").shape)
    out["env"] = [train("olmo-1b", ckpt_dir=d, **kw)["losses"]
                  for d in (None, os.path.join(wd, "train_env"))]
    return out


def _caught(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads each rank's error
        return type(e).__name__, str(e)
    return None


def _failures(rank, mesh, wd) -> dict:
    """A write, a snapshot and a read that fail on rank 0 only, and a tree
    with a leaf too few: what each rank raised."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.distributed.sharding import distribute
    ck = Checkpointer(os.path.join(wd, "fail"))
    tree = {"a": distribute(torch.arange(16.0).reshape(4, 4),
                            (Shard(0), Replicate()), mesh),
            "b": torch.zeros(3)}
    out = {}
    real_save, real_host = np.save, C._host

    def dying_save(path, arr):
        if str(path).endswith("leaf_1.npy"):
            raise OSError("disk full")
        real_save(path, arr)

    def dying_host(x):
        raise MemoryError("host copy")
    if rank == 0:
        np.save = dying_save
    try:
        ck.save(1, tree)
        out["write"] = _caught(ck.wait)
    finally:
        np.save = real_save
    if rank == 0:
        C._host = dying_host
    try:
        out["snapshot"] = _caught(lambda: ck.save(2, tree))
    finally:
        C._host = real_host
    ck.save(3, tree, block=True)
    out["steps"] = ck.steps()
    if rank == 0:
        os.remove(os.path.join(wd, "fail", "step_3", "leaf_1.npy"))
    out["read"] = _caught(lambda: ck.restore(tree, 3))
    out["leaves"] = _caught(lambda: ck.restore({"a": tree["a"]}, 3))
    return out


def _two(mesh, wd, params_np) -> dict:
    """On the rescaled mesh: the four-rank step-2 checkpoint restored
    without ``shardings`` (``like`` on this mesh), with them (``like``
    plain), onto plain tensors, then two more steps."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.sharding import tree_shardings, use_mesh
    from repro_torch.models.spec import axes_tree, tree_leaves, tree_map
    res = {}
    for mom in MOMENTS:
        model, step_fn, opt, params = _setup(mom, params_np, mesh)
        like = (params, opt.init(params))
        _, _, _, plain = _setup(mom, params_np)
        plain_like = (plain, opt.init(plain))
        with use_mesh(mesh):
            p_sh = tree_shardings(axes_tree(model.specs()), params, mesh,
                                  params=True)
        # the moments as the sharded state places them; the plain step
        # count (``None``) as ``like`` holds it
        it = iter(tree_leaves(like[1]))
        sh = (p_sh, tree_map(lambda _: _sharding_of(next(it), mesh),
                             plain_like[1]))
        ck = Checkpointer(os.path.join(wd, f"four_{mom}"))
        got, _ = ck.restore(like, 2)
        got_sh, manifest = ck.restore(plain_like, 2, shardings=sh)
        got_plain, _ = ck.restore(plain_like, 2)
        state, losses = got, []
        batch_at = _batches(mesh)
        with use_mesh(mesh):
            for i in (2, 3):
                *state, m = step_fn(*state, batch_at(i))
                losses.append(float(m["loss"]))
        res[mom] = {
            "step": manifest["step"], "blocks": _blocks(got),
            "blocks_sharded": _blocks(got_sh),
            "like_placements": [tuple(x.placements)
                                if isinstance(x, DTensor) else None
                                for x in tree_leaves(like)],
            "plain": [x.numpy() for x in tree_leaves(got_plain)],
            "losses": losses,
            "final": [_full(x) for x in tree_leaves(state[0])]}
    return res


def _sharding_of(x, mesh):
    """The ``NamedSharding`` whose placements are DTensor ``x``'s; ``None``
    for a plain tensor."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import NamedSharding
    if not isinstance(x, DTensor):
        return None
    spec = [None] * x.ndim
    for name, p in zip(mesh.axis_names, x.placements):
        if p.is_shard():
            spec[p.dim] = name if spec[p.dim] is None else (
                tuple(np.atleast_1d(spec[p.dim])) + (name,))
    return NamedSharding(mesh, tuple(spec))


def _rank_main(rank, world, workdir, port, which):
    """One gloo rank of the four (``which="four"``) or of the two: every
    check of its group, its results pickled."""
    import torch.distributed as dist

    from repro_torch.distributed.fault_tolerance import ElasticScaler
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    with open(os.path.join(workdir, "params.pkl"), "rb") as f:
        params_np = pickle.load(f)
    if which == "four":
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with use_mesh(mesh):
            res = _four(rank, mesh, workdir, params_np)
            res["remat"] = _remat_elsewhere(mesh, params_np)
        res["launch"] = _launch(workdir)
        res["fail"] = _failures(rank, mesh, workdir)
    else:
        shape = ElasticScaler(data_axis=2, model_axis=2).next_mesh_shape(2)
        mesh = make_mesh(tuple(shape.values()), tuple(shape), "cpu")
        res = _two(mesh, workdir, params_np)
        res["mesh"] = dict(mesh.shape)
    with open(os.path.join(workdir, f"{which}{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The test process: the plain runs, the ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _group(world, which, wd):
    """Start ``world`` ranks, wait for them within the limit, return what
    each pickled."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.abspath(SRC)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    env.pop("WORLD_SIZE", None)
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import test_torch_checkpoint_dist as T; "
            "T._rank_main({{}}, {}, {!r}, {}, {!r})").format(
                HERE, world, wd, _free_port(), which)
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIME_LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.decode()[-3000:]
    out = []
    for r in range(world):
        with open(os.path.join(wd, f"{which}{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _jax_tree(tree):
    import jax.numpy as jnp

    from repro_torch.models.spec import tree_map
    return tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The plain runs and their checkpoints (the port's and the
    reference's), then the four ranks and the two."""
    import dataclasses

    import jax
    from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro.models.spec import init_params as ref_init_params
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.spec import tree_leaves
    wd = str(tmp_path_factory.mktemp("ckpt_dist"))
    ref_cfg = dataclasses.replace(ref_get_config("olmo-1b").reduced(),
                                  dtype="float32")
    params_np = jax.tree.map(np.asarray, ref_init_params(
        ref_build_model(ref_cfg).specs(), jax.random.PRNGKey(0), "float32"))
    with open(os.path.join(wd, "params.pkl"), "wb") as f:
        pickle.dump(params_np, f)
    plain = {}
    for mom in MOMENTS:
        _, step_fn, opt, params = _setup(mom, params_np)
        state = (params, opt.init(params))
        ck = Checkpointer(os.path.join(wd, f"plain_{mom}"))
        final, losses = _train(step_fn, state, _batches(), ck)
        like = (params, opt.init(params))
        step2, _ = ck.restore(like, 2)
        RefCheckpointer(os.path.join(wd, f"ref_{mom}")).save(
            2, _jax_tree(step2), block=True)
        plain[mom] = {"like": like, "jax_like": _jax_tree(like),
                      "losses": losses, "step2": tree_leaves(step2),
                      "final": [x.numpy() for x in tree_leaves(final[0])]}
    return {"wd": wd, "plain": plain, "four": _group(4, "four", wd),
            "two": _group(2, "two", wd)}


def _leaf_files(wd, name, step):
    d = os.path.join(wd, name, f"step_{step}")
    n = len(os.listdir(d)) - 1
    assert sorted(os.listdir(d)) == sorted(
        [f"leaf_{i}.npy" for i in range(n)] + ["manifest.json"])
    return [np.load(os.path.join(d, f"leaf_{i}.npy")) for i in range(n)]


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _assert_blocks(blocks, files, what):
    assert len(blocks) == len(files), what
    for i, ((local, off, _), f) in enumerate(zip(blocks, files)):
        sl = tuple(slice(o, o + n) for o, n in zip(off, local.shape))
        assert local.dtype == f.dtype, f"{what} leaf {i}"
        np.testing.assert_array_equal(local, f[sl],
                                      err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("moments", MOMENTS)
def test_sharded_save_writes_every_leaf_whole(runs, moments):
    from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
    wd, r0 = runs["wd"], runs["four"][0][moments]
    plain_files = _leaf_files(wd, f"plain_{moments}", 2)
    for r in runs["four"]:
        assert r[moments]["sharded"] > 0       # the state really is split
    for step in (2, 4):
        files = _leaf_files(wd, f"four_{moments}", step)
        fulls = r0["saved"][step]
        assert [(f.shape, f.dtype) for f in files] == \
            [(p.shape, p.dtype) for p in plain_files]
        for i, (f, full) in enumerate(zip(files, fulls)):
            assert f.dtype == full.dtype
            np.testing.assert_array_equal(f, full, err_msg=f"leaf {i}")
    back, manifest = RefCheckpointer(os.path.join(
        wd, f"four_{moments}")).restore(runs["plain"][moments]["jax_like"], 2)
    assert manifest["step"] == 2
    import jax
    for i, (a, full) in enumerate(zip(jax.tree.leaves(back),
                                      r0["saved"][2])):
        np.testing.assert_array_equal(np.asarray(a), full,
                                      err_msg=f"reference, leaf {i}")


@pytest.mark.parametrize("moments", MOMENTS)
def test_resume_after_injected_failure_is_bit_equal(runs, moments):
    for r in runs["four"]:
        assert r[moments]["restored"] == [2]
        assert all(r[moments]["resume_equal"])
    assert sorted(os.listdir(os.path.join(runs["wd"], f"faulty_{moments}"))) \
        == ["step_2", "step_4"]


@pytest.mark.parametrize("moments", MOMENTS)
def test_two_ranks_restore_the_four_rank_checkpoint(runs, moments):
    files = _leaf_files(runs["wd"], f"four_{moments}", 2)
    for r in runs["two"]:
        assert r["mesh"] == {"data": 1, "model": 2}
        got = r[moments]
        assert got["step"] == 2
        for key in ("blocks", "blocks_sharded"):
            _assert_blocks(got[key], files, key)
            assert [p for _, _, p in got[key]] == got["like_placements"]
        for i, (a, f) in enumerate(zip(got["plain"], files)):
            np.testing.assert_array_equal(a, f, err_msg=f"plain leaf {i}")
    got = runs["two"][0][moments]
    for name, want in (("four ranks", runs["four"][0][moments]),
                       ("plain", runs["plain"][moments])):
        _close(np.float32(got["losses"]), np.float32(want["losses"][2:]),
               TRAIN_TOL, f"losses against {name}")
        assert len(got["final"]) == len(want["final"])
        for i, (a, w) in enumerate(zip(got["final"], want["final"])):
            _close(a, w, TRAIN_TOL, f"param {i} against {name}")


@pytest.mark.parametrize("moments", MOMENTS)
def test_plain_and_reference_checkpoints_restore_onto_four_ranks(
        runs, moments):
    for src in ("plain", "ref"):
        files = _leaf_files(runs["wd"], f"{src}_{moments}", 2)
        for r in runs["four"]:
            _assert_blocks(r[moments][f"from_{src}"], files, src)


@pytest.mark.parametrize("moments", MOMENTS)
def test_four_rank_checkpoint_restores_onto_plain_tensors(runs, moments):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models.spec import tree_leaves
    plain = runs["plain"][moments]
    got, _ = Checkpointer(os.path.join(runs["wd"], f"four_{moments}")) \
        .restore(plain["like"], 2)
    fulls = runs["four"][0][moments]["saved"][2]
    for i, (a, like, full) in enumerate(zip(
            tree_leaves(got), tree_leaves(plain["like"]), fulls)):
        assert a.dtype == like.dtype and not hasattr(a, "placements")
        np.testing.assert_array_equal(a.numpy(), full, err_msg=f"leaf {i}")
    # the sharded run's step 2 is the plain run's within the step tolerance
    for i, (a, b) in enumerate(zip(tree_leaves(got), plain["step2"])):
        if a.dtype == torch.float32:
            _close(a.numpy(), b.numpy(), TRAIN_TOL, f"leaf {i}")


def test_remat_recompute_on_the_engine_thread_sees_the_mesh(runs):
    """The card's backward runs on the autograd engine's device thread,
    where the caller's ``use_mesh`` is not active: a checkpointed group's
    recompute there must still constrain as the forward did (without the
    mesh, four H100s recomputed olmo-1b's MLP with other shards than the
    forward saved and ``torch.utils.checkpoint`` refused the step)."""
    n = _cfg().n_layers
    for r in runs["four"]:
        seen = r["remat"]["seen"]
        assert sorted(seen) == [(False, True)] * n + [(True, True)] * n
        assert r["remat"]["equal"]


def test_train_launcher_checkpoints_a_sharded_run(runs):
    wd = runs["wd"]
    for r in runs["four"]:
        got = r["launch"]
        assert got["env_mesh"] == {"data": 4, "model": 1}
        for key in ("mesh", "env"):
            none, ck = got[key]
            assert len(none) == 3 and ck == none, key
    for name in ("train_mesh", "train_env"):
        assert sorted(os.listdir(os.path.join(wd, name))) == \
            ["step_2", "step_3"]
        assert len(_leaf_files(wd, name, 3)) == \
            len(_leaf_files(wd, name, 2))


@pytest.mark.parametrize("what", ["write", "snapshot", "read"])
def test_a_failure_on_rank_0_raises_on_every_rank(runs, what):
    said = {"write": "disk full", "snapshot": "host copy",
            "read": "leaf_1.npy"}[what]
    own = {"write": "OSError", "snapshot": "MemoryError",
           "read": "FileNotFoundError"}[what]
    for rank, r in enumerate(runs["four"]):
        kind, msg = r["fail"][what]
        assert said in msg, (rank, msg)
        if rank == 0:
            assert kind == own, msg
        else:
            assert kind == "RuntimeError" and "on rank 0" in msg, msg
        assert r["fail"]["steps"] == [3]   # nothing else was written


def test_a_tree_of_other_leaves_is_refused_on_every_rank(runs):
    for r in runs["four"]:
        kind, msg = r["fail"]["leaves"]
        assert kind == "ValueError" and "holds 2 leaves" in msg, msg


def test_final_save_is_not_repeated(tmp_path):
    """The loop saves its final state once: the cadence's save at
    ``n_steps`` stands, else one more save at ``n_steps``."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.fault_tolerance import run_resilient_loop

    class Counting(Checkpointer):
        def __init__(self, directory):
            super().__init__(directory)
            self.saves = []

        def save(self, step, tree, extra=None, block=False):
            self.saves.append(step)
            super().save(step, tree, extra, block)

    def step_fn(params, opt_state, batch):
        return params + batch, opt_state + 1, {}
    for n, want in ((4, [2, 4]), (5, [2, 4, 5])):
        ck = Counting(str(tmp_path / str(n)))
        state = (torch.zeros(2), torch.zeros((), dtype=torch.int32))
        params, opt_state = run_resilient_loop(
            step_fn, state, lambda i: float(i), ck, n_steps=n, ckpt_every=2)
        assert ck.saves == want and ck.steps() == want[-3:]
        back, _ = ck.restore(state, n)
        assert torch.equal(back[0], params) and int(back[1]) == n
