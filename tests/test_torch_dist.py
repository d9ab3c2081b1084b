"""Sharded steps on four real gloo CPU ranks against the unsharded port.

Four processes form one gloo group (a free local port, one torch thread
each, a hard time limit), once for the whole file, and run every check in
it; the test process compares what they return. On a 2×2
``("data", "model")`` mesh, the reduced float32 configs of olmo-1b,
mamba2-370m, granite-moe-1b-a400m and whisper-tiny run with DTensor
parameters placed by ``PARAM_RULES`` (tensor parallelism over 'model',
FSDP of 'embed' over 'data') on the reference's own parameters
(``init_params(PRNGKey(0))``), batch over 'data':

* forward logits within 1e-4 of each tensor's scale (its largest
  magnitude, at least 1) of the unsharded port's, and of JAX's;
* 16 greedy decode steps on a cache placed by ``cache_axes`` (the
  sequence over 'model'): each step's logits within 1e-4 of scale and
  the greedy tokens equal, ``decode_step`` returning the cache it was
  given and every leaf's local shard keeping its data pointer (written
  where it lies, never restacked);
* granite-moe's logits are held at 5e-3 of scale instead, above one
  bfloat16 step of a gate (2^-8 = 3.9e-3): its gates are rounded to
  bfloat16 for the combine (as in the reference), and the sharded
  router's float32 logits, summed over other blocks, put a gate on the
  other bfloat16 neighbour now and then. In the forward that moves one
  token's logits by 0.021 (5.9e-4 of scale), in the 16 decode steps
  (four tokens routed at a capacity of one slot per expert) by up to
  1.5e-3 of scale (measured). With the dispatch and combine in float32
  every sharded forward logit is within 1.3e-5 of scale (measured);
* one train step with float32 moments (remat "full") and one with int8
  moments (two microbatches): loss, gradient norm and every updated
  parameter within 5e-4 of scale of the unsharded step's. Adam's first
  step moves each parameter by about ±lr whatever its gradient, so the
  gradients themselves are held too, at 5e-4 of each leaf's scale but
  for granite-moe: its dispatch and combine products are bfloat16 (as
  in the reference), and summed in another order they move its
  gradients by up to 4.7e-3 of scale (measured; with those products in
  float32 the sharded gradients sit within 7.6e-5), so granite's are
  held at 1e-2;
* ``make_global_batch``: each rank's rows are the global batch's rows of
  its 'data' block, bit for bit;
* ``compress_decompress(axis_name="pod")`` on a 2×1×2
  ``("pod", "data", "model")`` mesh equals, over three steps, the mean
  over the two pods of the reference's one-process outputs, and each
  rank keeps its own pod's error feedback;
* ``CollectiveMeter`` on gloo records a ``Shard(0)`` -> ``Shard(1)``
  redistribution as the all-to-all NCCL issues;
* the launchers' ``serve`` and ``train`` on the mesh serve the one-device
  run's tokens and train to its losses (reduced olmo-1b at its own
  bfloat16: within 1e-2 relative, the bfloat16 bound of
  ``tests/test_torch_train.py``; measured 1.7e-3);
* ``spmd.softmax`` and ``spmd.logsumexp`` with the reduced axis split
  over 'model', over both mesh axes and over neither: values and
  gradients within 1e-6 of scale of torch's function on the whole tensor
  in float32 and 1e-12 in float64 (a few ulps of the sums; a row's first
  blocks at ``-1e30``), the split axis never gathered;
* ``launch.serve_mesh.compare`` on a (data=1, model=4) mesh serves the
  one-device run's tokens;
* a sharded decode step of reduced olmo-1b gathers no logits and reduces
  their (B/2, KV, rep, 1, 1) maximum and sum, two all-reduces a layer; a
  sharded train step gathers no vocab-sized logits.
"""
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

ARCHS = ["olmo-1b", "mamba2-370m", "granite-moe-1b-a400m", "whisper-tiny"]
WORLD = 4
B, S, STEPS = 4, 32, 16
FWD_TOL = 1e-4
LOGIT_TOL = {"granite-moe-1b-a400m": 5e-3}
TRAIN_TOL = 5e-4
GRAD_TOL = {"granite-moe-1b-a400m": 1e-2}
TRAIN = {"float32": dict(remat="full", opt_state_dtype="float32",
                         microbatches=1),
         "int8": dict(remat="none", opt_state_dtype="int8",
                      microbatches=2)}
COMPRESS_SHAPES = {"w": (8, 16), "b": (16,), "e": (2, 3, 8)}
# spmd.softmax / logsumexp cases on the 2x2 ("data", "model") mesh: the
# placements of a (4, 6, 8) tensor and the dim reduced over
SPLIT_SHAPE = (4, 6, 8)
SPLITS = {"model": (("S0", "S2"), 2), "both": (("S2", "S2"), 2),
          "none": (("S0", "S1"), 2), "model_mid": (("R", "S1"), 1)}
SPLIT_TOL = {"float32": 1e-6, "float64": 1e-12}
# the cache length of the metered decode step: its logits' block (B/2, KV,
# rep, 1, METER_SEQ/2) differs in size from the gathered query
METER_SEQ = 40
TIME_LIMIT_S = 600
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


# ---------------------------------------------------------------------------
# What every rank runs (and, on plain tensors, the unsharded reference)
# ---------------------------------------------------------------------------


def _cfg(arch):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _full(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().float().numpy()


def _local_ptrs(tree) -> list:
    """The data pointer of every leaf's local tensor (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.spec import tree_leaves
    return [(t.to_local() if isinstance(t, DTensor) else t).data_ptr()
            for t in tree_leaves(tree)]


def _run_model(arch, case, mesh=None):
    """Forward logits, decode logits and tokens, and both train steps of
    one arch: on DTensors placed on ``mesh``, or plain without one."""
    import contextlib

    from repro_torch.configs import TrainConfig
    from repro_torch.data import make_global_batch
    from repro_torch.distributed.sharding import distribute_tree, use_mesh
    from repro_torch.models import build_model
    from repro_torch.models.spec import (axes_tree, params_from_numpy,
                                         tree_leaves)
    from repro_torch.train import make_grad_fn, make_train_step

    cfg = _cfg(arch)
    model = build_model(cfg)
    specs = model.specs()
    out = {}
    ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    train_meter = _axis_meter(mesh) if mesh is not None \
        else contextlib.nullcontext()
    with ctx:
        def place(tree, axes, params=False):
            return (distribute_tree(tree, axes, mesh, params=params)
                    if mesh is not None else tree)

        def batch_of(np_batch):
            if mesh is not None:
                return make_global_batch(np_batch, mesh, torch.float32)
            return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
                    else torch.from_numpy(v) for k, v in np_batch.items()}

        params = place(params_from_numpy(case["params"], device="cpu"),
                       axes_tree(specs), params=True)
        with torch.no_grad():
            logits, _ = model.forward(params, batch_of(case["batch"]))
            out["logits"] = _full(logits)
            cache = place(model.init_cache(B, STEPS, torch.float32,
                                           device="cpu"),
                          model.cache_axes())
            if cfg.family == "encdec":
                frames = batch_of({"f": case["batch"]["frames"]})["f"]
                cache["cross_kv"] = model.encoder_kv(
                    params, model.encode(params, frames))
            tok = torch.from_numpy(case["batch"]["tokens"][:, :1]).long()
            steps, toks = [], []
            ptrs, same = _local_ptrs(cache), True
            for i in range(STEPS):
                pos = torch.full((B,), i, dtype=torch.long)
                lg, again = model.decode_step(params, cache, tok, pos)
                same &= again is cache
                lg = _full(lg)[:, 0]
                steps.append(lg)
                tok = torch.from_numpy(lg[:, :cfg.vocab].argmax(-1))[:, None]
                toks.append(tok[:, 0].numpy())
            out["decode_logits"] = np.stack(steps)
            out["decode_tokens"] = np.stack(toks)
            out["decode_in_place"] = same and _local_ptrs(cache) == ptrs
        tb = batch_of(case["train_batch"])
        with train_meter:
            _, grads = make_grad_fn(model, TrainConfig(**TRAIN["float32"]))(
                params, tb)
        out["grads"] = [_full(g) for g in tree_leaves(grads)]
        out["train_collectives"] = [
            rec + (train_meter.axes.get(i),)
            for i, rec in enumerate(getattr(train_meter, "records", []))]
        for name, kw in TRAIN.items():
            step, opt = make_train_step(model, TrainConfig(**kw))
            new, _, m = step(params, opt.init(params), tb)
            out[f"train_{name}"] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": [_full(p) for p in tree_leaves(new)]}
    return out


def _axis_meter(mesh):
    """A ``CollectiveMeter`` whose ``axes`` maps a record's index to the
    mesh axis its functional collective runs over (by group name): a
    gather over 'data' and one over 'model' of equal blocks have equal
    bytes and group sizes on the 2×2 mesh."""
    from repro_torch.launch.hlo_analysis import CollectiveMeter
    dm = mesh.device_mesh
    names = {dm.get_group(a).group_name: a for a in dm.mesh_dim_names}

    class AxisMeter(CollectiveMeter):
        def __init__(self):
            super().__init__()
            self.axes = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n = len(self.records)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if len(self.records) > n:
                self.axes[n] = next((names[a] for a in args[1:]
                                     if isinstance(a, str) and a in names),
                                    None)
            return out
    return AxisMeter()


def _compress_grads(pod, step):
    rng = np.random.default_rng((pod, step))
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in COMPRESS_SHAPES.items()}


def _metered_decode(mesh, params_np):
    """The collectives of one decode step of reduced olmo-1b on
    ``mesh``, at position 5 of a cache of ``METER_SEQ`` placed by
    ``cache_axes`` (its sequence over 'model')."""
    from repro_torch.distributed.sharding import distribute_tree, use_mesh
    from repro_torch.launch.hlo_analysis import CollectiveMeter
    from repro_torch.models import build_model
    from repro_torch.models.spec import axes_tree, params_from_numpy
    model = build_model(_cfg("olmo-1b"))
    meter = CollectiveMeter()
    with use_mesh(mesh), torch.no_grad():
        params = distribute_tree(params_from_numpy(params_np, device="cpu"),
                                 axes_tree(model.specs()), mesh, params=True)
        cache = distribute_tree(model.init_cache(B, METER_SEQ, torch.float32,
                                                 device="cpu"),
                                model.cache_axes(), mesh)
        tok = torch.zeros((B, 1), dtype=torch.long)
        pos = torch.full((B,), 5, dtype=torch.long)
        with meter:
            model.decode_step(params, cache, tok, pos)
    return meter.records


def _split_input(dtype):
    """The (4, 6, 8) input of the split-reduction cases: seeded normal
    values, batch row 0's first four entries of the last two dims at
    ``-1e30`` (a whole block of every split case's reduced axis), and the
    seeded upstream gradients of softmax and logsumexp."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(SPLIT_SHAPE) * 3
    x[0, :4, :4] = -1e30
    g = rng.standard_normal(SPLIT_SHAPE)
    return {"x": x.astype(dtype), "g": g.astype(dtype),
            "g_lse": {dim: rng.standard_normal(
                SPLIT_SHAPE[:dim] + SPLIT_SHAPE[dim + 1:]).astype(dtype)
                for dim in (1, 2)}}


def _placement(code):
    from torch.distributed.tensor import Replicate, Shard
    return Replicate() if code == "R" else Shard(int(code[1:]))


def _split_reductions(dm):
    """``spmd.softmax`` and ``spmd.logsumexp`` on every case of
    ``SPLITS`` in both dtypes: the whole values and gradients, the
    output placements and the collectives of forward and backward."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import spmd
    from repro_torch.launch.hlo_analysis import CollectiveMeter

    def place(a, pl):
        return distribute_tensor(torch.from_numpy(a), dm, pl,
                                 src_data_rank=None)
    out = {}
    for dtype in SPLIT_TOL:
        inp = _split_input(dtype)
        for case, (codes, dim) in SPLITS.items():
            pl = tuple(_placement(c) for c in codes)
            for fn in ("softmax", "logsumexp"):
                x = place(inp["x"], pl).requires_grad_()
                fwd, bwd = CollectiveMeter(), CollectiveMeter()
                with fwd:
                    y = getattr(spmd, fn)(x, dim)
                g = place(inp["g"] if fn == "softmax"
                          else inp["g_lse"][dim], y.placements)
                with bwd:
                    (gx,) = torch.autograd.grad(y, x, g)
                out[(dtype, case, fn)] = {
                    "y": y.full_tensor().detach().numpy(),
                    "grad": gx.full_tensor().numpy(),
                    "placements": tuple(y.placements),
                    "forward": fwd.records, "backward": bwd.records}
    return out


def _rank_main(rank, workdir, port):
    """One gloo rank: every sharded check, its results pickled."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, make_global_batch
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.hlo_analysis import CollectiveMeter
    from repro_torch.launch import serve_mesh
    from repro_torch.launch.mesh import make_mesh, mesh_from_env
    from repro_torch.optim import grad_compress

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    res = {}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    for arch in ARCHS:
        res[arch] = _run_model(arch, inputs[arch], mesh)
    batch = SyntheticLM(get_config("olmo-1b").reduced(), batch=8,
                        seq=16).at_step(3)
    local = make_global_batch(batch, mesh, torch.float32)
    res["batch"] = {"coord": mesh.device_mesh.get_coordinate(),
                    "placements": tuple(local["tokens"].placements),
                    "rows": {k: v.to_local().numpy()
                             for k, v in local.items()}}
    pods = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    pod = pods.device_mesh.get_coordinate()[0]
    with use_mesh(pods):
        err = grad_compress.init_error(
            {k: torch.zeros(s) for k, s in COMPRESS_SHAPES.items()})
        outs = []
        for step in range(3):
            g = {k: torch.from_numpy(v)
                 for k, v in _compress_grads(pod, step).items()}
            comp, err = grad_compress.compress_decompress(g, err,
                                                          axis_name="pod")
            outs.append(({k: v.numpy() for k, v in comp.items()},
                         {k: v.numpy() for k, v in err.items()}))
    res["compress"] = {"pod": pod, "steps": outs}
    dm = mesh.device_mesh
    x = distribute_tensor(torch.arange(64.0).reshape(8, 8), dm,
                          [Shard(0), Replicate()], src_data_rank=None)
    meter = CollectiveMeter()
    with meter:
        y = x.redistribute(dm, [Shard(1), Replicate()])
    res["meter"] = {"records": meter.records,
                    "equal": bool(torch.equal(y.full_tensor(),
                                              torch.arange(64.0)
                                              .reshape(8, 8)))}
    res["split"] = _split_reductions(dm)
    res["decode_collectives"] = _metered_decode(
        mesh, inputs["olmo-1b"]["params"])
    res["launch"] = _launchers(mesh)
    res["serve_mesh"] = serve_mesh.compare(
        make_mesh((1, WORLD), ("data", "model"), "cpu"), smoke=True,
        requests=5, max_new=6, max_batch=2, max_seq=32, device="cpu",
        dtype="float32")
    os.environ["WORLD_SIZE"] = str(WORLD)
    env_mesh = mesh_from_env("cpu")
    res["launch"]["env_mesh"] = dict(env_mesh.shape)
    res["launch"]["env_serve"] = _launchers(env_mesh)["serve"]
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def _launchers(mesh=None):
    """``launch.serve.serve`` and ``launch.train.train`` on reduced
    olmo-1b in float32: the served tokens and the losses."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train
    mesh = mesh or make_local_mesh("cpu")
    rep = serve("olmo-1b", smoke=True, requests=5, max_new=6, max_batch=2,
                max_seq=32, device="cpu", dtype="float32", mesh=mesh)
    tr = train("olmo-1b", smoke=True, steps=2, batch=4, seq=16,
               device="cpu", mesh=mesh)
    return {"serve": rep["results"], "losses": tr["losses"]}


# ---------------------------------------------------------------------------
# The test process: reference inputs, four ranks, the unsharded runs
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs():
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro.models.spec import init_params as ref_init_params
    from repro_torch.data import SyntheticLM
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = _cfg(arch)
        ref_cfg = ref_get_config(arch).reduced()
        import dataclasses
        ref_cfg = dataclasses.replace(ref_cfg, dtype="float32")
        params = jax.tree.map(np.asarray, ref_init_params(
            ref_build_model(ref_cfg).specs(), jax.random.PRNGKey(0),
            "float32"))
        rng = np.random.default_rng(100 + i)
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S))}
        if cfg.family == "encdec":
            batch["frames"] = (rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)
        out[arch] = {"params": params, "batch": batch,
                     "train_batch": SyntheticLM(cfg, batch=B, seq=16,
                                                seed=i).at_step(0)}
    return out


@pytest.fixture(scope="module")
def runs():
    """Every rank's results, the inputs and the unsharded port's
    results, from one four-rank group for the whole file."""
    inputs = _inputs()
    with tempfile.TemporaryDirectory() as wd:
        with open(os.path.join(wd, "inputs.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.abspath(SRC)]
                       + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        code = ("import sys; sys.path.insert(0, {!r}); "
                "import test_torch_dist as T; "
                "T._rank_main({{}}, {!r}, {})").format(HERE, wd, port)
        procs = [subprocess.Popen([sys.executable, "-c", code.format(r)],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(WORLD)]
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
        ranks = []
        for r in range(WORLD):
            with open(os.path.join(wd, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    plain = {arch: _run_model(arch, inputs[arch]) for arch in ARCHS}
    return {"inputs": inputs, "ranks": ranks, "plain": plain,
            "launch": _launchers()}


def _close(got, want, tol, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_unsharded_and_jax(runs, arch):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    import dataclasses
    want = runs["plain"][arch]["logits"]
    tol = LOGIT_TOL.get(arch, FWD_TOL)
    for r in runs["ranks"]:
        _close(r[arch]["logits"], want, tol, f"{arch} forward")
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    case = runs["inputs"][arch]
    batch = {"tokens": jnp.asarray(case["batch"]["tokens"], jnp.int32)}
    if "frames" in case["batch"]:
        batch["frames"] = jnp.asarray(case["batch"]["frames"])
    params = jax.tree.map(jnp.asarray, case["params"])
    ref_logits, _ = ref_build_model(ref_cfg).forward(params, batch)
    _close(runs["ranks"][0][arch]["logits"],
           np.asarray(ref_logits, np.float32), tol, f"{arch} vs jax")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_unsharded(runs, arch):
    """And every rank's decode step writes each cache leaf's local shard
    where it lies: the cache is never restacked."""
    want = runs["plain"][arch]
    assert want["decode_in_place"]
    for r in runs["ranks"]:
        got = r[arch]
        assert got["decode_in_place"]
        np.testing.assert_array_equal(got["decode_tokens"],
                                      want["decode_tokens"])
        for i in range(STEPS):
            _close(got["decode_logits"][i], want["decode_logits"][i],
                   LOGIT_TOL.get(arch, FWD_TOL), f"{arch} decode step {i}")


@pytest.mark.parametrize("moments", sorted(TRAIN))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unsharded(runs, arch, moments):
    want = runs["plain"][arch][f"train_{moments}"]
    for r in runs["ranks"]:
        got = r[arch][f"train_{moments}"]
        _close(np.float32(got["loss"]), np.float32(want["loss"]),
               TRAIN_TOL, f"{arch} loss")
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=TRAIN_TOL)
        assert len(got["params"]) == len(want["params"])
        for i, (g, w) in enumerate(zip(got["params"], want["params"])):
            _close(g, w, TRAIN_TOL, f"{arch} {moments} param {i}")
    tol = GRAD_TOL.get(arch, TRAIN_TOL)
    for i, (g, w) in enumerate(zip(runs["ranks"][0][arch]["grads"],
                                   runs["plain"][arch]["grads"])):
        _close(g, w, tol, f"{arch} gradient {i}")


def test_global_batch_rows_are_the_ranks_rows(runs):
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from torch.distributed.tensor import Replicate, Shard
    batch = SyntheticLM(get_config("olmo-1b").reduced(), batch=8,
                        seq=16).at_step(3)
    for r in runs["ranks"]:
        got = r["batch"]
        data = got["coord"][0]
        assert got["placements"] == (Shard(0), Replicate())
        for k, v in batch.items():
            rows = v[data * 4:(data + 1) * 4]
            assert got["rows"][k].dtype == np.int64
            np.testing.assert_array_equal(got["rows"][k], rows)


def test_pod_all_reduce_is_the_mean_of_the_pods(runs):
    import jax.numpy as jnp
    from repro.optim import grad_compress as ref_gc
    ref = {}
    for pod in (0, 1):
        err = ref_gc.init_error({k: jnp.zeros(s)
                                 for k, s in COMPRESS_SHAPES.items()})
        steps = []
        for step in range(3):
            g = {k: jnp.asarray(v)
                 for k, v in _compress_grads(pod, step).items()}
            out, err = ref_gc.compress_decompress(g, err)
            steps.append(({k: np.asarray(v) for k, v in out.items()},
                          {k: np.asarray(v) for k, v in err.items()}))
        ref[pod] = steps
    assert sorted(r["compress"]["pod"] for r in runs["ranks"]) == \
        [0, 0, 1, 1]
    for r in runs["ranks"]:
        pod = r["compress"]["pod"]
        for step, (out, err) in enumerate(r["compress"]["steps"]):
            for k in COMPRESS_SHAPES:
                mean = (ref[0][step][0][k] + ref[1][step][0][k]) / 2
                _close(out[k], mean, 1e-6, f"{k} step {step}")
                _close(err[k], ref[pod][step][1][k], 1e-6, f"{k} error")


def test_meter_names_the_all_to_all_on_gloo(runs):
    for r in runs["ranks"]:
        assert r["meter"]["equal"]
        assert r["meter"]["records"] == [("all-to-all", 8 * 4 * 4, 2)]


def test_launchers_serve_and_train_sharded(runs):
    """``serve`` and ``train`` on the 2×2 mesh and on the mesh
    ``mesh_from_env`` builds under ``torchrun`` (``WORLD_SIZE=4``:
    data=4, model=1): the served tokens equal the one-device run's (the
    engine writes each prefill into its ranks' blocks of the cache and
    gathers the logits for sampling), the bfloat16 losses within 1e-2
    relative."""
    want = runs["launch"]
    for r in runs["ranks"]:
        got = r["launch"]
        assert got["serve"] == want["serve"]
        assert got["env_mesh"] == {"data": WORLD, "model": 1}
        assert got["env_serve"] == want["serve"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-2, err_msg="train losses")


def test_serve_mesh_splits_the_cache_four_ways(runs):
    """``launch.serve_mesh.compare`` on a (data=1, model=4) mesh, the
    cache's sequence split over all four ranks: the sharded and metered
    runs serve the one-device run's tokens, and the metered run's
    collectives are all-reduces and all-gathers."""
    want = runs["launch"]["serve"]
    for r in runs["ranks"]:
        got = r["serve_mesh"]
        assert got["mesh"] == {"data": 1, "model": WORLD}
        assert got["tokens_equal"] and got["results"] == want
        assert set(got["first_divergence"].values()) == {None}
        assert got["decode_steps"] == len(got["decode_ms"]["plain"]) > 0
        assert got["collectives"]["count"] > 0
        assert set(got["collectives"]["operand_bytes"]) <= {
            "all-reduce", "all-gather", "all-to-all", "reduce-scatter"}
        assert got["collectives"]["operand_bytes"]["all-reduce"] > 0


def _split_want(dtype, case, fn):
    """torch's function on the whole input, and its gradient."""
    inp = _split_input(dtype)
    dim = SPLITS[case][1]
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y = getattr(torch, fn)(x, dim)
    g = inp["g"] if fn == "softmax" else inp["g_lse"][dim]
    (gx,) = torch.autograd.grad(y, x, torch.from_numpy(g))
    return y.detach().numpy(), gx.numpy()


@pytest.mark.parametrize("fn", ["softmax", "logsumexp"])
@pytest.mark.parametrize("case", sorted(SPLITS))
@pytest.mark.parametrize("dtype", sorted(SPLIT_TOL))
def test_split_reductions_match_torch(runs, dtype, case, fn):
    """Values and gradients within ``SPLIT_TOL`` of scale (1e-6 in
    float32, 1e-12 in float64: the global sum taken in another order)
    of torch's function on the whole tensor. The output keeps every
    placement of the input but ``dim`` (logsumexp drops it); each mesh
    axis that splits ``dim`` costs one all-reduce of the statistic's
    shape for the maximum and one for the sum, softmax's backward one
    more for the sum, and nothing is gathered."""
    from torch.distributed.tensor import Replicate, Shard
    codes, dim = SPLITS[case]
    pl = tuple(_placement(c) for c in codes)
    want_y, want_g = _split_want(dtype, case, fn)
    tol = SPLIT_TOL[dtype]
    split = [p for p in pl if p == Shard(dim)]
    stat = np.prod([n // (2 if any(p == Shard(d) for p in pl) else 1)
                    for d, n in enumerate(SPLIT_SHAPE) if d != dim])
    stat_bytes = int(stat) * np.dtype(dtype).itemsize
    if fn == "softmax":
        want_pl = pl
    else:
        want_pl = tuple(Replicate() if p == Shard(dim)
                        else Shard(p.dim - 1) if isinstance(p, Shard)
                        and p.dim > dim else p for p in pl)
    for r in runs["ranks"]:
        got = r["split"][(dtype, case, fn)]
        _close(got["y"], want_y, tol, f"{case} {fn} value")
        _close(got["grad"], want_g, tol, f"{case} {fn} gradient")
        assert got["placements"] == want_pl
        assert got["forward"] == [("all-reduce", stat_bytes, 2)] \
            * (2 * len(split))
        assert got["backward"] == ([("all-reduce", stat_bytes, 2)]
                                   * len(split) if fn == "softmax" else [])


def test_sharded_decode_step_reduces_and_never_gathers_the_logits(runs):
    """One decode step of reduced olmo-1b on the 2×2 mesh, its cache
    split over the sequence ('cache_seq' over 'model'): no all-gather of
    the logits' local (B/2, KV, rep, 1, METER_SEQ/2) float32 block (nor
    of the block gathered whole), and two all-reduces of their (B/2, KV,
    rep, 1, 1) maximum and sum a layer. The logits are split over the
    sequence, not the KV heads, which stay whole on every rank."""
    cfg = _cfg("olmo-1b")
    rep = cfg.n_heads // cfg.n_kv_heads
    stat = (B // 2) * cfg.n_kv_heads * rep * 4
    logits_local = stat * (METER_SEQ // 2)
    for r in runs["ranks"]:
        recs = r["decode_collectives"]
        assert recs, "the sharded decode step issued no collective"
        assert not [x for x in recs if x[0] == "all-gather"
                    and x[1] in (logits_local, 2 * logits_local)], recs
        assert [x for x in recs if x[:2] == ("all-reduce", stat)] == \
            [("all-reduce", stat, 2)] * (2 * cfg.n_layers)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_gathers_no_vocab_logits(runs, arch):
    """The gradients of one train step on the 2×2 mesh (the vocab split
    over 'model'): no all-gather over 'model' as large as a rank's logits
    with the whole vocab, (B/2, 16, V) float32; the loss is
    vocab-parallel. (The backward of the logits' reduce-scatter over
    'data' gathers their gradient's batch, of the same size, over
    'data'.)"""
    cfg = _cfg(arch)
    whole_vocab = (B // 2) * 16 * cfg.vocab * 4
    for r in runs["ranks"]:
        recs = r[arch]["train_collectives"]
        assert recs, "the sharded train step issued no collective"
        assert all(x[3] in ("data", "model") for x in recs
                   if x[0] == "all-gather"), recs
        big = [x for x in recs if x[0] == "all-gather"
               and x[3] == "model" and x[1] >= whole_vocab]
        assert not big, big
