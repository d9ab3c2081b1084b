"""The port's serving engine against the reference's.

The reference's ``test_engine_matches_oracle`` setup (olmo reduced, f32,
six requests on four slots, so slots are recycled) on the reference's own
parameters: the port's greedy tokens equal the JAX ``Engine``'s and the
port's own full-forward oracle. The same for the mamba reduced config,
which hands a prefill's conv tail and SSM state into its slot. The
engine's and the model's spans and counters (``repro_torch.obs``) on a
tiny port model: their tree, their counts, and the same tokens with
tracing on and off. On the CPU, and under ``use_mesh`` with a DTensor
cache (a one-rank gloo group in a subprocess), the engine captures no
CUDA graph: every decode step is eager, and the tokens are the same.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

import jax  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.spec import init_params as ref_init_params  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import Request as RefRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import init_params  # noqa: E402
from repro_torch.models.spec import params_from_numpy  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402


def _setup(arch, seed):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_init_params(ref_model.specs(), jax.random.PRNGKey(seed),
                                 "float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    return cfg, model, params, ref_model, ref_params


def oracle_continuation(model, params, cfg, prompt, n):
    """Greedy continuation by full forwards over the growing sequence."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits, _ = model.forward(
                params, {"tokens": torch.tensor([toks], dtype=torch.long)})
            toks.append(int(torch.argmax(logits[0, -1, :cfg.vocab])))
    return toks[len(prompt):]


def _serve_both(arch, seed, prompts, max_new, max_batch, max_seq):
    cfg, model, params, ref_model, ref_params = _setup(arch, seed)
    eng = Engine(model, params, max_batch=max_batch, max_seq=max_seq)
    got = eng.run([Request(uid=i, prompt=p, max_new=max_new)
                   for i, p in enumerate(prompts)])
    ref = RefEngine(ref_model, ref_params, max_batch=max_batch,
                    max_seq=max_seq)
    want = ref.run([RefRequest(uid=i, prompt=p.astype(np.int32),
                               max_new=max_new)
                    for i, p in enumerate(prompts)])
    return cfg, model, params, eng, got, want


def test_engine_matches_reference_and_oracle():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, (8 + i,)) for i in range(6)]
    # 6 requests > 4 slots: forces slot recycling
    cfg, model, params, eng, got, want = _serve_both(
        "olmo-1b", 0, prompts, max_new=5, max_batch=4, max_seq=64)
    assert len(got) == 6
    assert got == want
    for uid in range(3):
        assert got[uid] == oracle_continuation(model, params, cfg,
                                               prompts[uid], 5)
    t = eng.timings()
    assert sorted(t["prefill_ms"]) == list(range(6))
    assert len(t["decode_ms"]) >= 5 and min(t["decode_ms"]) > 0


def test_engine_mamba_state_handoff():
    """SSM prefill -> decode handoff (conv + ssm state), three requests on
    two slots so a slot is recycled."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, (10 + 3 * i,)) for i in range(3)]
    cfg, model, params, eng, got, want = _serve_both(
        "mamba2-370m", 1, prompts, max_new=4, max_batch=2, max_seq=48)
    assert got == want
    for uid in range(3):
        assert got[uid] == oracle_continuation(model, params, cfg,
                                               prompts[uid], 4)


def test_sampling_needs_a_generator():
    cfg = get_config("olmo-1b").reduced()
    model = build_model(cfg)
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         "float32")
    with pytest.raises(ValueError, match="generator"):
        Engine(model, params, max_batch=2, max_seq=32, temperature=0.7)
    outs = []
    for _ in range(2):
        eng = Engine(model, params, max_batch=2, max_seq=32,
                     temperature=0.7,
                     generator=np.random.default_rng(5))
        outs.append(eng.run([Request(uid=0, prompt=np.arange(1, 9),
                                     max_new=6)]))
    assert outs[0] == outs[1] and len(outs[0][0]) == 6


def test_launcher_and_meshes(capsys):
    rep = serve_main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                      "--dtype", "float32", "--requests", "3",
                      "--max-new", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("served 3 requests, 12 tokens in ")
    assert out[1].startswith("  req 0: [") and len(out) == 4
    assert rep["cfg"].dtype == "float32" and rep["params"] > 0
    assert all(len(v) == 4 for v in rep["results"].values())
    m = make_local_mesh("cpu")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    if torch.cuda.device_count() < 256:
        with pytest.raises(ValueError, match="256 devices"):
            make_production_mesh()
        with pytest.raises(ValueError, match="512 devices"):
            make_production_mesh(multi_pod=True)


def _tiny():
    """The reduced olmo in float32 on the port's own seeded weights."""
    cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                              dtype="float32")
    model = build_model(cfg)
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         "float32")
    return cfg, model, params


def _tree(events):
    """Chrome-trace complete events of one thread as nested
    ``(name, args, children)``, by time containment, in start order."""
    roots, stack = [], []
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        while stack and e["ts"] >= stack[-1][0]["ts"] + stack[-1][0]["dur"]:
            stack.pop()
        node = (e, [])
        (stack[-1][1] if stack else roots).append(node)
        stack.append(node)

    def strip(node):
        e, kids = node
        args = {k: v for k, v in e["args"].items() if k != "depth"}
        return e["name"], args, [strip(k) for k in kids]
    return [strip(n) for n in roots]


def test_one_admit_and_one_step_give_the_span_tree():
    cfg, model, params = _tiny()
    B = 2
    eng = Engine(model, params, max_batch=B, max_seq=32)
    V = params["embed"]["tok"].shape[0]         # the logits' row
    groups = [("model.group", {"g": g}, []) for g in range(model.n_groups)]
    metrics.reset_metrics()
    tr = trace.enable()
    try:
        assert eng.admit(Request(uid=7, prompt=np.arange(1, 9), max_new=4))
        eng.step()
    finally:
        trace.disable()
    assert _tree(tr.events()) == [
        ("engine.admit", {"uid": 7, "prompt_len": 8, "slot": 0}, [
            ("model.forward", {"tokens": 8}, groups),
            ("engine.admit.handoff", {}, []),
            ("engine.admit.first_token", {}, [])]),
        ("engine.step", {"live": 1}, [
            ("model.decode_step", {"batch": B}, groups),
            ("engine.step.fetch", {"bytes": B * V * 4}, []),
            ("engine.step.sample", {}, [])])]
    snap = metrics.snapshot()
    assert snap["engine.tokens"]["value"] == 2
    assert snap["engine.host_copy_bytes"]["value"] == V * 4 + B * V * 4


@pytest.mark.parametrize("traced", [False, True])
def test_counters_and_tokens_with_tracing_on_and_off(traced):
    """Three requests on two slots (a slot recycled, steps with an empty
    slot): the counters equal the tokens served and a float32 logits row
    per prefill and per slot of every step; the tokens are the oracle's
    either way; a tracer turned off records nothing."""
    cfg, model, params = _tiny()
    B = 2
    eng = Engine(model, params, max_batch=B, max_seq=48)
    V = params["embed"]["tok"].shape[0]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (6 + 2 * i,)) for i in range(3)]
    metrics.reset_metrics()
    tr = trace.enable()
    if not traced:
        trace.disable()
    try:
        got = eng.run([Request(uid=i, prompt=p, max_new=3 + i)
                       for i, p in enumerate(prompts)])
    finally:
        trace.disable()
    for uid, p in enumerate(prompts):
        assert got[uid] == oracle_continuation(model, params, cfg, p, 3 + uid)
    steps = len(eng.timings()["decode_ms"])
    snap = metrics.snapshot()
    assert snap["engine.tokens"]["value"] == sum(map(len, got.values()))
    assert snap["engine.host_copy_bytes"]["value"] == \
        (len(prompts) + steps * B) * V * 4
    names = [e["name"] for e in tr.events()]
    if not traced:
        assert names == []
        return
    assert names.count("engine.admit") == len(prompts)
    assert names.count("engine.step") == names.count(
        "model.decode_step") == steps
    assert names.count("model.group") == model.n_groups * (
        steps + len(prompts))


def _decode_steps() -> dict:
    """The decode steps counted so far, by path."""
    snap = metrics.snapshot()
    return {k: snap.get(f"model.decode.{k}", {"value": 0})["value"]
            for k in ("graph", "eager")}


def _eager_prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 512, (5 + 3 * i,)) for i in range(3)]


def test_cpu_engine_decodes_every_step_eagerly():
    """On the CPU the engine builds no graph: one ``model.decode.eager``
    a decode step, no ``model.decode.graph``, the oracle's tokens."""
    cfg, model, params = _tiny()
    eng = Engine(model, params, max_batch=2, max_seq=40)
    assert eng.graph is None
    prompts = _eager_prompts()
    metrics.reset_metrics()
    got = eng.run([Request(uid=i, prompt=p, max_new=4)
                   for i, p in enumerate(prompts)])
    steps = len(eng.timings()["decode_ms"])
    assert steps > 0 and _decode_steps() == {"graph": 0, "eager": steps}
    for uid, p in enumerate(prompts):
        assert got[uid] == oracle_continuation(model, params, cfg, p, 4)


# ``_tiny``'s engine over a DTensor cache: a one-rank gloo group, the
# (data=1, model=1) mesh, parameters and cache placed on it
_MESH_SERVE = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import distribute_tree, use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.spec import axes_tree, init_params, tree_leaves
    from repro_torch.obs import metrics
    from repro_torch.serve import Engine, Request
    store, prompts = sys.argv[1], json.loads(sys.argv[2])
    dist.init_process_group("gloo", init_method="file://" + store, rank=0,
                            world_size=1)
    try:
        cfg = dataclasses.replace(get_config("olmo-1b").reduced(),
                                  dtype="float32")
        model = build_model(cfg)
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        with use_mesh(mesh):
            specs = model.specs()
            params = distribute_tree(
                init_params(specs, torch.Generator().manual_seed(0),
                            "float32"), axes_tree(specs), mesh, params=True)
            eng = Engine(model, params, max_batch=2, max_seq=40)
            metrics.reset_metrics()
            got = eng.run([Request(uid=i, prompt=np.asarray(p), max_new=4)
                           for i, p in enumerate(prompts)])
        snap = metrics.snapshot()
        print(json.dumps({
            "dtensor": all(isinstance(t, DTensor)
                           for t in tree_leaves(eng.cache)),
            "graph": eng.graph is not None,
            "steps": len(eng.timings()["decode_ms"]),
            "counts": {k: snap.get("model.decode." + k, {"value": 0})["value"]
                       for k in ("graph", "eager")},
            "tokens": {str(u): v for u, v in got.items()}}))
    finally:
        dist.destroy_process_group()
""")


def test_mesh_engine_decodes_every_step_eagerly(tmp_path):
    """Under ``use_mesh`` the cache is DTensors: the engine builds no
    graph, counts one ``model.decode.eager`` a step and none under
    ``model.decode.graph``, and serves the plain CPU engine's tokens."""
    cfg, model, params = _tiny()
    prompts = _eager_prompts()
    plain = Engine(model, params, max_batch=2, max_seq=40).run(
        [Request(uid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _MESH_SERVE, str(tmp_path / "store"),
         json.dumps([p.tolist() for p in prompts])],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["dtensor"] and not rep["graph"] and rep["steps"] > 0
    assert rep["counts"] == {"graph": 0, "eager": rep["steps"]}
    assert {int(u): v for u, v in rep["tokens"].items()} == plain


@pytest.mark.parametrize("module", ["repro_torch.obs.trace",
                                    "repro_torch.obs.metrics"])
def test_obs_docstring_examples(module):
    """The examples in the port's obs modules run as written."""
    import doctest
    import importlib
    try:
        res = doctest.testmod(importlib.import_module(module))
    finally:
        trace.disable()
    assert res.attempted > 0 and res.failed == 0
