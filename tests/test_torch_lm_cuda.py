"""The model stack on the card equals its CPU run (card only).

For the reduced config of every family, in float32 on the same seeded
parameters and inputs: forward logits and caches, and four decode steps
after it, on ``cuda`` agree with the CPU within 1e-3 of each tensor's
scale (its largest magnitude, at least 1; the hybrid's SSM states reach
the tens of thousands).

The serving engine's decode step replayed from its CUDA graph
(``lm.DecodeGraph``) equals the eager ``Model.decode_step`` on a clone of
the engine's cache, step by step, for every family and a reduced
granite-4.0-h-micro, in bfloat16 and float32: the same greedy tokens,
logits within one rounding of the dtype (its ``eps`` times the logits'
largest magnitude, at least 1), and the same counts of the kernel's
calls, launches and state bytes copied; a slot is retired and another
request admitted into it mid-run. A float64 cache decodes eagerly.

Marked ``cuda``: the tests skip without a card. They import nothing of
the reference package, so they run where jax is absent.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import DecodeGraph  # noqa: E402
from repro_torch.models.spec import (init_params, tree_leaves,  # noqa: E402
                                     tree_map)
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

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


# the replayed step against the eager one: every family above and the
# port-only hybrid, served on SLOTS slots for GRAPH_STEPS steps
GRAPH_ARCHS = FAMILIES + ["granite-4.0-h-micro"]
SLOTS, GRAPH_STEPS = 3, 6
# what a step's host code counts; each replay adds the capture's counts
STEP_COUNTS = ("attention.decode.kernel", "attention.decode.plain",
               "mamba.decode.state_copy_bytes", "decode_attention.launches")


def _counts() -> dict:
    from repro_torch.kernels.decode_attention import decode_attention
    reg = metrics.registry()
    out = {n: getattr(reg.get(n), "value", 0) for n in STEP_COUNTS
           + ("model.decode.graph", "model.decode.eager")}
    out["decode_attention.launches"] = decode_attention.launches
    return out


def _minus(a: dict, b: dict) -> dict:
    return {k: a[k] - b[k] for k in a}


def _serving_engine(cuda, arch, dtype):
    """The reduced ``arch`` in ``dtype`` on the card, an ``Engine`` of
    SLOTS slots over it, and its prompts' length. A vlm prompt (256
    patches and some text) is prefilled with patch embeddings, a whisper
    prompt with frames, whose cross K/V go into the request's slot of the
    engine's cache; the other families prefill as the engine does."""
    if arch == "granite-4.0-h-micro":
        cfg = get_config("granite-4.0-h-micro-smoke")
    else:
        cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, dtype=dtype)
    n = 260 if cfg.family == "vlm" else 8
    model = build_model(cfg)
    params = tree_map(lambda t: t.to(cuda), init_params(
        model.specs(), torch.Generator().manual_seed(1), dtype))
    eng = Engine(model, params, max_batch=SLOTS,
                 max_seq=n + GRAPH_STEPS + 8)
    if cfg.family in ("vlm", "encdec"):
        rng = np.random.default_rng(7)
        wdt = params["embed"]["tok"].dtype

        def extra(rows):
            return torch.from_numpy(rng.standard_normal(
                (1, rows, cfg.d_model)).astype(np.float32) * 0.1).to(cuda,
                                                                     wdt)

        def prefill(tokens):
            batch = {"tokens": tokens}
            if cfg.family == "vlm":
                batch["patch_embeds"] = extra(256)
            else:
                batch["frames"] = extra(cfg.enc_seq)
                slot = eng.slots.index(None)
                kv = model.encoder_kv(params, model.encode(params,
                                                           batch["frames"]))
                for dst, src in zip(eng.cache["cross_kv"], kv):
                    dst[:, slot] = src[:, 0]
            logits, caches = model.forward(params, batch)
            return logits[:, -1], caches
        eng._prefill = prefill
    return cfg, model, params, eng, n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_replayed_step_equals_the_eager_step(cuda, arch, dtype):
    """GRAPH_STEPS engine steps replayed from the graph, each against
    ``Model.decode_step`` run eagerly on a clone of the engine's cache
    with the same tokens and positions: equal greedy tokens, logits
    within one rounding of ``dtype``, and the same kernel calls, launches
    and state bytes copied. Request 0 retires after two steps and request
    3 is admitted into its slot: the graph reads the new prefill's rows
    and states where the handoff wrote them."""
    rng = np.random.default_rng(GRAPH_ARCHS.index(arch))
    cfg, model, params, eng, n = _serving_engine(cuda, arch, dtype)
    assert eng.graph is not None and eng.graph.capture_s > 0
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, (n + i % 3,)),
                    max_new=3 if i == 0 else GRAPH_STEPS + 2)
            for i in range(4)]
    with torch.no_grad():
        for r in reqs[:SLOTS]:
            assert eng.admit(r)
        eps = torch.finfo(getattr(torch, dtype)).eps
        eager = dict.fromkeys(_counts(), 0)
        graph_spent = dict(eager)
        recycled = False
        for step in range(GRAPH_STEPS):
            if reqs[0].done and not recycled:
                assert eng.slots.index(None) == 0 and eng.admit(reqs[3])
                recycled = True
            live = [i for i, r in enumerate(eng.slots) if r is not None]
            tokens = torch.zeros((SLOTS, 1), dtype=torch.long)
            for i in live:
                tokens[i, 0] = eng.slots[i].out[-1]
            shadow = tree_map(torch.clone, eng.cache)
            c0 = _counts()
            want, _ = model.decode_step(params, shadow, tokens.to(cuda),
                                        torch.from_numpy(eng.pos).to(cuda))
            eager = {k: eager[k] + v
                     for k, v in _minus(_counts(), c0).items()}
            c0 = _counts()
            out = eng.step()
            graph_spent = {k: graph_spent[k] + v
                           for k, v in _minus(_counts(), c0).items()}
            want = want[live, 0].float().cpu()
            got = eng.graph.logits[live, 0].float().cpu()
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            assert err <= eps * scale, (
                f"{arch} {dtype} step {step}: logits off by {err}")
            assert [t for _, t in out] == want[:, :cfg.vocab].argmax(
                -1).tolist(), f"{arch} {dtype} step {step}"
        assert recycled
    assert graph_spent["model.decode.graph"] == GRAPH_STEPS
    assert graph_spent["model.decode.eager"] == 0
    assert eager["model.decode.graph"] == eager["model.decode.eager"] == 0
    for name in STEP_COUNTS:
        assert graph_spent[name] == eager[name], (name, graph_spent, eager)
    attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    assert eager["attention.decode.kernel"] == attn * GRAPH_STEPS
    assert len(eng.timings()["decode_ms"]) == GRAPH_STEPS


@pytest.mark.cuda
def test_float64_engine_decodes_eagerly_on_the_card(cuda):
    """A float64 cache is none the decode kernel takes: the engine builds
    no graph and counts its steps under ``model.decode.eager``."""
    cfg, model, params, eng, n = _serving_engine(cuda, "olmo-1b", "float64")
    assert eng.graph is None and not DecodeGraph.takes(eng.cache)
    c0 = _counts()
    got = eng.run([Request(uid=0, prompt=np.arange(1, n + 1), max_new=4)])
    spent = _minus(_counts(), c0)
    assert len(got[0]) == 4
    assert spent["model.decode.eager"] == 3 and \
        spent["model.decode.graph"] == 0
