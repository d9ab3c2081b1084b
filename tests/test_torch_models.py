"""The port's model stack against the reference, family by family.

Each family's reduced config in float32 runs in both packages on the
reference's own parameters (``repro.models.spec.init_params(PRNGKey(0))``
carried across by ``repro_torch.models.spec.params_from_numpy``), on the
same inputs made from a seed with numpy: forward logits and caches, and
``decode_step`` over 16 tokens (logits and caches), agree within 1e-4 of
each tensor's scale — its largest magnitude, at least 1 — absolute. Plain
1e-4 absolute is too tight for float32 sums in another order: logits reach
|38| and the hybrid's SSM states |34000|. The largest differences measured
were 7.0e-5 of the scale (whisper's logits, 2.1e-3 at scale 29.8), 5.7e-5
(granite's decode logits) and 3.1e-5 (jamba's SSM state, 0.58). The
granite decode steps route two tokens at a capacity of one slot per
expert, so tokens are dropped (68 dropped slots over the 64 MoE calls).

One bfloat16 case (olmo-1b at its own dtype) cannot be held to the
reference's ``tests/test_models_smoke.py`` tolerance of 2e-2: bfloat16
rounding alone moves the reference's own logits by up to 5.2 (mean 0.37)
from its float32 forward on the same weights, and the port's bfloat16
logits differed from the reference's by up to 1.9 (mean 0.14). So that
case holds the port's bfloat16 error against the float32 forward to the
reference's own, within 10% in the mean and 50% in the maximum.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from _config_parity import config_parity  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.spec import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.spec import (Spec, abstract_params,  # noqa: E402
                                     axes_tree, init_params,
                                     params_from_numpy, stack_specs,
                                     tree_leaves, tree_map)

B, S, STEPS = 2, 32, 16
ATOL = 1e-4
FAMILIES = ["olmo-1b", "granite-moe-1b-a400m", "mamba2-370m", "qwen2-vl-2b",
            "whisper-tiny", "jamba-1.5-large-398b", "matpim-bnn"]
_CASES = {}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _case(arch, dtype="float32"):
    """(port cfg, port model, port params, reference model, reference
    params, numpy batch) for one arch's reduced config, memoized."""
    key = (arch, dtype)
    if key not in _CASES:
        ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                      dtype=dtype)
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        mine, must = config_parity(cfg, ref_cfg)
        assert mine == must
        ref_model = ref_build_model(ref_cfg)
        ref_params = ref_init_params(ref_model.specs(),
                                     jax.random.PRNGKey(0), dtype)
        model = build_model(cfg)
        params = params_from_numpy(_np_tree(ref_params), device="cpu")
        rng = np.random.default_rng(FAMILIES.index(arch))
        seq = 288 if cfg.family == "vlm" else S
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, seq))}
        if cfg.family == "encdec":
            batch["frames"] = (rng.standard_normal(
                (B, cfg.enc_seq, cfg.d_model)) * 0.1).astype(np.float32)
        if cfg.family == "vlm":
            batch["patch_embeds"] = (rng.standard_normal(
                (B, 256, cfg.d_model)) * 0.1).astype(np.float32)
        _CASES[key] = (cfg, model, params, ref_model, ref_params, batch)
    return _CASES[key]


def _ref_batch(batch, dtype):
    out = {"tokens": jnp.asarray(batch["tokens"], jnp.int32)}
    for k in ("frames", "patch_embeds"):
        if k in batch:
            out[k] = jnp.asarray(batch[k], jnp.dtype(dtype))
    return out


def _port_batch(batch, dtype):
    out = {"tokens": torch.from_numpy(batch["tokens"]).long()}
    for k in ("frames", "patch_embeds"):
        if k in batch:
            out[k] = torch.from_numpy(batch[k]).to(getattr(torch, dtype))
    return out


def _close(got, want, atol, what):
    got = tree_leaves(got)
    want = [np.asarray(w, dtype=np.float32)
            for w in jax.tree.leaves(_np_tree(want))]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol * scale,
                                   err_msg=f"{what}, leaf {i}")


def test_spec_helpers():
    s = Spec((4, 6), ("embed", "mlp"))
    with pytest.raises(ValueError):
        Spec((4,), ("embed", "mlp"))
    tree = {"b": s, "a": {"w": Spec((3,), ("embed",), "ones")}}
    st = stack_specs(tree, 5)
    assert st["b"].shape == (5, 4, 6) and st["b"].axes[0] == "layers"
    assert axes_tree(tree) == {"b": ("embed", "mlp"), "a": {"w": ("embed",)}}
    ab = abstract_params(tree, "float32")
    assert ab["b"].device.type == "meta" and ab["b"].shape == (4, 6)
    g = torch.Generator().manual_seed(0)
    p = init_params(tree, g, "float32")
    assert p["a"]["w"].eq(1).all() and p["b"].dtype == torch.float32
    # normal leaves scale by 1/sqrt(fan_in): std near 1/2 over 10^4 draws
    big = init_params(Spec((4, 2500), (None, None)),
                      torch.Generator().manual_seed(1), "float32")
    assert abs(float(big.std()) - 0.5) < 0.02
    again = init_params(tree, torch.Generator().manual_seed(0), "float32")
    assert torch.equal(again["b"], p["b"])


def test_params_from_numpy_keeps_the_reference_tree():
    cfg, model, params, ref_model, ref_params, _ = _case("olmo-1b")
    ref_leaves = jax.tree.leaves(ref_params)
    leaves = tree_leaves(params)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bf = params_from_numpy({"w": np.asarray(jnp.arange(4.0,
                                                       dtype=jnp.bfloat16))},
                           device="cpu")
    assert bf["w"].dtype == torch.bfloat16
    assert bf["w"].float().tolist() == [0.0, 1.0, 2.0, 3.0]


def test_entry_points_default_to_the_card():
    """``params_from_numpy`` and ``init_cache`` put their tensors on the
    card unless the CPU is asked for, and raise without CUDA rather than
    fall back to the CPU."""
    model = build_model(dataclasses.replace(
        get_config("olmo-1b").reduced(), dtype="float32"))
    tree = {"w": np.ones(3, np.float32)}
    if torch.cuda.is_available():
        assert params_from_numpy(tree)["w"].device.type == "cuda"
        assert tree_leaves(model.init_cache(1, 4))[0].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            params_from_numpy(tree)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init_cache(1, 4)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"
    assert tree_leaves(model.init_cache(1, 4, device="cpu"))[0] \
        .device.type == "cpu"


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_reference(arch):
    cfg, model, params, ref_model, ref_params, batch = _case(arch)
    want_logits, want_cache = jax.jit(ref_model.forward)(
        ref_params, _ref_batch(batch, "float32"))
    with torch.no_grad():
        logits, cache = model.forward(params, _port_batch(batch, "float32"))
    seq = batch["tokens"].shape[1]
    assert logits.shape == (B, seq, cfg.vocab_padded)
    assert logits.dtype == torch.float32
    _close(logits, want_logits, ATOL, f"{arch} logits")
    _close(cache, want_cache, ATOL, f"{arch} caches")


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_reference(arch):
    """16 decode steps from an empty cache (whisper's cross K/V from the
    encoder): every step's logits and the final caches."""
    cfg, model, params, ref_model, ref_params, batch = _case(arch)
    toks = batch["tokens"][:, :STEPS]
    ref_cache = ref_model.init_cache(B, STEPS, jnp.float32)
    cache = model.init_cache(B, STEPS, torch.float32, device="cpu")
    with torch.no_grad():
        if cfg.family == "encdec":
            rb = _ref_batch(batch, "float32")
            enc = ref_model.encode(ref_params, rb["frames"])
            ref_cache["cross_kv"] = tuple(ref_model.encoder_kv(ref_params,
                                                               enc))
            enc_t = model.encode(params, _port_batch(batch,
                                                     "float32")["frames"])
            cache["cross_kv"] = model.encoder_kv(params, enc_t)
            _close(cache["cross_kv"], ref_cache["cross_kv"], ATOL,
                   f"{arch} cross K/V")
        step = jax.jit(ref_model.decode_step)
        for t in range(STEPS):
            want, ref_cache = step(ref_params, ref_cache,
                                   jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                   jnp.full((B,), t, jnp.int32))
            got, cache = model.decode_step(
                params, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
                torch.full((B,), t, dtype=torch.long))
            _close(got, want, ATOL, f"{arch} decode step {t}")
    _close(cache["layers"], ref_cache["layers"], ATOL, f"{arch} caches")


def test_forward_bf16_error_as_the_reference():
    """olmo-1b's reduced config at its own dtype (bfloat16): the port's
    error against the float32 forward on the same weights is the
    reference's, within 10% in the mean and 50% in the maximum (see the
    module docstring for why 2e-2 elementwise does not apply)."""
    cfg, model, params, ref_model, ref_params, batch = _case("olmo-1b",
                                                             "bfloat16")
    assert params["embed"]["tok"].dtype == torch.bfloat16
    ref_bf16 = np.asarray(jax.jit(ref_model.forward)(
        ref_params, _ref_batch(batch, "bfloat16"))[0], np.float32)
    ref32 = ref_build_model(dataclasses.replace(ref_model.cfg,
                                                dtype="float32"))
    want = np.asarray(jax.jit(ref32.forward)(
        jax.tree.map(lambda a: a.astype(jnp.float32), ref_params),
        _ref_batch(batch, "float32"))[0])
    with torch.no_grad():
        got = model.forward(params, _port_batch(batch, "bfloat16"))[0]
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err, ref_err = np.abs(got - want), np.abs(ref_bf16 - want)
    assert err.mean() <= 1.1 * ref_err.mean(), (err.mean(), ref_err.mean())
    assert err.max() <= 1.5 * ref_err.max(), (err.max(), ref_err.max())


def test_decode_consistency_with_forward():
    """The reference's own check on the port alone: token-by-token decode
    matches the full forward (f32, lossless MoE capacity)."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              dtype="float32", capacity_factor=8.0)
    model = build_model(cfg)
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         "float32")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, STEPS))).long()
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(B, STEPS, torch.float32, device="cpu")
        for t in range(STEPS):
            lg, cache = model.decode_step(params, cache, toks[:, t:t + 1],
                                          torch.full((B,), t))
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=2e-2, atol=2e-2)


def test_binary_ffn_sign_straight_through():
    """sign(0) = +1; the backward passes the gradient where |x| <= 1."""
    x = torch.tensor([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 3.0],
                     requires_grad=True)
    y = L._sign_ste(x)
    assert y.tolist() == [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0, 1.0]
    y.sum().backward()
    assert x.grad.tolist() == [0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.0]


def test_remat_values():
    cfg = get_config("olmo-1b").reduced()
    for r in ("none", "full", "dots"):
        assert build_model(cfg, remat=r).remat == r
    with pytest.raises(ValueError):
        build_model(cfg, remat="everything")


IN_PLACE = ["olmo-1b", "granite-moe-1b-a400m", "mamba2-370m",
            "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", IN_PLACE)
def test_decode_updates_a_plain_cache_in_place(arch):
    """Three decode steps on a plain cache of seeded values, the slots at
    different positions: ``decode_step`` returns the cache it was given,
    every leaf keeps its storage, each slot's K/V change at row ``pos[b]``
    alone, and every leaf (the Mamba states too) is within 1e-4 of its
    scale of the cache the reference's ``decode_step`` returns from the
    same values. Every attention layer's call takes the kernel's path."""
    from repro_torch.obs import metrics
    cfg, model, params, ref_model, ref_params, batch = _case(arch)
    toks = batch["tokens"]
    cache = model.init_cache(B, S, torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in tree_leaves(cache):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    ref_cache = jax.tree.unflatten(
        jax.tree.structure(ref_model.init_cache(B, S, jnp.float32)),
        # copies: the port's step writes these tensors' memory in place
        [jnp.array(leaf.numpy()) for leaf in tree_leaves(cache)])
    ref_step = jax.jit(ref_model.decode_step)
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    n_attn = sum(m == "attn" for m, _ in model.kinds) * model.n_groups
    kernel = metrics.counter("attention.decode.kernel")
    plain = metrics.counter("attention.decode.plain")

    with torch.no_grad():
        for t in range(3):
            pos = np.array([3 + t, 17 + t])
            before = tree_map(torch.clone, cache)
            k0, p0 = kernel.value, plain.value
            _, new = model.decode_step(
                params, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
                torch.from_numpy(pos))
            assert (kernel.value - k0, plain.value - p0) == (n_attn, 0)
            _, ref_cache = ref_step(ref_params, ref_cache,
                                    jnp.asarray(toks[:, t:t + 1], jnp.int32),
                                    jnp.asarray(pos, jnp.int32))
            assert new is cache
            assert [x.data_ptr() for x in tree_leaves(cache)] == ptrs
            _close(cache, ref_cache, ATOL, f"{arch} caches, step {t}")
            at = torch.zeros(B, S, dtype=torch.bool)
            at[torch.arange(B), torch.from_numpy(pos)] = True
            for name, sub in cache["layers"].items():
                for kv in set(sub) & {"k", "v"}:
                    old = before["layers"][name][kv]
                    moved = (sub[kv] != old).any(-1).any(-1)
                    assert torch.equal(moved, at.expand_as(moved)), \
                        (arch, t, name, kv)
