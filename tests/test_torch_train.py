"""The port's train step against the reference.

Reduced float32 configs of olmo-1b, mamba2-370m and granite-moe-1b-a400m
(the reference's ``TRAIN_DEFAULT``) and matpim-bnn, on the reference's
own parameters (``init_params(PRNGKey(0))`` carried across by
``params_from_numpy``) and ``SyntheticLM`` batches:

* the loss is within 1e-4 of its scale (its magnitude, at least 1) of
  JAX's ``value_and_grad`` with ``remat="none"`` (the reference's values
  do not depend on remat), the measure the forward tests use. Every
  gradient leaf is within 5e-4 of that leaf's scale (its largest
  magnitude, at least 1) of JAX's, and of the port's own gradients in
  float64 on the same weights. 1e-4 is below float32's own error here:
  against float64 the reference's float32 gradients are off by up to
  1.7e-4 of scale (olmo-1b's ``wk``) and the port's by up to 2.4e-4
  (granite's ``norm2``). Port against reference measured at most 2.2e-4;
* mamba2's float32 gradients are, leaf by leaf, at most 2x the
  reference's distance from float64 (measured at most 1.14x). Torch's CPU
  BLAS sums the mamba projections' 64-wide contraction in one float32
  chain, which rounds ~1.7x further from float64 than XLA's CPU dot, and
  the SSD stack grows that rounding into the gradients: before the port
  split the projections into four partial products
  (``models/mamba.py::_proj``) its leaves sat 1.2e-4-1.7e-4 of scale from
  float64 where the reference's sit 1.4e-5-3.2e-5 (up to 6.2x). The
  forward of the projections alone closes the gap: the backward in
  float32 over a float64 forward sits at 0.78x the reference's. Over
  twelve batch seeds the largest leaf distance is 0.90x the reference's
  (geometric mean; 2.19x before), and a single leaf still exceeds 2x in
  three of them (at most 2.9x), as rounding amplified by the scan falls;
* on the port, ``remat`` ``"none"``, ``"full"`` and ``"dots"`` give
  bit-equal loss and gradients, and "full" and "dots" recompute in the
  backward pass ("full" every product, "dots" only those over a batch);
* ``microbatches=2`` accumulates in the parameters' dtype and matches the
  reference's accumulated step: float32 gradients within the tolerance
  above of the reference's two microbatch gradients summed and halved,
  loss and gradient norm within 1e-5 relative of its ``train_step``'s, and
  the new parameters within 1e-6 where the gradient stands above rounding
  noise (Adam's first step moves every other parameter by ±lr whatever its
  size). On a bfloat16 config the port's gradients are the bfloat16 sum of
  its own microbatch gradients, halved, bit for bit, and the loss is
  within 1e-2 relative of the reference's (measured 1.6e-3-2.7e-3 over
  three seeds; bfloat16 rounding in another order). The bfloat16 gradient
  norms are not compared: in both frameworks they move 3-26% from the
  float32 norm on the same weights;
* matpim-bnn's loss falls over 10 steps (the reference's
  ``test_binary_ffn_model``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.spec import init_params as ref_init_params  # noqa: E402
from repro.train import make_loss_fn as ref_make_loss_fn  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import (params_from_numpy,  # noqa: E402
                                     tree_leaves, tree_map)
from repro_torch.train import (make_grad_fn, make_train_step,  # noqa: E402
                               xent_loss)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

ARCHS = ["olmo-1b", "mamba2-370m", "granite-moe-1b-a400m", "matpim-bnn"]
B, S = 4, 16
LOSS_TOL = 1e-4
GRAD_TOL = 5e-4
_CASES = {}


def _case(arch, dtype="float32"):
    """(port model, port params, reference model, reference params, numpy
    batch) for one arch's reduced config, memoized."""
    key = (arch, dtype)
    if key not in _CASES:
        ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                      dtype=dtype)
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
        ref_model = ref_build_model(ref_cfg)
        ref_params = ref_init_params(ref_model.specs(),
                                     jax.random.PRNGKey(0), dtype)
        model = build_model(cfg)
        params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
        batch = SyntheticLM(cfg, batch=B, seq=S, seed=ARCHS.index(arch)
                            ).at_step(0)
        _CASES[key] = (model, params, ref_model, ref_params, batch)
    return _CASES[key]


def _port(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _ref_value_and_grad(ref_model, ref_params, batch):
    ref_model.remat = "none"
    fn = jax.jit(jax.value_and_grad(ref_make_loss_fn(ref_model)))
    return fn(ref_params, _ref(batch))


def _close(got, want, what, atol=GRAD_TOL):
    got = [g.double().numpy() for g in tree_leaves(got)]
    want = [np.asarray(w, np.float64) for w in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol * scale,
                                   err_msg=f"{what}, leaf {i}")


def test_xent_loss_matches_reference():
    from repro.train import xent_loss as ref_xent
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 11)) * 4).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want = float(ref_xent(jnp.asarray(logits), jnp.asarray(targets)))
    got = xent_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    assert abs(got.item() - want) <= 1e-6 * abs(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    model, params, ref_model, ref_params, batch = _case(arch)
    want_loss, want_grads = _ref_value_and_grad(ref_model, ref_params, batch)
    tc = TrainConfig(remat="none")
    loss, grads = make_grad_fn(model, tc)(params, _port(batch))
    scale = max(1.0, abs(float(want_loss)))
    assert abs(loss.item() - float(want_loss)) <= LOSS_TOL * scale
    _close(grads, want_grads, f"{arch} grads")
    for g, p in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.dtype == p.dtype and not g.requires_grad
    wide = build_model(dataclasses.replace(model.cfg, dtype="float64"))
    _, grads64 = make_grad_fn(wide, tc)(tree_map(lambda t: t.double(), params),
                                        _port(batch))
    _close(grads, tree_leaves(grads64), f"{arch} grads against float64")


def test_mamba2_f32_grads_as_close_to_float64_as_the_reference():
    """Each mamba2 leaf's float32 gradient lies at most 2x as far from the
    port's float64 gradient as the reference's float32 one, each distance
    the largest absolute difference over the leaf's scale."""
    model, params, ref_model, ref_params, batch = _case("mamba2-370m")
    _, want = _ref_value_and_grad(ref_model, ref_params, batch)
    tc = TrainConfig(remat="none")
    _, got = make_grad_fn(model, tc)(params, _port(batch))
    wide = build_model(dataclasses.replace(model.cfg, dtype="float64"))
    _, exact = make_grad_fn(wide, tc)(tree_map(lambda t: t.double(), params),
                                      _port(batch))
    leaves = zip(tree_leaves(got), jax.tree.leaves(want), tree_leaves(exact))
    for i, (g, w, e) in enumerate(leaves):
        e = e.numpy()
        scale = max(1.0, float(np.abs(e).max()))
        port = float(np.abs(g.double().numpy() - e).max()) / scale
        ref = float(np.abs(np.asarray(w, np.float64) - e).max()) / scale
        assert port <= 2 * ref, (i, port, ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_values_give_equal_gradients(arch):
    model, params, *_, batch = _case(arch)
    runs = {}
    for remat in ("none", "full", "dots"):
        runs[remat] = make_grad_fn(model, TrainConfig(remat=remat))(
            params, _port(batch))
    model.remat = "none"
    base_loss, base = runs["none"]
    for remat in ("full", "dots"):
        loss, grads = runs[remat]
        assert torch.equal(loss, base_loss), remat
        for a, b in zip(tree_leaves(grads), tree_leaves(base)):
            assert torch.equal(a, b), remat


class _CountBmm(TorchDispatchMode):
    """Counts ``aten.bmm`` calls (every ``torch.einsum`` product), and
    those over a batch of more than one."""

    def __init__(self):
        super().__init__()
        self.all = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.bmm.default:
            self.all += 1
            self.batched += args[0].shape[0] > 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_in_the_backward_pass():
    """The backward pass of "full" reruns every forward product, that of
    "dots" only the products over a batch (attention), keeping those
    without one; with gradients on, no cache comes back."""
    model, params, *_, batch = _case("olmo-1b")
    counts = {}
    for remat in ("none", "full", "dots"):
        model.remat = remat
        tree = tree_map(lambda t: t.detach().requires_grad_(True), params)
        logits, cache = model.forward(tree, _port(batch))
        assert (cache is None) == (remat != "none")
        with _CountBmm() as n:
            torch.autograd.grad(logits.sum(), tree_leaves(tree))
        counts[remat] = (n.all, n.batched)
    model.remat = "none"
    batched = 2 * model.n_groups          # attention scores and PV
    none, full, dots = counts["none"], counts["full"], counts["dots"]
    assert full[1] == dots[1] == none[1] + batched, counts
    assert dots[0] == none[0] + batched, counts
    assert full[0] > dots[0], counts        # and the projections
    with torch.no_grad():
        model.remat = "full"
        _, cache = model.forward(params, _port(batch))
        model.remat = "none"
    assert cache is not None


def _ref_microbatch_grads(ref_model, ref_params, batch, n):
    """The reference's per-microbatch gradients, summed and halved."""
    tot = None
    for i in range(n):
        mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
              for k, v in batch.items()}
        _, g = _ref_value_and_grad(ref_model, ref_params, mb)
        tot = g if tot is None else jax.tree.map(jnp.add, tot, g)
    return jax.tree.map(lambda a: a / n, tot)


def test_microbatches_match_reference_f32():
    model, params, ref_model, ref_params, batch = _case("olmo-1b")
    tc = TrainConfig(lr=1e-3, microbatches=2, remat="none")
    loss, grads = make_grad_fn(model, tc)(params, _port(batch))
    _close(grads, _ref_microbatch_grads(ref_model, ref_params, batch, 2),
           "microbatch grads")
    ref_step, ref_opt = ref_make_train_step(
        ref_model, RefTrainConfig(lr=1e-3, microbatches=2, remat="none"))
    want_p, _, want_m = jax.jit(ref_step)(ref_params,
                                          ref_opt.init(ref_params),
                                          _ref(batch))
    step, opt = make_train_step(model, tc)
    got_p, got_s, got_m = step(params, opt.init(params), _port(batch))
    assert got_s["step"].item() == 1
    for k in ("loss", "grad_norm"):
        w = float(want_m[k])
        assert abs(got_m[k].item() - w) <= 1e-5 * abs(w), k
    for g, p, w in zip(tree_leaves(grads), tree_leaves(got_p),
                       jax.tree.leaves(want_p)):
        sure = g.abs() > 1e-3 * max(1e-6, float(g.abs().max()))
        w = torch.from_numpy(np.array(w))
        np.testing.assert_allclose(p[sure].numpy(), w[sure].numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_microbatches_accumulate_in_bf16():
    model, params, ref_model, ref_params, batch = _case("olmo-1b",
                                                       "bfloat16")
    tc = TrainConfig(microbatches=2, remat="none")
    loss, grads = make_grad_fn(model, tc)(params, _port(batch))
    one = make_grad_fn(model, TrainConfig(remat="none"))
    halves = [one(params, {k: v[i * B // 2:(i + 1) * B // 2]
                           for k, v in _port(batch).items()})
              for i in range(2)]
    for i, g in enumerate(tree_leaves(grads)):
        a, b = (tree_leaves(h[1])[i] for h in halves)
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, (torch.zeros_like(a) + a + b) / 2), i
    assert loss.item() == ((halves[0][0] + halves[1][0]) / 2).item()
    ref_step, ref_opt = ref_make_train_step(
        ref_model, RefTrainConfig(microbatches=2, remat="none"))
    _, _, want = jax.jit(ref_step)(ref_params, ref_opt.init(ref_params),
                                   _ref(batch))
    w = float(want["loss"])
    assert abs(loss.item() - w) <= 1e-2 * abs(w), (loss.item(), w)


def test_binary_ffn_model_trains():
    """The paper's technique as a first-class feature: BNN FFN trains
    (straight-through gradients flow through sign())."""
    model, params, *_ = _case("matpim-bnn")
    assert model.cfg.binary_ffn
    step, opt = make_train_step(model, TrainConfig(lr=1e-3))
    s = opt.init(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, model.cfg.vocab, (B, S))).long()}
    batch["targets"] = torch.roll(batch["tokens"], -1, dims=1)
    p, losses = params, []
    for _ in range(10):
        p, s, met = step(p, s, batch)
        losses.append(met["loss"].item())
    assert losses[-1] < losses[0], losses
