"""The port's tree helpers and optimizers against the reference.

* ``tree_map``/``tree_leaves`` rebuild a ``NamedTuple`` field by field and
  visit leaves in ``jax.tree.flatten``'s order.
* ``_quantize``/``_dequantize``: equal codes and scales on seeded arrays,
  0-d included.
* ``AdamW`` on the same numpy parameters and gradients over 5 steps. With
  float32 moments the port's parameters and state equal the reference's
  bit for bit (measured: every leaf, every step). With int8 moments XLA's
  CPU backend contracts ``b2 * v + (1 - b2) * g * g`` into one fused
  multiply-add where ``v`` is dequantized inside the same fusion; the
  port rounds the product and the sum apiece, so ``v`` differs by up to an
  ulp and its per-row scale (``max sqrt(v) / 127``) by up to 2.6e-7
  relative (the most measured over 20 five-step runs of these shapes).
  The test holds the int8 state's scales and float32 parameters to 1e-6
  relative, bfloat16 parameters to one bf16 step (2^-8), and the codes
  equal but for at most one code step where ``x / scale`` falls within
  that rounding of a .5 boundary (no code differed in those runs, nor in
  12 000 two-step runs of 2–8 elements).
* ``lr_at`` equal at steps 1, 50, 100, 101, 5000 and 20000.
* ``grad_compress`` over 5 steps of error feedback within 1e-6 of each
  leaf's scale (a mean in another summation order), ``compression_stats``
  equal.
"""
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import TrainConfig as RefTrainConfig  # noqa: E402
from repro.optim import grad_compress as ref_gc  # noqa: E402
from repro.optim import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.models.spec import (tree_leaves, tree_map,  # noqa: E402
                                     tree_unflatten)
from repro_torch.optim import grad_compress, optimizer  # noqa: E402
from repro_torch.optim.optimizer import (AdamW, QTensor,  # noqa: E402
                                         make_optimizer)

SHAPES = {"w": (16, 32), "b": (32,), "s": (), "e": (3, 4, 64)}
STEPS = 5


class Pair(NamedTuple):
    second_declared_first: object
    a: object


def _np(shape, rng, scale=1.0):
    return np.asarray(rng.standard_normal(shape) * scale, np.float32)


def _port_tree(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_tree_map_rebuilds_named_tuples_in_jax_order():
    rng = np.random.default_rng(0)
    tree = {"z": Pair(_np(2, rng), [_np(3, rng), (_np(1, rng),)]),
            "a": QTensor(_np(4, rng), _np(1, rng)),
            "m": {"y": _np(5, rng), "b": _np(6, rng)}}
    want = jax.tree.leaves(tree)
    got = tree_leaves(tree)
    assert [w.shape for w in want] == [g.shape for g in got]
    assert all(w is g for w, g in zip(want, got))
    mapped = tree_map(lambda a: a * 2, tree)
    assert type(mapped["z"]) is Pair and type(mapped["a"]) is QTensor
    assert mapped["z"]._fields == ("second_declared_first", "a")
    np.testing.assert_array_equal(mapped["a"].scale, tree["a"].scale * 2)
    assert list(mapped) == ["z", "a", "m"]     # dict order kept
    back = tree_unflatten(tree, [a + 1 for a in got])
    np.testing.assert_array_equal(back["z"].a[1][0], tree["z"].a[1][0] + 1)
    with pytest.raises(ValueError):
        tree_unflatten(tree, got[:-1])


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (4, 3, 64)])
def test_quantize_matches_reference(shape):
    rng = np.random.default_rng(len(shape) * 10 + sum(shape))
    for x in (_np(shape, rng), _np(shape, rng, 1e-6),
              np.zeros(shape, np.float32)):
        want = ref_opt._quantize(jnp.asarray(x))
        got = optimizer._quantize(torch.from_numpy(x))
        assert isinstance(got, QTensor)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
        np.testing.assert_array_equal(
            optimizer._dequantize(got, shape).numpy(),
            np.asarray(ref_opt._dequantize(want, shape)))


def test_quantize_rounds_half_to_even():
    # x / scale = k + 0.5 exactly: 127 / 127 sets scale to 1 (+1e-12)
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    assert optimizer._quantize(x).q.tolist() == [127, 0, 2, 2, 0, -2]


def test_lr_schedule_matches_reference():
    for lr in (1e-3, 3e-4):
        ref = ref_opt.AdamW(RefTrainConfig(lr=lr))
        port = AdamW(TrainConfig(lr=lr))
        for step in (0, 1, 50, 99, 100, 101, 5000, 10100, 20000):
            want = np.asarray(ref.lr_at(jnp.asarray(step, jnp.int32)))
            got = port.lr_at(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert got.item() == want.item(), (lr, step)


def _close_state(got, want, what):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (what, i)
        if g.dtype == np.int8:
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (what, i)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0,
                                       err_msg=f"{what}, leaf {i}")


@pytest.mark.parametrize("opt_dtype", ["float32", "int8"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(opt_dtype, param_dtype):
    rng = np.random.default_rng({"float32": 0, "int8": 1}[opt_dtype])
    tc = TrainConfig(lr=1e-3, opt_state_dtype=opt_dtype)
    ref = ref_opt.AdamW(RefTrainConfig(lr=1e-3, opt_state_dtype=opt_dtype))
    port = make_optimizer(tc)
    params = {k: _np(s, rng) for k, s in SHAPES.items()}
    rp = {k: jnp.asarray(v, param_dtype) for k, v in params.items()}
    pp = {k: torch.from_numpy(v).to(getattr(torch, param_dtype))
          for k, v in params.items()}
    rs, ps = ref.init(rp), port.init(pp)
    _close_state(ps, rs, "init")
    exact = opt_dtype == "float32"
    for step in range(STEPS):
        # gradients over four decades, the same numpy arrays to both
        g = {k: _np(s, rng, 10.0 ** rng.uniform(-3, 1))
             for k, s in SHAPES.items()}
        rp, rs = ref.update({k: jnp.asarray(v, param_dtype)
                             for k, v in g.items()}, rs, rp)
        pp, ps = port.update({k: torch.from_numpy(v).to(
            getattr(torch, param_dtype)) for k, v in g.items()}, ps, pp)
        assert ps["step"].item() == step + 1
        for k in SHAPES:
            got = pp[k].float().numpy()
            want = np.asarray(rp[k].astype(jnp.float32))
            assert pp[k].dtype == getattr(torch, param_dtype)
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=k)
            else:
                # bfloat16 parameters: one bf16 step where the float32
                # values straddle a rounding boundary
                tol = 1e-6 if param_dtype == "float32" else 2 ** -8
                np.testing.assert_allclose(got, want, rtol=tol, atol=0,
                                           err_msg=k)
        if exact:
            for g_, w_ in zip(tree_leaves(ps), jax.tree.leaves(rs)):
                np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
        else:
            _close_state(ps, rs, f"step {step}")


def test_adamw_update_leaves_its_arguments():
    tc = TrainConfig(opt_state_dtype="int8")
    opt = AdamW(tc)
    p = {"w": torch.ones(4, 8)}
    s = opt.init(p)
    assert isinstance(s["mu"]["w"]["m"], QTensor)
    before = [t.clone() for t in tree_leaves((p, s))]
    opt.update({"w": torch.full((4, 8), 0.5)}, s, p)
    for a, b in zip(tree_leaves((p, s)), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opt_dtype", ["float32", "int8"])
def test_abstract_init_allocates_nothing(opt_dtype):
    tc = TrainConfig(opt_state_dtype=opt_dtype)
    params = {k: torch.empty(s, device="meta") for k, s in SHAPES.items()}
    got = AdamW(tc).abstract_init(params)
    ref = ref_opt.AdamW(RefTrainConfig(opt_state_dtype=opt_dtype))
    want = ref.abstract_init({k: jax.ShapeDtypeStruct(s, jnp.float32)
                              for k, s in SHAPES.items()})
    got_l, want_l = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    concrete = AdamW(tc).init({k: torch.zeros(s) for k, s in SHAPES.items()})
    assert [tuple(t.shape) for t in tree_leaves(concrete)] == \
        [tuple(t.shape) for t in got_l]


def test_grad_compress_matches_reference():
    rng = np.random.default_rng(3)
    grads = [{k: _np(s, rng) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    rerr = ref_gc.init_error({k: jnp.asarray(v) for k, v in grads[0].items()})
    perr = grad_compress.init_error(_port_tree(grads[0]))
    for g in grads:
        rout, rerr = ref_gc.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, rerr)
        pout, perr = grad_compress.compress_decompress(_port_tree(g), perr)
        for got, want in ((pout, rout), (perr, rerr)):
            for k in SHAPES:
                w = np.asarray(want[k])
                scale = max(1.0, float(np.abs(w).max()))
                np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                           atol=1e-6 * scale, err_msg=k)
    assert grad_compress.compression_stats(_port_tree(grads[0])) == \
        ref_gc.compression_stats({k: jnp.asarray(v)
                                  for k, v in grads[0].items()})


def test_grad_compress_refuses_a_process_group(monkeypatch):
    """A process group no longer refuses the compression: without an
    active mesh holding ``axis_name`` the all-reduce is the identity, as
    the reference's ``pmean`` outside ``shard_map`` is (the all-reduce
    over 'pod' ranks is held in ``tests/test_torch_dist.py``)."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    g = {"w": torch.tensor([1.0, -2.0, 3.0])}
    out, err = grad_compress.compress_decompress(
        g, grad_compress.init_error(g), axis_name="pod")
    assert torch.equal(out["w"], torch.tensor([2.0, -2.0, 2.0]))
    assert torch.equal(err["w"], torch.tensor([-1.0, 0.0, 1.0]))
