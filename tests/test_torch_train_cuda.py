"""The training half on the card equals its CPU run (card only).

For reduced float32 configs, on the same seeded parameters and batch: the
loss and every gradient leaf on ``cuda`` agree with the CPU within 1e-3 of
each leaf's scale (its largest magnitude, at least 1), under ``remat``
``"none"`` and ``"full"``; AdamW's update with float32 and int8 moments,
given the same gradients, agrees within 1e-6 relative (int8 codes within
one step); and the launcher trains the reduced olmo-1b on the card,
timing each step with CUDA events. Marked ``cuda``: the tests skip without
a card. They import nothing of the reference package, so they run where
jax is absent.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.configs import TrainConfig, get_config  # noqa: E402
from repro_torch.data import SyntheticLM, make_global_batch  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import (init_params, tree_leaves,  # noqa: E402
                                     tree_map)
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import make_grad_fn  # noqa: E402

ARCHS = ["olmo-1b", "mamba2-370m", "granite-moe-1b-a400m", "matpim-bnn"]
TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, want, what, tol=TOL):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what}, leaf {i}")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_card_gradients_equal_cpu(cuda, arch, remat):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build_model(cfg)
    params = init_params(model.specs(), torch.Generator().manual_seed(0),
                         "float32")
    batch = SyntheticLM(cfg, batch=4, seq=32, seed=1).at_step(0)
    grad_fn = make_grad_fn(model, TrainConfig(remat=remat))
    loss, grads = grad_fn(params, make_global_batch(
        batch, make_local_mesh("cpu"), "float32"))
    gl, gg = grad_fn(tree_map(lambda t: t.to(cuda), params),
                     make_global_batch(batch, make_local_mesh(cuda),
                                       "float32"))
    assert abs(gl.item() - loss.item()) <= TOL * max(1.0, abs(loss.item()))
    _close(gg, grads, f"{arch} {remat}")


@pytest.mark.cuda
@pytest.mark.parametrize("opt_dtype", ["float32", "int8"])
def test_card_optimizer_equals_cpu(cuda, opt_dtype):
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 96), "b": (96,), "s": ()}
    opt = AdamW(TrainConfig(lr=1e-3, opt_state_dtype=opt_dtype))
    params = {k: torch.from_numpy(np.asarray(rng.standard_normal(s),
                                             np.float32))
              for k, s in shapes.items()}
    cpu = (params, opt.init(params))
    card = tree_map(lambda t: t.to(cuda), cpu)
    for _ in range(5):
        g = {k: torch.from_numpy(np.asarray(rng.standard_normal(s),
                                            np.float32))
             for k, s in shapes.items()}
        cpu = opt.update(g, cpu[1], cpu[0])
        card = opt.update(tree_map(lambda t: t.to(cuda), g), card[1],
                          card[0])
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        a = a.cpu()
        if a.dtype == torch.int8:
            assert (a.int() - b.int()).abs().max() <= 1
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0)


@pytest.mark.cuda
def test_launcher_trains_on_the_card(cuda):
    rep = train("olmo-1b", smoke=True, steps=3, batch=4, seq=32,
                remat="full", opt_dtype="int8", microbatches=2)
    assert len(rep["losses"]) == 3
    assert all(np.isfinite(rep["losses"]))
    assert len(rep["step_ms"]) == 3 and min(rep["grads_ms"]) > 0
    assert rep["peak_memory_bytes"] > 0
    assert all(t.device.type == "cuda" for t in tree_leaves(rep["params"]))


@pytest.mark.cuda
def test_train_profile_on_the_card(cuda):
    from repro_torch.launch.train_profile import profile_step
    rep = profile_step("olmo-1b-smoke", batch=4, seq=32, remat="full")
    prof, mem = rep["profile"], rep["memory"]
    assert 0 < prof["busy_ms"] <= prof["wall_ms"] and prof["kernels"] > 0
    assert mem["resident_bytes"] > 0
    assert mem["grads"]["peak_bytes"] > 0 and mem["update"]["peak_bytes"] > 0
