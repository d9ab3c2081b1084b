"""The port's analytic roofline (``launch/analytic.py``) equals the
reference's, value for value, for every config × ``SHAPES`` × remat ×
optimizer dtype, and ``roofline_ms`` divides by the rates it is given
(the port holds no device constant)."""
import math

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import TrainConfig as RefTrainConfig  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import analytic as ref  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import (REGISTRY, SHAPES, ShapeConfig,  # noqa: E402
                                 TrainConfig, get_config)
from repro_torch.launch import analytic  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.spec import abstract_params, param_count  # noqa: E402

ARCHS = sorted(REGISTRY)


def _n_params(arch):
    return param_count(abstract_params(build_model(get_config(arch)).specs()))


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_equals_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    n = _n_params(arch)
    ref_specs = ref_build_model(ref_cfg).specs()
    import jax
    assert n == sum(math.prod(s.shape) for s in jax.tree.leaves(
        ref_specs, is_leaf=lambda x: hasattr(x, "axes")))
    assert analytic.param_bytes(cfg, n) == ref.param_bytes(ref_cfg, n)
    for name, shape in SHAPES.items():
        ref_shape = REF_SHAPES[name]
        assert analytic.forward_flops(cfg, shape) == \
            ref.forward_flops(ref_cfg, ref_shape)
        assert analytic.cache_bytes(cfg, shape) == \
            ref.cache_bytes(ref_cfg, ref_shape)
        assert analytic.act_bytes(cfg, shape) == \
            ref.act_bytes(ref_cfg, ref_shape)
        for remat in ("none", "full", "dots"):
            for opt in ("float32", "int8"):
                tc = TrainConfig(remat=remat, opt_state_dtype=opt)
                rtc = RefTrainConfig(remat=remat, opt_state_dtype=opt)
                assert analytic.cell_flops(cfg, shape, tc) == \
                    ref.cell_flops(ref_cfg, ref_shape, rtc)
                assert analytic.cell_bytes(cfg, shape, tc, n) == \
                    ref.cell_bytes(ref_cfg, ref_shape, rtc, n)


def test_roofline_of_olmo_train_step():
    """olmo-1b, 8 × 256 tokens: 1.90e13 flops with full remat (1.46e13
    without); 3.43e10 bytes with float32 moments, 2.02e10 with int8."""
    cfg = get_config("olmo-1b")
    shape = ShapeConfig("train_8x256", 256, 8, "train")
    n = _n_params("olmo-1b")
    assert n == 1_177_026_560
    full = analytic.cell_flops(cfg, shape, TrainConfig(remat="full"))
    none = analytic.cell_flops(cfg, shape, TrainConfig(remat="none"))
    assert round(full / 1e11) == 190 and round(none / 1e11) == 146
    f32 = analytic.cell_bytes(cfg, shape, TrainConfig(), n)
    int8 = analytic.cell_bytes(cfg, shape,
                               TrainConfig(opt_state_dtype="int8"), n)
    assert round(f32 / 1e8) == 343 and round(int8 / 1e8) == 202
    r = analytic.roofline_ms(full, f32, 989e12, 3.35e12)
    assert r["bound_by"] == "operations"
    assert r["bound_ms"] == full / 989e12 * 1e3
    assert r["bytes_ms"] == f32 / 3.35e12 * 1e3
    r = analytic.roofline_ms(1.0, 1e9, 1e12, 1e12)
    assert r["bound_by"] == "bytes" and r["bound_ms"] == 1.0
