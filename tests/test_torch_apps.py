"""The port's application pipelines and configs against the reference's.

``repro_torch.apps`` — ``BinaryMLP`` built from a reference model's own ±1
``weights``, ``fault_sweep``, the three imaging pipelines and
``Pipeline([MatvecStage])`` — must give the reference's decoded outputs,
scores and per-stage reports (cycles, IO cycles, tiles, reduce depth equal;
nJ equal to ``rel=1e-12``) on ``backend="numpy"``, the sweeps at the same
seeds; ``repro_torch.configs`` must equal the reference registry. On the
CPU: the stages fetch their plans from a ``PlanService(device="cpu")``
and run with ``device="cpu"``, on ``torch`` and on ``kernels`` (the
kernels' plain versions).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from _config_parity import config_parity  # noqa: E402
from repro.apps import bnn as ref_bnn  # noqa: E402
from repro.apps import imaging as ref_imaging  # noqa: E402
from repro.apps import pipeline as ref_pipeline  # noqa: E402
from repro.configs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
import repro_torch.apps as apps  # noqa: E402
from repro_torch.apps import bnn, imaging, pipeline  # noqa: E402
from repro_torch.configs import ASSIGNED, REGISTRY, get_config  # noqa: E402
from repro_torch.serve import (PlanService, get_default_service,  # noqa
                               reset_default_service)

SMALL_KW = dict(rows=64, cols=256, parts=8)


@pytest.fixture(scope="module")
def svc():
    return PlanService(device="cpu", max_plans=64)


def _same_report(got, want):
    """Pipeline reports: name and profile equal, every stage's integers
    equal, energies to ``rel=1e-12``."""
    assert (got.name, got.profile, got.cycles) == \
        (want.name, want.profile, want.cycles)
    assert got.energy_nj == pytest.approx(want.energy_nj, rel=1e-12, abs=0)
    assert got.latency_ns == pytest.approx(want.latency_ns, rel=1e-12,
                                           abs=0)
    assert len(got.stages) == len(want.stages)
    for g, w in zip(got.stages, want.stages):
        assert (g.name, g.kind, g.cycles, g.io_cycles, g.n_tiles,
                g.reduce_depth, g.t_cycle_ns) == \
            (w.name, w.kind, w.cycles, w.io_cycles, w.n_tiles,
             w.reduce_depth, w.t_cycle_ns)
        assert g.array_nj == pytest.approx(w.array_nj, rel=1e-12, abs=0)
        assert g.io_nj == pytest.approx(w.io_nj, rel=1e-12, abs=0)


def _models(svc, which):
    """(reference model, port model on the reference's weights)."""
    if which == "config":
        ref = ref_bnn.BinaryMLP.from_config(n_layers=3)
        kw = {}
    else:     # quickstart §5: a [64, 64, 16] net on the small geometry
        ref = ref_bnn.BinaryMLP.random([64, 64, 16], seed=0,
                                       plan_kw=SMALL_KW)
        kw = SMALL_KW
    port = bnn.BinaryMLP(ref.weights, name=ref.pipeline.name,
                         plan_kw=dict(kw, service=svc))
    return ref, port


@pytest.mark.parametrize("backend", ("torch", "kernels"))
@pytest.mark.parametrize("which", ("config", "quickstart"))
def test_bnn_forward_matches_reference(svc, which, backend):
    ref, port = _models(svc, which)
    assert port.dims == ref.dims
    x = np.random.default_rng(7).choice([-1, 1], size=ref.dims[0])
    y_ref, rep_ref = ref.forward(x, backend="numpy")
    y, rep = port.forward(x, backend=backend, device="cpu")
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(port.scores, ref.scores)
    _same_report(rep, rep_ref)
    assert rep.backend == backend
    assert [s.backend for s in rep.stages] == [backend] * len(port.stages)
    want_y, want_dots = port.reference(x)
    np.testing.assert_array_equal(y, want_y)
    np.testing.assert_array_equal(port.scores, want_dots)

    X = np.random.default_rng(3).choice([-1, 1], size=(9, ref.dims[0]))
    dots_ref, acts_ref = ref.forward_batch(X, backend="numpy")
    dots, acts = port.forward_batch(X, backend=backend, device="cpu")
    np.testing.assert_array_equal(dots, dots_ref)
    assert len(acts) == len(acts_ref) == len(port.weights) - 1
    for a, b in zip(acts, acts_ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        port.predict(X, backend=backend, device="cpu"),
        ref.predict(X, backend="numpy"))


def test_fault_sweep_matches_reference(svc):
    ref, port = _models(svc, "config")
    want = ref_bnn.fault_sweep(ref, [1e-4, 1e-3], samples=32, seed=2)
    got = bnn.fault_sweep(port, [1e-4, 1e-3], samples=32, seed=2,
                          device="cpu")
    assert [dataclasses.astuple(p) for p in got] == \
        [dataclasses.astuple(p) for p in want]


def test_bnn_fault_forward_matches_reference(svc):
    from repro.device import FaultModel as RefModel
    from repro_torch.device import FaultModel
    ref, port = _models(svc, "quickstart")
    x = np.random.default_rng(4).choice([-1, 1], size=ref.dims[0])
    y_ref, _ = ref.forward(x, faults=RefModel.uniform(3e-2), rng=5)
    y, _ = port.forward(x, faults=FaultModel.uniform(3e-2), rng=5,
                        device="cpu")
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(port.scores, ref.scores)


@pytest.mark.parametrize("name,backend", [
    ("edge_pipeline", "kernels"), ("sharpen_pipeline", "kernels"),
    ("sharpen_pipeline", "torch"), ("binary_edge_pipeline", "kernels")])
def test_imaging_pipelines_match_reference(svc, name, backend):
    img = imaging.demo_image()
    np.testing.assert_array_equal(img, ref_imaging.demo_image())
    out_ref, rep_ref = getattr(ref_imaging, name)(img.shape).run(img)
    out, rep = getattr(imaging, name)(img.shape, service=svc).run(
        img, backend=backend, device="cpu")
    np.testing.assert_array_equal(np.asarray(out, dtype=np.int64),
                                  np.asarray(out_ref, dtype=np.int64))
    _same_report(rep, rep_ref)
    if name == "edge_pipeline":
        np.testing.assert_array_equal(np.asarray(out, dtype=np.int64),
                                      imaging.edge_reference(img))
    if name == "sharpen_pipeline":
        want = np.clip(imaging.ref_correlate(img, imaging.KERNELS["sharpen"]),
                       0, 15)
        np.testing.assert_array_equal(np.asarray(out, dtype=np.int64), want)
    labels = [s.backend for s in rep.stages]
    if name == "binary_edge_pipeline":
        want_labels = ["host", "kernels:fallback-torch"]
    else:
        want_labels = [backend] * len(rep.stages)
    assert labels == want_labels


def test_matvec_pipeline_and_helpers_match_reference(svc):
    rng = np.random.default_rng(6)
    A = rng.integers(0, 256, size=(40, 30))
    x = rng.integers(0, 256, size=30)
    want, rep_ref = ref_pipeline.Pipeline(
        [ref_pipeline.MatvecStage(A, 8, **SMALL_KW)]).run(x)
    got, rep = pipeline.Pipeline(
        [pipeline.MatvecStage(A, 8, service=svc, **SMALL_KW)]).run(
            x, backend="kernels", device="cpu")
    np.testing.assert_array_equal(got.astype(np.int64),
                                  (A @ x) % (1 << 16))
    np.testing.assert_array_equal(got, want)
    _same_report(rep, rep_ref)
    assert rep.stages[0].backend == "kernels"
    v = np.array([3, 255, 128, 0], dtype=object)
    np.testing.assert_array_equal(pipeline.decode_signed(v, 8),
                                  ref_pipeline.decode_signed(v, 8))
    img = imaging.demo_image(20, 18, seed=4)
    np.testing.assert_array_equal(img, ref_imaging.demo_image(20, 18,
                                                              seed=4))
    for op in ("sobel", "roberts"):
        np.testing.assert_array_equal(
            imaging.edge_reference(img, op, blur=False),
            ref_imaging.edge_reference(img, op, blur=False))
    assert str(rep).splitlines()[1:] == str(rep_ref).splitlines()[1:]


def test_service_tiled_fetch_shares_plans(svc):
    a = svc.tiled("binary_matvec", 16, 32, rows=64, cols=256, parts=8)
    b = svc.tiled("binary_matvec", 16, 32, rows=64, cols=256, parts=8)
    c = svc.tiled("binary_matvec", 16, 32)           # service geometry
    assert a is b and c is not a
    assert (c.plan.rows, c.plan.cols) == (1024, 1024)
    conv = svc.tiled("conv", 12, 12, 3, 8, key_extra=b"k", **SMALL_KW)
    assert conv.plan.program is None             # the stage binds K first


def test_default_service_runs_on_cuda():
    reset_default_service()
    try:
        if torch.cuda.is_available():
            assert get_default_service().device.type == "cuda"
            assert get_default_service() is get_default_service()
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                get_default_service()
    finally:
        reset_default_service()


@pytest.mark.parametrize("name", sorted(REF_REGISTRY))
def test_configs_match_reference(name):
    """Every field of the reference's config, the port's equal, and each
    field the port adds (``configs/base.py``) at its default, for the
    config, its reduced form and its ``-smoke``."""
    got, want = get_config(name), ref_get_config(name)
    mine, must = config_parity(got, want)
    assert mine == must
    mine, must = config_parity(got.reduced(), want.reduced())
    assert mine == must
    mine, must = config_parity(get_config(name + "-smoke"),
                               ref_get_config(name + "-smoke"))
    assert mine == must
    layers = range(got.n_layers)
    assert (got.vocab_padded, got.di,
            [(got.is_attn_layer(i), got.is_moe_layer(i)) for i in layers]) \
        == (want.vocab_padded, want.di,
            [(want.is_attn_layer(i), want.is_moe_layer(i)) for i in layers])


def test_config_registry_and_lazy_apps_match_reference():
    import repro.apps as ref_apps
    import repro.configs as ref_configs
    assert sorted(REGISTRY) == sorted(REF_REGISTRY)
    assert ASSIGNED == ref_configs.ASSIGNED
    assert apps.__all__ == ref_apps.__all__
    for name in apps.__all__:
        assert getattr(apps, name) is not None
    with pytest.raises(AttributeError):
        apps.no_such_name  # noqa: B018


@pytest.mark.parametrize("module", [
    "repro_torch.apps.imaging", "repro_torch.apps.pipeline",
    "repro_torch.core.tiling", "repro_torch.device.energy",
    "repro_torch.device.faults", "repro_torch.serve.matpim"])
def test_docstring_examples(module):
    """The examples in the slice's modules run on the CPU as written."""
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(module))
    assert res.attempted > 0 and res.failed == 0
