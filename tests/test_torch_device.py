"""The port's device models against the reference's.

``repro_torch.device`` — the static energy model (``trace_energy``,
``energy_table``, ``io_energy_fj``, the plans' and tiled wrappers'
``energy()``), the Monte-Carlo sweeps and in-crossbar TMR — must give the
reference's numbers: integers (cycles, gate events, init cells, samples)
equal, floats (energies, EDP, error rates) equal to ``rel=1e-12``, the
sweeps at the same seeds against the reference's ``backend="numpy"``.
Small sizes (64 to 256 samples) on the CPU (``device="cpu"``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro.core import BinaryConvPlan as RefBConv  # noqa: E402
from repro.core import BinaryMatvecPlan as RefBMV  # noqa: E402
from repro.core import ConvPlan as RefConv  # noqa: E402
from repro.core import MatvecPlan as RefMV  # noqa: E402
from repro.core.tiling import TiledBinaryMatvec as RefTiledBMV  # noqa: E402
from repro.core.tiling import TiledConv2d as RefTiledConv  # noqa: E402
from repro.core.tiling import TiledMatvec as RefTiledMV  # noqa: E402
from repro.device import energy as ref_energy  # noqa: E402
from repro.device import mitigation as ref_mitigation  # noqa: E402
from repro.device import montecarlo as ref_mc  # noqa: E402
import repro_torch.device as device  # noqa: E402
from repro_torch.core import (BinaryConvPlan, BinaryMatvecPlan,  # noqa: E402
                              ConvPlan, MatvecPlan, TiledBinaryMatvec,
                              TiledConv2d, TiledMatvec)
from repro_torch.device import energy, mitigation, montecarlo  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)
PROFILES = (None, "vteam-fast", "low-energy",
            energy.DeviceProfile("custom", 2.0, 0.3, 1.1, 2.5, 0.5))


def _same_numbers(got, want):
    """Dataclass (or tuple) fields: ints and strings equal, floats to
    ``rel=1e-12``."""
    g = dataclasses.astuple(got) if dataclasses.is_dataclass(got) else got
    w = dataclasses.astuple(want) if dataclasses.is_dataclass(want) else want
    assert len(g) == len(w)
    for a, b in zip(g, w):
        if isinstance(b, float):
            assert a == pytest.approx(b, rel=1e-12, abs=0.0)
        else:
            assert a == b


def _report_numbers(rep):
    return (rep.profile, rep.cycles, rep.gate_events, rep.init_cells,
            rep.gate_fj, rep.init_fj, rep.by_gate, rep.t_cycle_ns,
            rep.total_fj, rep.total_nj, rep.latency_ns, rep.edp_fj_ns)


def test_gate_tables_match_the_compiler():
    from repro_torch.core.compile import (GATE_IDS, MODE_COL, MODE_INIT,
                                          MODE_ROW)
    from repro_torch.core.isa import GATES
    assert energy.GATE_NAMES == ref_energy.GATE_NAMES
    assert energy.GATE_ARITY == ref_energy.GATE_ARITY
    assert list(energy.GATE_NAMES) == sorted(GATE_IDS, key=GATE_IDS.get)
    assert energy.GATE_ARITY == tuple(GATES[g].arity
                                      for g in energy.GATE_NAMES)
    assert (energy.M_COL, energy.M_ROW, energy.M_INIT) == \
        (MODE_COL, MODE_ROW, MODE_INIT)
    assert energy.PROFILES == {
        k: energy.DeviceProfile(**dataclasses.asdict(v))
        for k, v in ref_energy.PROFILES.items()}


@pytest.fixture(scope="module")
def plans():
    """The four algorithms' (reference, port) plans, compiled once."""
    rng = np.random.default_rng(4)
    K = rng.integers(0, 256, size=(3, 3))
    Kb = rng.choice([-1, 1], size=(3, 3))
    pairs = [(RefMV(48, 6, 8, 1, **GEOM), MatvecPlan(48, 6, 8, 1, **GEOM)),
             (RefBMV(48, 64, **GEOM), BinaryMatvecPlan(48, 64, **GEOM)),
             (RefConv(16, 8, 3, 8, **GEOM), ConvPlan(16, 8, 3, 8, **GEOM)),
             (RefBConv(16, 32, 3, **GEOM), BinaryConvPlan(16, 32, 3, **GEOM))]
    for (ref, port), kern in zip(pairs, (None, None, K, Kb)):
        if kern is not None:
            ref.ensure_program(kern)
            port.ensure_program(kern)
    for ref, port in pairs:
        ref.compile()
        port.compile()
    return pairs


@pytest.mark.parametrize("profile", PROFILES,
                         ids=("default", "vteam-fast", "low-energy",
                              "custom"))
def test_trace_energy_matches_reference(plans, profile):
    ref_prof = (ref_energy.DeviceProfile(**dataclasses.asdict(profile))
                if isinstance(profile, energy.DeviceProfile) else profile)
    for ref, port in plans:
        want = ref_energy.trace_energy(ref.compile(), ref_prof)
        got = energy.trace_energy(port.compile(), profile)
        _same_numbers(_report_numbers(got), _report_numbers(want))
        assert str(got) == str(want)
        _same_numbers(_report_numbers(port.energy(profile)),
                      _report_numbers(want))


def test_tiled_wrappers_price_one_tile():
    rng = np.random.default_rng(5)
    K = rng.integers(0, 16, size=(3, 3))
    pairs = [(RefTiledMV(100, 50, 8, **GEOM), TiledMatvec(100, 50, 8, **GEOM)),
             (RefTiledBMV(100, 300, **GEOM),
              TiledBinaryMatvec(100, 300, **GEOM))]
    for ref, port in pairs:
        assert port.n_tiles == ref.n_tiles
        _same_numbers(_report_numbers(port.energy("vteam-fast")),
                      _report_numbers(ref.energy("vteam-fast")))
    ref = RefTiledConv(20, 20, 3, 8, tile_m=8, tile_n=8, **GEOM)
    port = TiledConv2d(20, 20, 3, 8, tile_m=8, tile_n=8, **GEOM)
    _same_numbers(_report_numbers(port.energy(K=K)),
                  _report_numbers(ref.energy(K=K)))


def test_energy_table_matches_reference():
    want = ref_energy.energy_table(quick=True)
    got = energy.energy_table(quick=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _same_numbers(g, w)
    assert energy.format_energy_rows(got, "t") == \
        ref_energy.format_energy_rows(want, "t")


def test_io_energy_and_profiles_match_reference():
    for prof in ("vteam", "vteam-fast", "low-energy", None):
        for r, w in ((0, 0), (100, 50), (7, 0), (0, 13), (4096, 2048)):
            assert energy.io_energy_fj(r, w, prof) == pytest.approx(
                ref_energy.io_energy_fj(r, w, prof), rel=1e-12, abs=0.0)
        assert dataclasses.asdict(energy.get_profile(prof)) == \
            dataclasses.asdict(ref_energy.get_profile(prof))
    assert energy.get_profile(energy.DEFAULT_PROFILE) is \
        energy.DEFAULT_PROFILE


def _same_points(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_numbers(g, w)


@pytest.mark.parametrize("backend", ("torch-fused", "torch-unfused"))
def test_binary_matvec_sweep_matches_reference(backend):
    rates = [0.0, 1e-3, 1e-2]
    want = ref_mc.binary_matvec_sweep(rates, samples=96, seed=3)
    got = montecarlo.binary_matvec_sweep(rates, samples=96, seed=3,
                                         backend=backend, device="cpu")
    _same_points(got, want)
    assert got[0].bit_error_rate == got[0].sign_error_rate == 0.0
    assert device.format_sweep(got, "s") == ref_mc.format_sweep(want, "s")


def test_bnn_accuracy_sweep_matches_reference():
    rates = [0.0, 1e-3, 1e-2]
    want = ref_mc.bnn_accuracy_sweep(rates, n_inputs=128, seed=2)
    got = device.bnn_accuracy_sweep(rates, n_inputs=128, seed=2,
                                    device="cpu")
    _same_points(got, want)
    assert got[0].accuracy == 1.0


@pytest.mark.parametrize("rate,samples", [(1e-3, 64), (1e-2, 128)])
def test_tmr_matches_reference(rate, samples):
    want = ref_mitigation.tmr_binary_matvec(rate, samples=samples, seed=1)
    got = mitigation.tmr_binary_matvec(rate, samples=samples, seed=1,
                                       device="cpu")
    _same_numbers(got, want)
    assert got.cycle_overhead == want.cycle_overhead
    assert got.energy_overhead == pytest.approx(want.energy_overhead,
                                                rel=1e-12, abs=0.0)
    # the vote runs through the port's compile_program; the explicit model
    # overrides the rate
    got = device.tmr_binary_matvec(0.5, samples=32, device="cpu",
                                   faults=device.FaultModel(), seed=1)
    assert got.err_raw == got.err_tmr == 0.0


def test_lazy_exports_match_reference():
    import repro.device as ref_device
    assert sorted(device.__all__) == sorted(ref_device.__all__)
    for name in device.__all__:
        assert getattr(device, name) is not None
    with pytest.raises(AttributeError):
        device.no_such_name  # noqa: B018
