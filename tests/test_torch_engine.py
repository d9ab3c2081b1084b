"""The port's torch executors against the reference's numpy executors.

``torch-fused`` and ``torch-unfused`` (``repro_torch.core.engine``) must give
exactly the final memory, cycle count and op-category stats that
``repro.core.engine.execute(..., backend="numpy")`` gives — on the
conformance suite's random programs at every word-boundary batch size,
under one fixed ``FaultRealization``, and on a trace carried across from the
reference through ``compiled_state`` → ``compiled_from_state``. Inputs are
made with numpy from a seed and handed to both packages; every comparison
is exact (tolerance 0), since every quantity is a bit or an integer. These
run on the CPU (``device="cpu"``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from test_conformance import interp_reference, random_program  # noqa: E402

from repro.core import compile_program as ref_compile  # noqa: E402
from repro.core import execute as ref_execute  # noqa: E402
from repro.core.compile import compiled_state as ref_state  # noqa: E402
from repro.device.faults import FaultModel as RefFaultModel  # noqa: E402
from repro.device.faults import \
    FaultRealization as RefRealization  # noqa: E402
from repro_torch.core import (BinaryMatvecPlan,  # noqa: E402
                              available_backends, compile_program,
                              compiled_from_state, execute, parse_backend)
from repro_torch.core.autotune import TuningTable  # noqa: E402
from repro_torch.core import isa  # noqa: E402
from repro_torch.core.isa import ColOp  # noqa: E402
from repro_torch.device.faults import (FaultModel,  # noqa: E402
                                       FaultRealization)

BOUNDARY_BATCHES = (1, 8, 9, 32, 33, 64, 65, 128)
BACKENDS = ("torch-fused", "torch-unfused")
SEEDS = (3, 7, 11)


def port_program(prog):
    """The reference's micro-ops rebuilt as the port's (same fields)."""
    return [[getattr(isa, type(op).__name__)(**vars(op)) for op in cyc]
            for cyc in prog]


def _mems(rows, cols, B, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, rows, cols)) < 0.5).astype(np.uint8)


def _same(got, want, what):
    np.testing.assert_array_equal(got.mem, want.mem, err_msg=what)
    assert got.cycles == want.cycles, what
    assert got.stats == want.stats, what


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("B", BOUNDARY_BATCHES)
def test_random_programs_match_reference_numpy(seed, B):
    prog, rows, cols, parts = random_program(seed)
    mems = _mems(rows, cols, B, seed=1000 * seed + B)
    want = ref_execute(ref_compile(prog, rows, cols, parts, parts), mems,
                       backend="numpy")
    cp = compile_program(port_program(prog), rows, cols, parts, parts)
    for backend in BACKENDS:
        got = execute(cp, mems, backend=backend, device="cpu")
        _same(got, want, f"{backend} seed={seed} B={B}")
        assert got.backend == backend


@pytest.mark.parametrize("B", (1, 9, 32, 33))
def test_packed_layout_matches_reference(B):
    """The device buffer holds the reference's canonical uint32 words."""
    from repro.core.engine import _pack as ref_pack
    from repro_torch.core.engine import _pack, _unpack
    mems = _mems(6, 10, B, B)
    got = _pack(torch.from_numpy(mems))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref_pack(mems))
    np.testing.assert_array_equal(_unpack(got, B, 6, 10).numpy(), mems)


@pytest.mark.parametrize("seed", SEEDS)
def test_interpreter_matches_reference(seed):
    """The port's host interpreter is the reference's, cycle for cycle."""
    from repro_torch.core.crossbar import Crossbar
    prog, rows, cols, parts = random_program(seed)
    mems = _mems(rows, cols, 2, seed)
    ref, cycles, stats = interp_reference(prog, rows, cols, parts, mems)
    xb = Crossbar(rows, cols, parts, parts)
    for b in range(2):
        xb.mem[:, :] = mems[b]
        xb.cycles = 0
        xb.stats = {k: 0 for k in xb.stats}
        xb.run(port_program(prog))
        np.testing.assert_array_equal(xb.mem, ref[b])
    assert (xb.cycles, xb.stats) == (cycles, stats)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("B", (3, 33))
def test_fault_realization_matches_reference(seed, B):
    """One fixed realization (stuck-at, switching, init disturb) applied by
    both packages gives the same faulty memory."""
    prog, rows, cols, parts = random_program(seed)
    mems = _mems(rows, cols, B, seed + 5)
    ref_cp = ref_compile(prog, rows, cols, parts, parts)
    fm = RefFaultModel(p_sa0=0.03, p_sa1=0.03, p_switch=0.08, p_init=0.08)
    real = RefRealization.sample(fm, B, rows, cols, ref_cp.n_cycles,
                                 ref_cp.W, ref_cp.I, rng=seed)
    assert not real.is_ideal
    want = ref_execute(ref_cp, mems, backend="numpy", faults=real)
    mine = FaultRealization(sa0=real.sa0, sa1=real.sa1, switch=real.switch,
                            init_flip=real.init_flip)
    cp = compile_program(port_program(prog), rows, cols, parts, parts)
    for backend in BACKENDS + ("torch",):
        got = execute(cp, mems, backend=backend, device="cpu", faults=mine)
        _same(got, want, f"{backend} seed={seed}")


def test_trace_carried_from_reference():
    """A trace compiled by the reference, serialized with its
    ``compiled_state`` and rebuilt by the port, replays to the reference's
    result — the port's "weights" are the compiled trace."""
    from repro.core import BinaryMatvecPlan as RefPlan
    ref_plan = RefPlan(48, 64, rows=64, cols=256, parts=8)
    meta, arrays = ref_state(ref_plan.compile())
    cp = compiled_from_state(meta, {k: np.asarray(v)
                                    for k, v in arrays.items()})
    rng = np.random.default_rng(21)
    mems = np.zeros((5, 64, 256), np.uint8)
    As = rng.choice([-1, 1], size=(5, 48, 64))
    xs = rng.choice([-1, 1], size=(5, 64))
    for b in range(5):
        ref_plan.load_into(mems[b], As[b], xs[b])
    want = ref_execute(ref_plan.compile(), mems, backend="numpy")
    for backend in BACKENDS:
        _same(execute(cp, mems, backend=backend, device="cpu"), want,
              backend)
    # adopted by a port plan, the carried trace decodes like the reference
    plan = BinaryMatvecPlan(48, 64, rows=64, cols=256, parts=8)
    plan.adopt_compiled(cp)
    got = plan.execute_batch(mems, backend="kernels", device="cpu")
    assert got.backend == "kernels"
    for b in range(5):
        np.testing.assert_array_equal(plan.decode_y(got.mem[b]),
                                      ref_plan.decode_y(want.mem[b]))


def test_unfused_trace_and_max_batch():
    """fuse=False traces replay per cycle under ``torch``; ``torch-fused``
    attaches the schedule on demand; ``max_batch`` chunking is exact."""
    prog, rows, cols, parts = random_program(7)
    mems = _mems(rows, cols, 40, 9)
    want = ref_execute(ref_compile(prog, rows, cols, parts, parts), mems,
                       backend="numpy")
    cp = compile_program(port_program(prog), rows, cols, parts, parts,
                         fuse=False)
    _same(execute(cp, mems, backend="torch", device="cpu"), want, "auto")
    assert cp.schedule is None
    _same(execute(cp, mems, backend="torch-fused", device="cpu",
                  max_batch=16), want, "fused chunks")
    assert cp.schedule is not None


def test_prewarm_builds_the_plan_execute_uses():
    from repro_torch.core.fused import prewarm_replay
    prog, rows, cols, parts = random_program(3)
    mems = _mems(rows, cols, 4, 1)
    for fuse in (True, False):
        cp = compile_program(port_program(prog), rows, cols, parts, parts,
                             fuse=fuse)
        prewarm_replay(cp, device="cpu")
        builds = cp._caches.builds
        assert builds == 1
        execute(cp, mems, backend="torch", device="cpu")
        assert cp._caches.builds == builds


def test_duplicate_destinations_last_write_wins():
    """An unvalidated cycle writing one line twice keeps the last write, as
    the reference's numpy scatter does."""
    from repro.core import isa as ref_isa
    prog = [[ref_isa.ColOp("NOT", (0,), 2, None),
             ref_isa.ColOp("OR2", (0, 1), 2, None),
             ref_isa.ColOp("NOT", (1,), 2, None)]]
    mems = _mems(8, 8, 3, 4)
    want = ref_execute(ref_compile(prog, 8, 8, 1, 1, validate=False), mems,
                       backend="numpy-unfused")
    prog = port_program(prog)
    cp = compile_program(prog, 8, 8, 1, 1, validate=False)
    for backend in BACKENDS:
        _same(execute(cp, mems, backend=backend, device="cpu"), want,
              backend)


def test_backend_contracts():
    assert parse_backend("torch") == ("torch", "auto")
    assert parse_backend("torch-fused") == ("torch", "fused")
    assert parse_backend("kernels") == ("kernels", "auto")
    for bad in ("numpy", "jax", "pallas", "kernels-fused", "interp"):
        with pytest.raises(ValueError):
            parse_backend(bad)
    assert parse_backend("auto") == ("auto", "auto")
    assert available_backends() == ("auto", "torch", "torch-fused",
                                    "torch-unfused", "kernels")
    cp = compile_program([[ColOp("NOT", (0,), 1, None)]], 8, 8, 1, 1)
    mem = np.zeros((8, 8), np.uint8)
    with pytest.raises(NotImplementedError, match="device/faults.py"):
        execute(cp, mem, device="cpu", faults=FaultModel(p_switch=0.1))
    with pytest.raises(NotImplementedError, match="mesh_exec"):
        execute(cp, mem, device="cpu", mesh=object())
    out = execute(cp, mem, device="cpu").mem
    assert out.shape == (8, 8) and out[:, 1].all()
    # "auto" is ported: no kernel computes this trace, so it replays fused
    res = execute(cp, mem, backend="auto", device="cpu",
                  tunings=TuningTable())
    assert res.backend == "auto:torch-fused"
    assert np.array_equal(res.mem, out)


def test_cuda_is_the_default_device():
    """Without CUDA, a run that did not ask for the CPU raises instead of
    carrying on quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable here")
    cp = compile_program([[ColOp("NOT", (0,), 1, None)]], 8, 8, 1, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute(cp, np.zeros((8, 8), np.uint8))
