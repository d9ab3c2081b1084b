"""The port's ``MatvecPlan`` and ``ConvPlan`` against the reference.

Programs must compile to the reference's golden traces
(``tests/golden/matvec.json``, ``conv.json``, written by
``tools/gen_golden.py``), operands must load into byte-identical images, and
the port's ``kernels`` and ``torch`` backends must decode to exactly what
the reference's ``numpy`` replay decodes, with equal cycles and stats — in
the pattern of ``tests/test_pallas_backend.py``: α=2 matvec, conv with the
kernel stored in the array (``kstore``), K-specialized programs, the
stream-kernel fallback, negative taps, a batch of distinct kernels, and the
2^24 exactness bound sending a trace to ``kernels:fallback-torch``. A trace
compiled by the reference and carried over through ``compiled_state`` runs
in the port like the reference's own. The ``cuda`` test holds the card's
kernel path to the torch replay.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.core import (ConvPlan, MatvecPlan,  # noqa: E402
                              compiled_from_state, execute, matpim_conv2d,
                              matpim_matvec)
from repro_torch.core import kernel_exec as kx  # noqa: E402
from repro_torch.kernels.conv2d_shift import conv2d_shift  # noqa: E402
from repro_torch.kernels.splitk_matvec import splitk_matvec  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from gen_golden import trace_record  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)
GOLDEN_K = np.random.default_rng(99).integers(0, 16, size=(3, 3))


class _Ref:
    """The reference package, imported at first use (the ``cuda`` test
    runs where jax, and so the reference, is absent)."""

    def __getattr__(self, name):
        core = pytest.importorskip("repro.core")
        from repro.core.compile import compiled_state
        from repro.core.engine import execute
        found = {"Conv": core.ConvPlan, "Matvec": core.MatvecPlan,
                 "state": compiled_state, "execute": execute}[name]
        setattr(self, name, found)
        return found


REF = _Ref()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _golden(name):
    return json.loads((ROOT / "tests" / "golden" / f"{name}.json")
                      .read_text())


def test_golden_matvec_trace():
    plan = MatvecPlan(32, 16, 8, 2, rows=256, cols=512, parts=16)
    assert trace_record(plan) == _golden("matvec")


def test_golden_conv_trace():
    plan = ConvPlan(32, 6, 3, 4, rows=128, cols=512, parts=16)
    plan.ensure_program(GOLDEN_K)
    assert trace_record(plan) == _golden("conv")


@pytest.mark.parametrize("kind", ["matvec", "conv", "conv_stream"])
def test_load_into_byte_identical(kind):
    rng = np.random.default_rng(7)
    if kind == "matvec":
        ref, mine = (P(8, 4, 4, alpha=2, **GEOM)
                     for P in (REF.Matvec, MatvecPlan))
        args = (rng.integers(0, 16, (8, 4)), rng.integers(0, 16, 4))
    else:
        m, n, k = (17, 40, 2) if kind == "conv_stream" else (6, 7, 3)
        ref, mine = (P(m, n, k, 4, **GEOM) for P in (REF.Conv, ConvPlan))
        assert mine.stream_kernel == ref.stream_kernel == (
            kind == "conv_stream")
        args = (rng.integers(0, 16, (m, n)), rng.integers(-8, 8, (k, k)))
    want = np.zeros((64, 256), np.uint8)
    got = np.zeros((64, 256), np.uint8)
    ref.load_into(want, *args)
    mine.load_into(got, *args)
    np.testing.assert_array_equal(got, want)


def _images(plan, operands):
    mems = np.zeros((len(operands), plan.rows, plan.cols), np.uint8)
    for b, ops in enumerate(operands):
        plan.load_into(mems[b], *ops)
    return mems


def _against_reference(ref, mine, mems, decode, label="kernels",
                       backends=("kernels", "torch")):
    """Every backend decodes like the reference numpy replay, with its
    cycles and stats; returns the decoded instances."""
    want = REF.execute(ref.compile(), mems, backend="numpy")
    outs = [decode(ref, m) for m in want.mem]
    for backend in backends:
        got = mine.execute_batch(mems, backend=backend, device="cpu")
        assert got.backend == (label if backend == "kernels" else backend)
        assert (got.cycles, got.stats) == (want.cycles, want.stats)
        for b, m in enumerate(got.mem):
            np.testing.assert_array_equal(decode(mine, m), outs[b])
    return outs


def _matvec_y(plan, mem):
    return plan.decode_y(mem)


def _conv_out(plan, mem):
    return plan.decode_out(mem)


def _corr(A, K, N):
    k = K.shape[0]
    out = np.zeros((A.shape[0] - k + 1, A.shape[1] - k + 1), dtype=np.int64)
    for v in range(k):
        for h in range(k):
            out += A[v:v + out.shape[0], h:h + out.shape[1]] * K[v, h]
    return out % (1 << N)


@pytest.mark.parametrize("m,n,N,alpha,B", [(8, 4, 4, 2, 3), (5, 6, 3, 1, 2),
                                           (16, 8, 2, 2, 1)])
def test_matvec_bit_identical(m, n, N, alpha, B):
    rng = np.random.default_rng(m + n + N)
    As = rng.integers(0, 1 << N, (B, m, n))
    xs = rng.integers(0, 1 << N, (B, n))
    ref = REF.Matvec(m, n, N, alpha=alpha, **GEOM)
    mine = MatvecPlan(m, n, N, alpha=alpha, **GEOM)
    assert kx.kernels_eligible(mine.compile())
    outs = _against_reference(ref, mine, _images(ref, list(zip(As, xs))),
                              _matvec_y)
    for b in range(B):
        np.testing.assert_array_equal(outs[b],
                                      (As[b] @ xs[b]) % (1 << (2 * N)))


@pytest.mark.parametrize("specialize", [False, True])
def test_conv_bit_identical(specialize):
    rng = np.random.default_rng(2)
    K = rng.integers(0, 16, (2, 2))
    As = rng.integers(0, 16, (2, 6, 6))
    ref = REF.Conv(6, 6, 2, 4, specialize_kernel=specialize, **GEOM)
    mine = ConvPlan(6, 6, 2, 4, specialize_kernel=specialize, **GEOM)
    ref.ensure_program(K)
    mine.ensure_program(K)
    assert (mine.compile().kernel_spec["K"] is None) != specialize
    outs = _against_reference(ref, mine, _images(ref, [(A, K) for A in As]),
                              _conv_out)
    for b in range(2):
        np.testing.assert_array_equal(outs[b].astype(np.int64),
                                      _corr(As[b], K, 4))


@pytest.mark.parametrize("specialize", [False, True])
def test_conv_negative_taps(specialize):
    """Signed taps ride two's complement in kstore and raw in a specialized
    spec; both reduce mod 2^N like the reference (``%``, not ``fmod``)."""
    rng = np.random.default_rng(12)
    K = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]])
    As = rng.integers(0, 256, (2, 7, 7))
    ref = REF.Conv(7, 7, 3, 8, specialize_kernel=specialize, **GEOM)
    mine = ConvPlan(7, 7, 3, 8, specialize_kernel=specialize, **GEOM)
    ref.ensure_program(K)
    mine.ensure_program(K)
    outs = _against_reference(ref, mine, _images(ref, [(A, K) for A in As]),
                              _conv_out, backends=("kernels",))
    for b in range(2):
        np.testing.assert_array_equal(outs[b].astype(np.int64),
                                      _corr(As[b], K, 8))


def test_conv_stream_kernel_fallback():
    """A shape whose kstore does not fit streams K from the controller: the
    spec carries the bound (signed) kernel."""
    rng = np.random.default_rng(13)
    K = np.array([[1, -2], [3, -1]])
    As = rng.integers(0, 16, (2, 17, 40))
    ref = REF.Conv(17, 40, 2, 4, **GEOM)
    mine = ConvPlan(17, 40, 2, 4, **GEOM)
    assert mine.stream_kernel and mine.alpha == ref.alpha == 2
    ref.ensure_program(K)
    mine.ensure_program(K)
    np.testing.assert_array_equal(mine.compile().kernel_spec["K"], K)
    outs = _against_reference(ref, mine, _images(ref, [(A, K) for A in As]),
                              _conv_out, backends=("kernels",))
    for b in range(2):
        np.testing.assert_array_equal(outs[b].astype(np.int64),
                                      _corr(As[b], K, 4))


def test_conv_batch_distinct_kstore_kernels(monkeypatch):
    """Kernel-independent conv programs batch distinct kernels: the kstore
    bits are read per instance, not captured from the plan, and the whole
    batch is one conv2d_shift call with a (B, k, k) kernel batch."""
    import repro_torch.kernels.conv2d_shift as cs
    rng = np.random.default_rng(3)
    ref = REF.Conv(6, 6, 2, 4, **GEOM)
    mine = ConvPlan(6, 6, 2, 4, **GEOM)
    ref.ensure_program(rng.integers(0, 16, (2, 2)))
    mine.ensure_program(rng.integers(0, 16, (2, 2)))
    ops = [(rng.integers(0, 16, (6, 6)), rng.integers(0, 16, (2, 2)))
           for _ in range(3)]
    calls = []

    def spy(a, k, orig=cs.conv2d_shift):
        calls.append((tuple(a.shape), tuple(k.shape)))
        return orig(a, k)

    monkeypatch.setattr(cs, "conv2d_shift", spy)
    outs = _against_reference(ref, mine, _images(ref, ops), _conv_out)
    assert calls == [((3, 6, 6), (3, 2, 2))]
    for b, (A, K) in enumerate(ops):
        np.testing.assert_array_equal(outs[b].astype(np.int64),
                                      _corr(A, K, 4))


def test_exactness_bound_rejects_and_falls_back():
    plan = MatvecPlan(8, 8, 4, **GEOM)
    cp = plan.compile()
    assert kx.kernels_eligible(cp)                # 8·15² « 2^24
    cp.kernel_spec = dict(cp.kernel_spec, N=12)   # 8·4095² > 2^24
    assert not kx.kernels_eligible(cp)
    rng = np.random.default_rng(6)
    A, x = rng.integers(0, 16, (8, 8)), rng.integers(0, 16, 8)
    mem = _images(plan, [(A, x)])[0]
    before = splitk_matvec.launches
    res = execute(cp, mem, backend="kernels", device="cpu")
    assert res.backend == "kernels:fallback-torch"
    np.testing.assert_array_equal(plan.decode_y(res.mem), (A @ x) % 256)
    assert splitk_matvec.launches == before
    plan._compiled = None                         # drop the doctored trace
    conv = ConvPlan(6, 6, 3, 4, **GEOM)
    conv.ensure_program(np.ones((3, 3), np.int64))
    cp = conv.compile()
    assert kx.kernels_eligible(cp)                # 9·15² « 2^24
    cp.kernel_spec = dict(cp.kernel_spec, N=11)   # 9·2047² > 2^24
    assert not kx.kernels_eligible(cp)
    conv._compiled = None


def test_unbound_k_dependent_spec_is_ineligible():
    plan = ConvPlan(6, 6, 2, 4, specialize_kernel=True, **GEOM)
    assert plan.cycles > 0                        # builds with a dummy K
    assert plan.compile().kernel_spec is None
    assert not kx.kernels_eligible(plan.compile())


def test_run_and_wrappers_match_reference():
    rng = np.random.default_rng(14)
    A, x = rng.integers(0, 16, (8, 4)), rng.integers(0, 16, 4)
    want = REF.Matvec(8, 4, 4, alpha=2, **GEOM).run(A, x)
    got = MatvecPlan(8, 4, 4, alpha=2, **GEOM).run(A, x, backend="kernels",
                                                   device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    got = matpim_matvec(A, x, 4, alpha=2, device="cpu", **GEOM)
    np.testing.assert_array_equal(got[0], want[0])
    img, K = rng.integers(0, 16, (6, 6)), rng.integers(0, 16, (3, 3))
    want = REF.Conv(6, 6, 3, 4, **GEOM).run(img, K)
    got = matpim_conv2d(img, K, 4, backend="kernels", device="cpu", **GEOM)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("kind", ["matvec", "conv"])
def test_trace_carried_from_reference(kind):
    rng = np.random.default_rng(21)
    if kind == "matvec":
        ref, mine = (P(8, 4, 4, alpha=2, **GEOM)
                     for P in (REF.Matvec, MatvecPlan))
        ops = [(rng.integers(0, 16, (8, 4)), rng.integers(0, 16, 4))
               for _ in range(3)]
        decode = _matvec_y
    else:
        ref, mine = (P(6, 6, 2, 4, **GEOM) for P in (REF.Conv, ConvPlan))
        K = rng.integers(0, 16, (2, 2))
        ref.ensure_program(K)
        mine.ensure_program(K)
        ops = [(rng.integers(0, 16, (6, 6)), rng.integers(0, 16, (2, 2)))
               for _ in range(3)]
        decode = _conv_out
    meta, arrays = REF.state(ref.compile())
    cp = compiled_from_state(meta, {k: np.asarray(v)
                                    for k, v in arrays.items()})
    mine.adopt_compiled(cp)
    assert mine.compile() is cp and cp.kernel_spec["kind"] == kind
    _against_reference(ref, mine, _images(ref, ops), decode)


@pytest.mark.cuda
def test_cuda_kernels_backend_matches_replay(cuda):
    rng = np.random.default_rng(30)
    mv = MatvecPlan(16, 8, 8, alpha=2, **GEOM)
    mems = _images(mv, [(rng.integers(0, 256, (16, 8)),
                         rng.integers(0, 256, 8)) for _ in range(33)])
    before = splitk_matvec.launches
    got = mv.execute_batch(mems, backend="kernels", device=cuda)
    assert got.backend == "kernels" and splitk_matvec.launches == before + 1
    want = mv.execute_batch(mems, backend="torch-fused", device=cuda)
    for g, w in zip(got.mem, want.mem):
        np.testing.assert_array_equal(mv.decode_y(g), mv.decode_y(w))
    conv = ConvPlan(7, 7, 3, 8, **GEOM)
    conv.ensure_program(np.ones((3, 3), np.int64))
    mems = _images(conv, [(rng.integers(0, 256, (7, 7)),
                           rng.integers(-4, 256, (3, 3))) for _ in range(9)])
    before = conv2d_shift.launches
    got = conv.execute_batch(mems, backend="kernels", device=cuda)
    assert got.backend == "kernels" and conv2d_shift.launches == before + 1
    want = conv.execute_batch(mems, backend="torch-fused", device=cuda)
    for g, w in zip(got.mem, want.mem):
        np.testing.assert_array_equal(conv.decode_out(g),
                                      conv.decode_out(w))
