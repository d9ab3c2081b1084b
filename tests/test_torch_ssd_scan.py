"""The port's ``ssd_scan`` kernel against the plain chunked scan it replaces.

The tests marked ``cuda`` hold the CUDA kernel (``csrc/ssd_scan.cu``) on the
card to the plain version (``models/mamba.py::ssd_plain``, the unchanged
``_ssd`` over a padded sequence) and to a float64 run of the plain version
on the same inputs, at granite-4.0-h-micro's widths (64 heads of 64, state
128, chunk 256), for sequences under, at and past a chunk and long prompts,
one and two batch rows, with and without an initial state, in bfloat16 and
float32. The limit: the kernel's distance from float64 (max abs over the
float64 tensor's largest magnitude) is at most twice the plain float32
path's own, for y and for the final state. A ragged sequence gives the bits
of the same sequence padded with rows of ``dt`` = 0 and zero x, B and C,
and a dtype the kernel does not take raises. The inputs are made with
numpy: A and dt drawn as Mamba-2 publishes them (``bench/harness.py``:
A uniform in [1, 16], dt log-uniform in [0.001, 0.1]), x, B and C normal.

The CPU tests hold the wrapper's checks and its CPU path (the plain
version, bit for bit); they import nothing of the reference package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.kernels import ssd_scan as SS  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

H, P, N, CHUNK = 64, 64, 128, 256     # granite-4.0-h-micro's
A_RANGE, DT_RANGE = (1.0, 16.0), (1e-3, 1e-1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(b, s, seed, dtype=torch.float32, device="cpu", h=H, p=P, n=N,
            init=False):
    """x, dt, A, B, C, D and the initial state (or None) on ``device``; x,
    B and C in ``dtype``, the rest float32."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)
    x = f32(rng.standard_normal((b, s, h, p))).to(dtype)
    B = f32(rng.standard_normal((b, s, n))).to(dtype)
    C = f32(rng.standard_normal((b, s, n))).to(dtype)
    A = -f32(rng.uniform(*A_RANGE, h))
    lo, hi = np.log(DT_RANGE)
    dt = f32(np.exp(rng.uniform(lo, hi, (b, s, h))))
    D = f32(rng.standard_normal(h))
    state = f32(rng.standard_normal((b, h, p, n))) if init else None
    return x, dt, A, B, C, D, state


def _wide(ops):
    return [None if t is None else t.double() for t in ops]


def _dist(got, want) -> float:
    """Max abs distance over the float64 tensor's largest magnitude."""
    return float((got.double() - want).abs().max() / want.abs().max())


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("s", [1, 3, 255, 256, 257, 2048, 5000, 8000])
def test_kernel_within_twice_the_plain_distance_from_float64(cuda, s, b,
                                                             init, dtype):
    ops = _inputs(b, s, seed=s * 10 + b, dtype=dtype, device=cuda,
                  init=init)
    before = SS.ssd_scan.launches
    y, state = SS.ssd_scan(*ops[:6], CHUNK, ops[6])
    assert SS.ssd_scan.launches == before + 1
    assert y.shape == ops[0].shape and y.dtype == dtype
    assert state.shape == (b, H, P, N) and state.dtype == torch.float32
    py, pstate = M.ssd_plain(*ops[:6], CHUNK, ops[6])
    wy, wstate = M.ssd_plain(*_wide(ops[:6]), CHUNK, *_wide(ops[6:]))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    for got, plain, want in ((y, py, wy), (state, pstate, wstate)):
        assert _dist(got, want) <= 2 * _dist(plain, want), (
            _dist(got, want), _dist(plain, want))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 257, 700])
def test_ragged_sequence_is_the_padded_one(cuda, s):
    """A ragged last chunk gives the bits of the sequence padded to a whole
    chunk with rows of dt = 0 and zero x, B and C: such rows neither decay
    nor add to the state, and no real row reads them."""
    ops = _inputs(2, s, seed=s, device=cuda, init=True)
    pad = -s % CHUNK
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (ops[0], ops[3], ops[4])]
    dt = torch.nn.functional.pad(ops[1], (0, 0, 0, pad))
    y, state = SS.ssd_scan(*ops[:6], CHUNK, ops[6])
    py, pstate = SS.ssd_scan(padded[0], dt, ops[2], padded[1], padded[2],
                             ops[5], CHUNK, ops[6])
    assert torch.equal(y, py[:, :s]) and torch.equal(state, pstate)


@pytest.mark.cuda
def test_strided_views_read_where_they_lie(cuda):
    """x, B and C as views of one projection's output, as ``apply_mamba``
    passes them: the same bits as contiguous copies."""
    b, s = 1, 300
    ops = _inputs(b, s, seed=3, dtype=torch.bfloat16, device=cuda)
    packed = torch.cat([ops[0].reshape(b, s, H * P), ops[3], ops[4]], -1)
    x, B, C = torch.split(packed, [H * P, N, N], dim=-1)
    got = SS.ssd_scan(x.reshape(b, s, H, P), ops[1], ops[2], B, C, ops[5],
                      CHUNK)
    want = SS.ssd_scan(*ops[:6], CHUNK)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_refused_dtype_raises_on_the_card(cuda, dtype):
    ops = _inputs(1, 16, seed=1, dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        SS.ssd_scan(*ops[:6], CHUNK)


@pytest.mark.cuda
def test_model_path_counts_the_kernel(cuda):
    """``ssd_chunked`` on plain CUDA tensors without gradients takes the
    kernel; with an operand requiring a gradient, the plain path."""
    ops = _inputs(1, 40, seed=2, device=cuda)
    kernel = metrics.counter("mamba.ssd.kernel").value
    plain = metrics.counter("mamba.ssd.plain").value
    with torch.no_grad():
        M.ssd_chunked(*ops[:6], chunk=16)
    x = ops[0].clone().requires_grad_()
    y, _ = M.ssd_chunked(x, *ops[1:6], chunk=16)
    assert y.requires_grad
    assert metrics.counter("mamba.ssd.kernel").value - kernel == 1
    assert metrics.counter("mamba.ssd.plain").value - plain == 1


# -- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("s", [7, 16, 37])
def test_cpu_operands_take_the_plain_version(s, init):
    ops = _inputs(2, s, seed=s, h=3, p=4, n=5, init=init)
    got = SS.ssd_scan(*ops[:6], 16, ops[6])
    want = M.ssd_plain(*ops[:6], 16, ops[6])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_shape_disagreements_raise():
    x, dt, A, B, C, D, _ = _inputs(1, 8, seed=0, h=3, p=4, n=5)
    for bad in ((x[:, :4], dt, A, B, C, D), (x, dt, A[:2], B, C, D),
                (x, dt, A, B, C[..., :4], D), (x, dt[..., :2], A, B, C, D)):
        with pytest.raises(ValueError):
            SS.ssd_scan(*bad, 16)
    with pytest.raises(ValueError):
        SS.ssd_scan(x, dt, A, B, C, D, 16, torch.zeros(1, 3, 4, 4))
    with pytest.raises(ValueError, match="operands on"):
        SS.ssd_scan(x, dt, A, B.to("meta"), C, D, 16)


def test_scratch_and_flops_follow_the_shape():
    """The scratch holds a chunk's cumulative sums (float64), its state and
    one C·Bᵀ; the flops are ``bench/flops.py``'s count of the SSD."""
    assert SS.scratch_elements(1, 5000, H, P, N, CHUNK) == \
        20 * (2 * H * CHUNK + H * P * N + CHUNK * CHUNK)
    assert SS.scratch_elements(2, 3, H, P, N, CHUNK) == \
        2 * (2 * H * 3 + H * P * N + 9)
    T = 5000
    assert SS.flops(1, T, H, P, N, CHUNK) == \
        2 * T * CHUNK * N + 2 * T * CHUNK * H * P + 4 * T * H * P * N
    # about 4.2 MFLOP a token at granite's widths
    assert 4.1e6 < SS.flops(1, T, H, P, N, CHUNK) / T < 4.3e6
