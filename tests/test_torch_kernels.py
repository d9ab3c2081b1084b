"""The port's ``binary_matmul`` against the reference's Pallas kernel.

On the CPU the wrapper takes its plain PyTorch version; it must equal the
reference kernel (``repro.kernels.binary_matmul`` in interpret mode) and the
reference oracles ``ref.binary_matmul_ref`` / ``ref.binary_matmul_packed_ref``
exactly, at the shapes of ``tests/test_kernels.py``. The tests marked
``cuda`` hold the CUDA kernel to the plain version on the card and skip
without one; they need no reference package, so they run where jax is
absent. Reference imports happen inside the tests for the same reason.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.binary_matmul import (binary_matmul,  # noqa: E402
                                               binary_matmul_plain)

SHAPES = [(8, 8, 32), (16, 8, 64), (128, 128, 256), (64, 256, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(M, N, K, seed):
    rng = np.random.default_rng(seed)
    return (rng.choice([-1, 1], size=(M, K)).astype(np.float32),
            rng.choice([-1, 1], size=(N, K)).astype(np.float32))


def test_pack_bits_matches_reference():
    jnp = pytest.importorskip("jax.numpy")
    ref_k = pytest.importorskip("repro.kernels.ref")
    x = np.random.default_rng(0).choice([-1.0, 1.0], size=(4, 96))
    want = np.asarray(ref_k.pack_bits(jnp.asarray(x)))
    got = ref.pack_bits(torch.from_numpy(x)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # packing along another axis
    want0 = np.asarray(ref_k.pack_bits(jnp.asarray(x.T), axis=0))
    got0 = ref.pack_bits(torch.from_numpy(x.T), axis=0).numpy()
    np.testing.assert_array_equal(got0.view(np.uint32), want0)


@pytest.mark.parametrize("M,N,K", SHAPES)
def test_plain_matches_reference_kernel(M, N, K):
    jnp = pytest.importorskip("jax.numpy")
    ref_k = pytest.importorskip("repro.kernels.ref")
    from repro.kernels.binary_matmul import binary_matmul as ref_kernel
    a, b = _operands(M, N, K, M + N + K)
    ap, bp = ref_k.pack_bits(jnp.asarray(a)), ref_k.pack_bits(jnp.asarray(b))
    want = np.asarray(ref_kernel(ap, bp, interpret=True))
    ta = torch.from_numpy(np.array(ap).view(np.int32))
    tb = torch.from_numpy(np.array(bp).view(np.int32))
    got = binary_matmul(ta, tb)               # CPU tensors: plain version
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        binary_matmul_plain(ta, tb).numpy(), want)
    np.testing.assert_array_equal(ref.binary_matmul_ref(
        torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_k.binary_matmul_ref(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        ref.binary_matmul_packed_ref(ta, tb, K).numpy(),
        np.asarray(ref_k.binary_matmul_packed_ref(ap, bp, K)))


@pytest.mark.parametrize("M,N,Kw", [(5, 3, 1), (7, 1, 13), (1, 9, 40)])
def test_plain_batched_ragged_shapes(M, N, Kw):
    """No block divisibility: any (M, N, Kw), with a leading batch axis
    equal to the per-instance function."""
    rng = np.random.default_rng(M * N * Kw)
    a = torch.from_numpy(rng.integers(-2**31, 2**31, size=(3, M, Kw),
                                      dtype=np.int64).astype(np.int32))
    b = torch.from_numpy(rng.integers(-2**31, 2**31, size=(3, N, Kw),
                                      dtype=np.int64).astype(np.int32))
    got = binary_matmul(a, b)
    assert got.shape == (3, M, N) and got.dtype == torch.int32
    for i in range(3):
        ua = a[i].numpy().view(np.uint32)
        ub = b[i].numpy().view(np.uint32)
        x = ua[:, None, :] ^ ub[None, :, :]
        mism = np.unpackbits(x.view(np.uint8), axis=-1).reshape(
            M, N, -1).sum(-1).astype(np.int64)
        np.testing.assert_array_equal(got[i].numpy(), 32 * Kw - 2 * mism)


def test_wrapper_checks():
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        binary_matmul(a.to(torch.int64), a)
    with pytest.raises(ValueError):
        binary_matmul(a, torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        binary_matmul(a[None], a)


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", SHAPES + [(1024, 1, 416), (300, 7, 33)])
def test_cuda_kernel_matches_plain(cuda, M, N, K):
    a, b = _operands(M, N, K, 7 * M + N)
    ta = ref.pack_bits(torch.from_numpy(np.pad(a, ((0, 0), (0, -K % 32)))))
    tb = ref.pack_bits(torch.from_numpy(np.pad(b, ((0, 0), (0, -K % 32)))))
    before = binary_matmul.launches
    got = binary_matmul(ta.to(cuda), tb.to(cuda))
    torch.cuda.synchronize()
    assert binary_matmul.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  binary_matmul_plain(ta, tb).numpy())
    # batched: one launch for every instance
    ga = torch.stack([ta, ~ta]).to(cuda)
    gb = torch.stack([tb, tb]).to(cuda)
    got = binary_matmul(ga, gb)
    torch.cuda.synchronize()
    assert binary_matmul.launches == before + 2
    np.testing.assert_array_equal(
        got.cpu().numpy(), binary_matmul_plain(ga.cpu(), gb.cpu()).numpy())


def test_crossbar_binary_matvec_oracle():
    """The port's crossbar-engine matvec oracle equals the dense ±1 dot
    product and the reference's oracle on the same seed, exactly."""
    ref_k = pytest.importorskip("repro.kernels.ref")
    rng = np.random.default_rng(11)
    M, K = 24, 64
    a = rng.choice([-1, 1], size=(M, K))
    x = rng.choice([-1, 1], size=K)
    got = ref.crossbar_binary_matvec_ref(a, x, device="cpu")
    np.testing.assert_array_equal(got, a @ x)
    np.testing.assert_array_equal(got, ref_k.crossbar_binary_matvec_ref(a, x))


@pytest.mark.parametrize("M,N,K", [(16, 4, 64), (1100, 2, 700)])
def test_binary_matmul_vs_crossbar_engine(M, N, K):
    """The port's ``binary_matmul`` (its plain version on the CPU) agrees
    with the port's compiled crossbar simulator, and that with the
    reference's; the second shape spans two row tiles and two K tiles."""
    ref_k = pytest.importorskip("repro.kernels.ref")
    rng = np.random.default_rng(5)
    a = rng.choice([-1, 1], size=(M, K)).astype(np.float32)
    b = rng.choice([-1, 1], size=(N, K)).astype(np.float32)
    pad = ((0, 0), (0, -K % 32))
    got = binary_matmul(ref.pack_bits(torch.from_numpy(np.pad(a, pad))),
                        ref.pack_bits(torch.from_numpy(np.pad(b, pad))))
    want = ref.crossbar_binary_matmul_ref(a, b, device="cpu")
    # zero padding packs to bit 0 (−1) on both sides: K % 32 extra matches
    np.testing.assert_array_equal(got.numpy(), want + (-K % 32))
    np.testing.assert_array_equal(want, a.astype(np.int64) @ b.T)
    if M * K <= 1024:   # the reference's engine is slow past one tile
        np.testing.assert_array_equal(
            want, ref_k.crossbar_binary_matmul_ref(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(1024, 20, 416), (1100, 3, 700)])
def test_cuda_kernel_matches_crossbar_engine(cuda, M, N, K):
    """The CUDA kernel equals the crossbar engine replayed on the card
    (``backend="torch"``), bit for bit."""
    rng = np.random.default_rng(M + N)
    a = rng.choice([-1, 1], size=(M, K)).astype(np.float32)
    b = rng.choice([-1, 1], size=(N, K)).astype(np.float32)
    pad = ((0, 0), (0, -K % 32))
    got = binary_matmul(ref.pack_bits(torch.from_numpy(np.pad(a, pad))).to(cuda),
                        ref.pack_bits(torch.from_numpy(np.pad(b, pad))).to(cuda))
    want = ref.crossbar_binary_matmul_ref(a, b, device=cuda)
    np.testing.assert_array_equal(got.cpu().numpy(), want + (-K % 32))
