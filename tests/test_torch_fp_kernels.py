"""The port's full-precision and binary-conv kernels against the reference.

``splitk_matvec``, ``conv2d_shift``, ``conv2d_shift_tiled`` and
``binary_conv2d`` (``repro_torch.kernels``) on the CPU take their plain
PyTorch versions; they must agree with the reference's oracles
(``repro.kernels.ref``) at the shapes of ``tests/test_kernels.py`` and with
the reference's Pallas kernels in interpret mode at one small shape each.
The reference ``conv2d_shift_tiled`` fails on the installed jax (it calls
``pl.load``), so the tiled port is held against ``conv2d_shift_ref`` and the
untiled kernel instead. Tolerances: float32 ``rtol 1e-5`` with ``atol 1e-3``
(matvec, 2048-term sums) or ``1e-5`` (conv); bfloat16 inputs are rounded
once, identically on both sides, so the tolerance covers f32 summation order
only, and the reference's own bf16 tolerances are kept; integer-valued
inputs under 2^24 and the binary conv are exact. The ``cuda`` tests hold each
CUDA kernel to its plain version on the card and skip without one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul  # noqa: E402
from repro_torch.kernels.conv2d_shift import (  # noqa: E402
    binary_conv2d, binary_conv2d_plain, conv2d_shift, conv2d_shift_plain,
    conv2d_shift_tiled, conv2d_shift_tiled_plain)
from repro_torch.kernels.splitk_matvec import (  # noqa: E402
    splitk_matvec, splitk_matvec_plain)

SPLITK = [(256, 512, "f32"), (512, 1024, "bf16"), (1024, 4096, "bf16"),
          (256, 2048, "f32")]
CONV = [(32, 32, 3, "f32"), (64, 48, 5, "f32"), (33, 31, 3, "bf16"),
        (128, 128, 3, "bf16")]
TILED = [(66, 66, 3, 32, 32), (131, 67, 4, 64, 32)]
BCONV = [(16, 16, 32, 3), (32, 24, 64, 3), (20, 20, 128, 5)]
TOL = {("matvec", "f32"): dict(rtol=1e-5, atol=1e-3),
       ("matvec", "bf16"): dict(rtol=2e-2, atol=0.5),
       ("conv", "f32"): dict(rtol=1e-5, atol=1e-5),
       ("conv", "bf16"): dict(rtol=3e-2, atol=0.5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jnp():
    return pytest.importorskip("jax.numpy")


def _pair(shape, dt, seed):
    """Same values for both sides: a numpy float32 array (already rounded
    to bf16 when ``dt`` is bf16) and the torch tensor in ``dt``."""
    jnp = _jnp()
    x = np.random.default_rng(seed).standard_normal(shape)
    if dt == "bf16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        return x, torch.from_numpy(x).to(torch.bfloat16)
    x = x.astype(np.float32)
    return x, torch.from_numpy(x)


def _jdt(dt):
    jnp = _jnp()
    return jnp.bfloat16 if dt == "bf16" else jnp.float32


# -- split-K matvec -----------------------------------------------------------


@pytest.mark.parametrize("M,K,dt", SPLITK)
def test_splitk_matches_reference_oracle(M, K, dt):
    jnp = _jnp()
    ref_k = pytest.importorskip("repro.kernels.ref")
    a_np, a = _pair((M, K), dt, M + K)
    x_np, x = _pair((K,), dt, M + K + 1)
    want = np.asarray(ref_k.splitk_matvec_ref(
        jnp.asarray(a_np, _jdt(dt)), jnp.asarray(x_np, _jdt(dt))))
    tol = TOL[("matvec", dt)]
    got = splitk_matvec(a, x)                 # CPU tensors: plain version
    assert got.dtype == torch.float32 and got.shape == (M,)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(ref.splitk_matvec_ref(a, x).numpy(), want,
                               **tol)


def test_splitk_matches_reference_kernel_interpret():
    jnp = _jnp()
    from repro.kernels.splitk_matvec import splitk_matvec as ref_kernel
    a_np, a = _pair((256, 1024), "f32", 3)
    x_np, x = _pair((1024,), "f32", 4)
    want = np.asarray(ref_kernel(jnp.asarray(a_np), jnp.asarray(x_np),
                                 bk=256, interpret=True))  # 4-way split-K
    np.testing.assert_allclose(splitk_matvec_plain(a, x).numpy(), want,
                               rtol=1e-5, atol=1e-3)


def test_splitk_exact_on_integers_and_batched():
    """Integer-valued operands under 2^24 (the bridge's case) are exact, and
    a batch entry equals the unbatched call."""
    rng = np.random.default_rng(5)
    A = rng.integers(0, 256, size=(27, 64, 39))
    x = rng.integers(0, 256, size=(27, 39))
    y = splitk_matvec(torch.from_numpy(A).float(),
                      torch.from_numpy(x).float())
    assert y.shape == (27, 64)
    np.testing.assert_array_equal(y.numpy().astype(np.int64),
                                  np.einsum("bmk,bk->bm", A, x))
    y3 = splitk_matvec(torch.from_numpy(A[3]).float(),
                       torch.from_numpy(x[3]).float())
    np.testing.assert_array_equal(y3.numpy(), y[3].numpy())


def test_splitk_rejects_bad_operands():
    a = torch.zeros((4, 8))
    with pytest.raises(TypeError):
        splitk_matvec(a.to(torch.float64), torch.zeros(8))
    with pytest.raises(ValueError):
        splitk_matvec(a, torch.zeros(7))
    with pytest.raises(ValueError):
        splitk_matvec(torch.zeros((2, 4, 8)), torch.zeros((3, 8)))


# -- conv2d_shift ---------------------------------------------------------------


@pytest.mark.parametrize("H,W,k,dt", CONV)
def test_conv_matches_reference_oracle(H, W, k, dt):
    jnp = _jnp()
    ref_k = pytest.importorskip("repro.kernels.ref")
    a_np, a = _pair((H, W), dt, H + W + k)
    k_np, kk = _pair((k, k), dt, H + W + k + 1)
    want = np.asarray(ref_k.conv2d_shift_ref(
        jnp.asarray(a_np, _jdt(dt)), jnp.asarray(k_np, _jdt(dt))))
    tol = TOL[("conv", dt)]
    got = conv2d_shift(a, kk)
    assert got.shape == (H - k + 1, W - k + 1)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    np.testing.assert_allclose(ref.conv2d_shift_ref(a, kk).numpy(), want,
                               **tol)


def test_conv_matches_reference_kernel_interpret():
    jnp = _jnp()
    from repro.kernels.conv2d_shift import conv2d_shift as ref_kernel
    a_np, a = _pair((32, 32), "f32", 6)
    k_np, kk = _pair((3, 3), "f32", 7)
    want = np.asarray(ref_kernel(jnp.asarray(a_np), jnp.asarray(k_np),
                                 interpret=True))
    np.testing.assert_allclose(conv2d_shift_plain(a, kk).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_conv_batched_kernels_exact_on_integers():
    """A batch of images with one kernel each (the bridge's case), or one
    kernel for all, equals the per-image calls exactly on integers."""
    rng = np.random.default_rng(8)
    A = torch.from_numpy(rng.integers(0, 256, size=(5, 12, 9))).float()
    Ks = torch.from_numpy(rng.integers(-8, 256, size=(5, 3, 3))).float()
    got = conv2d_shift(A, Ks)
    shared = conv2d_shift(A, Ks[0])
    for b in range(5):
        want = ref.conv2d_shift_ref(A[b], Ks[b])
        assert torch.equal(got[b], want)
        assert torch.equal(shared[b], ref.conv2d_shift_ref(A[b], Ks[0]))
    with pytest.raises(ValueError, match="kernels for"):
        conv2d_shift(A, Ks[:2])


# -- conv2d_shift_tiled ----------------------------------------------------------


@pytest.mark.parametrize("H,W,k,bh,bw", TILED)
def test_tiled_matches_reference_oracle(H, W, k, bh, bw):
    # the reference kernel fails on the installed jax (pl.load), so the
    # tiled port is held against the reference oracle and the untiled kernel
    jnp = _jnp()
    ref_k = pytest.importorskip("repro.kernels.ref")
    a_np, a = _pair((H, W), "f32", H * W)
    k_np, kk = _pair((k, k), "f32", H * W + 1)
    want = np.asarray(ref_k.conv2d_shift_ref(jnp.asarray(a_np),
                                             jnp.asarray(k_np)))
    got = conv2d_shift_tiled(a, kk, bh=bh, bw=bw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, conv2d_shift(a, kk))
    assert torch.equal(conv2d_shift_tiled_plain(a, kk, bh, bw), got)


def test_tiled_rejects_uneven_tiling():
    a, kk = torch.zeros((67, 66)), torch.zeros((3, 3))   # output 65 x 64
    with pytest.raises(ValueError, match="tile evenly"):
        conv2d_shift_tiled(a, kk, bh=32, bw=32)
    with pytest.raises(ValueError, match="tile evenly"):
        ops.conv2d(torch.zeros((131, 130)), kk, tiled=True)  # 129 x 128
    # tiles clamp to the output: one 65 x 64 tile is even
    assert conv2d_shift_tiled(a, kk).shape == (65, 64)


# -- binary_conv2d ----------------------------------------------------------------


def _bconv_operands(H, W, C, k):
    rng = np.random.default_rng(C + k)
    a = rng.choice([-1, 1], size=(H, W, C)).astype(np.float32)
    kk = rng.choice([-1, 1], size=(k, k, C)).astype(np.float32)
    return a, kk


@pytest.mark.parametrize("H,W,C,k", BCONV)
def test_binary_conv_matches_reference_oracle(H, W, C, k):
    jnp = _jnp()
    ref_k = pytest.importorskip("repro.kernels.ref")
    a, kk = _bconv_operands(H, W, C, k)
    ap = ref_k.pack_bits(jnp.asarray(a), axis=-1)
    kp = ref_k.pack_bits(jnp.asarray(kk), axis=-1)
    want = np.asarray(ref_k.binary_conv2d_ref(ap, kp))
    ta = ref.pack_bits(torch.from_numpy(a))
    tk = ref.pack_bits(torch.from_numpy(kk))
    np.testing.assert_array_equal(ta.numpy().view(np.uint32), np.asarray(ap))
    got = binary_conv2d(ta, tk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.binary_conv2d_ref(ta, tk).numpy(),
                                  want)
    dense = np.zeros((H - k + 1, W - k + 1), np.int64)
    for v in range(k):
        for h in range(k):
            dense += np.einsum("hwc,c->hw",
                               a[v:H - k + 1 + v, h:W - k + 1 + h, :],
                               kk[v, h, :]).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), dense)


def test_binary_conv_matches_reference_kernel_interpret():
    jnp = _jnp()
    ref_k = pytest.importorskip("repro.kernels.ref")
    from repro.kernels.conv2d_shift import binary_conv2d as ref_kernel
    a, kk = _bconv_operands(16, 16, 32, 3)
    ap = ref_k.pack_bits(jnp.asarray(a), axis=-1)
    kp = ref_k.pack_bits(jnp.asarray(kk), axis=-1)
    want = np.asarray(ref_kernel(ap, kp, interpret=True))
    got = binary_conv2d_plain(torch.from_numpy(np.array(ap).view(np.int32)),
                              torch.from_numpy(np.array(kp).view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


# -- ops ----------------------------------------------------------------------------


def _launches():
    return (binary_matmul.launches, splitk_matvec.launches,
            conv2d_shift.launches, conv2d_shift_tiled.launches,
            binary_conv2d.launches)


def test_ops_dispatch_on_cpu_to_plain_versions():
    rng = np.random.default_rng(9)
    before = _launches()
    a = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    assert torch.equal(ops.matvec(a, x), splitk_matvec_plain(a, x))
    img = torch.from_numpy(rng.standard_normal((34, 18)).astype(np.float32))
    kk = torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32))
    assert torch.equal(ops.conv2d(img, kk), conv2d_shift_plain(img, kk))
    assert torch.equal(ops.conv2d(img, kk, tiled=True),
                       conv2d_shift_plain(img, kk))
    ab, kb = _bconv_operands(10, 9, 64, 3)
    ap, kp = ref.pack_bits(torch.from_numpy(ab)), ref.pack_bits(
        torch.from_numpy(kb))
    got = ops.conv2d_binary(ap.numpy().view(np.uint32),
                            kp.numpy().view(np.uint64))
    assert torch.equal(got, binary_conv2d_plain(ap, kp))
    w = rng.choice([-1.0, 1.0], size=(8, 64)).astype(np.float32)
    wp = ref.pack_bits(torch.from_numpy(w)).numpy().view(np.uint32)
    xs = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(np.float32))
    dense = ops.binary_dense(xs, wp.view(np.uint64), 64)
    assert dense.shape == (2, 3, 8)
    want = np.where(xs.numpy() > 0, 1, -1) @ w.T
    np.testing.assert_array_equal(dense.numpy(), want.astype(np.int32))
    assert _launches() == before              # CPU operands: no kernel


def test_binary_dense_matches_reference_ops():
    jnp = _jnp()
    from repro.kernels import ops as ref_ops
    rng = np.random.default_rng(1)
    K, N = 64, 8
    x = rng.choice([-1, 1], (4, K)).astype(np.float32)
    w = rng.choice([-1, 1], (N, K)).astype(np.float32)
    wp = np.asarray(ref_ops.pack_bits(jnp.asarray(w)))
    want = np.asarray(ref_ops.binary_dense(jnp.asarray(x), wp, K))
    got = ops.binary_dense(torch.from_numpy(x), wp.view(np.uint64), K)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32,
                                   np.uint64])
def test_as_packed_words_views_unsigned_little_endian(dtype):
    rng = np.random.default_rng(0)
    w32 = rng.integers(0, 1 << 32, size=(8, 4), dtype=np.uint64).astype(
        np.uint32)
    wide = w32.view(dtype)
    got = ops.as_packed_words(wide)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), w32)
    big = wide.astype(np.dtype(dtype).newbyteorder(">"))   # same values
    np.testing.assert_array_equal(
        ops.as_packed_words(big).numpy().view(np.uint32), w32)
    if dtype != np.uint32:         # same bytes as a torch tensor, in place
        tw = torch.from_numpy(wide.copy())
        np.testing.assert_array_equal(
            ops.as_packed_words(tw).numpy().view(np.uint32), w32)
    ref_ops = pytest.importorskip("repro.kernels.ops")
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32), np.asarray(ref_ops.as_packed_words(wide)))


def test_as_packed_words_rejects_signed_and_ragged():
    w32 = np.arange(8, dtype=np.uint32).reshape(2, 4)
    for signed in (np.int32, np.int64, np.int8):
        with pytest.raises(TypeError, match="unsigned"):
            ops.as_packed_words(w32.astype(signed))
    with pytest.raises(TypeError, match="unsigned"):
        ops.as_packed_words(torch.zeros((2, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="whole"):
        ops.as_packed_words(w32.view(np.uint8)[:, :6])    # 1.5 words
    t = torch.zeros((2, 4), dtype=torch.int32)
    assert ops.as_packed_words(t) is t        # the port's words pass through


# -- on the card ---------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,dt", SPLITK + [(1024, 39, "f32")])
def test_cuda_splitk_matches_plain(cuda, M, K, dt):
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(M + K)
    a = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    x = torch.randn((K,), generator=g, device=cuda).to(dtype)
    before = splitk_matvec.launches
    got = splitk_matvec(a, x)
    assert splitk_matvec.launches == before + 1
    torch.testing.assert_close(got, splitk_matvec_plain(a, x),
                               **TOL[("matvec", dt)])
    # integers whose every sum stays under 2^24 (K·15² ≤ 4096·225): exact
    # in any summation order, so the batched launch equals the plain sums
    B = torch.randint(0, 16, (27, M, K), generator=g, device=cuda).float()
    xb = torch.randint(0, 16, (27, K), generator=g, device=cuda).float()
    assert torch.equal(splitk_matvec(B, xb), splitk_matvec_plain(B, xb))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,k,dt", CONV)
def test_cuda_conv_matches_plain(cuda, H, W, k, dt):
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    g = torch.Generator(device=cuda).manual_seed(H + W + k)
    a = torch.randn((H, W), generator=g, device=cuda).to(dtype)
    kk = torch.randn((k, k), generator=g, device=cuda).to(dtype)
    before = conv2d_shift.launches
    got = conv2d_shift(a, kk)
    assert conv2d_shift.launches == before + 1
    torch.testing.assert_close(got, conv2d_shift_plain(a, kk),
                               **TOL[("conv", dt)])
    A = torch.randint(0, 256, (126, 64, 8), generator=g, device=cuda).float()
    Ks = torch.randint(0, 256, (126, 3, 3), generator=g, device=cuda).float()
    assert torch.equal(conv2d_shift(A, Ks), conv2d_shift_plain(A, Ks))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,k,bh,bw", TILED + [(130, 130, 3, 128, 128)])
def test_cuda_tiled_matches_plain(cuda, H, W, k, bh, bw):
    g = torch.Generator(device=cuda).manual_seed(H * W)
    a = torch.randn((H, W), generator=g, device=cuda)
    kk = torch.randn((k, k), generator=g, device=cuda)
    before = conv2d_shift_tiled.launches
    got = conv2d_shift_tiled(a, kk, bh=bh, bw=bw)
    assert conv2d_shift_tiled.launches == before + 1
    torch.testing.assert_close(got, conv2d_shift_plain(a, kk), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,k", BCONV)
def test_cuda_binary_conv_matches_plain(cuda, H, W, C, k):
    a, kk = _bconv_operands(H, W, C, k)
    ap = ref.pack_bits(torch.from_numpy(a).to(cuda))
    kp = ref.pack_bits(torch.from_numpy(kk).to(cuda))
    before = binary_conv2d.launches
    got = binary_conv2d(ap, kp)
    assert binary_conv2d.launches == before + 1
    assert torch.equal(got, binary_conv2d_plain(ap, kp))
