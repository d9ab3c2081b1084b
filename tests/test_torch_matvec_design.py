"""The redesigned matvec kernels: launch plans, row staging, lean wrappers.

``splitk_matvec`` and ``binary_matmul`` stage whole short rows in shared
memory (``csrc/row_stage.cuh``); their launch plans (``matvec_launch_plan``,
``binary_launch_plan``) are Python, so the CPU tests hold them to their
promises: every row (every output) is covered exactly once, shared memory
fits the 48 KB a block gets without an opt-in, and the served shapes
launch at least 132 CTAs. Numpy walks of each kernel's index arithmetic —
the span's head, 16-byte chunks and tail from base offsets of 0–3 words (up
to 7 bf16 elements), each row's walk with its lanes and rotation, the long
rows' 16-byte loads, the binary tiles' padded chunks — read shared memory
set to a NaN sentinel wherever nothing was staged, so a result equal to the
plain version shows that every output reads staged values only. The
wrappers keep every rejection they had, and their per-signature cache. The
plain versions match the JAX reference at the served short shapes (the
oracle and the Pallas kernel in interpret mode; tolerance 0 on integer
inputs). The ``cuda`` tests hold each kernel to its plain version on the
card in every mode, on views at odd offsets, and skip without one.
Integer-valued inputs are exact; float inputs keep the reference's
tolerances (f32 rtol 1e-5 / atol 1e-3, bf16 rtol 2e-2 / atol 0.5).
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import binary_matmul as bmm  # noqa: E402
from repro_torch.kernels import splitk_matvec as skm  # noqa: E402
from repro_torch.kernels.binary_matmul import (  # noqa: E402
    binary_launch_plan, binary_matmul, binary_matmul_plain)
from repro_torch.kernels.splitk_matvec import (  # noqa: E402
    matvec_launch_plan, splitk_matvec, splitk_matvec_plain)

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: dict(rtol=1e-5, atol=1e-3), BF16: dict(rtol=2e-2, atol=0.5)}
# the served shapes: (B, M, K) of splitk_matvec's two buckets (27 tiles of
# MatvecPlan(1024, 39, 8); the 300×500 request's 14 tiles), (B, M, Kw) of
# binary_matmul's three (4096×2048, 1024×384, 300×500 ±1 requests)
SERVED_MV = [(27, 1024, 39), (14, 512, 39)]
SERVED_BIN = [(20, 1024, 13), (2, 1024, 13), (2, 512, 13)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clear_caches():
    for fn in (matvec_launch_plan, binary_launch_plan, skm._signature,
               bmm._signature):
        fn.cache_clear()


# -- launch plans ---------------------------------------------------------


def _covers_rows_once(rows, grid_x, M):
    """CTA x owns rows x·rows .. x·rows + rows − 1 (clipped to M)."""
    owned = np.concatenate([np.arange(x * rows, min(M, (x + 1) * rows))
                            for x in range(grid_x)])
    return len(owned) == M and np.array_equal(np.sort(owned), np.arange(M))


@settings(max_examples=150, deadline=None)
@given(B=st.integers(1, 64), M=st.integers(1, 3000),
       K=st.integers(0, 9000), a_bf16=st.integers(0, 1),
       x_bf16=st.integers(0, 1))
def test_matvec_plan_covers_rows_fits_and_fills(B, M, K, a_bf16, x_bf16):
    a_dt, x_dt = (BF16 if a_bf16 else F32), (BF16 if x_bf16 else F32)
    p = matvec_launch_plan(B, M, K, a_dt, x_dt)
    es = a_dt.itemsize
    assert p.short == (K * es <= skm.SHORT_ROW_BYTES)
    assert p.grid == (-(-M // p.rows), B)
    assert _covers_rows_once(p.rows, p.grid[0], M)
    assert p.smem <= kernels.SMEM_BYTES and p.threads % 32 == 0
    if p.short:
        assert p.grid[0] * p.grid[1] >= min(kernels.MIN_CTAS, B * M)
        # a power of two of rows, one thread or a group of lanes per row
        assert p.rows & (p.rows - 1) == 0 and p.rows <= kernels.MAX_ROWS
        assert p.threads == max(32, p.rows) and p.lanes * p.rows == p.threads
        assert p.x_off >= 16 - es + p.rows * K * es and p.x_off % 16 == 0
        assert p.smem == p.x_off + kernels.span_bytes(1, K, x_dt.itemsize)
        assert p.rot == int(K > 0 and K % 2 == 0)
    else:       # S warps a row, x staged in chunks of at most X_CHUNK
        S = p.lanes // 32
        assert S & (S - 1) == 0 and p.threads == p.lanes * p.rows
        assert p.threads <= 32 * skm.MAX_WARPS
        chunks = -(-p.xchunk * es // 16)
        assert S == skm.MAX_WARPS or chunks <= 32 * skm.PREFETCH * S
        assert S == 1 or chunks > 16 * skm.PREFETCH * S
        assert p.xchunk == min(K, skm.X_CHUNK)
        assert p.x_off == kernels.span_bytes(1, p.xchunk, x_dt.itemsize)
        assert p.smem == p.x_off + 4 * p.threads // 32
        # CTAs keep MIN_ROWS rows (or their warps' rows) to share x
        least = min(skm.MIN_ROWS, skm.MAX_WARPS // S)
        assert p.rows >= least
        assert p.grid[0] * B >= min(kernels.MIN_CTAS, B * -(-M // least))


@settings(max_examples=150, deadline=None)
@given(B=st.integers(1, 64), M=st.integers(1, 3000), N=st.integers(1, 300),
       Kw=st.integers(1, 12000))
def test_binary_plan_covers_outputs_fits_and_fills(B, M, N, Kw):
    p = binary_launch_plan(B, M, N, Kw)
    assert p.smem <= kernels.SMEM_BYTES and p.threads % 32 == 0
    assert p.grid[1] == B
    if p.rows_mode:
        assert N == 1 and p.lanes * p.rows == p.threads
        assert _covers_rows_once(p.rows, p.grid[0], M)
        assert p.grid[0] * B >= min(kernels.MIN_CTAS, B * M)
        assert p.smem == p.x_off + kernels.span_bytes(1, Kw, 4)
    else:
        # rows too long to stage whole at N = 1 take the tile kernel
        assert N > 1 or (kernels.span_bytes(1, Kw, 4) + 4 * Kw
                         > kernels.SMEM_BYTES)
        tm = bmm.TILE_WARPS * p.rm
        assert p.staged == (Kw > bmm.DIRECT_WORDS)
        assert p.smem == (4 * (tm + bmm.TILE_N) * (bmm.K_CHUNK + 1)
                          if p.staged else 0)
        assert p.rows == tm and p.tiles_n == -(-N // bmm.TILE_N)
        assert p.grid[0] == -(-M // tm) * p.tiles_n
        assert _covers_rows_once(tm, -(-M // tm), M)
        if -(-M // bmm.TILE_WARPS) * p.tiles_n * B >= kernels.MIN_CTAS:
            assert p.grid[0] * B >= kernels.MIN_CTAS


@pytest.mark.parametrize("B,M,K,want", [
    # (rows per CTA, threads, lanes per row, CTAs)
    (27, 1024, 39, (128, 128, 1, 216)),     # the served bucket
    (14, 512, 39, (32, 32, 1, 224)),        # the 300×500 request's
])
def test_matvec_plan_at_the_served_shapes(B, M, K, want):
    p = matvec_launch_plan(B, M, K, F32, F32)
    assert p.short and p.rot == 0           # K = 39: odd, no rotation
    assert (p.rows, p.threads, p.lanes, p.grid[0] * p.grid[1]) == want
    assert p.smem < 24 * 1024


@pytest.mark.parametrize("B,M,Kw,want", [
    (20, 1024, 13, (128, 128, 1, 160)),     # the main path's bucket
    (2, 1024, 13, (8, 32, 4, 256)),
    (2, 512, 13, (4, 32, 8, 256)),
])
def test_binary_plan_at_the_served_shapes(B, M, Kw, want):
    p = binary_launch_plan(B, M, 1, Kw)
    assert p.rows_mode and p.rot == 0
    assert (p.rows, p.threads, p.lanes, p.grid[0] * p.grid[1]) == want


@pytest.mark.parametrize("M,K,dt,want", [
    # (rows per CTA, warps per row, CTAs)
    (256, 512, F32, (4, 1, 64)),
    (512, 1024, BF16, (4, 1, 128)),
    (1024, 4096, BF16, (2, 4, 512)),
    (256, 2048, F32, (2, 4, 128)),
])
def test_long_rows_plan_at_the_reference_shapes(M, K, dt, want):
    p = matvec_launch_plan(1, M, K, dt, dt)
    assert not p.short
    assert (p.rows, p.lanes // 32, p.grid[0] * p.grid[1]) == want


def test_tile_plan_of_ops_binary_dense():
    p = binary_launch_plan(1, 64, 1024, 32)          # ops.binary_dense
    assert not p.rows_mode and p.staged and (p.rm, p.grid) == (1, (256, 1))
    p = binary_launch_plan(1, 128, 128, 8)           # the reference's
    assert not p.rows_mode and not p.staged and p.smem == 0


# -- numpy walks of the kernels' index arithmetic -------------------------


def _stage_span(mem, start, n, es, smem):
    """row_stage.cuh::stage_span: the n elements of ``mem`` from ``start``
    (byte address ``start·es`` of a 16-byte aligned allocation) into
    ``smem[mis:mis + n]``; chunk copies must be 16-byte aligned at both
    ends. Returns mis."""
    V = 16 // es
    mis = (start * es % 16) // es
    head = min(n, (V - mis) % V)
    nvec = (n - head) // V
    tail0 = head + nvec * V
    copied = np.zeros(n, int)
    for c in range(nvec):
        i = head + c * V
        assert (start + i) * es % 16 == 0 and (mis + i) * es % 16 == 0
        smem[mis + i:mis + i + V] = mem[start + i:start + i + V]
        copied[i:i + V] += 1
    for e in range(head + n - tail0):
        i = e if e < head else tail0 + e - head
        smem[mis + i] = mem[start + i]
        copied[i] += 1
    assert (copied == 1).all()
    return mis


def _walk_rows(A, x, base, es, xes, p, combine):
    """The short-row kernels (matvec_short_rows, binary_rows), CTA by CTA:
    A (B, M, K) and x (B, K) lie in flat memories from element ``base`` on;
    each CTA stages its rows' span and its x as spans into NaN-filled
    shared arrays, then thread t walks row t // lanes, lanes (t % lanes) +
    lanes·j, rotated by the row's index when ``rot``; ``combine(a_values,
    x_values)`` is a row's partial sum. Returns (B, M)."""
    B, M, K = A.shape
    mem = np.concatenate([np.zeros(base), A.ravel().astype(np.float64)])
    xmem = np.concatenate([np.zeros(base), x.ravel().astype(np.float64)])
    out = np.full((B, M), np.nan)
    written = np.zeros((B, M), int)
    for b in range(B):
        for cx in range(p.grid[0]):
            r0 = cx * p.rows
            nrows = min(p.rows, M - r0)
            sa = np.full(p.x_off // es, np.nan)
            mis = _stage_span(mem, base + (b * M + r0) * K, nrows * K, es, sa)
            assert (mis + nrows * K) * es <= p.x_off
            sx = np.full((p.smem - p.x_off) // xes, np.nan)
            misx = _stage_span(xmem, base + b * K, K, xes, sx)
            for t in range(p.threads):
                r, g = divmod(t, p.lanes)
                if r >= nrows or g:
                    continue
                off = r % K if p.rot else 0
                ks = [(kk + off) % K for gg in range(p.lanes)
                      for kk in range(gg, K, p.lanes)]
                assert sorted(ks) == list(range(K))     # each k once
                ks = np.array(ks, int)
                out[b, r0 + r] = combine(sa[mis + r * K + ks], sx[misx + ks])
                written[b, r0 + r] += 1
    assert (written == 1).all()
    return out


def _dot(av, xv):
    assert not np.isnan(av).any() and not np.isnan(xv).any()
    return float(np.dot(av, xv))


def _mism(av, xv):
    assert not np.isnan(av).any() and not np.isnan(xv).any()
    w = av.astype(np.uint64) ^ xv.astype(np.uint64)
    return int(sum(bin(int(v)).count("1") for v in w))


def _rows_per_cta(monkeypatch, rows):
    """Plans of exactly ``rows`` rows per CTA (as shared memory allows)."""
    monkeypatch.setattr(kernels, "MAX_ROWS", rows)
    monkeypatch.setattr(kernels, "MIN_CTAS", 1)
    _clear_caches()


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("B,M,K,bf16,rows", [
    (2, 40, 39, False, 32),       # the served row length, 2 CTAs a tile
    (3, 10, 39, True, 4),         # bf16: up to 7 elements of head; 8 lanes
    (2, 37, 40, False, 8),        # even K rotates; M not a multiple of R
    (1, 9, 13, False, 2),         # 16 lanes a row
    (2, 1, 3, True, 128),         # spans shorter than a chunk: no body
    (1, 5, 0, False, 128),        # empty rows
])
def test_matvec_short_rows_walk(monkeypatch, base, B, M, K, bf16, rows):
    _rows_per_cta(monkeypatch, rows)
    dt = BF16 if bf16 else F32
    p = matvec_launch_plan(B, M, K, dt, dt)
    _clear_caches()
    assert p.short and p.rows == rows and p.lanes == max(1, 32 // rows)
    rng = np.random.default_rng(B * M + K + base)
    A = rng.integers(0, 256, (B, M, K)).astype(np.float64)
    x = rng.integers(0, 256, (B, K)).astype(np.float64)
    got = _walk_rows(A, x, base, dt.itemsize, dt.itemsize, p, _dot)
    want = splitk_matvec_plain(torch.from_numpy(A), torch.from_numpy(x))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("B,M,Kw,rows", [
    (2, 300, 13, 128),            # the main path's words, M ragged
    (2, 33, 16, 8),               # even Kw rotates, 4 lanes a row
    (1, 7, 31, 1),                # a warp per row
    (3, 4, 2, 2),                 # 8-byte rows
])
def test_binary_rows_walk(monkeypatch, base, B, M, Kw, rows):
    _rows_per_cta(monkeypatch, rows)
    p = binary_launch_plan(B, M, 1, Kw)
    _clear_caches()
    assert p.rows_mode and p.rows == rows
    rng = np.random.default_rng(B * M + Kw + base)
    A = rng.integers(0, 1 << 32, (B, M, Kw), dtype=np.uint64)
    x = rng.integers(0, 1 << 32, (B, Kw), dtype=np.uint64)
    mism = _walk_rows(A, x, base, 4, 4, p, _mism)
    got = 32 * Kw - 2 * mism
    ta = torch.from_numpy(A.astype(np.uint32).view(np.int32))
    tx = torch.from_numpy(x.astype(np.uint32).view(np.int32))[:, None]
    want = binary_matmul_plain(ta, tx)[:, :, 0]
    np.testing.assert_array_equal(got, want.numpy())


def _walk_long_rows(A, x, base, es, xes, p):
    """matvec_long_rows: thread t of CTA (cx, b) is thread rt = t % lanes
    of row cx·rows + t // lanes; per chunk of x (staged raw by stage_span
    into a NaN-filled array), thread rt takes the head element at rt,
    16-byte chunks c ≡ rt (mod lanes) (each load 16-byte aligned, its x
    values a vector read aligned to its width where the kernel takes one)
    and the tail element at tail0 + rt."""
    B, M, K = A.shape
    V = 16 // es
    out = np.full((B, M), np.nan)
    xmem = np.concatenate([np.zeros(base), x.ravel()])
    for b in range(B):
        for cx in range(p.grid[0]):
            for rl in range(p.rows):
                row = cx * p.rows + rl
                if row >= M:
                    continue
                acc, seen = 0.0, np.zeros(K, int)
                for k0 in range(0, K, p.xchunk):
                    n = min(p.xchunk, K - k0)
                    sx = np.full(p.x_off // xes, np.nan)
                    misx = _stage_span(xmem, base + b * K + k0, n, xes, sx)
                    addr = (base + (b * M + row) * K + k0) * es
                    mis = addr % 16 // es
                    head = min(n, (V - mis) % V)
                    nvec = (n - head) // V
                    tail0 = head + nvec * V
                    assert head <= p.lanes and n - tail0 <= p.lanes
                    ks = list(range(head)) + list(range(tail0, n))
                    for rt in range(p.lanes):
                        for c in range(rt, nvec, p.lanes):
                            k = head + c * V
                            assert (addr + k * es) % 16 == 0
                            if (misx + head) % V == 0:
                                assert (misx + k) * xes % (V * xes) == 0
                            ks += range(k, k + V)
                    ks = np.array(ks, int)
                    acc += _dot(A[b, row, k0 + ks], sx[misx + ks])
                    seen[k0 + ks] += 1
                assert (seen == 1).all()
                out[b, row] = acc
    return out


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("B,M,K,a_bf16,x_bf16,xchunk", [
    (1, 9, 512, False, False, None),
    (2, 5, 257, True, True, None),     # rows drift off 16 bytes one by one
    (1, 6, 300, False, True, 72),      # x in chunks of 72
    (1, 4, 1030, True, False, 200),
    (1, 3, 600, False, False, None),   # 2 warps a row
])
def test_matvec_long_rows_walk(monkeypatch, base, B, M, K, a_bf16, x_bf16,
                               xchunk):
    if xchunk:
        monkeypatch.setattr(skm, "X_CHUNK", xchunk)
    _clear_caches()
    a_dt, x_dt = (BF16 if a_bf16 else F32), (BF16 if x_bf16 else F32)
    p = matvec_launch_plan(B, M, K, a_dt, x_dt)
    _clear_caches()
    assert not p.short and p.xchunk == min(K, xchunk or K)
    assert p.lanes == (64 if K == 600 else 32)
    rng = np.random.default_rng(M + K + base)
    A = rng.integers(0, 16, (B, M, K)).astype(np.float64)
    x = rng.integers(0, 16, (B, K)).astype(np.float64)
    got = _walk_long_rows(A, x, base, a_dt.itemsize, x_dt.itemsize, p)
    want = splitk_matvec_plain(torch.from_numpy(A), torch.from_numpy(x))
    np.testing.assert_array_equal(got, want.numpy())


def _popcount(v):
    return np.unpackbits(v.astype(np.uint64)[..., None].view(np.uint8),
                         axis=-1).sum(-1).astype(np.int64)


def _walk_tiles(A, Bm, p):
    """binary_tiles: CTA (cx, b) stages TM rows of A and TILE_N of B, a
    chunk of K_CHUNK words at a time (word w of each row by lane w), at
    pitch K_CHUNK + 1 into NaN-filled arrays (rows past M or N, and words
    past the chunk, as zeros), or, unstaged, reads rows clamped to M − 1
    and N − 1; thread (lane, warp) counts B row j0 + lane against A rows
    i0 + warp + 8·r."""
    nb, M, Kw = A.shape
    N = Bm.shape[1]
    W, TN, KC = bmm.TILE_WARPS, bmm.TILE_N, bmm.K_CHUNK
    tm, P = p.rows, KC + 1
    lane, warp = np.arange(32), np.arange(W)
    out = np.full((nb, M, N), -1 << 40)
    for b in range(nb):
        for cx in range(p.grid[0]):
            ti, tj = divmod(cx, p.tiles_n)
            i0, j0 = ti * tm, tj * TN
            mism = np.zeros((p.rm, W, 32), int)
            if not p.staged:
                bw = Bm[b, np.minimum(j0 + lane, N - 1)]        # (32, Kw)
                for r in range(p.rm):
                    aw = A[b, np.minimum(i0 + warp + W * r, M - 1)]
                    mism[r] = _popcount(aw[:, None, :] ^ bw[None]).sum(-1)
            for k0 in range(0, Kw, KC) if p.staged else ():
                kc = min(KC, Kw - k0)
                sa, sb = np.full(tm * P, np.nan), np.full(TN * P, np.nan)
                for s, m, row0, nrows, n in ((sa, A[b], i0, tm, M),
                                             (sb, Bm[b], j0, TN, N)):
                    for e in range(nrows * KC):
                        r, w = divmod(e, KC)
                        i = row0 + r
                        s[r * P + w] = m[i, k0 + w] if i < n and w < kc else 0
                bw = sb.reshape(TN, P)[lane, :kc]               # (32, kc)
                for r in range(p.rm):
                    aw = sa.reshape(tm, P)[warp + W * r, :kc]   # (W, kc)
                    assert not np.isnan(aw).any() and not np.isnan(bw).any()
                    mism[r] += _popcount(aw[:, None, :].astype(np.uint64)
                                         ^ bw[None].astype(np.uint64)).sum(-1)
            for r in range(p.rm):
                for w in warp:
                    i, j = i0 + w + W * r, j0 + lane
                    if i >= M:
                        continue
                    keep = j < N
                    assert (out[b, i, j[keep]] == -1 << 40).all()  # once
                    out[b, i, j[keep]] = 32 * Kw - 2 * mism[r, w, keep]
    return out


@pytest.mark.parametrize("B,M,N,Kw,min_ctas", [
    (1, 8, 8, 1, None),           # the reference's smallest shape: direct
    (2, 20, 40, 35, None),        # two chunks, ragged N and M
    (1, 70, 33, 5, 1),            # 4 A rows a thread, direct
    (1, 45, 70, 20, 1),           # 4 A rows a thread, staged
])
def test_binary_tiles_walk(monkeypatch, B, M, N, Kw, min_ctas):
    if min_ctas:
        monkeypatch.setattr(bmm, "MIN_CTAS", min_ctas)
    _clear_caches()
    p = binary_launch_plan(B, M, N, Kw)
    _clear_caches()
    assert not p.rows_mode and p.rm == (bmm.MAX_RM if min_ctas else 1)
    assert p.staged == (Kw > bmm.DIRECT_WORDS)
    rng = np.random.default_rng(M + N + Kw)
    A = rng.integers(0, 1 << 32, (B, M, Kw), dtype=np.uint64)
    Bm = rng.integers(0, 1 << 32, (B, N, Kw), dtype=np.uint64)
    got = _walk_tiles(A, Bm, p)
    want = binary_matmul_plain(
        torch.from_numpy(A.astype(np.uint32).view(np.int32)),
        torch.from_numpy(Bm.astype(np.uint32).view(np.int32)))
    np.testing.assert_array_equal(got, want.numpy())


# -- wrappers -------------------------------------------------------------


def test_signatures_are_cached_per_shape_and_dtype():
    _clear_caches()
    a, x = torch.ones((3, 20, 39)), torch.ones((3, 39))
    for _ in range(3):
        assert torch.equal(splitk_matvec(a, x), splitk_matvec_plain(a, x))
    info = skm._signature.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    sig = skm._signature(a.shape, x.shape, a.dtype, x.dtype)
    assert sig.out_shape == (3, 20) and sig.n_out == 60
    assert sig.refusal is None and sig.args.short_rows == 1
    assert (sig.args.rows, sig.args.lanes, sig.args.grid_x) == (1, 32, 20)
    assert sig.args_addr == ctypes.addressof(sig.args)
    wa = torch.zeros((20, 13), dtype=torch.int32)
    wx = torch.zeros((1, 13), dtype=torch.int32)
    for _ in range(2):
        assert binary_matmul(wa, wx).shape == (20, 1)
    info = bmm._signature.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    sig = bmm._signature(wa.shape, wx.shape, wa.dtype, wx.dtype)
    assert sig.out_shape == (20, 1) and sig.out_dtype == torch.int32
    assert sig.args.rows_mode == 1 and sig.args.Kw == 13
    # shapes the kernel cannot index are refused on CUDA only
    big = skm._signature((70000, 4, 4), (70000, 4), F32, F32)
    assert big.refusal and "index range" in big.refusal
    big = bmm._signature((1 << 16, 1 << 15), (1, 1 << 15), torch.int32,
                         torch.int32)
    assert big.refusal and "index range" in big.refusal
    _clear_caches()


I32 = torch.int32
BAD_MV = [
    (TypeError, lambda: (torch.zeros((4, 8), dtype=torch.float64),
                         torch.zeros(8))),
    (TypeError, lambda: (torch.zeros((4, 8)),
                         torch.zeros(8, dtype=torch.float16))),
    (ValueError, lambda: (torch.zeros((4, 8)), torch.zeros(7))),
    (ValueError, lambda: (torch.zeros((2, 4, 8)), torch.zeros((3, 8)))),
    (ValueError, lambda: (torch.zeros(8), torch.zeros(8))),
    (ValueError, lambda: (torch.zeros((4, 8)), torch.zeros((1, 8)))),
    (ValueError, lambda: (torch.zeros((4, 8)),
                          torch.zeros(8, device="meta"))),
    (ValueError, lambda: (torch.zeros((4, 8), device="meta"),
                          torch.zeros(8, device="meta"))),
]
BAD_BIN = [
    (TypeError, lambda: (torch.zeros((4, 3), dtype=torch.int64),
                         torch.zeros((1, 3), dtype=I32))),
    (TypeError, lambda: (torch.zeros((4, 3), dtype=I32),
                         torch.zeros((1, 3), dtype=torch.uint8))),
    (ValueError, lambda: (torch.zeros((4, 3), dtype=I32),
                          torch.zeros((4, 2), dtype=I32))),
    (ValueError, lambda: (torch.zeros((2, 4, 3), dtype=I32),
                          torch.zeros((4, 3), dtype=I32))),
    (ValueError, lambda: (torch.zeros((2, 4, 3), dtype=I32),
                          torch.zeros((3, 1, 3), dtype=I32))),
    (ValueError, lambda: (torch.zeros(3, dtype=I32),
                          torch.zeros(3, dtype=I32))),
    (ValueError, lambda: (torch.zeros((4, 3), dtype=I32),
                          torch.zeros((1, 3), dtype=I32, device="meta"))),
    (ValueError, lambda: (torch.zeros((4, 3), dtype=I32, device="meta"),
                          torch.zeros((1, 3), dtype=I32, device="meta"))),
]


@pytest.mark.parametrize("wrapper,exc,operands",
                         [(splitk_matvec, e, o) for e, o in BAD_MV]
                         + [(binary_matmul, e, o) for e, o in BAD_BIN])
def test_wrappers_keep_their_rejections(wrapper, exc, operands):
    a, b = operands()
    before = wrapper.launches
    with pytest.raises(exc):
        wrapper(a, b)
    with pytest.raises(exc):          # a raise is never cached
        wrapper(a, b)
    assert wrapper.launches == before


def test_empty_operands_need_no_launch():
    assert splitk_matvec(torch.zeros((0, 5)), torch.zeros(5)).shape == (0,)
    assert torch.equal(splitk_matvec(torch.zeros((3, 0)), torch.zeros(0)),
                       torch.zeros(3))
    assert binary_matmul(torch.zeros((0, 2), dtype=I32),
                         torch.zeros((1, 2), dtype=I32)).shape == (0, 1)


# -- the plain versions against the JAX reference -------------------------


@pytest.mark.parametrize("M,K", [(1024, 39), (512, 39)])
def test_splitk_plain_matches_reference_at_served_shapes(M, K):
    jnp = pytest.importorskip("jax.numpy")
    ref_k = pytest.importorskip("repro.kernels.ref")
    from repro.kernels.splitk_matvec import splitk_matvec as ref_kernel
    rng = np.random.default_rng(M + K)
    a = rng.integers(0, 256, (M, K)).astype(np.float32)
    x = rng.integers(0, 256, K).astype(np.float32)
    got = splitk_matvec(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_k.splitk_matvec_ref(jnp.asarray(a),
                                                        jnp.asarray(x))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_kernel(jnp.asarray(a), jnp.asarray(x),
                                           interpret=True)))


@pytest.mark.parametrize("M,Kw", [(1024, 13), (512, 13), (256, 7),
                                  (128, 31)])
def test_binary_plain_matches_reference_at_served_shapes(M, Kw):
    jnp = pytest.importorskip("jax.numpy")
    ref_k = pytest.importorskip("repro.kernels.ref")
    from repro.kernels.binary_matmul import binary_matmul as ref_kernel
    rng = np.random.default_rng(M + Kw)
    a = rng.integers(0, 1 << 32, (M, Kw), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 1 << 32, (1, Kw), dtype=np.uint64).astype(np.uint32)
    got = binary_matmul(torch.from_numpy(a.view(np.int32)),
                        torch.from_numpy(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        ref_k.binary_matmul_packed_ref(jnp.asarray(a), jnp.asarray(x),
                                       32 * Kw)))
    np.testing.assert_array_equal(got, np.asarray(
        ref_kernel(jnp.asarray(a), jnp.asarray(x), bk=Kw, interpret=True)))


# -- on the card ----------------------------------------------------------


@pytest.fixture(params=["planned", "small CTAs", "other kernel",
                        "chunked"])
def mode(request, monkeypatch):
    """The plans as they are; with at most 8 rows a CTA (groups of lanes
    per row) and every binary tile read directly; with every launch on the
    other kernel (long rows for splitk_matvec, tiles for binary_matmul at N
    = 1); with long rows' x in chunks of 72 and binary tiles of 4 A rows a
    thread."""
    knobs = {"planned": {}, "small CTAs": {(kernels, "MAX_ROWS"): 8,
                                           (bmm, "DIRECT_WORDS"): 1 << 20},
             "other kernel": {(skm, "SHORT_ROW_BYTES"): -1,
                              (kernels, "SMEM_BYTES"): 0},
             "chunked": {(skm, "X_CHUNK"): 72, (bmm, "MIN_CTAS"): 1}}
    for (mod, name), value in knobs[request.param].items():
        monkeypatch.setattr(mod, name, value)
    _clear_caches()
    yield request.param
    _clear_caches()


def _ints(g, shape, hi, dtype):
    return torch.randint(0, hi, shape, generator=g, device="cuda").to(dtype)


MV_CARD = [   # (label, B, M, K, a dtype, x dtype, integer inputs)
    ("served", 27, 1024, 39, F32, F32, True),
    ("300x500 bucket", 14, 512, 39, F32, F32, True),
    ("bf16 a", 27, 1024, 39, BF16, F32, True),
    ("bf16 x", 3, 100, 39, F32, BF16, False),
    ("bf16 both", 2, 257, 39, BF16, BF16, False),
    ("M not a multiple of R", 3, 1000, 39, F32, F32, True),
    ("even K", 4, 300, 40, F32, F32, True),
    ("K 1", 2, 77, 1, F32, F32, True),
    ("long f32", 0, 256, 512, F32, F32, False),
    ("long bf16", 0, 1024, 4096, BF16, BF16, False),
    ("long odd K", 2, 33, 1031, F32, BF16, True),
    ("long bf16 odd K", 1, 70, 2053, BF16, BF16, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,B,M,K,adt,xdt,integer", MV_CARD)
def test_cuda_splitk_matches_plain(cuda, mode, label, B, M, K, adt, xdt,
                                   integer):
    g = torch.Generator(device=cuda).manual_seed(M + K)
    lead = (B,) if B else ()
    if integer:
        a, x = _ints(g, lead + (M, K), 16, adt), _ints(g, lead + (K,), 16, xdt)
    else:
        a = torch.randn(lead + (M, K), generator=g, device=cuda).to(adt)
        x = torch.randn(lead + (K,), generator=g, device=cuda).to(xdt)
    before = splitk_matvec.launches
    got = splitk_matvec(a, x)
    assert splitk_matvec.launches == before + 1
    want = splitk_matvec_plain(a, x)
    if integer:
        assert torch.equal(got, want)
    else:
        tol = TOL[BF16 if BF16 in (adt, xdt) else F32]
        torch.testing.assert_close(got, want, **tol)


BIN_CARD = [   # (B, M, N, Kw)
    (20, 1024, 1, 13), (2, 1024, 1, 13), (2, 512, 1, 13),   # served
    (3, 1000, 1, 13),            # M not a multiple of R
    (2, 300, 1, 16), (1, 77, 1, 31), (1, 50, 1, 100),      # even, odd, long
    (0, 8, 8, 1), (0, 128, 128, 8), (0, 64, 256, 16),      # the reference's
    (0, 64, 1024, 32),           # ops.binary_dense
    (2, 45, 70, 35),             # ragged tiles, two chunks
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,M,N,Kw", BIN_CARD)
def test_cuda_binary_matches_plain(cuda, mode, B, M, N, Kw):
    g = torch.Generator(device=cuda).manual_seed(M + N + Kw)
    lead = (B,) if B else ()
    a = torch.randint(-(1 << 31), 1 << 31, lead + (M, Kw), generator=g,
                      device=cuda, dtype=torch.int64).to(I32)
    b = torch.randint(-(1 << 31), 1 << 31, lead + (N, Kw), generator=g,
                      device=cuda, dtype=torch.int64).to(I32)
    before = binary_matmul.launches
    got = binary_matmul(a, b)
    assert binary_matmul.launches == before + 1
    assert torch.equal(got, binary_matmul_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 5, 7])
def test_cuda_kernels_on_views_at_odd_offsets(cuda, mode, offset):
    # contiguous views whose every row starts off 16 bytes
    g = torch.Generator(device=cuda).manual_seed(offset)
    for dt, M, K in ((F32, 300, 39), (BF16, 300, 39), (F32, 40, 600),
                     (BF16, 40, 1100)):
        flat = _ints(g, (offset + 3 * M * K,), 16, dt)
        a = flat[offset:].view(3, M, K)
        x = _ints(g, (offset + 3 * K,), 16, dt)[offset:].view(3, K)
        assert a.data_ptr() % 16 == offset * dt.itemsize % 16
        assert torch.equal(splitk_matvec(a, x), splitk_matvec_plain(a, x))
    flat = torch.randint(-(1 << 31), 1 << 31, (offset + 2 * 1024 * 13,),
                         generator=g, device=cuda, dtype=torch.int64).to(I32)
    a = flat[offset:].view(2, 1024, 13)
    x = flat[offset:offset + 2 * 13].view(2, 1, 13)
    assert torch.equal(binary_matmul(a, x), binary_matmul_plain(a, x))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    a, x = torch.zeros((64, 39), device=cuda), torch.zeros(39, device=cuda)
    w = torch.zeros((64, 13), dtype=I32, device=cuda)
    for wrapper, l, r in ((splitk_matvec, a, x),
                          (binary_matmul, w, w[:1])):
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(l.t().contiguous().t(), r)
        with pytest.raises(ValueError, match="operands on"):
            wrapper(l, r.cpu())
    with pytest.raises(ValueError, match="index range"):
        splitk_matvec(torch.zeros((65536, 1, 1), device=cuda),
                      torch.zeros((65536, 1), device=cuda))
    assert torch.equal(splitk_matvec(a[:, :0], x[:0]),
                       torch.zeros(64, device=cuda))
