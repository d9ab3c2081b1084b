"""The redesigned binary conv kernel: launch plan, numpy walk, lean wrapper.

``binary_conv2d`` runs one CUDA kernel whose launch
:func:`binary_conv_launch_plan` chooses in Python, so the CPU tests hold
the plan to its promises: a group of lanes per output (a power of two that
leaves few unit slots idle), CTA tiles that cover every output once, staged
halo rows and taps within the 48 KB a block gets without an opt-in, and at
least 132 CTAs once there are enough outputs (the ops path's 64×64 outputs
among them). A numpy walk of the kernel's index arithmetic — each halo row
staged as a span (head words, 16-byte chunks, tail words) from base offsets
of 0–3 words into shared memory set to NaN, the taps beside them, each
lane's units of 1 or 4 words, the clamped outputs of a ragged tile, the
group's sum — must equal the plain version, and the plain version the JAX
reference (its oracle and its Pallas kernel in interpret mode) at small
versions of the card's shapes. The wrapper keeps every rejection it had and
caches its signature. The ``cuda`` tests hold the kernel to its plain
version on the card at the design shapes, in every mode, on views at odd
offsets, and skip without one. Every comparison is exact (tolerance 0).
"""
import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.kernels import conv2d_shift as cs  # noqa: E402
from repro_torch.kernels.conv2d_shift import (  # noqa: E402
    binary_conv2d, binary_conv2d_plain, binary_conv_launch_plan)

I32 = torch.int32
DIRECT = {"BCONV_STAGE_TAPS": 1 << 40}    # plan knobs: read A through L1
STAGED = {"BCONV_STAGE_TAPS": 0}          # ... stage row reuse's halos
REUSE = {"BCONV_MIN_CTAS": 1}             # ... row reuse at any size
SPREAD = {"REUSE_KH": (9, 0)}             # ... unit spread at any size


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clear_caches():
    binary_conv_launch_plan.cache_clear()
    cs._binary_signature.cache_clear()


def _plan(monkeypatch, knobs, OH, OW, Cw, kh, kw):
    for name, value in knobs.items():
        monkeypatch.setattr(cs, name, value)
    _clear_caches()
    try:
        return binary_conv_launch_plan(OH, OW, Cw, kh, kw)
    finally:
        _clear_caches()


def _group_outputs(p, OH, OW):
    """(row, column) of every output a launch stores: CTA x owns a TH×TW
    tile, group grp of its threads // G the Q rows rb·Q.. of column c."""
    groups = np.arange(p.threads // p.G)
    rb, c = groups // p.TW, groups % p.TW
    got = []
    for bx in range(p.ctas):
        y0, x0 = (bx // p.grid[1]) * p.TH, (bx % p.grid[1]) * p.TW
        th, tw = min(p.TH, OH - y0), min(p.TW, OW - x0)
        for q in range(p.Q):
            keep = (c < tw) & (rb * p.Q + q < th)
            got.append(np.stack([y0 + rb[keep] * p.Q + q, x0 + c[keep]], 1))
    return np.concatenate(got)


# -- launch plan ----------------------------------------------------------


def _lanes_ok(G, n):
    """G lanes for n units: a power of two up to a warp that idles at most
    1/LANE_WASTE of its slots, and the next power of two would idle more."""
    def idle_ok(G):
        return -(-n // G) * G * cs.LANE_WASTE <= (cs.LANE_WASTE + 1) * n
    return (G & (G - 1) == 0 and 1 <= G <= 32 and (G == 1 or idle_ok(G))
            and (G == 32 or not idle_ok(2 * G)))


@settings(max_examples=200, deadline=None)
@given(OH=st.integers(1, 1100), OW=st.integers(1, 1100),
       Cw=st.integers(1, 300), kh=st.integers(1, 7), kw=st.integers(1, 7))
def test_launch_plan_groups_tiles_fit_and_fill(OH, OW, Cw, kh, kw):
    p = binary_conv_launch_plan(OH, OW, Cw, kh, kw)
    assert p.V == (4 if Cw % 4 == 0 else 1)
    LU = kw * Cw // p.V
    if p.reuse:       # Q rows a group, the lanes sharing a run's units
        assert cs.REUSE_KH[0] <= kh <= cs.REUSE_KH[1]
        assert p.Q == cs.BCONV_Q and p.ctas >= cs.BCONV_MIN_CTAS
        assert _lanes_ok(p.G, LU)
        # staged where the kernel has more than 9 taps and the tile fits
        assert p.staged == (kh * kw > cs.BCONV_STAGE_TAPS and any(
            cs._bconv_smem(*cs._bconv_tile(OH, OW, n // p.G, p.Q)[:2], Cw,
                           kh, kw, p.V)[2] <= cs.SMEM_BYTES
            for n in (256, 128, 64, 32)))
        if not p.staged:      # the most threads that keep 132 CTAs
            for n in (256, 128, 64):
                tile = cs._bconv_tile(OH, OW, n // p.G, p.Q)
                assert n <= p.threads or tile[2][0] * tile[2][1] < 132
    else:             # one output a group, the lanes sharing all its units
        assert p.Q == 1 and _lanes_ok(p.G, kh * LU) and not p.staged
        # one CTA per SM once a warp-sized CTA would give that many
        if OH * OW * p.G >= 132 * 32:
            assert p.ctas >= 132
    # whole warps, groups of G lanes, a tile of groups × Q outputs
    assert p.threads % 32 == 0 and 32 <= p.threads <= cs.BCONV_THREADS
    groups = p.threads // p.G
    assert p.TW & (p.TW - 1) == 0 and groups % p.TW == 0
    assert p.TH * p.TW == groups * p.Q and p.TH % p.Q == 0
    assert p.grid == (-(-OH // p.TH), -(-OW // p.TW))
    # shared memory: halo rows of 16-byte multiples with room for a span's
    # misalignment; units of 4 words keep a pitch ≡ kw·Cw (mod 32 words)
    if p.staged:
        assert p.smem <= cs.SMEM_BYTES and p.pitch % 4 == 0
        assert p.pitch >= (p.TW + kw - 1) * Cw + 3
        assert p.V == 1 or (p.pitch - kw * Cw) % 32 == 0
        assert p.taps_off == 4 * p.pitch * (p.TH + kh - 1)
        assert p.smem >= p.taps_off + 4 * (kh * kw * Cw + 3)
        assert p.taps_off % 16 == 0
    else:
        assert (p.smem, p.pitch, p.taps_off) == (0, 0, 0)
    if OH * OW <= 20_000:           # every output stored exactly once
        out = _group_outputs(p, OH, OW)
        assert len(out) == OH * OW
        assert len(np.unique(out[:, 0] * OW + out[:, 1])) == OH * OW


@pytest.mark.parametrize("OH,OW,Cw,k,want", [
    # (V, G, reuse, Q, TH, TW, threads, staged, CTAs)
    (64, 64, 8, 3, (4, 4, False, 1, 4, 4, 64, False, 256)),  # the ops path
    (512, 512, 8, 3, (4, 2, True, 4, 32, 16, 256, False, 512)),
    (256, 256, 32, 3, (4, 8, True, 4, 16, 8, 256, False, 512)),
    (256, 256, 8, 5, (4, 2, True, 4, 16, 16, 128, True, 256)),  # 25 taps
    (64, 64, 3, 3, (1, 4, False, 1, 4, 4, 64, False, 256)),  # rows off 16 B
    (14, 14, 1, 3, (1, 2, False, 1, 4, 4, 32, False, 16)),   # the reference's
    (16, 16, 4, 5, (4, 4, False, 1, 4, 2, 32, False, 32)),
    (200, 200, 1000, 5, (4, 32, True, 4, 8, 4, 256, False, 1250)),  # > 48 KB
])
def test_launch_plan_at_the_card_shapes(OH, OW, Cw, k, want):
    p = binary_conv_launch_plan(OH, OW, Cw, k, k)
    assert (p.V, p.G, p.reuse, p.Q, p.TH, p.TW, p.threads, p.staged,
            p.ctas) == want
    assert p.smem <= cs.SMEM_BYTES


def test_the_ops_path_fills_every_sm():
    p = binary_conv_launch_plan(64, 64, 8, 3, 3)     # 66×66, C 256, k 3
    assert p.ctas >= 132 and not p.reuse and p.G == 4


# -- a numpy walk of the kernel -------------------------------------------


def _stage_span(mem, start, n, smem):
    """row_stage.cuh::stage_span for 4-byte words: the n words of ``mem``
    from ``start`` (word address in a 16-byte aligned allocation) into
    ``smem[mis:mis + n]``, 16-byte chunks aligned at both ends. Returns
    mis."""
    mis = start % 4
    head = min(n, (4 - mis) % 4)
    nvec = (n - head) // 4
    tail0 = head + nvec * 4
    copied = np.zeros(n, int)
    for c in range(nvec):
        i = head + 4 * c
        assert (start + i) % 4 == 0 and (mis + i) % 4 == 0
        smem[mis + i:mis + i + 4] = mem[start + i:start + i + 4]
        copied[i:i + 4] += 1
    for e in range(head + n - tail0):
        i = e if e < head else tail0 + e - head
        smem[mis + i] = mem[start + i]
        copied[i] += 1
    assert (copied == 1).all()
    return mis


def _popcount(v):
    return np.unpackbits(v.astype(np.uint32)[..., None].view(np.uint8),
                         axis=-1).sum(-1).astype(np.int64)


def _walk_kernel(A, K, p, base=0, kbase=0):
    """binary_conv2d_kernel in numpy, CTA by CTA. A (H, W, Cw) and K (kh,
    kw, Cw) words lie in flat memories from word ``base`` / ``kbase`` on;
    units of 4 words only where both start 16-byte aligned (the C entry's
    choice). Staged: every halo row is a span into a NaN-filled shared
    array at its row's pitch, the taps as one span beside them, and the
    reads use the kernel's row offsets (a row's misalignment from the
    tile's first word). Unit spread: each lane counts units g, g + G, ...
    of all kh runs against its group's output (row clamped to the tile).
    Row reuse: for each unit column j = g, g + G, ... of a run, each of the
    Q + kh − 1 halo rows' unit (clamped to the tile's last halo row) is
    counted against every (output row q, tap row v) with q + v its row.
    The group's sum is stored by lane q % G."""
    H, W, Cw = A.shape
    kh, kw = K.shape[:2]
    OH, OW = H - kh + 1, W - kw + 1
    V = p.V if base % 4 == 0 and kbase % 4 == 0 else 1
    mem = np.concatenate([np.zeros(base), A.ravel().astype(np.float64)])
    kmem = np.concatenate([np.zeros(kbase), K.ravel().astype(np.float64)])
    L, WC = kw * Cw, W * Cw
    LU = L // V
    t = np.arange(p.threads)
    g, grp = t % p.G, t // p.G
    rb, c = grp // p.TW, grp % p.TW
    out = np.full((OH, OW), -1 << 40)

    def count(words, taps):
        assert not np.isnan(words).any() and not np.isnan(taps).any()
        x = words.astype(np.uint64) ^ taps.astype(np.uint64)
        return _popcount(x).sum(-1)

    for bx in range(p.ctas):
        y0, x0 = (bx // p.grid[1]) * p.TH, (bx % p.grid[1]) * p.TW
        th, tw = min(p.TH, OH - y0), min(p.TW, OW - x0)
        src = base + y0 * WC + x0 * Cw
        if p.staged:
            tile = np.full(p.taps_off // 4, np.nan)
            n = (tw + kw - 1) * Cw
            for r in range(th + kh - 1):
                assert r * p.pitch % 4 == 0
                row = tile[r * p.pitch:(r + 1) * p.pitch]
                mis = _stage_span(mem, src + r * WC, n, row)
                assert mis + n <= p.pitch
            taps = np.full((p.smem - p.taps_off) // 4, np.nan)
            tbase = _stage_span(kmem, kbase, kh * L, taps)
            m0 = src % 4
            assert V == 1 or m0 == 0

            def rowoff(r):
                return r * p.pitch + ((m0 + r * (WC % 4)) % 4 if V == 1
                                      else 0)
        else:
            tile, taps, tbase = mem, kmem, kbase

            def rowoff(r):
                return src + r * WC

        def unit(mem, at):
            at = np.asarray(at)
            assert V == 1 or (at % 4 == 0).all()        # uint4 aligned
            return np.stack([mem[at + e] for e in range(V)], -1)

        col = np.minimum(c, tw - 1) * Cw
        row0 = rb * p.Q
        mism = np.zeros((p.Q, p.threads), np.int64)
        if not p.reuse:
            row = np.minimum(row0, th - 1)
            for m in range(-(-kh * LU // p.G)):
                u = g + m * p.G
                ok = u < kh * LU
                v, j = u[ok] // LU, u[ok] % LU
                tap = unit(taps, tbase + (v * LU + j) * V)
                at = [rowoff(r) for r in row[ok] + v] + col[ok] + j * V
                mism[0, ok] += count(unit(tile, at), tap)
        else:
            hr = np.minimum(row0[:, None] + np.arange(p.Q + kh - 1),
                            th + kh - 2)
            ro = np.vectorize(rowoff)(hr) + col[:, None]
            for m in range(-(-LU // p.G)):
                j = g + m * p.G
                ok = j < LU
                for r in range(p.Q + kh - 1):
                    x = unit(tile, ro[ok, r] + j[ok] * V)
                    for v in range(kh):
                        if 0 <= r - v < p.Q:
                            tap = unit(taps, tbase + (v * LU + j[ok]) * V)
                            mism[r - v, ok] += count(x, tap)
        total = 32 * kh * L
        for q in range(p.Q):
            sums = mism[q].reshape(-1, p.G).sum(1)       # __shfl_xor_sync
            orow = row0 + q
            store = (g == q % p.G) & (c < tw) & (orow < th)
            oy, ox = y0 + orow[store], x0 + c[store]
            assert (out[oy, ox] == -1 << 40).all()       # once
            out[oy, ox] = total - 2 * sums[grp[store]]
    assert (out != -1 << 40).all()
    return out


def _words(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _plain(A, K):
    return binary_conv2d_plain(torch.from_numpy(A.view(np.int32)),
                               torch.from_numpy(K.view(np.int32))).numpy()


WALK = [   # (H, W, Cw, kh, kw, knobs)
    (18, 18, 8, 3, 3, {}),            # the ops path's words, 4-word units
    (18, 18, 8, 3, 3, REUSE),         # rows reused, Q = 4
    (18, 18, 8, 3, 3, {**REUSE, **STAGED}),
    (13, 21, 1, 3, 3, {}),            # one word, ragged last tiles
    (13, 21, 1, 3, 3, {**REUSE, **STAGED}),
    (12, 14, 3, 3, 3, {}),            # rows off 16 bytes
    (12, 14, 3, 3, 3, {**REUSE, **STAGED}),
    (12, 14, 3, 3, 3, REUSE),
    (9, 11, 32, 3, 3, REUSE),         # 8 lanes a group
    (9, 11, 32, 3, 3, {}),
    (11, 10, 8, 5, 5, {}),
    (11, 10, 8, 5, 5, REUSE),         # 25 taps: staged
    (11, 10, 3, 5, 5, REUSE),
    (10, 13, 8, 2, 5, {**REUSE, **STAGED}),   # kh != kw
    (13, 9, 3, 4, 2, REUSE),
    (12, 12, 4, 6, 2, REUSE),         # no row reuse compiled for kh 6
    (10, 11, 4, 1, 3, {**REUSE, **STAGED}),
]


@pytest.mark.parametrize("base", [0, 1, 2, 3])
@pytest.mark.parametrize("H,W,Cw,kh,kw,knobs", WALK)
def test_kernel_walk_reads_only_staged_words(monkeypatch, base, H, W, Cw, kh,
                                             kw, knobs):
    p = _plan(monkeypatch, knobs, H - kh + 1, W - kw + 1, Cw, kh, kw)
    assert p.reuse == ("BCONV_MIN_CTAS" in knobs and 2 <= kh <= 5)
    assert p.staged == (p.reuse and (knobs.get("BCONV_STAGE_TAPS") == 0
                                     or kh * kw > 9))
    assert p.Q == (4 if p.reuse else 1)
    rng = np.random.default_rng(H * W + Cw + base)
    A, K = _words(rng, (H, W, Cw)), _words(rng, (kh, kw, Cw))
    want = _plain(A, K)
    np.testing.assert_array_equal(_walk_kernel(A, K, p, base, 0), want)
    # K off 16 bytes too: single words
    np.testing.assert_array_equal(_walk_kernel(A, K, p, base, 3 - base),
                                  want)


def test_kernel_walk_at_the_ops_path_shape():
    rng = np.random.default_rng(66)
    A, K = _words(rng, (66, 66, 8)), _words(rng, (3, 3, 8))
    p = binary_conv_launch_plan(64, 64, 8, 3, 3)
    np.testing.assert_array_equal(_walk_kernel(A, K, p), _plain(A, K))


def test_kernel_walk_of_spread_units_past_48_kb():
    rng = np.random.default_rng(1000)
    A, K = _words(rng, (4, 5, 1000)), _words(rng, (3, 3, 1000))
    p = binary_conv_launch_plan(2, 3, 1000, 3, 3)
    assert not p.staged and not p.reuse
    np.testing.assert_array_equal(_walk_kernel(A, K, p, 1, 2), _plain(A, K))


def test_kernel_walk_of_row_reuse_too_large_to_stage(monkeypatch):
    rng = np.random.default_rng(999)
    A, K = _words(rng, (9, 12, 1000)), _words(rng, (5, 5, 1000))
    p = _plan(monkeypatch, REUSE, 5, 8, 1000, 5, 5)
    assert p.reuse and not p.staged
    np.testing.assert_array_equal(_walk_kernel(A, K, p, 1, 2), _plain(A, K))


# -- the wrapper ------------------------------------------------------------


def test_signature_is_cached_per_shape_and_dtype():
    _clear_caches()
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_words(rng, (10, 12, 8)).view(np.int32))
    k = torch.from_numpy(_words(rng, (3, 3, 8)).view(np.int32))
    for _ in range(3):
        assert torch.equal(binary_conv2d(a, k), binary_conv2d_plain(a, k))
    info = cs._binary_signature.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    sig = cs._binary_signature(a.shape, k.shape, a.dtype, k.dtype)
    assert sig.out_shape == (8, 10) and sig.out_dtype == I32
    assert sig.n_out == 80 and sig.refusal is None
    p = binary_conv_launch_plan(8, 10, 8, 3, 3)
    assert (sig.args.V, 1 << sig.args.lg, sig.args.reuse, sig.args.Q,
            sig.args.TH, sig.args.TW, sig.args.threads, sig.args.staged,
            sig.args.grid_x, sig.args.grid_y) == (
        p.V, p.G, int(p.reuse), p.Q, p.TH, p.TW, p.threads, int(p.staged),
        *p.grid)
    assert sig.args_addr == ctypes.addressof(sig.args)
    # shapes the kernel cannot index are refused on CUDA only
    big = cs._binary_signature((1 << 12, 1 << 12, 128), (3, 3, 128), I32,
                               I32)
    assert big.refusal and "index range" in big.refusal
    big = cs._binary_signature((1 << 16, 1 << 16, 0), (3, 3, 0), I32, I32)
    assert big.refusal and "index range" in big.refusal
    _clear_caches()


BAD = [
    (TypeError, lambda: (torch.zeros((8, 8, 2), dtype=torch.int64),
                         torch.zeros((3, 3, 2), dtype=I32))),
    (TypeError, lambda: (torch.zeros((8, 8, 2), dtype=I32),
                         torch.zeros((3, 3, 2), dtype=torch.uint8))),
    (ValueError, lambda: (torch.zeros((8, 8), dtype=I32),
                          torch.zeros((3, 3), dtype=I32))),
    (ValueError, lambda: (torch.zeros((8, 8, 2), dtype=I32),
                          torch.zeros((3, 3, 3), dtype=I32))),
    (ValueError, lambda: (torch.zeros((8, 8, 2), dtype=I32),
                          torch.zeros((9, 3, 2), dtype=I32))),
    (ValueError, lambda: (torch.zeros((8, 8, 2), dtype=I32),
                          torch.zeros((3, 9, 2), dtype=I32))),
    (ValueError, lambda: (torch.zeros((8, 8, 2), dtype=I32),
                          torch.zeros((0, 3, 2), dtype=I32))),
    (ValueError, lambda: (torch.zeros((8, 8, 2), dtype=I32),
                          torch.zeros((3, 3, 2), dtype=I32, device="meta"))),
    (ValueError, lambda: (torch.zeros((8, 8, 2), dtype=I32, device="meta"),
                          torch.zeros((3, 3, 2), dtype=I32, device="meta"))),
]


@pytest.mark.parametrize("exc,operands", BAD)
def test_wrapper_keeps_its_rejections(exc, operands):
    a, k = operands()
    before = binary_conv2d.launches
    with pytest.raises(exc):
        binary_conv2d(a, k)
    with pytest.raises(exc):          # a raise is never cached
        binary_conv2d(a, k)
    assert binary_conv2d.launches == before


def test_cpu_views_and_empty_channels_take_the_plain_version():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(_words(rng, (9, 12, 8)).view(np.int32))
    k = torch.from_numpy(_words(rng, (3, 3, 8)).view(np.int32))
    before = binary_conv2d.launches
    view = a.transpose(0, 1)          # not contiguous: fine on the CPU
    assert torch.equal(binary_conv2d(view, k), binary_conv2d_plain(view, k))
    empty = binary_conv2d(torch.zeros((5, 5, 0), dtype=I32),
                          torch.zeros((3, 3, 0), dtype=I32))
    assert torch.equal(empty, torch.zeros((3, 3), dtype=I32))
    assert binary_conv2d.launches == before


# -- the plain version against the JAX reference --------------------------


REF = [   # small versions of the card's shapes: (H, W, C, kh, kw)
    (18, 18, 256, 3, 3),      # 66×66×256
    (12, 12, 96, 3, 3),       # 66×66×96: 3-word rows
    (20, 20, 256, 3, 3),      # 514×514×256
    (10, 10, 1024, 3, 3),     # 258×258×1024
    (12, 11, 32, 2, 5),       # kh != kw
]


@pytest.mark.parametrize("H,W,C,kh,kw", REF)
def test_plain_and_walk_match_the_reference(H, W, C, kh, kw):
    jnp = pytest.importorskip("jax.numpy")
    ref_k = pytest.importorskip("repro.kernels.ref")
    from repro.kernels.conv2d_shift import binary_conv2d as ref_kernel
    rng = np.random.default_rng(H * C + kw)
    A, K = _words(rng, (H, W, C // 32)), _words(rng, (kh, kw, C // 32))
    want = np.asarray(ref_k.binary_conv2d_ref(jnp.asarray(A),
                                              jnp.asarray(K)))
    np.testing.assert_array_equal(
        np.asarray(ref_kernel(jnp.asarray(A), jnp.asarray(K),
                              interpret=True)), want)
    np.testing.assert_array_equal(_plain(A, K), want)
    got = binary_conv2d(torch.from_numpy(A.view(np.int32)),
                        torch.from_numpy(K.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    p = binary_conv_launch_plan(H - kh + 1, W - kw + 1, C // 32, kh, kw)
    np.testing.assert_array_equal(_walk_kernel(A, K, p), want)


# -- on the card ----------------------------------------------------------


@pytest.fixture(params=["planned", "direct", "staged", "reuse",
                        "reuse staged", "spread"])
def mode(request, monkeypatch):
    """The plan as it is; every launch reading A through L1; every row
    reuse staged; row reuse whatever the CTA count, direct or staged; unit
    spread whatever the size."""
    knobs = {"planned": {}, "direct": DIRECT, "staged": STAGED,
             "reuse": {**REUSE, **DIRECT}, "reuse staged": {**REUSE, **STAGED},
             "spread": SPREAD}[request.param]
    for name, value in knobs.items():
        monkeypatch.setattr(cs, name, value)
    _clear_caches()
    yield request.param
    _clear_caches()


def _cuda_words(g, shape, offset=0):
    n = int(np.prod(shape))
    flat = torch.randint(-(1 << 31), 1 << 31, (offset + n,), generator=g,
                         device="cuda", dtype=torch.int64).to(I32)
    return flat[offset:].view(shape)


CARD = [   # (H, W, C, kh, kw)
    (66, 66, 256, 3, 3),       # the ops path
    (514, 514, 256, 3, 3),
    (258, 258, 1024, 3, 3),
    (66, 66, 96, 3, 3),        # 3-word rows, off 16 bytes
    (16, 16, 32, 3, 3), (32, 24, 64, 3, 3), (20, 20, 128, 5, 5),
    (67, 131, 64, 2, 5),       # kh != kw, ragged tiles
    (260, 260, 256, 5, 5),     # 25 taps: staged
    (5, 5, 32000, 3, 3),       # taps past 48 KB
]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,kh,kw", CARD)
def test_cuda_binary_conv_matches_plain_at_design_shapes(cuda, mode, H, W, C,
                                                         kh, kw):
    g = torch.Generator(device=cuda).manual_seed(H + C)
    a = _cuda_words(g, (H, W, C // 32))
    k = _cuda_words(g, (kh, kw, C // 32))
    before = binary_conv2d.launches
    got = binary_conv2d(a, k)
    assert binary_conv2d.launches == before + 1
    assert torch.equal(got, binary_conv2d_plain(a, k))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("H,W,C", [(66, 66, 256), (66, 66, 96),
                                   (40, 50, 1024)])
def test_cuda_binary_conv_on_views_at_odd_offsets(cuda, mode, offset, H, W,
                                                  C):
    g = torch.Generator(device=cuda).manual_seed(offset + C)
    a = _cuda_words(g, (H, W, C // 32), offset)
    assert a.data_ptr() % 16 == 4 * offset
    for k in (_cuda_words(g, (3, 3, C // 32)),
              _cuda_words(g, (3, 3, C // 32), 4 - offset)):
        assert torch.equal(binary_conv2d(a, k), binary_conv2d_plain(a, k))
    aligned = a.clone()
    k = _cuda_words(g, (3, 3, C // 32), offset)
    assert torch.equal(binary_conv2d(aligned, k),
                       binary_conv2d_plain(aligned, k))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    a = torch.zeros((66, 66, 8), dtype=I32, device=cuda)
    k = torch.zeros((3, 3, 8), dtype=I32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        binary_conv2d(a.transpose(0, 1), k)
    with pytest.raises(ValueError, match="operands on"):
        binary_conv2d(a, k.cpu())
    empty = binary_conv2d(a[:, :, :0].contiguous(), k[:, :, :0].contiguous())
    assert torch.equal(empty, torch.zeros((64, 64), dtype=I32, device=cuda))
