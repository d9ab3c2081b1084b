"""The redesigned float conv kernels: launch plan, lean wrappers, card shapes.

``conv2d_shift`` and ``conv2d_shift_tiled`` run one CUDA kernel whose CTA
tiling :func:`conv_launch_plan` chooses for the H100 in Python, so the CPU
tests hold the plan to its promises: the CTA tiles cover every output once,
staged halo tiles and taps fit the shared memory a block gets without an
opt-in (a kernel too large for that reads A directly), and a launch of at
least 132·512 outputs has at least 132 CTAs. A numpy walk of the kernel's
index arithmetic (staging by rows, the register strip), with unstaged
shared memory set to NaN, checks that every output is computed from staged
values only. The wrappers keep every rejection they had. The ``cuda`` tests
hold the kernel to its plain version on the card at the shapes the redesign
stresses (many small images, 256×256 reference tiles, odd widths, kh ≠ kw,
bf16/f32 mixes, outputs smaller than one CTA tile, halos past 48 KB) and
skip without one. Integer-valued inputs are exact; float inputs keep the
reference's tolerances (f32 rtol/atol 1e-5, bf16 rtol 3e-2 / atol 0.5).
"""
import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.kernels import conv2d_shift as cs  # noqa: E402
from repro_torch.kernels.conv2d_shift import (  # noqa: E402
    conv2d_shift, conv2d_shift_plain, conv2d_shift_tiled,
    conv2d_shift_tiled_plain, conv_launch_plan)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
STAGED = {"STAGE_TAPS": 0, "DIRECT_CTAS": 0}     # plan knobs: stage all
BF16_TOL = dict(rtol=3e-2, atol=0.5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ctas(p):
    return p.grid[0] * p.grid[1]


def _threads(p):
    """Column, strip and image of each thread of a (TW, TH / R, images)
    block."""
    c, s, i = np.meshgrid(*(np.arange(n) for n in p.block), indexing="ij")
    return c.ravel(), s.ravel(), i.ravel()


def _thread_outputs(p, OH, OW, B):
    """(image, row, column) of every output the launch stores, following
    the kernel: CTA (x, y) owns a TH×TW tile of images_per_cta images,
    thread (c, s, i) rows R·s..R·s+R−1 of column c of image i."""
    ncol = -(-OW // p.TW)
    c, s, i = _threads(p)
    got = []
    for bx in range(p.grid[0]):
        y0, x0 = (bx // ncol) * p.TH, (bx % ncol) * p.TW
        th, tw = min(p.TH, OH - y0), min(p.TW, OW - x0)
        for by in range(p.grid[1]):
            b0 = by * p.images_per_cta
            nimg = min(p.images_per_cta, B - b0)
            for r in range(p.R):
                keep = (i < nimg) & (c < tw) & (s * p.R + r < th)
                got.append(np.stack([b0 + i[keep], y0 + s[keep] * p.R + r,
                                     x0 + c[keep]], 1))
    return np.concatenate(got)


@settings(max_examples=150, deadline=None)
@given(OH=st.integers(1, 2048), OW=st.integers(1, 2048),
       B=st.integers(1, 2000), kh=st.integers(1, 9), kw=st.integers(1, 9),
       bf16=st.integers(0, 1))
def test_launch_plan_tiles_fit_and_fill_the_card(OH, OW, B, kh, kw, bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    es = dtype.itemsize
    p = conv_launch_plan(OH, OW, B, kh, kw, dtype)
    # tiles: whole strips, a thread for each, at most MAX_THREADS of them
    assert p.R in (cs.STRIP, cs.TALL_STRIP) and p.TH % p.R == 0
    assert 1 <= p.TW <= cs.MAX_TILE_W
    assert p.block == (p.TW, p.TH // p.R, p.images_per_cta)
    assert p.threads <= cs.MAX_THREADS and p.images_per_cta <= 64
    # the grid covers every output: row tiles × column tiles, image groups
    assert p.grid == (-(-OH // p.TH) * -(-OW // p.TW),
                      -(-B // p.images_per_cta))
    assert (p.grid[1] - 1) * p.images_per_cta < B
    # shared memory: halo rows 16-byte aligned, taps after them
    pitch = -(-(p.TW + kw - 1) * es // 16) * 16 // es
    halo = p.images_per_cta * (p.TH + kh - 1) * pitch * es
    fits = halo + 4 * p.images_per_cta * kh * kw <= cs.SMEM_BYTES
    # up to 3×3 taps, fewer CTAs than SMs, or a halo tile that does not fit
    # what a block gets without an opt-in: read A directly
    assert p.staged == (kh * kw > cs.STAGE_TAPS
                        and _ctas(p) >= cs.DIRECT_CTAS and fits)
    if not p.staged:
        assert (p.smem, p.pitch, p.taps_off) == (0, 0, 0)
    else:
        assert p.pitch == pitch and p.taps_off == halo
        assert p.smem == halo + 4 * p.images_per_cta * kh * kw
    # at least one CTA per SM once there are 132·512 outputs
    if B * OH * OW >= 132 * 512:
        assert _ctas(p) >= 132
    if OH * OW * B <= 60_000:      # and each output is stored exactly once
        out = _thread_outputs(p, OH, OW, B)
        assert len(out) == B * OH * OW
        flat = (out[:, 0] * OH + out[:, 1]) * OW + out[:, 2]
        assert len(np.unique(flat)) == B * OH * OW


@pytest.mark.parametrize("OH,OW,B,want,k", [
    # (TH, TW, images per CTA, R, staged, threads, CTAs), kernel size
    (62, 6, 126, (64, 6, 1, 4, False, 96, 126), 3),   # the served batch
    (62, 6, 1000, (64, 6, 1, 4, False, 96, 1000), 3),
    (1024, 1024, 1, (16, 128, 1, 8, False, 256, 512), 3),  # the ops path
    (512, 512, 1, (4, 128, 1, 4, False, 128, 512), 3),
    (1024, 1024, 1, (8, 128, 1, 4, True, 256, 1024), 5),   # 25 taps: staged
    (6, 6, 126, (8, 6, 10, 4, False, 120, 13), 3),   # tiny images share
])
def test_launch_plan_at_the_paths_shapes(OH, OW, B, want, k):
    p = conv_launch_plan(OH, OW, B, k, k, torch.float32)
    assert (p.TH, p.TW, p.images_per_cta, p.R, p.staged, p.threads,
            _ctas(p)) == want
    assert p.smem < 16 * 1024


@pytest.mark.parametrize("OH,OW,B,kh,kw,dtype", [
    (8, 5000, 4, 3, 20000, torch.bfloat16),    # a 40 KB halo row
    (64, 64, 200, 1500, 1500, torch.float32),
    (1016, 1, 300, 9, 9, torch.float32),    # 1024-row one-column halos
])
def test_launch_plan_reads_kernels_too_large_to_stage_directly(OH, OW, B, kh,
                                                               kw, dtype):
    p = conv_launch_plan(OH, OW, B, kh, kw, dtype)
    assert kh * kw > cs.STAGE_TAPS and _ctas(p) >= cs.DIRECT_CTAS
    assert not p.staged and p.smem == 0


def _walk_kernel(a, k, p):
    """The kernel's arithmetic in numpy, CTA by CTA: stage the halo rows
    and taps into NaN-filled shared arrays laid out as the plan says (or
    read A directly), accumulate each thread's strip, store the valid
    rows."""
    B, H, W = a.shape
    kh, kw = k.shape[-2:]
    OH, OW = H - kh + 1, W - kw + 1
    ncol, img = -(-OW // p.TW), (p.TH + kh - 1) * p.pitch
    c, s, i = _threads(p)
    out = np.full((B, OH, OW), np.nan)
    for bx in range(p.grid[0]):
        y0, x0 = (bx // ncol) * p.TH, (bx % ncol) * p.TW
        th, tw = min(p.TH, OH - y0), min(p.TW, OW - x0)
        for by in range(p.grid[1]):
            b0 = by * p.images_per_cta
            nimg = min(p.images_per_cta, B - b0)
            live = i < nimg
            acc = np.zeros((p.threads, p.R))
            if not p.staged:      # straight from A, rows past it unread
                for v in range(kh):
                    for h in range(kw):
                        kb = np.where(live, b0 + i, 0) if len(k) > 1 else 0
                        tap = k[kb, v, h]
                        for r in range(p.R):
                            y = y0 + s * p.R + r + v
                            ok = live & (c < tw) & (y < y0 + th + kh - 1)
                            x = a[np.where(ok, b0 + i, 0), np.where(ok, y, 0),
                                  np.where(ok, x0 + c + h, 0)]
                            acc[:, r] += np.where(ok, x * tap, 0)
            if p.staged:
                tile = np.full(p.images_per_cta * img, np.nan)
                taps = np.full(p.images_per_cta * kh * kw, np.nan)
                for ii in range(nimg):
                    for hr in range(th + kh - 1):
                        d = ii * img + hr * p.pitch
                        tile[d:d + tw + kw - 1] = a[
                            b0 + ii, y0 + hr, x0:x0 + tw + kw - 1]
                    kb = b0 + ii if len(k) > 1 else 0
                    taps[ii * kh * kw:(ii + 1) * kh * kw] = k[kb].ravel()
                col = np.where(live, i * img + s * p.R * p.pitch + c, 0)
                tp = np.where(live, i if len(k) > 1 else 0, 0) * kh * kw
                for h in range(kw):
                    for j in range(p.R + kh - 1):
                        x = tile[col + j * p.pitch + h]
                        for r in range(max(0, j - kh + 1), min(p.R, j + 1)):
                            acc[:, r] += np.where(
                                live, x * taps[tp + (j - r) * kw + h], 0)
            for r in range(p.R):
                keep = live & (c < tw) & (s * p.R + r < th)
                out[b0 + i[keep], y0 + s[keep] * p.R + r,
                    x0 + c[keep]] = acc[keep, r]
    return out


@pytest.mark.parametrize("B,H,W,kh,kw,per_image,knobs", [
    (3, 64, 8, 3, 3, True, {}),         # the served tile, read direct
    (3, 64, 8, 3, 3, True, STAGED),                # ... and staged
    (2, 67, 131, 2, 5, False, {}),      # kh != kw, a ragged column tile
    (13, 9, 7, 3, 3, True, {}),         # tiny images, 12 to a CTA
    (1, 40, 70, 4, 4, False, {}),
    (2, 45, 70, 3, 3, True, {"TALL_STRIP_OUTPUTS": 0}),   # 8-row strips
    (2, 45, 70, 3, 3, True, {"TALL_STRIP_OUTPUTS": 0, **STAGED}),
    (2, 30, 40, 5, 5, False, {}),       # 25 taps, few CTAs: direct
    (2, 14, 40, 7, 9, True, {"SMEM_BYTES": 1500, **STAGED}),  # too large
    (1, 12, 90, 5, 60, False, {"SMEM_BYTES": 1500, **STAGED}),  # to stage
])
def test_kernel_walk_reads_only_staged_values(monkeypatch, B, H, W, kh, kw,
                                              per_image, knobs):
    for name, value in knobs.items():
        monkeypatch.setattr(cs, name, value)
    conv_launch_plan.cache_clear()
    try:
        p = conv_launch_plan(H - kh + 1, W - kw + 1, B, kh, kw, torch.float32)
    finally:
        conv_launch_plan.cache_clear()
    # halo tiles past SMEM_BYTES are read directly
    assert p.staged == (knobs.get("STAGE_TAPS") == 0
                        and "SMEM_BYTES" not in knobs)
    assert p.R == (cs.TALL_STRIP if "TALL_STRIP_OUTPUTS" in knobs
                   and not p.staged else cs.STRIP)
    rng = np.random.default_rng(B * H + W)
    a = rng.integers(0, 16, (B, H, W)).astype(np.float64)
    k = rng.integers(-8, 16, (B if per_image else 1, kh, kw)).astype(
        np.float64)
    got = _walk_kernel(a, k, p)
    want = conv2d_shift_plain(torch.from_numpy(a),
                              torch.from_numpy(k if per_image else k[0]))
    np.testing.assert_array_equal(got, want.double().numpy())


def test_tiled_plain_takes_256_tiles_once_refused_by_shared_memory():
    rng = np.random.default_rng(514)
    a = torch.from_numpy(rng.integers(0, 16, (514, 514))).float()
    k = torch.from_numpy(rng.integers(0, 16, (3, 3))).float()
    want = conv2d_shift_plain(a, k)
    assert torch.equal(conv2d_shift_tiled_plain(a, k, 256, 256), want)
    assert torch.equal(conv2d_shift_tiled(a, k, bh=256, bw=256), want)


BAD = [
    (TypeError, lambda: (torch.zeros((8, 8), dtype=torch.int32),
                         torch.zeros((3, 3)))),
    (TypeError, lambda: (torch.zeros((8, 8)),
                         torch.zeros((3, 3), dtype=torch.float16))),
    (ValueError, lambda: (torch.zeros(8), torch.zeros(3))),
    (ValueError, lambda: (torch.zeros((8, 8)), torch.zeros((2, 3, 3)))),
    (ValueError, lambda: (torch.zeros((3, 8, 8)), torch.zeros((2, 3, 3)))),
    (ValueError, lambda: (torch.zeros((8, 8)), torch.zeros((9, 3)))),
    (ValueError, lambda: (torch.zeros((8, 8)), torch.zeros((3, 0)))),
    (ValueError, lambda: (torch.zeros((8, 8)),
                          torch.zeros((3, 3), device="meta"))),
    (ValueError, lambda: (torch.zeros((8, 8), device="meta"),
                          torch.zeros((3, 3), device="meta"))),
]


@pytest.mark.parametrize("wrapper", [conv2d_shift, conv2d_shift_tiled])
@pytest.mark.parametrize("exc,operands", BAD)
def test_wrappers_keep_their_rejections(wrapper, exc, operands):
    a, k = operands()
    before = wrapper.launches
    with pytest.raises(exc):
        wrapper(a, k)
    with pytest.raises(exc):          # a raise is never cached
        wrapper(a, k)
    assert wrapper.launches == before


def test_tiled_rejects_bad_tiles_on_every_call():
    a, k = torch.zeros((34, 34)), torch.zeros((3, 3))     # output 32 × 32
    for _ in range(2):
        with pytest.raises(ValueError, match="tile evenly"):
            conv2d_shift_tiled(a, k, bh=5, bw=32)
        with pytest.raises(ValueError, match="positive"):
            conv2d_shift_tiled(a, k, bh=0, bw=32)
    assert conv2d_shift_tiled(a, k, bh=16, bw=8).shape == (32, 32)


def test_signature_is_cached_per_shape_and_dtype():
    cs._signature.cache_clear()
    a, k = torch.ones((2, 10, 12)), torch.ones((2, 3, 3))
    for _ in range(3):
        assert torch.equal(conv2d_shift(a, k), conv2d_shift_plain(a, k))
    info = cs._signature.cache_info()
    assert (info.misses, info.hits) == (1, 2)
    sig = cs._signature("conv2d_shift", a.shape, k.shape, a.dtype, k.dtype)
    assert sig.out_shape == (2, 8, 10) and sig.n_out == 160
    assert sig.refusal is None and sig.args.k_batched == 1
    assert (sig.args.TH, sig.args.TW, sig.args.ipc) == (8, 10, 2)
    assert sig.args_addr == ctypes.addressof(sig.args)


# -- on the card ----------------------------------------------------------


def _ints(g, shape, hi, dtype=torch.float32):
    return torch.randint(0, hi, shape, generator=g, device="cuda").to(dtype)


CARD = [   # (label, a shape, k shape, a dtype, k dtype, integer inputs)
    ("served", (126, 64, 8), (126, 3, 3), "f32", "f32", True),
    ("1000 images", (1000, 64, 8), (1000, 3, 3), "f32", "f32", True),
    ("odd width", (1026, 1027), (3, 3), "f32", "f32", True),
    ("odd width bf16", (1026, 1027), (3, 3), "bf16", "bf16", True),
    ("kh != kw", (8, 130, 68), (8, 2, 5), "bf16", "bf16", False),
    ("kh != kw shared", (67, 131), (2, 5), "f32", "f32", False),
    ("bf16 a", (5, 33, 31), (3, 3), "bf16", "f32", False),
    ("bf16 k", (5, 33, 31), (5, 3, 3), "f32", "bf16", False),
    ("under one tile", (3, 6, 7), (3, 3, 3), "f32", "f32", False),
    ("single output", (4, 4), (4, 4), "f32", "f32", False),
    ("halo past 48 KB", (4, 8, 20000), (2, 15000), "f32", "f32", True),
]


@pytest.fixture(params=["planned", "staged", "direct"])
def mode(request, monkeypatch):
    """The plan as it is, or with every launch staged in shared memory, or
    with every launch reading A directly."""
    knobs = {"planned": {}, "staged": STAGED,
             "direct": {"STAGE_TAPS": 1 << 40}}[request.param]
    for name, value in knobs.items():
        monkeypatch.setattr(cs, name, value)
    conv_launch_plan.cache_clear()
    cs._signature.cache_clear()
    yield request.param
    conv_launch_plan.cache_clear()
    cs._signature.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("label,ashape,kshape,adt,kdt,integer", CARD)
def test_cuda_conv_matches_plain_at_design_shapes(cuda, mode, label, ashape,
                                                  kshape, adt, kdt, integer):
    dts = {"f32": torch.float32, "bf16": torch.bfloat16}
    g = torch.Generator(device=cuda).manual_seed(len(label))
    if integer:
        a, k = _ints(g, ashape, 16, dts[adt]), _ints(g, kshape, 4, dts[kdt])
    else:
        a = torch.randn(ashape, generator=g, device=cuda).to(dts[adt])
        k = torch.randn(kshape, generator=g, device=cuda).to(dts[kdt])
    if label == "halo past 48 KB":     # read directly in every mode
        assert not conv_launch_plan(7, 5001, 4, 2, 15000, torch.float32).staged
    before = conv2d_shift.launches
    got = conv2d_shift(a, k)
    assert conv2d_shift.launches == before + 1
    want = conv2d_shift_plain(a, k)
    if integer:
        assert torch.equal(got, want)
    else:
        tol = BF16_TOL if "bf16" in (adt, kdt) else F32_TOL
        torch.testing.assert_close(got, want, **tol)


TILED_CARD = [   # (a shape, k shape, bh, bw, a dtype)
    ((514, 514), (3, 3), 256, 256, torch.float32),
    ((1026, 1026), (3, 3), 128, 128, torch.float32),
    ((1026, 1027), (3, 3), 128, 205, torch.bfloat16),
    ((129, 132), (2, 5), 64, 32, torch.float32),
    ((4, 66, 66), (4, 3, 3), 32, 32, torch.bfloat16),
    ((4, 66, 66), (3, 3), 64, 64, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("ashape,kshape,bh,bw,dtype", TILED_CARD)
def test_cuda_tiled_matches_plain_at_design_shapes(cuda, mode, ashape, kshape,
                                                   bh, bw, dtype):
    g = torch.Generator(device=cuda).manual_seed(bh + bw)
    a, k = _ints(g, ashape, 16, dtype), _ints(g, kshape, 16)
    before = conv2d_shift_tiled.launches
    got = conv2d_shift_tiled(a, k, bh, bw)
    assert conv2d_shift_tiled.launches == before + 1
    assert torch.equal(got, conv2d_shift_tiled_plain(a, k, bh, bw))


@pytest.mark.cuda
def test_cuda_conv_on_a_view_with_an_odd_offset(cuda, mode):
    # a contiguous view 4 bytes past a 16-byte boundary: narrower copies
    base = torch.arange(1 + 66 * 66, device=cuda, dtype=torch.float32) % 7
    a, k = base[1:].view(66, 66), torch.ones((3, 3), device=cuda)
    assert a.data_ptr() % 16 == 4
    assert torch.equal(conv2d_shift(a, k), conv2d_shift_plain(a, k))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernel_cannot_take(cuda):
    a = torch.zeros((66, 66), device=cuda)
    k = torch.zeros((3, 3), device=cuda)
    for wrapper in (conv2d_shift, conv2d_shift_tiled):
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(a.t(), k)
        with pytest.raises(ValueError, match="operands on"):
            wrapper(a, k.cpu())
    with pytest.raises(ValueError, match="index range"):
        conv2d_shift(torch.zeros((65536, 3, 3), device=cuda), k)
    assert math.prod(conv2d_shift(a[None], k).shape) == 64 * 64
