"""The port's ``decode_attention`` against the masked softmax of ``_sdpa``.

On the CPU the wrapper takes its plain PyTorch version, which must equal
``models.layers._sdpa`` under the ``pos`` mask, the path a decode step took
before the kernel, for 1, 2 and 7 query heads a KV head, head sizes 16,
64, 80 and 128, and ``pos`` at 0, at a chunk boundary of the kernel's
launch plan and at ``S_max - 1``. Rows past ``pos`` hold NaN, which must
never reach the output. As an operator it is counted whole: its flops by
a registered formula (the plain einsums' count, on real and ``meta``
tensors) and, in the dry run, its output alone. Each launch plan names
its variant of the CUDA source. The tests marked ``cuda`` hold the CUDA
kernel to the plain version on the card and skip without one (they import
nothing of the reference package).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.kernels import decode_attention as DA  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

KV, S_MAX = 2, 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(B, H, KV, S, hd, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)
    return normal(B, 1, H, hd), normal(B, S, KV, hd), normal(B, S, KV, hd)


def _positions(where: str, B: int, S: int, H: int, KV: int, hd: int):
    """Slot 0 at ``where``, the others spread below the end."""
    plan = DA.decode_launch_plan(B, H, KV, S, hd, torch.float32)
    at = {"zero": 0, "boundary": plan.chunk_rows, "last": S - 1}[where]
    return torch.tensor([at] + [(S * (b + 1)) // (B + 1) for b in
                                range(B - 1)], dtype=torch.long)


def _valid(pos, S):
    return torch.arange(S)[None, :] <= pos[:, None]            # (B, S)


def _poisoned(cache, pos):
    """``cache`` with every row past each slot's ``pos`` set to NaN."""
    out = cache.clone()
    out[~_valid(pos.cpu(), cache.shape[1]).to(cache.device)] = float("nan")
    return out


@pytest.mark.parametrize("where", ["zero", "boundary", "last"])
@pytest.mark.parametrize("hd", [16, 64, 80, 128])
@pytest.mark.parametrize("rep", [1, 2, 7])
def test_plain_equals_sdpa_under_the_mask(rep, hd, where):
    B, H = 3, KV * rep
    q, k, v = _operands(B, H, KV, S_MAX, hd, seed=rep * 1000 + hd)
    pos = _positions(where, B, S_MAX, H, KV, hd)
    want = L._sdpa(q, k, v, _valid(pos, S_MAX)[:, None, :], None)
    got = DA.decode_attention(q, _poisoned(k, pos), _poisoned(v, pos), pos)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.isfinite(got).all()
    # the same operations on the same finite values: equal bit for bit
    # (rows past pos weigh exactly 0 in both)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_plain_equals_sdpa_in_bfloat16():
    """A bfloat16 q and cache, as the served model has them: float32
    arithmetic, the result rounded once to bfloat16, as ``_sdpa``."""
    B, H, hd = 3, 4, 64
    q, k, v = _operands(B, H, KV, S_MAX, hd, seed=5, dtype=torch.bfloat16)
    pos = _positions("boundary", B, S_MAX, H, KV, hd)
    want = L._sdpa(q, k, v, _valid(pos, S_MAX)[:, None, :], None)
    got = DA.decode_attention(q, _poisoned(k, pos), _poisoned(v, pos), pos)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_meta_tensors_give_shapes():
    """The dry run's ``meta`` tensors get an empty result of q's shape
    and dtype (the operator's fake implementation)."""
    q = torch.empty(2, 1, 8, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 128, 2, 64, device="meta", dtype=torch.bfloat16)
    pos = torch.empty(2, device="meta", dtype=torch.long)
    out = DA.decode_attention(q, k, k, pos)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_flops_are_the_plain_einsums(device):
    """``FlopCounterMode`` counts the operator by its registered formula,
    the same on real and ``meta`` tensors: the whole cache's count that
    the plain version's two einsums give."""
    from torch.utils.flop_counter import FlopCounterMode
    B, H, S, hd = 3, 2 * KV, 40, 16
    q, k, v = _operands(B, H, KV, S, hd, seed=3)
    pos = torch.tensor([0, 17, S - 1])
    with FlopCounterMode(display=False) as plain:
        DA.decode_attention_plain(q, k, v, pos)
    q, k, v, pos = (t.to(device) for t in (q, k, v, pos))
    with FlopCounterMode(display=False) as op:
        DA.decode_attention(q, k, v, pos)
    assert op.get_total_flops() == plain.get_total_flops() \
        == 4 * B * H * S * hd
    assert set(op.get_flop_counts()["Global"]) == {
        torch.ops.repro_torch.decode_attention}


def test_dry_run_holds_only_the_output():
    """On ``meta`` the dry run's meter sees one operator that makes its
    output alone, as the kernel does: no float32 copy of the cache."""
    from repro_torch.launch import dryrun as D
    q = torch.empty(4, 1, 8, 128, device="meta", dtype=torch.bfloat16)
    k = torch.empty(4, 2048, 8, 128, device="meta", dtype=torch.bfloat16)
    pos = torch.empty(4, device="meta", dtype=torch.long)
    got = D.measure_step(DA.decode_attention, (q, k, k, pos))
    assert got["temp_bytes"] == got["output_bytes"] == q.numel() * 2


@pytest.mark.parametrize("dtype,hd,rep,want", [
    (torch.bfloat16, 128, 1, ("__nv_bfloat16", 1, 1)),
    (torch.bfloat16, 256, 7, ("__nv_bfloat16", 8, 1)),
    (torch.float32, 128, 2, ("float", 2, 1)),
    (torch.float32, 256, 16, ("float", 8, 2)),
])
def test_each_plan_has_its_variant(dtype, hd, rep, want):
    """A launch's signature names the build of the CUDA source that runs
    its plan: the cache's element type, the heads a CTA takes and the
    vectors a lane holds; each variant is a library of its own."""
    from repro_torch import kernels
    H = KV * rep
    sig = DA._signature((2, 1, H, hd), (2, 512, KV, hd), (2, 512, KV, hd),
                        (2,), dtype, dtype, dtype, torch.int64)
    tc, rb, vpl = want
    assert sig.defines == (f"-DDECODE_TC={tc}", f"-DDECODE_RB={rb}",
                           f"-DDECODE_VPL={vpl}")
    p = DA.decode_launch_plan(2, H, KV, 512, hd, dtype)
    assert p.rb == rb and p.lanes * vpl >= p.nvec > p.lanes * (vpl - 1)
    paths = {kernels.library_path(DA.SOURCE, sig.defines),
             kernels.library_path(DA.SOURCE, ()),
             kernels.library_path(DA.SOURCE, sig.defines[:2])}
    assert len(paths) == 3


@pytest.mark.parametrize("B,H,KV,S,hd,dtype", [
    (32, 16, 16, 2048, 128, torch.bfloat16),   # olmo-1b chat
    (16, 16, 16, 2048, 128, torch.bfloat16),   # olmo-1b rag
    (2, 4, 2, 32, 16, torch.float32),          # a reduced config
    (4, 56, 8, 4096, 128, torch.bfloat16),     # 7 heads a KV head
    (1, 32, 2, 300, 256, torch.float32),       # 16 heads a KV head
])
def test_launch_plan_covers_every_row(B, H, KV, S, hd, dtype):
    """The chunks cover the rows once, a CTA's heads cover its KV head's,
    a row's lanes cover its vectors, and the launch reaches two CTAs an SM
    where the rows allow it."""
    p = DA.decode_launch_plan(B, H, KV, S, hd, dtype)
    rep = H // KV
    assert (p.chunks - 1) * p.chunk_rows < S <= p.chunks * p.chunk_rows
    assert p.rb * p.groups >= rep and p.rb <= DA.MAX_HEADS
    assert p.rb * (p.groups - 1) < rep
    assert p.nvec == hd * dtype.itemsize // 16
    assert 32 % p.lanes == 0 and p.lanes * (1 + (p.nvec > 32)) >= p.nvec
    ctas = B * KV * p.groups * p.chunks
    assert ctas >= DA.TARGET_CTAS or p.chunks == max(
        1, S // DA.MIN_CHUNK_ROWS)
    assert p.chunks == 1 or p.chunk_rows >= DA.MIN_CHUNK_ROWS


def test_shape_disagreements_raise():
    q, k, v = _operands(2, 4, 2, 16, 16, seed=0)
    pos = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="disagree"):
        DA.decode_attention(q, k, v[:, :8], pos)
    with pytest.raises(ValueError, match="disagree"):
        DA.decode_attention(q, k, v, pos[:1])
    with pytest.raises(ValueError, match="takes q"):
        DA.decode_attention(q[:, 0], k, v, pos)


def test_attention_decode_takes_the_kernel_for_a_plain_cache():
    """A float32 cache goes to ``decode_attention`` and a float64 one to
    ``_sdpa``, each counted; the two agree on the same values, and each
    cache gets its new rows at ``pos`` in place."""
    from repro_torch.configs import get_config
    from repro_torch.models.spec import init_params
    from repro_torch.obs import metrics
    import dataclasses
    cfg = get_config("olmo-1b").reduced()
    out, counts = {}, {}
    for dt in ("float32", "float64"):
        c = dataclasses.replace(cfg, dtype=dt)
        p = init_params(L.attn_specs(c), torch.Generator().manual_seed(0),
                        dt)
        wide = getattr(torch, dt)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 1, c.d_model))).to(wide)
        ck, cv = (torch.from_numpy(np.random.default_rng(s).standard_normal(
            (2, 32, c.n_kv_heads, c.hd))).to(wide) for s in (2, 3))
        before = {n: metrics.counter(f"attention.decode.{n}").value
                  for n in ("kernel", "plain")}
        old = [ck.clone(), cv.clone()]
        y = L.attention_decode(p, c, x, ck, cv, torch.tensor([5, 30]))
        at = torch.zeros(2, 32, dtype=torch.bool)
        at[[0, 1], [5, 30]] = True
        for new, was in zip((ck, cv), old):
            assert torch.equal((new != was).any(-1).any(-1), at)
        counts[dt] = tuple(metrics.counter(f"attention.decode.{n}").value
                           - before[n] for n in ("kernel", "plain"))
        out[dt] = y
    assert counts == {"float32": (1, 0), "float64": (0, 1)}
    torch.testing.assert_close(out["float32"].double(), out["float64"],
                               rtol=0, atol=1e-5)


# cases on the card: the served shapes, a reduced config's, every kind of
# head group (rep 1, 2, 7, 8 and 16, over two groups), hd 80, a float32
# hd of 256 (two vectors a lane), one chunk and several
CARD = [
    (32, 16, 16, 2048, 128, torch.bfloat16),   # olmo-1b chat
    (16, 16, 16, 2048, 128, torch.bfloat16),   # olmo-1b rag
    (2, 4, 2, 32, 16, torch.float32),          # reduced olmo-1b
    (2, 4, 2, 32, 16, torch.bfloat16),
    (3, 14, 2, 700, 64, torch.bfloat16),       # rep 7
    (3, 16, 2, 700, 80, torch.float32),        # rep 8, hd 80
    (2, 32, 2, 1000, 128, torch.float32),      # rep 16: two head groups
    (2, 4, 2, 600, 256, torch.float32),        # two vectors a lane
    (2, 4, 2, 600, 256, torch.bfloat16),
    (64, 32, 32, 256, 128, torch.bfloat16),    # one chunk
]


def _card_case(B, H, KV, S, hd, dtype, cuda, seed):
    q, k, v = _operands(B, H, KV, S, hd, seed, dtype, cuda)
    g = np.random.default_rng(seed + 1)
    pos = torch.from_numpy(g.integers(0, S, B)).to(cuda)
    pos[0] = S - 1
    if B > 1:
        pos[1] = 0
    return q, _poisoned(k, pos), _poisoned(v, pos), pos


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,dtype", CARD)
def test_kernel_equals_plain(cuda, B, H, KV, S, hd, dtype):
    """The kernel against the plain version on the same card, rows past
    ``pos`` at NaN. Both sum in float32 in another order: within 1e-5 of
    the values' scale (an output is a convex sum of v rows, so at most
    their largest magnitude), after one rounding of each to q's dtype,
    which in bfloat16 may land one unit in the last place apart (at most
    2^-7 of the value)."""
    q, k, v, pos = _card_case(B, H, KV, S, hd, dtype, cuda, seed=B + H + S)
    n = DA.decode_attention.launches
    got = DA.decode_attention(q, k, v, pos)
    assert DA.decode_attention.launches == n + 1
    want = DA.decode_attention_plain(q.cpu(), k.cpu(), v.cpu(), pos.cpu())
    torch.cuda.synchronize()
    got = got.cpu()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    scale = float(v.float().nan_to_num().abs().max())
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    err = (got.float() - want.float()).abs()
    bound = 1e-5 * scale + ulp * want.float().abs()
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.cuda
def test_kernel_takes_a_group_slice_of_a_stacked_cache(cuda):
    """The layer's view into the stacked cache (``unbind``), float32 q on
    a bfloat16 cache, and a launch on another stream."""
    stack = torch.randn(3, 4, 256, 2, 64, device=cuda).bfloat16()
    q = torch.randn(4, 1, 4, 64, device=cuda)
    pos = torch.tensor([0, 100, 200, 255], device=cuda)
    k, v = stack.unbind(0)[1:]
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        got = DA.decode_attention(q, k, v, pos)
    s.synchronize()
    want = DA.decode_attention_plain(q.cpu(), k.cpu(), v.cpu(), pos.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(
        v.float().abs().max()))


@pytest.mark.cuda
def test_kernel_refusals_raise(cuda):
    q = torch.randn(2, 1, 4, 12, device=cuda)
    k = torch.randn(2, 32, 2, 12, device=cuda)
    pos = torch.zeros(2, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        DA.decode_attention(q, k, k, pos)
    q = torch.randn(2, 1, 4, 16, device=cuda)
    k = torch.randn(2, 32, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="int64"):
        DA.decode_attention(q, k, k, pos.int())
    with pytest.raises(ValueError, match="operands on"):
        DA.decode_attention(q, k, k, pos.cpu())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.randn(2 * 32 * 2 * 16 + 1, device=cuda)[1:]
        DA.decode_attention(q, flat.view(2, 32, 2, 16), k, pos)
