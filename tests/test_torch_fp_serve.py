"""Full-precision tiling and serving in the port against the reference.

``TiledMatvec``, ``TiledConv2d`` and ``PlanService`` (``repro_torch``) must
give the reference's results exactly: the same ``y`` and maps, grid, cycles
and reduction depth for tiled operations, and the same tickets and stats for
a shuffled stream that mixes full-precision matvec, conv and binary matvec,
served through ``submit``/``flush`` and ``run_stream``. Distinct conv
kernels share one plan and one batch, as in the reference. Small geometries
on the CPU (``device="cpu"``); full width is ``chip_smoke.py``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro.core.tiling import TiledConv2d as RefTiledConv  # noqa: E402
from repro.core.tiling import TiledMatvec as RefTiledMatvec  # noqa: E402
from repro.serve.matpim import PlanService as RefService  # noqa: E402
from repro.serve.matpim import ServeRequest as RefRequest  # noqa: E402
from repro_torch.core import (TiledConv2d, TiledMatvec,  # noqa: E402
                              tiled_conv2d, tiled_matvec)
from repro_torch.core.tiling import (max_matvec_block,  # noqa: E402
                                     tiled_binary_conv2d)
from repro_torch.device.faults import FaultModel  # noqa: E402
from repro_torch.kernels.conv2d_shift import conv2d_shift  # noqa: E402
from repro_torch.kernels.splitk_matvec import splitk_matvec  # noqa: E402
from repro_torch.serve import PlanService, ServeRequest  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)


def _info(info):
    return (info.grid, info.n_tiles, info.cycles, info.reduce_depth)


def test_max_matvec_block_matches_reference():
    from repro.core.tiling import max_matvec_block as ref_block
    for N in (1, 2, 4, 8, 16, 32):
        for cols, parts in ((1024, 32), (256, 8), (512, 16)):
            assert max_matvec_block(N, cols, parts) == ref_block(N, cols,
                                                                 parts)


@pytest.mark.parametrize("M,K,N,backend", [(70, 30, 4, "kernels"),
                                           (20, 13, 3, "torch"),
                                           (64, 50, 8, "kernels")])
def test_tiled_matvec_matches_reference(M, K, N, backend):
    rng = np.random.default_rng(M + K + N)
    A = rng.integers(0, 1 << N, size=(M, K))
    x = rng.integers(0, 1 << N, size=K)
    ref = RefTiledMatvec(M, K, N, **GEOM)
    y_ref, info_ref = ref.run(A, x, backend="numpy")
    t = TiledMatvec(M, K, N, **GEOM)
    y, info = t.run(A, x, backend=backend, device="cpu")
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(
        y, (A.astype(object) @ x.astype(object)) % (1 << (2 * N)))
    assert _info(info) == _info(info_ref) and info.backend == backend
    y2, info2 = tiled_matvec(A, x, N, backend=backend, device="cpu",
                             tile_m=32, **GEOM)
    np.testing.assert_array_equal(y2, y_ref)
    assert info2.grid == (3 if M > 64 else -(-M // 32), info.grid[1])


@pytest.mark.parametrize("H,W,k,N,backend", [(20, 17, 3, 4, "kernels"),
                                             (9, 10, 2, 3, "torch")])
def test_tiled_conv_matches_reference(H, W, k, N, backend):
    rng = np.random.default_rng(H + W + k)
    A = rng.integers(0, 1 << N, size=(H, W))
    K = rng.integers(0, 1 << N, size=(k, k))
    ref = RefTiledConv(H, W, k, N, tile_m=12, **GEOM)
    out_ref, info_ref = ref.run(A, K, backend="numpy")
    t = TiledConv2d(H, W, k, N, tile_m=12, **GEOM)
    out, info = t.run(A, K, backend=backend, device="cpu")
    np.testing.assert_array_equal(out, out_ref)
    assert _info(info) == _info(info_ref) and info.backend == backend
    out2, _ = tiled_conv2d(A, K, N, tile_m=12, backend=backend,
                           device="cpu", **GEOM)
    np.testing.assert_array_equal(out2, out_ref)


def _conv_oracle(img, K, N):
    k = K.shape[0]
    oh, ow = img.shape[0] - k + 1, img.shape[1] - k + 1
    out = np.zeros((oh, ow), dtype=np.int64)
    for v in range(k):
        for h in range(k):
            out += img[v:v + oh, h:h + ow] * K[v, h]
    return out % (1 << N)


def _stream(seed, n=12):
    """Shuffled mixed requests: full-precision matvec (N 3 or 4), conv with
    a few kernels (some signed), and binary matvec."""
    rng = np.random.default_rng(seed)
    kernels = [rng.integers(0, 16, size=(3, 3)),
               np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]]),
               rng.integers(0, 16, size=(2, 2))]
    reqs = []
    for i in range(n):
        kind = ("matvec", "conv", "binary_matvec")[i % 3]
        if kind == "matvec":
            m, k = int(rng.integers(2, 12)), int(rng.integers(4, 24))
            N = int(rng.integers(3, 5))
            reqs.append((kind, (rng.integers(0, 1 << N, size=(m, k)),
                                rng.integers(0, 1 << N, size=k), N)))
        elif kind == "conv":
            K = kernels[int(rng.integers(len(kernels)))]
            H, W = int(rng.integers(4, 13)), int(rng.integers(4, 11))
            reqs.append((kind, (rng.integers(0, 16, size=(H, W)), K, 4)))
        else:
            m, k = int(rng.integers(2, 12)), int(rng.integers(4, 40))
            reqs.append((kind, (rng.choice([-1, 1], size=(m, k)),
                                rng.choice([-1, 1], size=k))))
    order = rng.permutation(n)
    return [reqs[i] for i in order]


def _oracle(kind, args):
    if kind == "binary_matvec":
        A, x = args
        return np.where(A @ x >= 0, 1, -1)
    if kind == "matvec":
        A, x, N = args
        return (A.astype(object) @ x.astype(object)) % (1 << (2 * N))
    img, K, N = args
    return _conv_oracle(img, K, N)


STATS = ("hits", "misses", "evictions", "requests", "batches", "units")


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_mixed_stream_flush_matches_reference(backend):
    reqs = _stream(11)
    ref = RefService(store=False, **GEOM)
    ref_t = [ref.submit(kind, *args) for kind, args in reqs]
    ref.flush()
    svc = PlanService(backend=backend, device="cpu", **GEOM)
    mine = [svc.submit(kind, *args) for kind, args in reqs]
    assert len(svc.flush()) == len(reqs)
    for t, r, (kind, args) in zip(mine, ref_t, reqs):
        assert t.done and t.kind == r.kind == kind
        np.testing.assert_array_equal(t.result, r.result)
        np.testing.assert_array_equal(np.asarray(t.result, dtype=np.int64),
                                      np.asarray(_oracle(kind, args),
                                                 dtype=np.int64))
        assert (t.key[:-1], t.cycles, t.reduce_depth, t.n_units,
                t.batch_units) == (r.key[:-1], r.cycles, r.reduce_depth,
                                   r.n_units, r.batch_units)
        assert t.backend == backend
    for f in STATS:
        assert getattr(svc.stats, f) == getattr(ref.stats, f), f


def test_mixed_stream_run_stream_matches_reference():
    reqs = _stream(5, n=15)
    ref = RefService(store=False, max_plans=3, **GEOM)
    want = ref.run_stream([RefRequest(kind, args) for kind, args in reqs],
                          slots=8)
    svc = PlanService(max_plans=3, backend="kernels", device="cpu", **GEOM)
    before = (splitk_matvec.launches, conv2d_shift.launches)
    got = svc.run_stream([ServeRequest(kind, args) for kind, args in reqs],
                         slots=8)
    assert (splitk_matvec.launches, conv2d_shift.launches) == before  # CPU
    assert len(got) == len(want) == len(reqs)
    for t, r in zip(got, want):
        np.testing.assert_array_equal(t.result, r.result)
        assert (t.kind, t.cycles, t.queue_steps, t.batch_units) == \
            (r.kind, r.cycles, r.queue_steps, r.batch_units)
        assert t.backend == "kernels"
    for f in STATS:
        assert getattr(svc.stats, f) == getattr(ref.stats, f), f


def test_distinct_kernel_convs_share_one_plan():
    """Kernel-independent conv programs serve every kernel of a shape: two
    requests with different kernels hit one cached plan and coalesce."""
    rng = np.random.default_rng(2)
    svc = PlanService(backend="kernels", device="cpu", **GEOM)
    img1 = rng.integers(0, 64, size=(9, 9))
    img2 = rng.integers(0, 64, size=(10, 12))  # same (16, 16) bucket
    K1 = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]])
    K2 = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]])
    t1 = svc.submit_conv(img1, K1, N=8)
    t2 = svc.submit_conv(img2, K2, N=8)
    svc.flush()
    assert t1.key == t2.key and svc.stats.misses == 1
    assert t1.batch_units == t2.batch_units == t1.n_units + t2.n_units
    for t, img, K in ((t1, img1, K1), (t2, img2, K2)):
        np.testing.assert_array_equal(np.asarray(t.result, dtype=np.int64),
                                      _conv_oracle(img, K, 8))
        assert t.backend == "kernels"
    assert svc.stats.compile_s > 0   # conv program build is priced at miss


def test_unported_submissions_raise():
    svc = PlanService(device="cpu", **GEOM)
    img, K = np.ones((6, 6), np.int64), np.ones((3, 3), np.int64)
    # binary conv is ported: the service, the tiled wrapper and the one-shot
    # call all give the ±1 map (an all-+1 image and kernel: all +1)
    t1 = svc.submit_binary_conv(img, K)
    t2 = svc.submit("binary_conv", img, K)
    svc.flush()
    assert t1.key == t2.key and t1.batch_units == 2 * t1.n_units
    out, _ = TiledConv2d(6, 6, 3, 1, binary=True, tile_m=6, tile_n=32,
                         **GEOM).run(img, K, device="cpu")
    out2, _ = tiled_binary_conv2d(img, K, tile_m=6, tile_n=32, device="cpu",
                                  **GEOM)
    for got in (t1.result, t2.result, out, out2):
        np.testing.assert_array_equal(got, np.ones((4, 4), np.int64))
    with pytest.raises(ValueError):
        svc.submit_binary_conv(img, 2 * K)
    with pytest.raises(ValueError):
        svc.submit_matvec(np.ones((2, 4)), np.ones(5), 4)
    with pytest.raises(ValueError):
        svc.submit_conv(np.ones((2, 6)), K, 4)
    assert svc.stats.requests == 2      # the refused submissions count not
    # FaultModel requests are ported: every kind draws from the service's
    # seeded stream and gives the reference service's bits
    from repro.device.faults import FaultModel as RefModel
    ref = RefService(seed=0, **GEOM)
    svc = PlanService(seed=0, device="cpu", **GEOM)
    rng = np.random.default_rng(8)
    A, x = rng.integers(0, 16, (5, 7)), rng.integers(0, 16, 7)
    img = rng.integers(0, 16, (9, 9))
    Kb = np.array([[1, -1, 1], [1, 1, -1], [-1, 1, 1]])
    tickets = {}
    for s, fm in ((svc, FaultModel(p_switch=0.1)),
                  (ref, RefModel(p_switch=0.1))):
        tickets[s] = [s.submit_matvec(A, x, 4, faults=fm),
                      s.submit_conv(img, K, 4, faults=fm),
                      s.submit_binary_conv(img * 2 - 15, Kb, faults=fm)]
        s.flush()
    for t, r in zip(tickets[svc], tickets[ref]):
        np.testing.assert_array_equal(np.asarray(t.result, dtype=np.int64),
                                      np.asarray(r.result, dtype=np.int64))
        assert t.backend == "torch"
