"""Image-processing chains as composed in-memory convolutions.

The port of ``src/repro/apps/imaging.py``; every conv stage's tiles run on
a torch ``device`` (on ``backend="kernels"``, the full-precision convs
launch ``conv2d_shift``; the binary convs replay, labelled
``kernels:fallback-torch``).

The canonical mMPU application after neural inference: classic kernels
(box blur, sharpen, Sobel/Roberts edge detection) run as §III-A/B
full-precision crossbar convolutions — negative taps encoded two's-complement
mod 2^N, outputs decoded signed — and chained stage-to-stage through the
:class:`~repro_torch.apps.pipeline.Pipeline`, so every chain reports the
per-stage cycle/energy/data-movement breakdown. A binary path binarizes on the host
and edge-detects with the §III-C ±1-kernel conv.

All kernels are *correlation* masks (``Out[r,c] = Σ A[r+v,c+h]·K[v,h]``,
valid region), matching the plans' semantics; symmetric kernels are
unaffected and the Sobel/Roberts masks are stated in that convention.

Chains shrink the image by k−1 per conv stage (valid convolution), so each
stage is constructed against its actual input shape.

Run the demo:

    PYTHONPATH=src python -m repro_torch.apps.imaging
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .pipeline import (BinaryConvStage, ConvStage, HostStage, ParallelStage,
                       Pipeline)

# correlation masks, integer taps (negative taps ride mod-2^N encoding)
KERNELS = {
    "blur3": np.ones((3, 3), dtype=np.int64),        # box blur ×9 (host /9)
    "sharpen": np.array([[0, -1, 0], [-1, 5, -1], [0, -1, 0]]),
    "sobel_x": np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]),
    "sobel_y": np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]]),
    "roberts_x": np.array([[1, 0], [0, -1]]),
    "roberts_y": np.array([[0, 1], [-1, 0]]),
}

# ±1 masks for the binary path (§III-C taps must be ±1)
BINARY_KERNELS = {
    "edge_v": np.array([[1, -1], [1, -1]]),          # vertical transitions
    "edge_h": np.array([[1, 1], [-1, -1]]),          # horizontal transitions
}


def ref_correlate(A: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Host reference for the plans' valid correlation (exact, signed).

    >>> A = np.arange(9).reshape(3, 3)
    >>> ref_correlate(A, np.array([[1, -1], [1, -1]]))
    array([[-2, -2],
           [-2, -2]])
    """
    A = np.asarray(A, dtype=np.int64)
    K = np.asarray(K, dtype=np.int64)
    H, W = A.shape
    k = K.shape[0]
    out = np.zeros((H - k + 1, W - k + 1), dtype=np.int64)
    for v in range(k):
        for h in range(k):
            out += K[v, h] * A[v : v + H - k + 1, h : h + W - k + 1]
    return out


def edge_reference(img: np.ndarray, op: str = "sobel",
                   blur: bool = True) -> np.ndarray:
    """Host reference for :func:`edge_pipeline`: (optional blur/9) →
    |G_x| + |G_y| with the ``op`` gradient masks. The single source of
    truth the tests and benchmarks score the in-crossbar chain against."""
    a = np.asarray(img, dtype=np.int64)
    if blur:
        a = ref_correlate(a, KERNELS["blur3"]) // 9
    return (np.abs(ref_correlate(a, KERNELS[f"{op}_x"]))
            + np.abs(ref_correlate(a, KERNELS[f"{op}_y"])))


def _conv(kname: str, shape: Tuple[int, int], N: int, signed: bool = True,
          post=None, **tile_kw) -> ConvStage:
    tile_kw.setdefault("tile_m", min(64, max(shape[0], KERNELS[kname].shape[0] + 1)))
    return ConvStage(KERNELS[kname], shape, N, signed=signed, post=post,
                     name=kname, **tile_kw)


def _grad_merge(gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """L1 gradient magnitude |Gx| + |Gy| (host merge of the two branches)."""
    return np.abs(np.asarray(gx, dtype=np.int64)) + \
        np.abs(np.asarray(gy, dtype=np.int64))


def edge_pipeline(shape: Tuple[int, int], N: int = 8, op: str = "sobel",
                  blur: bool = True, **tile_kw) -> Pipeline:
    """Blur → {Sobel|Roberts} gradient magnitude, all convs in-crossbar.

    The two gradient convs run on disjoint tile grids in parallel
    (:class:`ParallelStage`: latency incl. IO cycles = max, energy = sum);
    magnitudes
    merge on the host. ``N`` must hold the worst-case |tap sum| × pixel
    range in N−1 bits — N=8 covers 4-bit pixels under Sobel.
    """
    H, W = shape
    stages = []
    if blur:
        stages.append(_conv("blur3", (H, W), N, signed=False,
                            post=lambda o: o // 9, **tile_kw))
        H, W = H - 2, W - 2
    kx, ky = (f"{op}_x", f"{op}_y")
    stages.append(ParallelStage(
        [_conv(kx, (H, W), N, **tile_kw), _conv(ky, (H, W), N, **tile_kw)],
        merge=_grad_merge, name=f"{op}_grad"))
    return Pipeline(stages, name=f"{'blur_' if blur else ''}{op}_edge")


def sharpen_pipeline(shape: Tuple[int, int], N: int = 10, vmax: int = 15,
                     **tile_kw) -> Pipeline:
    """Unsharp 3×3 sharpen, output clamped to [0, vmax] on the host.

    Default N=10: with 4-bit pixels the pre-clamp range is [−4·15, 9·15] =
    [−60, 135], which needs a 9-bit signed window.
    """
    stages = [
        _conv("sharpen", shape, N, signed=True,
              post=lambda o: np.clip(np.asarray(o, dtype=np.int64), 0, vmax),
              **tile_kw),
    ]
    return Pipeline(stages, name="sharpen")


def binary_edge_pipeline(shape: Tuple[int, int], threshold: int = 7,
                         **tile_kw) -> Pipeline:
    """Host binarize (> threshold → +1) → ±1 edge convs (§III-C), merged as
    the elementwise OR (max) of the vertical/horizontal detectors."""
    H, W = shape
    tile_kw.setdefault("tile_m", min(64, H))
    tile_kw.setdefault("tile_n", 32)
    binar = HostStage(lambda img: np.where(np.asarray(img) > threshold,
                                           1, -1), name="binarize")
    branches = [BinaryConvStage(BINARY_KERNELS[k], (H, W), name=k, **tile_kw)
                for k in ("edge_v", "edge_h")]
    edges = ParallelStage(branches, merge=np.maximum, name="bedge")
    return Pipeline([binar, edges], name="binary_edge")


def demo_image(H: int = 24, W: int = 24, vmax: int = 15,
               seed: Optional[int] = None) -> np.ndarray:
    """Synthetic 4-bit test card: bright square + diagonal ramp (+ noise)."""
    img = np.zeros((H, W), dtype=np.int64)
    img += (np.add.outer(np.arange(H), np.arange(W)) * vmax // (H + W - 2))
    img[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = vmax
    if seed is not None:
        img += np.random.default_rng(seed).integers(0, 2, size=(H, W))
    return np.clip(img, 0, vmax)


def main() -> None:
    img = demo_image()
    print(f"input image {img.shape}, range [{img.min()}, {img.max()}]")

    pipe = edge_pipeline(img.shape, N=8, op="sobel")
    mag, rep = pipe.run(img, backend="kernels")
    want = edge_reference(img, "sobel")
    print(rep)
    print(f"blur→sobel magnitude {mag.shape}, matches host reference: "
          f"{bool(np.array_equal(np.asarray(mag, dtype=np.int64), want))}")

    pipe = sharpen_pipeline(img.shape)
    sharp, rep = pipe.run(img, backend="kernels")
    want = np.clip(ref_correlate(img, KERNELS["sharpen"]), 0, 15)
    print(rep)
    print(f"sharpen {sharp.shape}, matches host reference: "
          f"{bool(np.array_equal(np.asarray(sharp, dtype=np.int64), want))}")

    pipe = binary_edge_pipeline(img.shape)
    edges, rep = pipe.run(img, backend="kernels")
    print(rep)
    print(f"binary edge map {edges.shape}: "
          f"{int((edges > 0).sum())} edge pixels")


if __name__ == "__main__":
    main()
