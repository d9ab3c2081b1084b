// Shift-and-add 2D convolutions for Hopper (sm_90a): valid cross-correlation
// (no flip, MatPIM Algorithm 1) with f32 accumulation, and the
// channel-packed binary (XNOR-popcount) conv. Built with nvcc into a plain C
// library and loaded with ctypes by repro_torch/kernels/conv2d_shift.py,
// which holds the plain PyTorch version of each function and chooses every
// launch's tiling (conv_launch_plan).
//
// Replaces the three TPU kernels of src/repro/kernels/conv2d_shift.py:
//   conv2d_shift        (_conv_kernel under pl.pallas_call)
//   conv2d_shift_tiled  (_conv_tiled_kernel)
//   binary_conv2d       (_binary_conv_kernel)
// The two float kernels compute the same function, so both run one kernel
// template, conv2d_shift_kernel; they differ only in the wrapper's contract.
//
// CTA tile, not the reference's tile. The TPU kernels hold the whole image,
// or a bh x bw output tile with its halo, in VMEM: bh x bw (128 x 128 by
// default) is a block size chosen for a TPU. Here the launcher picks the
// CTA's output tile TH x TW for the card: at most 128 columns and 256
// threads, shrunk in height until there are two CTAs per SM (264) or a CTA
// is down to 512 outputs, with several small images per CTA where one image
// gives a warp too little work. At the ops path's 1026 x 1026 image that is
// 16 x 128 tiles, 512 CTAs; the served batch of 126 64 x 8 images is 126
// CTAs of 96 threads. conv2d_shift_tiled still applies the reference's
// bh x bw contract (the output must tile evenly) and computes the same
// output, so any such (bh, bw) runs, as in the reference: no tile needs a
// shared-memory opt-in.
//
// Register strip. Thread (c, s, i) owns R consecutive output rows (4, or 8
// in large images read directly) of column c of image i. It reads each of
// the (R+kh-1) x kw input values its strip needs once and adds it into every
// output of the strip that uses it: for 3 x 3 and R = 4, 18 loads for 36
// FMAs instead of 36 loads. The 3 x 3 case is compiled with the taps in
// registers. A warp's lanes hold neighbouring columns, so each load and each
// stored output row is one contiguous run (a full 128-byte line at TW >= 32).
// Stores stay scalar: with one column per thread a warp's store of one
// output row already fills whole 128-byte lines, and float2 / float4 stores
// would need two or four columns per thread, which halves or quarters the
// threads of the small served tiles and needs an edge path for the rows of
// odd-width outputs that are only 4-byte aligned (not measured).
// Block and grid indices give the thread's column, strip and image without
// a division.
//
// Where the strip reads from. Kernels of up to 3 x 3 taps (every path of
// the repo) read A straight from global memory through L1: with the strip
// reusing each value in registers, L1 serves the neighbours' overlap, and a
// shared-memory stage and its barrier cost more than they save (measured
// slower at every shape tried; PERF.md has the times). Larger kernels
// read each pixel k*k times and stage halo tiles: each CTA copies its
// (TH+kh-1) x (TW+kw-1) halo tile per image into shared memory with
// cp.async, in the input's own dtype (bf16 is widened to f32 when read),
// and the taps as f32. A group of lanes, up to a warp, copies one halo row,
// a contiguous run, at the widest cp.async (16, 8 or 4 bytes) that A's
// address, its row stride and the tile's column offset allow, with element
// copies for the row's tail and for bf16 rows only 2-byte aligned. No TMA:
// a 2D tensor map needs row strides that are multiples of 16 bytes, and a
// 1026-wide f32 image has 4104-byte rows. A kernel whose halo tile and taps
// would pass the 48 KB a block gets without an opt-in reads A directly, as
// do launches of fewer CTAs than SMs: with one CTA per SM at most, no
// staging overlaps another CTA's work.
//
// No tensor cores. The work is memory-bound: 9 multiply-adds per 8 bytes
// moved (about 2.25 flop/byte) against a ridge near 20 for f32 on the H100;
// and f32 operands would pass through TF32, which breaks the reference's
// 1e-5 float tolerance. Sums run in another order than the plain version
// (columns of taps outer, rows inner); integer inputs whose sums stay under
// 2^24, the kernel bridge's case, are exact in any order.
//
// What bounds them. conv2d_shift_tiled at 1026 x 1026, k = 3, reads 4.2 MB
// and writes 4.2 MB: device memory bounds it (2.5 us at 3.35 TB/s). The
// served conv2d_shift, B = 126 images of 64 x 8 with k = 3, moves about
// 450 KB (0.13 us): the launch itself and the wrapper on the host dominate.
// binary_conv2d does 3 integer ops (xor, popc, add) per word per tap and
// reuses each input word k*k times, so at wide C its integer issue rate, not
// memory, is the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"

// Launch parameters, computed and cached by the Python wrapper
// (kernels/conv2d_shift.py::_Args, same field order, all int32).
struct ConvArgs {
  int B, H, W, kh, kw, OH, OW;
  int TH, TW, ipc, R;  // CTA output tile, images per CTA, rows per thread
  int staged;          // halo tiles through shared memory, or read direct
  int pitch;           // shared row pitch, in elements of A (16-byte rows)
  int ncol;            // column tiles; grid.x = row tiles * ncol
  int smem, taps_off;  // dynamic shared bytes, where the f32 taps start
  int grid_x, grid_y;  // grid.y = image groups
  int k_batched, a_bf16, k_bf16;
};

namespace {

constexpr int kThreads = 256;  // binary_conv2d's block, and the most a
                               // float conv block has

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

using row_stage::cp_async;
using row_stage::cp_async_wait_all;

// Stage `nrows` halo rows of n elements each, row r from src to dst as
// locate(r, src, dst) sets them, src aligned to 2^lvw bytes and dst to 16.
// A row is nvec cp.async copies of 2^lvw bytes (16, 8 or 4) and then its
// tail element by element (every element when lvw is 1: bf16 rows at an odd
// element). A group of 2^lg consecutive threads, the fewest that cover a
// row's copies, at most a warp and at most the block, copies one row, so
// narrow rows do not leave most of a warp idle; the row's address is
// computed once per row, not per element.
template <typename TA, typename Locate>
__device__ __forceinline__ void stage_rows(int nrows, int n, int lvw, int t,
                                           int nthreads, Locate locate) {
  constexpr int es = (int)sizeof(TA);
  const int nvec = lvw >= 2 ? (n * es) >> lvw : 0;
  const int tail0 = (nvec << lvw) / es;  // first element copied singly
  const int units = nvec + n - tail0;
  const int lg = min(units > 1 ? 32 - __clz(units - 1) : 0,
                     min(5, 31 - __clz(nthreads)));
  const int ngroups = nthreads >> lg, li = t & ((1 << lg) - 1);
  for (int row = t < (ngroups << lg) ? t >> lg : nrows; row < nrows;
       row += ngroups) {
    const TA* src;
    TA* dst;
    locate(row, src, dst);
    char* d = reinterpret_cast<char*>(dst);
    const char* sc = reinterpret_cast<const char*>(src);
    for (int u = li; u < units; u += 1 << lg) {
      if (u >= nvec)
        dst[tail0 + u - nvec] = src[tail0 + u - nvec];
      else if (lvw == 4)
        cp_async<16>(d + u * 16, sc + u * 16);
      else if (lvw == 3)
        cp_async<8>(d + u * 8, sc + u * 8);
      else
        cp_async<4>(d + u * 4, sc + u * 4);
    }
  }
}

// The register strip: acc[r] += x(r + v, h) * tap(v, h) over kh x kw
// taps, each input value x(j, h) read once and added into every output of
// the strip that uses it (columns of taps outer, rows inner). KH, KW > 0
// unroll it with the taps in registers.
template <int R, int KH, int KW, typename X, typename Tap>
__device__ __forceinline__ void accumulate(float (&acc)[R], int kh, int kw,
                                           X x, Tap tap) {
  if constexpr (KH > 0 && KW > 0) {
    float tr[KH * KW];
#pragma unroll
    for (int v = 0; v < KH; ++v)
#pragma unroll
      for (int h = 0; h < KW; ++h) tr[v * KW + h] = tap(v, h);
#pragma unroll
    for (int h = 0; h < KW; ++h)
#pragma unroll
      for (int j = 0; j < R + KH - 1; ++j) {
        const float xv = x(j, h);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (j - r >= 0 && j - r < KH)
            acc[r] = fmaf(xv, tr[(j - r) * KW + h], acc[r]);
      }
  } else {
    for (int h = 0; h < kw; ++h)
      for (int j = 0; j < R + kh - 1; ++j) {
        const float xv = x(j, h);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (j - r >= 0 && j - r < kh)
            acc[r] = fmaf(xv, tap(j - r, h), acc[r]);
      }
  }
}

// a: (B, H, W); k: (B or 1, kh, kw); out: (B, OH, OW) float32. Block
// (blockIdx.x / ncol, blockIdx.x % ncol) of images ipc * blockIdx.y.. owns
// a TH x TW output tile of each, with threads (TW, TH / R, ipc): thread
// (c, s, i) owns rows R*s..R*s+R-1 of column c of image i. KH, KW > 0
// compile the kernel size in (taps in registers); 0 reads it from args.
// STAGED stages halo tiles in shared memory; otherwise the strip reads A
// and the taps straight from global memory, through L1.
template <bool STAGED, int R, int KH, int KW, typename TA, typename TK>
__global__ void __launch_bounds__(kThreads)
    conv2d_shift_kernel(const TA* __restrict__ a, const TK* __restrict__ k,
                        float* __restrict__ out, const ConvArgs p,
                        const int lvw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kh = KH > 0 ? KH : p.kh, kw = KW > 0 ? KW : p.kw;
  int ty = blockIdx.x, tx = 0;
  if (p.ncol > 1) {
    ty = blockIdx.x / p.ncol;
    tx = blockIdx.x - ty * p.ncol;
  }
  const int y0 = ty * p.TH, x0 = tx * p.TW, b0 = blockIdx.y * p.ipc;
  const int th = min(p.TH, p.OH - y0), tw = min(p.TW, p.OW - x0);
  const int nimg = min(p.ipc, p.B - b0);
  const int img_elems = (p.TH + kh - 1) * p.pitch;
  TA* tile = reinterpret_cast<TA*>(smem);
  float* taps = reinterpret_cast<float*>(smem + p.taps_off);

  const int c = threadIdx.x, s = threadIdx.y, i = threadIdx.z;
  const int t = c + blockDim.x * (s + blockDim.y * i);
  const int nthreads = blockDim.x * blockDim.y * blockDim.z;
  const int ntk = p.k_batched ? nimg : 1;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;

  if constexpr (!STAGED) {
    if (i < nimg && c < tw) {
      // the strip's input rows that exist: reads past them would leave A
      const int rows = th + kh - 1 - s * R;
      const TA* col =
          a + ((long long)(b0 + i) * p.H + y0 + s * R) * p.W + x0 + c;
      const TK* kk = k + (p.k_batched ? (long long)(b0 + i) * kh * kw : 0);
      accumulate<R, KH, KW>(
          acc, kh, kw,
          [&](int j, int h) {
            return j < rows ? to_f32(col[(long long)j * p.W + h]) : 0.f;
          },
          [&](int v, int h) { return to_f32(kk[v * kw + h]); });
    }
  } else {
    const int hrows = th + kh - 1;
    stage_rows<TA>(nimg * hrows, tw + kw - 1, lvw, t, nthreads,
                   [&](int row, const TA*& src, TA*& dst) {
                     int ii = 0, hr = row;
                     if (nimg > 1) {
                       ii = row / hrows;
                       hr = row - ii * hrows;
                     }
                     src = a + ((long long)(b0 + ii) * p.H + y0 + hr) * p.W +
                           x0;
                     dst = tile + ii * img_elems + hr * p.pitch;
                   });
    // the CTA's images' kernels are contiguous in k
    const TK* kk = k + (p.k_batched ? (long long)b0 * kh * kw : 0);
    for (int e = t; e < ntk * kh * kw; e += nthreads) taps[e] = to_f32(kk[e]);
    cp_async_wait_all();
    __syncthreads();
    if (i < nimg) {
      // rows past the strip's valid outputs may read halo rows that were
      // not staged; they feed only outputs that are never stored
      const TA* col = tile + i * img_elems + s * R * p.pitch + c;
      const float* tp = taps + (p.k_batched ? i : 0) * kh * kw;
      accumulate<R, KH, KW>(
          acc, kh, kw,
          [&](int j, int h) { return to_f32(col[j * p.pitch + h]); },
          [&](int v, int h) { return tp[v * kw + h]; });
    }
  }
  if (i < nimg && c < tw) {
    float* o =
        out + ((long long)(b0 + i) * p.OH + y0 + s * R) * p.OW + x0 + c;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (s * R + r < th) o[(long long)r * p.OW] = acc[r];
  }
}

// a: (H, W, Cw) uint32, k: (kh, kw, Cw) uint32, out: (OH, OW) int32 =
// kh*kw*32*Cw - 2 * sum of popcount(a ^ k) over taps and words
__global__ void binary_conv2d_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ k,
                                     int32_t* __restrict__ out, int H, int W,
                                     int Cw, int kh, int kw) {
  const int OH = H - kh + 1, OW = W - kw + 1;
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long long)OH * OW) return;
  const int oy = (int)(o / OW), ox = (int)(o - (long long)oy * OW);
  int mism = 0;
  for (int v = 0; v < kh; ++v)
    for (int h = 0; h < kw; ++h) {
      const uint32_t* src = a + ((long long)(oy + v) * W + ox + h) * Cw;
      const uint32_t* tap = k + (long long)(v * kw + h) * Cw;
      for (int w = 0; w < Cw; ++w) mism += __popc(src[w] ^ tap[w]);
    }
  out[o] = kh * kw * 32 * Cw - 2 * mism;
}

template <bool STAGED, int R, int KH, int KW, typename TA, typename TK>
void launch_conv(const void* a, const void* k, void* out, const ConvArgs& p,
                 int lvw, cudaStream_t stream) {
  conv2d_shift_kernel<STAGED, R, KH, KW, TA, TK>
      <<<dim3((unsigned)p.grid_x, (unsigned)p.grid_y),
         dim3((unsigned)p.TW, (unsigned)(p.TH / p.R), (unsigned)p.ipc),
         p.smem, stream>>>((const TA*)a, (const TK*)k, (float*)out, p, lvw);
}

template <bool STAGED, typename TA, typename TK>
void launch_staged(const void* a, const void* k, void* out,
                   const ConvArgs& p, int lvw, cudaStream_t stream) {
  const bool k3 = p.kh == 3 && p.kw == 3;
  if (p.R == 8)
    k3 ? launch_conv<STAGED, 8, 3, 3, TA, TK>(a, k, out, p, lvw, stream)
       : launch_conv<STAGED, 8, 0, 0, TA, TK>(a, k, out, p, lvw, stream);
  else
    k3 ? launch_conv<STAGED, 4, 3, 3, TA, TK>(a, k, out, p, lvw, stream)
       : launch_conv<STAGED, 4, 0, 0, TA, TK>(a, k, out, p, lvw, stream);
}

template <typename TA, typename TK>
void launch_typed(const void* a, const void* k, void* out, const ConvArgs& p,
                  int lvw, cudaStream_t stream) {
  p.staged ? launch_staged<true, TA, TK>(a, k, out, p, lvw, stream)
           : launch_staged<false, TA, TK>(a, k, out, p, lvw, stream);
}

// log2 of the widest cp.async (16, 8 or 4 bytes) that A's address, its row
// stride and the column offset of every tile allow; 1 (bf16 only) copies the
// rows element by element.
int copy_width_log2(const void* a, const ConvArgs& p) {
  const long long es = p.a_bf16 ? 2 : 4;
  const long long offsets[] = {(long long)(uintptr_t)a, p.W * es,
                               p.ncol > 1 ? p.TW * es : 0};
  int lvw = 4;
  for (long long o : offsets)
    while ((1LL << lvw) > es && o % (1LL << lvw)) --lvw;
  return lvw;
}

}  // namespace

// a: (B, H, W), k: (B, kh, kw) when k_batched else (kh, kw), out:
// (B, H-kh+1, W-kw+1) float32, all contiguous on the device; args: the
// launch plan and dtypes (a_bf16 / k_bf16 pick bfloat16 or float32 for each
// operand). Serves conv2d_shift and conv2d_shift_tiled. Launches on `stream`
// and returns cudaGetLastError() so a refused launch reaches the caller.
extern "C" int matpim_conv2d_shift(const void* a, const void* k, void* out,
                                   const ConvArgs* args, void* stream) {
  const ConvArgs& p = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const int lvw = copy_width_log2(a, p);
  if (p.a_bf16 && p.k_bf16)
    launch_typed<__nv_bfloat16, __nv_bfloat16>(a, k, out, p, lvw, s);
  else if (p.a_bf16)
    launch_typed<__nv_bfloat16, float>(a, k, out, p, lvw, s);
  else if (p.k_bf16)
    launch_typed<float, __nv_bfloat16>(a, k, out, p, lvw, s);
  else
    launch_typed<float, float>(a, k, out, p, lvw, s);
  return (int)cudaGetLastError();
}

// a: (H, W, Cw) uint32, k: (kh, kw, Cw) uint32, out: (H-kh+1, W-kw+1)
// int32, all contiguous on the device.
extern "C" int matpim_binary_conv2d(const void* a, const void* k, void* out,
                                    int H, int W, int Cw, int kh, int kw,
                                    void* stream) {
  const long long n = (long long)(H - kh + 1) * (W - kw + 1);
  binary_conv2d_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                         0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)k, (int32_t*)out, H, W, Cw, kh,
      kw);
  return (int)cudaGetLastError();
}
