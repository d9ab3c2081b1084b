// Shift-and-add 2D convolutions for Hopper (sm_90a): valid cross-correlation
// (no flip, MatPIM Algorithm 1) with f32 accumulation, and the
// channel-packed binary (XNOR-popcount) conv. Built with nvcc into a plain C
// library and loaded with ctypes by repro_torch/kernels/conv2d_shift.py,
// which holds the plain PyTorch version of each function and chooses every
// launch's tiling (conv_launch_plan, binary_conv_launch_plan).
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
//
// binary_conv2d replaces _binary_conv_kernel / binary_conv2d of
// src/repro/kernels/conv2d_shift.py:88-115, which holds the whole packed
// image in VMEM and adds kh*kw shifted XOR-popcount planes. Per word per tap
// it does one XOR, one population count and one add. The card counts
// population at 16 per SM per clock against 64 for XOR and add, so wherever
// the work is above the launch floor the popcount pipe is the bound (at
// 514 x 514 x 256 and 258 x 258 x 1024, k = 3: 18.9 M popcounts, 4.5 us,
// against 2.5-2.8 us for the bytes). At the ops path's 66 x 66 x 256 the
// bound is 0.07 us and the launch and one memory round trip are the time.
// What the design does about each:
//   - Fill the card: a group of 2^lg lanes (a power of two that leaves at
//     most 1/8 of its unit slots idle) shares an output's words and sums its
//     counts with __shfl_xor_sync, in CTA tiles chosen by the wrapper
//     (binary_conv_launch_plan) so that launches of enough outputs have at
//     least 132 CTAs: 256 CTAs of 16 outputs at 66 x 66 x 256, where one
//     thread an output in blocks of 256 would launch 16.
//   - Few loads per popcount: channels are words and a tap row's words are
//     one contiguous run, read as uint4 where Cw % 4 == 0 (and the views
//     are 16-byte aligned). Small launches spread all of an output's units
//     over its lanes, 8 loads in flight each, for one memory round trip
//     (count_units). Launches that fill the card reuse rows (count_rows): a
//     group owns 4 output rows of a column and counts each halo row's unit,
//     loaded once, against every (output row, tap row) that uses it, 4*kh
//     counts from 3+kh loads, so the loop issues 9 LDS.128, 48 XORs, 48
//     popcounts and 24 adds per 48 words (its SASS for sm_90a): the
//     popcount pipe is the loop's limit.
//   - Staging: with row reuse over more than 9 taps a CTA copies its halo
//     rows, each a contiguous run of (TW+kw-1)*Cw words, and the taps into
//     shared memory once (row_stage.cuh's span copy), row pitch padded to
//     kw*Cw mod 32 words so a group's units that run on into the next row
//     stay on consecutive banks; 48 KB without an opt-in. Every other launch
//     reads A and K through L1: the copies of all resident CTAs finish
//     before any count starts, while direct loads overlap other warps'
//     counts, and that measured faster at every 3 x 3 and small 5 x 5 shape
//     (PERF.md gives both times).
//
// No tensor cores for binary_conv2d. A call computes one output channel,
// the reference's contract, and the smallest b1 mma.sync is n = 8 wide, so
// 7/8 of every product would be thrown away. ptxas of the CUDA 12.9
// toolkit still takes both b1 variants for sm_90a,
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc and .and.popc
// (the toolkit on the card's machine carries no PTX ISA document; this was
// checked by compiling each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// binary_conv2d's launch parameters, computed and cached by the Python
// wrapper (kernels/conv2d_shift.py::_BinaryArgs, same field order, int32).
struct BconvArgs {
  int H, W, Cw, kh, kw, OH, OW;
  int V;               // words per unit: 4 (uint4) where Cw % 4 == 0, else 1
  int lg;              // lanes per output group: 2^lg
  int reuse;           // row reuse (count_rows), or unit spread
  int Q;               // outputs per group, in consecutive rows
  int TH, TW;          // CTA output tile (TW a power of two)
  int threads, staged;
  int pitch;           // shared halo row pitch, words (a multiple of 4)
  int smem, taps_off;  // dynamic shared bytes, where the taps start
  int grid_x, grid_y;  // row tiles, column tiles
};

namespace {

constexpr int kThreads = 256;  // the most threads a conv block has
constexpr int kChunk = 8;      // binary conv units a lane loads at once
constexpr int kReuseRows = 4;  // its output rows per lane group under row
                               // reuse (BCONV_Q in the wrapper)

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

// binary_conv2d's popcount of a ^ k over one unit of V words.
__device__ __forceinline__ int popc_xor(uint32_t a, uint32_t b) {
  return __popc(a ^ b);
}
__device__ __forceinline__ int popc_xor(uint4 a, uint4 b) {
  return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
         __popc(a.w ^ b.w);
}

// One unit of words: from shared memory, or from global memory through L1.
template <typename U, bool SHARED>
__device__ __forceinline__ U load_unit(const uint32_t* p) {
  if constexpr (SHARED)
    return *reinterpret_cast<const U*>(p);
  else
    return __ldg(reinterpret_cast<const U*>(p));
}

// Unit spread (small launches, where latency rules): the lane's count for
// its group's one output at halo row `row`, word `col`, over units g, g+G,
// ... of the output's kh runs of LU units, kChunk loads in flight at once,
// read through L1 (a row stride of WC words).
template <int V, typename U>
__device__ __forceinline__ int count_units(const uint32_t* tile,
                                           const uint32_t* taps, int row,
                                           int col, int WC, int kh, int LU,
                                           int g, int G) {
  const int r0 = row * WC + col;
  int mism = 0, v = 0, j = g;  // this lane's next unit, v * LU + j
  while (j >= LU && v < kh) {
    j -= LU;
    ++v;
  }
  while (v < kh) {
    U tp[kChunk], x[kChunk];
    bool ok[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      ok[i] = v < kh;
      if (ok[i]) {
        tp[i] = load_unit<U, false>(taps + (v * LU + j) * V);
        x[i] = load_unit<U, false>(tile + r0 + v * WC + j * V);
      }
      j += G;
      while (j >= LU && v < kh) {
        j -= LU;
        ++v;
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      if (ok[i]) mism += popc_xor(x[i], tp[i]);
  }
  return mism;
}

// Row reuse (launches that fill the card): the lane's counts for its
// group's Q outputs, rows row0..row0+Q-1 of one column, over the unit
// columns j = g, g+G, ... of the KH runs. For each j the lane loads the KH
// tap units once and each of the Q+KH-1 halo rows' unit once, and counts
// that unit against every (output q, tap row v) with q + v = its row: Q*KH
// counts from Q+KH-1 loads. Halo rows past hmax (rows of outputs past the
// tile, never stored) are clamped to it. Halo row r starts at word
// r*stride of `tile` (+ the staged row's misalignment (m0 + r*wc4) % 4
// when V = 1).
template <int V, int Q, int KH, bool SHARED, typename U>
__device__ __forceinline__ void count_rows(int (&mism)[Q],
                                           const uint32_t* tile,
                                           const uint32_t* taps, int row0,
                                           int hmax, int col, int stride,
                                           int m0, int wc4, int LU, int g,
                                           int G) {
  constexpr bool MIS = SHARED && V == 1;
  int ro[Q + KH - 1];
#pragma unroll
  for (int r = 0; r < Q + KH - 1; ++r) {
    const int hr = min(row0 + r, hmax);
    ro[r] = hr * stride + col + (MIS ? (m0 + hr * wc4) & 3 : 0);
  }
  for (int j = g; j < LU; j += G) {
    U tv[KH];
#pragma unroll
    for (int v = 0; v < KH; ++v)
      tv[v] = load_unit<U, SHARED>(taps + (v * LU + j) * V);
#pragma unroll
    for (int r = 0; r < Q + KH - 1; ++r) {
      const U x = load_unit<U, SHARED>(tile + ro[r] + j * V);
#pragma unroll
      for (int v = 0; v < KH; ++v)
        if (r - v >= 0 && r - v < Q) mism[r - v] += popc_xor(x, tv[v]);
    }
  }
}

// a: (H, W, Cw) uint32, k: (kh, kw, Cw) uint32, out: (OH, OW) int32 =
// kh*kw*32*Cw - 2 * sum of popcount(a ^ k) over taps and words.
// CTA (blockIdx.x, blockIdx.y) owns the TH x TW output tile at row tile x,
// column tile y. Its threads form groups of G = 2^lg lanes, group (rb, c)
// = (grp / TW, grp % TW) owning the Q outputs of rows rb*Q.. of column c
// (TW a power of two). For a fixed tap row v an output's taps and words
// are one contiguous run of L = kw*Cw words (a[oy+v, ox.., :] and
// k[v, :, :]), so an output's work is kh runs of L/V units of V words
// (uint4 when V = 4). KH = 0: Q = 1 and the lanes spread all kh*L/V units
// (count_units); KH = kh: row reuse (count_rows). The group's counts are
// summed by __shfl_xor_sync. Outputs past the ragged tile edge are clamped
// to the last valid column and halo row (counted, never stored), so no read
// leaves the halo tile. STAGED (row reuse only): the CTA first copies its
// (TH+kh-1) halo rows into shared memory, each row one span of
// (TW+kw-1)*Cw words, and the taps as one span (row_stage.cuh: each lands
// at its own misalignment); else it reads A and K through L1. Offsets are
// 32-bit: the wrapper refuses images of 2^31 words or more.
template <int V, int KH, int Q, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    binary_conv2d_kernel(const uint32_t* __restrict__ a,
                         const uint32_t* __restrict__ k,
                         int32_t* __restrict__ out, const BconvArgs p) {
  using U = typename std::conditional<V == 4, uint4, uint32_t>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int y0 = blockIdx.x * p.TH, x0 = blockIdx.y * p.TW;
  const int th = min(p.TH, p.OH - y0), tw = min(p.TW, p.OW - x0);
  const int Cw = p.Cw, WC = p.W * Cw, LU = p.kw * Cw / V;
  const uint32_t* src = a + y0 * WC + x0 * Cw;  // the halo tile's first word

  const int G = 1 << p.lg, g = t & (G - 1), grp = t >> p.lg;
  const int ltw = 31 - __clz(p.TW);
  const int rb = grp >> ltw, c = grp & (p.TW - 1);
  const int col = min(c, tw - 1) * Cw, row0 = rb * Q;
  int mism[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) mism[q] = 0;
  if constexpr (KH == 0) {
    static_assert(Q == 1 && !STAGED, "unit spread reads through L1");
    mism[0] = count_units<V, U>(src, k, min(row0, th - 1), col, WC, p.kh, LU,
                                g, G);
  } else if constexpr (STAGED) {
    uint32_t* st = reinterpret_cast<uint32_t*>(smem);
    uint32_t* sk = reinterpret_cast<uint32_t*>(smem + p.taps_off);
    const int hrows = th + KH - 1, n = (tw + p.kw - 1) * Cw;
    // a group of 2^lr threads, the fewest that cover a row's copies (at
    // most a warp), stages one row
    const int units = (n >> 2) + 2;
    const int lr = min(32 - __clz(units - 1), min(5, 31 - __clz(p.threads)));
    const int li = t & ((1 << lr) - 1);
    for (int r = t >> lr; r < hrows; r += p.threads >> lr)
      row_stage::stage_span(st + r * p.pitch, src + r * WC, n, li, 1 << lr);
    const int kmis = row_stage::stage_span(sk, k, KH * p.kw * Cw, t,
                                           p.threads);
    row_stage::cp_async_wait_all();
    __syncthreads();
    count_rows<V, Q, KH, true, U>(mism, st, sk + kmis, row0, th + KH - 2,
                                  col, p.pitch, row_stage::misalignment(src),
                                  WC & 3, LU, g, G);
  } else {
    count_rows<V, Q, KH, false, U>(mism, src, k, row0, th + KH - 2, col, WC,
                                   0, 0, LU, g, G);
  }
  // a group is G (a power of two) aligned lanes of one warp
#pragma unroll
  for (int q = 0; q < Q; ++q)
    for (int o = G >> 1; o > 0; o >>= 1)
      mism[q] += __shfl_xor_sync(0xffffffffu, mism[q], o);
  const unsigned total = 32u * (unsigned)(p.kh * p.kw * Cw);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int orow = row0 + q;
    if ((q & (G - 1)) == g && c < tw && orow < th)
      out[(y0 + orow) * p.OW + x0 + c] =
          (int32_t)(total - 2u * (unsigned)mism[q]);
  }
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

template <int V, int KH, int Q, bool STAGED>
void launch_bconv_q(const void* a, const void* k, void* out,
                    const BconvArgs& p, cudaStream_t stream) {
  binary_conv2d_kernel<V, KH, Q, STAGED>
      <<<dim3((unsigned)p.grid_x, (unsigned)p.grid_y), (unsigned)p.threads,
         p.smem, stream>>>((const uint32_t*)a, (const uint32_t*)k,
                           (int32_t*)out, p);
}

template <int V, bool STAGED>
void launch_bconv(const void* a, const void* k, void* out, const BconvArgs& p,
                  cudaStream_t stream) {
  constexpr int Q = kReuseRows;
  switch (p.reuse ? p.kh : 0) {
    case 2: return launch_bconv_q<V, 2, Q, STAGED>(a, k, out, p, stream);
    case 3: return launch_bconv_q<V, 3, Q, STAGED>(a, k, out, p, stream);
    case 4: return launch_bconv_q<V, 4, Q, STAGED>(a, k, out, p, stream);
    case 5: return launch_bconv_q<V, 5, Q, STAGED>(a, k, out, p, stream);
    default: return launch_bconv_q<V, 0, 1, false>(a, k, out, p, stream);
  }
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
// int32, all contiguous on the device; args: the launch plan. Units of four
// words need A and K 16-byte aligned: a view off 16 bytes runs the plan
// with single words. Launches on `stream` and returns cudaGetLastError().
extern "C" int matpim_binary_conv2d(const void* a, const void* k, void* out,
                                    const BconvArgs* args, void* stream) {
  const BconvArgs& p = *args;
  cudaStream_t s = (cudaStream_t)stream;
  // the plans the kernel is compiled for (binary_conv_launch_plan's)
  const bool ok = p.reuse ? p.kh >= 2 && p.kh <= 5 && p.Q == kReuseRows
                          : p.Q == 1 && !p.staged;
  if (!ok) return (int)cudaErrorInvalidValue;
  const bool v4 = p.V == 4 && (((uintptr_t)a | (uintptr_t)k) & 15) == 0;
  if (v4)
    p.staged ? launch_bconv<4, true>(a, k, out, p, s)
             : launch_bconv<4, false>(a, k, out, p, s);
  else
    p.staged ? launch_bconv<1, true>(a, k, out, p, s)
             : launch_bconv<1, false>(a, k, out, p, s);
  return (int)cudaGetLastError();
}
