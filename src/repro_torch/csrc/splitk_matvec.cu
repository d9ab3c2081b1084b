// Matrix-vector product with f32 accumulation for Hopper (sm_90a):
// y[b, i] = sum_k A[b, i, k] * x[b, k], A and x in float32 or bfloat16 (each
// its own type), y float32. Built with nvcc into a plain C library and loaded
// with ctypes by repro_torch/kernels/splitk_matvec.py, which holds the plain
// PyTorch version of the same function and chooses every launch's mode and
// CTA shape (matvec_launch_plan).
//
// Replaces the TPU kernel splitk_matvec in src/repro/kernels/splitk_matvec.py
// (_splitk_kernel under pl.pallas_call). Each batch entry computes exactly
// that kernel's function, for any (M, K): the kernel masks the ragged edge
// itself, so the TPU's (256, 512) block divisibility is gone.
//
// Translation. The TPU runs a grid (M/bm, K/bk) in order on one core and
// carries each row's partial sum in the output block from one k-step to the
// next (MatPIM's split-K: block products summed in order). Hopper runs
// blocks in parallel and in no order, so nothing carries between blocks:
// each row is reduced whole inside one CTA. A leading batch axis on
// blockIdx.y lets one launch serve every crossbar tile of a served bucket.
//
// What bounds it. The served path calls it with B = 27 tiles, M = 1024 rows,
// K = 39 (float32 holding 8-bit integers): it reads about 4.3 MB and does
// about 2.2 M flops, so device memory bounds it (about 1.3 us at 3.35 TB/s),
// and at that size a launch's fixed cost is of the same order. A warp per
// row with lanes striding over K fits such rows badly: at K = 39, 25 of 32
// lanes would take one element, every warp would pay a 5-step shuffle tree,
// and a warp's reads would touch one or two 128-byte lines, 27,648 warps
// each with few loads in flight. So the kernel has two modes:
//
// Short rows (at most 512 bytes; the served K = 39 f32 rows are 156 B). A
// CTA owns R consecutive rows of one batch entry, R*K contiguous elements,
// and copies them into shared memory as one span (row_stage.cuh: 16-byte
// cp.async chunks from the span's first 16-byte boundary, single elements
// at the ragged ends), and the batch entry's x beside them the same way,
// all copies in flight at once. Then one thread per row (a group of `lanes`
// threads when the CTA has fewer than 32 rows) walks its row in shared
// memory. An odd K puts neighbouring rows on distinct banks; with an even K
// each row's walk starts at its own column (`rot`), which does the same. R
// is the plan's: 128 rows (216 CTAs) at the served shape, fewer where that
// leaves SMs idle.
//
// Long rows (the reference's K = 512-4096). A warp per row, or several
// warps splitting a row's K so that a thread loads at most 4 chunks of 16
// bytes (4 f32 or 8 bf16 each); 8 warps a CTA, or down to 4 rows a CTA to
// reach 132 CTAs, so that the x a CTA stages serves several rows. x is
// staged in shared memory once per CTA (in chunks of up to 8192 elements)
// with cp.async, raw, while each thread already loads its first chunks of
// A from the row's first 16-byte boundary (single elements at the row's
// ends); shuffles sum a warp, shared memory the warps of a row.
//
// On integer inputs whose true sum stays below 2^24 (the kernel bridge's
// case) the result is exact in any order; on float inputs it differs from
// the TPU's summation order in the last bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"

// Launch parameters, computed and cached by the Python wrapper
// (kernels/splitk_matvec.py::_Args, same field order, all int32).
struct MatvecArgs {
  int B, M, K;
  int short_rows;            // short-row mode, or warps per long row
  int rows, threads, lanes;  // rows per CTA, threads, threads per row
  int rot;                   // short rows: walks start at the row's column
  int xchunk;                // long rows: x elements staged at once
  int smem, x_off;           // dynamic shared bytes; where x starts (short
                             // rows), where warp partials start (long rows)
  int grid_x;                // CTAs per batch entry (grid.y = B)
  int a_bf16, x_bf16;
};

namespace {

using row_stage::cp_async_wait_all;
using row_stage::stage_span;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V elements of x, staged raw in shared memory from xs on, as f32; VEC
// reads them with one vector load of V * sizeof(TX) bytes (8, 16 or 32),
// xs aligned to it.
template <int V, typename TX, bool VEC>
__device__ __forceinline__ void load_x(float (&xv)[V], const TX* xs) {
  if constexpr (VEC && sizeof(TX) == 4) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(xs)[q];
      xv[4 * q] = f.x;
      xv[4 * q + 1] = f.y;
      xv[4 * q + 2] = f.z;
      xv[4 * q + 3] = f.w;
    }
  } else if constexpr (VEC) {  // bf16: two a word, low half first
    unsigned w[V / 2];
    if constexpr (V == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(xs);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(xs);
      w[0] = u.x, w[1] = u.y;
    }
#pragma unroll
    for (int q = 0; q < V / 2; ++q) {
      xv[2 * q] = __uint_as_float(w[q] << 16);
      xv[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) xv[q] = to_f32(xs[q]);
  }
}

// The dot product of one 16-byte chunk of A (4 f32 or 8 bf16; widening
// bf16 is exact) with V values of x.
template <typename TA, int V>
__device__ __forceinline__ float dot_chunk(const uint4 v,
                                          const float (&xv)[V]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (sizeof(TA) == 4) {
      acc = fmaf(__uint_as_float(w[q]), xv[q], acc);
    } else {
      acc = fmaf(__uint_as_float(w[q] << 16), xv[2 * q], acc);
      acc = fmaf(__uint_as_float(w[q] & 0xffff0000u), xv[2 * q + 1], acc);
    }
  }
  return acc;
}

constexpr int kPrefetch = 4;  // A chunks a thread loads before x lands

// Thread rt of a row's nt: its 16-byte chunks c = rt + nt * j of the row
// (vrow) against x (xs, raw, element c * V on), the first kPrefetch already
// loaded into pre.
template <typename TA, typename TX, bool VEC>
__device__ __forceinline__ float dot_chunks(const uint4 (&pre)[kPrefetch],
                                           const uint4* __restrict__ vrow,
                                           const TX* xs, int nvec, int rt,
                                           int nt) {
  constexpr int V = 16 / (int)sizeof(TA);
  float acc = 0.f, xv[V];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int c = rt + nt * j;
    if (c < nvec) {
      load_x<V, TX, VEC>(xv, xs + c * V);
      acc += dot_chunk<TA, V>(pre[j], xv);
    }
  }
#pragma unroll 4
  for (int c = rt + nt * kPrefetch; c < nvec; c += nt) {
    load_x<V, TX, VEC>(xv, xs + c * V);
    acc += dot_chunk<TA, V>(__ldg(vrow + c), xv);
  }
  return acc;
}

// Short rows: CTA (blockIdx.x, b) owns rows r0..r0+rows-1 of batch entry
// b; thread t reduces row t / lanes with its lanes - 1 neighbours.
template <typename TA, typename TX>
__global__ void __launch_bounds__(256)
    matvec_short_rows(const TA* __restrict__ a, const TX* __restrict__ x,
                      float* __restrict__ y, const MatvecArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  TA* sa = reinterpret_cast<TA*>(smem);
  TX* sx = reinterpret_cast<TX*>(smem + p.x_off);
  const int K = p.K, t = threadIdx.x;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * p.rows;
  const int nrows = min(p.rows, p.M - r0);
  const int mis = stage_span(sa, a + (b * p.M + r0) * K, nrows * K, t,
                             (int)blockDim.x);
  const TX* xs = sx + stage_span(sx, x + b * K, K, t, (int)blockDim.x);
  cp_async_wait_all();
  __syncthreads();
  const int r = t / p.lanes, g = t - r * p.lanes;
  float acc = 0.f;
  if (r < nrows) {
    const TA* row = sa + mis + r * K;
    const int off = p.rot ? r % K : 0;
#pragma unroll 4
    for (int kk = g; kk < K; kk += p.lanes) {
      const int k = kk + off < K ? kk + off : kk + off - K;
      acc = fmaf(to_f32(row[k]), to_f32(xs[k]), acc);
    }
  }
  // a row's lanes are `lanes` (a power of two) aligned threads of a warp
  for (int o = p.lanes >> 1; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (g == 0 && r < nrows) y[b * p.M + r0 + r] = acc;
}

// Long rows: CTA (blockIdx.x, b) owns rows blockIdx.x * rows + rl, each
// reduced by nt = lanes threads (one warp or several): thread t is thread
// rt = t % nt of row rl = t / nt. Per chunk of x (xchunk elements): x is
// staged raw by cp.async (row_stage.cuh) while each thread loads its first
// kPrefetch 16-byte chunks of A; then head and tail elements (shorter than
// a chunk, one thread each) and the chunks. Lanes sum by shuffles, the
// row's warps through shared memory (part, at x_off).
template <typename TA, typename TX>
__global__ void __launch_bounds__(256)
    matvec_long_rows(const TA* __restrict__ a, const TX* __restrict__ x,
                     float* __restrict__ y, const MatvecArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  TX* sx = reinterpret_cast<TX*>(smem);
  float* part = reinterpret_cast<float*>(smem + p.x_off);
  constexpr int V = 16 / (int)sizeof(TA);
  const int K = p.K, t = threadIdx.x, nt = p.lanes;
  const int rl = t / nt, rt = t - rl * nt;
  const long long b = blockIdx.y;
  const int row = blockIdx.x * p.rows + rl;
  const bool live = row < p.M;
  const TA* arow = a + (b * p.M + (live ? row : 0)) * K;
  float acc = 0.f;
  for (int k0 = 0; k0 < K; k0 += p.xchunk) {
    const int n = min(p.xchunk, K - k0);
    if (k0) __syncthreads();  // every thread is done with the last chunk
    const int misx =
        row_stage::stage_span(sx, x + b * K + k0, n, t, (int)blockDim.x);
    const TA* r = arow + k0;
    const int head = min(n, (V - row_stage::misalignment(r)) % V);
    const int nvec = (n - head) / V, tail0 = head + nvec * V;
    const uint4* vrow = reinterpret_cast<const uint4*>(r + head);
    uint4 pre[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j)
      pre[j] = live && rt + nt * j < nvec ? __ldg(vrow + rt + nt * j)
                                          : make_uint4(0u, 0u, 0u, 0u);
    const float ah = live && rt < head ? to_f32(r[rt]) : 0.f;
    const float at = live && tail0 + rt < n ? to_f32(r[tail0 + rt]) : 0.f;
    row_stage::cp_async_wait_all();
    __syncthreads();
    if (live) {
      const TX* xs = sx + misx;
      if (rt < head) acc = fmaf(ah, to_f32(xs[rt]), acc);
      if (tail0 + rt < n) acc = fmaf(at, to_f32(xs[tail0 + rt]), acc);
      // x's values as vectors where the shared address allows
      acc += (misx + head) % V == 0
                 ? dot_chunks<TA, TX, true>(pre, vrow, xs + head, nvec, rt,
                                            nt)
                 : dot_chunks<TA, TX, false>(pre, vrow, xs + head, nvec, rt,
                                             nt);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (nt > 32) {
    if ((t & 31) == 0) part[t >> 5] = acc;
    __syncthreads();
    if (rt == 0) {
      acc = 0.f;
      for (int w = 0; w < nt >> 5; ++w) acc += part[(t >> 5) + w];
    }
  }
  if (rt == 0 && live) y[b * p.M + row] = acc;
}

template <typename TA, typename TX>
void launch(const void* a, const void* x, void* y, const MatvecArgs& p,
            cudaStream_t stream) {
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.B);
  if (p.short_rows)
    matvec_short_rows<TA, TX><<<grid, p.threads, p.smem, stream>>>(
        (const TA*)a, (const TX*)x, (float*)y, p);
  else
    matvec_long_rows<TA, TX><<<grid, p.threads, p.smem, stream>>>(
        (const TA*)a, (const TX*)x, (float*)y, p);
}

}  // namespace

// a: (B, M, K), x: (B, K), y: (B, M) float32, all contiguous on the device;
// args: the launch plan and dtypes (a_bf16 / x_bf16 pick bfloat16 or
// float32 for each operand). Launches on `stream` and returns
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int matpim_splitk_matvec(const void* a, const void* x, void* y,
                                    const MatvecArgs* args, void* stream) {
  const MatvecArgs& p = *args;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.a_bf16 && p.x_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(a, x, y, p, s);
  else if (p.a_bf16)
    launch<__nv_bfloat16, float>(a, x, y, p, s);
  else if (p.x_bf16)
    launch<float, __nv_bfloat16>(a, x, y, p, s);
  else
    launch<float, float>(a, x, y, p, s);
  return (int)cudaGetLastError();
}
