// XNOR-popcount GEMM for Hopper (sm_90a): the ±1 dot product of bit-packed
// operands, C[b, i, j] = K - 2 * popcount(A[b, i, :] ^ B[b, j, :]),
// K = 32 * Kw. Built with nvcc into a plain C library and loaded with ctypes
// by repro_torch/kernels/binary_matmul.py, which holds the plain PyTorch
// version of the same function and chooses every launch's kernel and CTA
// shape (binary_launch_plan).
//
// Replaces the TPU kernel binary_matmul in src/repro/kernels/binary_matmul.py
// (_binary_matmul_kernel under pl.pallas_call). Each batch entry computes
// exactly that kernel's function, for any (M, N, Kw): the kernel masks the
// ragged edge itself, so no block-divisibility constraint is left.
//
// Translation. The TPU runs a grid (M/bm, N/bn, Kw/bk) in order on one core
// and carries the mismatch count in the output block from one k-step to the
// next. Hopper runs blocks in parallel and in no order, so nothing carries
// between blocks: each output's whole K axis is counted inside one CTA. A
// leading batch axis on blockIdx.y lets one launch serve every crossbar tile
// of a bucket.
//
// What bounds it. The main path calls it with N = 1 (a matrix-vector
// product per tile), M = 1024 rows and Kw = 13 words (416 bits), B = 20
// tiles: it reads about 1.1 MB and does about 0.8 M integer operations, so
// device memory bounds it (about 0.34 us at 3.35 TB/s) and in practice the
// launch's fixed cost dominates. A warp per output with lanes striding over
// the words fits such rows badly: at Kw = 13, 19 of 32 lanes would load
// nothing, every warp would pay a 5-step shuffle tree for 13 popcounts, and
// 20,480 warps would each keep one 52-byte row in flight. So two kernels:
//
// binary_rows (N = 1, every bucket of the main path). A CTA owns R
// consecutive rows of A, R*Kw contiguous words, and copies them into shared
// memory as one span (row_stage.cuh: 16-byte cp.async chunks from the
// span's first 16-byte boundary, single words at the ragged ends), and x's
// Kw words beside them the same way, all copies in flight at once. One
// thread per row (a group of `lanes` threads when the CTA has fewer than 32
// rows) does Kw __popc(a ^ x) and adds from shared memory, and neighbouring
// rows store neighbouring outputs. An odd Kw puts neighbouring rows on
// distinct banks; with an even Kw each row's walk starts at its own word
// (`rot`). R is the plan's: 128 rows (160 CTAs) at 20 x 1024 x 13, fewer
// where that leaves SMs idle.
//
// binary_tiles (N > 1: ops.binary_dense; and N = 1 rows too long to stage
// in 48 KB). A CTA holds TILE_WARPS * RM rows of A and 32 rows of B in
// shared memory, a chunk of 32 words at a time, rows padded to 33 words so
// lane j's reads of B row j hit distinct banks; lane j counts B row j
// against RM rows of A per warp (A's words are broadcast to the warp), and
// a warp's 32 outputs are one contiguous store. Rows of at most 8 words
// (the reference's 8 x 8 x 1 and 128 x 128 x 8) skip the staging and its
// barriers and read the words through L1: measured faster there, slower
// from 16 words on. No tensor cores: b1 MMA gains nothing at N = 1, and the
// N > 1 callers are small.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_stage.cuh"

// Launch parameters, computed and cached by the Python wrapper
// (kernels/binary_matmul.py::_Args, same field order, all int32).
struct BinaryArgs {
  int B, M, N, Kw;
  int rows_mode;             // binary_rows (N = 1), or binary_tiles
  int rows, threads, lanes;  // rows of A per CTA, threads, threads per row
  int rot;                   // binary_rows: walks start at the row's word
  int rm;                    // binary_tiles: A rows per thread
  int tiles_n;               // binary_tiles: tiles across N
  int staged;                // binary_tiles: through shared memory
  int smem, x_off;           // dynamic shared bytes, where x starts
  int grid_x;                // CTAs per batch entry (grid.y = B)
};

namespace {

constexpr int kTileN = 32;      // B rows per tile, one per lane
constexpr int kTileWarps = 8;   // warps per tile CTA
constexpr int kChunk = 32;      // words staged per row at once, a lane each
constexpr int kPitch = kChunk + 1;

// N = 1: CTA (blockIdx.x, b) owns rows r0..r0+rows-1 of batch entry b;
// thread t counts row t / lanes with its lanes - 1 neighbours.
__global__ void __launch_bounds__(256)
    binary_rows(const uint32_t* __restrict__ a,
                const uint32_t* __restrict__ x, int32_t* __restrict__ c,
                const BinaryArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sa = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sx = reinterpret_cast<uint32_t*>(smem + p.x_off);
  const int Kw = p.Kw, t = threadIdx.x;
  const long long b = blockIdx.y;
  const int r0 = blockIdx.x * p.rows;
  const int nrows = min(p.rows, p.M - r0);
  const int mis = row_stage::stage_span(sa, a + (b * p.M + r0) * Kw,
                                        nrows * Kw, t, (int)blockDim.x);
  const uint32_t* xs =
      sx + row_stage::stage_span(sx, x + b * Kw, Kw, t, (int)blockDim.x);
  row_stage::cp_async_wait_all();
  __syncthreads();
  const int r = t / p.lanes, g = t - r * p.lanes;
  int mism = 0;
  if (r < nrows) {
    const uint32_t* row = sa + mis + r * Kw;
    const int off = p.rot ? r % Kw : 0;
#pragma unroll 4
    for (int kk = g; kk < Kw; kk += p.lanes) {
      const int k = kk + off < Kw ? kk + off : kk + off - Kw;
      mism += __popc(row[k] ^ xs[k]);
    }
  }
  // a row's lanes are `lanes` (a power of two) aligned threads of a warp
  for (int o = p.lanes >> 1; o > 0; o >>= 1)
    mism += __shfl_xor_sync(0xffffffffu, mism, o);
  if (g == 0 && r < nrows) c[b * p.M + r0 + r] = 32 * Kw - 2 * mism;
}

// Stage the chunk of kc words from word k0 of A rows i0..i0+TM-1 and B
// rows j0..j0+31 into sa and sb at pitch kPitch, rows past M or N and
// words past kc as zeros. Thread (lane, warp) copies word lane of rows
// warp + kTileWarps * q, every load issued before the first store.
template <int RM>
__device__ __forceinline__ void stage_tiles(
    uint32_t* sa, uint32_t* sb, const uint32_t* __restrict__ a,
    const uint32_t* __restrict__ bm, int i0, int j0, int M, int N, int Kw,
    int k0, int kc) {
  constexpr int QB = kTileN / kTileWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool word = lane < kc;
  uint32_t va[RM], vb[QB];
#pragma unroll
  for (int q = 0; q < RM; ++q) {
    const int i = i0 + warp + kTileWarps * q;
    va[q] = word && i < M ? a[(long long)i * Kw + k0 + lane] : 0u;
  }
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    const int j = j0 + warp + kTileWarps * q;
    vb[q] = word && j < N ? bm[(long long)j * Kw + k0 + lane] : 0u;
  }
#pragma unroll
  for (int q = 0; q < RM; ++q)
    sa[(warp + kTileWarps * q) * kPitch + lane] = va[q];
#pragma unroll
  for (int q = 0; q < QB; ++q)
    sb[(warp + kTileWarps * q) * kPitch + lane] = vb[q];
}

// N > 1: CTA (blockIdx.x, b) owns A rows i0..i0+8*RM-1 and B rows
// j0..j0+31 of batch entry b; thread (lane, warp) counts B row j0 + lane
// against A rows i0 + warp + 8 * r, r < RM. STAGED: through shared memory,
// a chunk of kChunk words at a time; else (rows of a few words, where a
// barrier costs more than it saves) straight from global memory through L1,
// with rows past M or N clamped to the last (their outputs are not stored).
template <int RM, bool STAGED>
__global__ void __launch_bounds__(kTileWarps * 32)
    binary_tiles(const uint32_t* __restrict__ a,
                 const uint32_t* __restrict__ bm, int32_t* __restrict__ c,
                 const BinaryArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TM = kTileWarps * RM;
  uint32_t* sa = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sb = sa + TM * kPitch;
  const int ti = blockIdx.x / p.tiles_n, tj = blockIdx.x - ti * p.tiles_n;
  const int i0 = ti * TM, j0 = tj * kTileN;
  const long long b = blockIdx.y;
  const uint32_t* ab = a + b * p.M * p.Kw;
  const uint32_t* bb = bm + b * p.N * p.Kw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int mism[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) mism[r] = 0;
  if constexpr (STAGED) {
    for (int k0 = 0; k0 < p.Kw; k0 += kChunk) {
      const int kc = min(kChunk, p.Kw - k0);
      if (k0) __syncthreads();  // every warp is done with the last chunk
      stage_tiles<RM>(sa, sb, ab, bb, i0, j0, p.M, p.N, p.Kw, k0, kc);
      __syncthreads();
      for (int w = 0; w < kc; ++w) {
        const uint32_t bw = sb[lane * kPitch + w];
#pragma unroll
        for (int r = 0; r < RM; ++r)
          mism[r] += __popc(sa[(warp + kTileWarps * r) * kPitch + w] ^ bw);
      }
    }
  } else {
    const uint32_t* brow = bb + (long long)min(j0 + lane, p.N - 1) * p.Kw;
    for (int w = 0; w < p.Kw; ++w) {
      const uint32_t bw = __ldg(brow + w);
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const int i = min(i0 + warp + kTileWarps * r, p.M - 1);
        mism[r] += __popc(__ldg(ab + (long long)i * p.Kw + w) ^ bw);
      }
    }
  }
  const int j = j0 + lane;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int i = i0 + warp + kTileWarps * r;
    if (i < p.M && j < p.N)
      c[(b * p.M + i) * p.N + j] = 32 * p.Kw - 2 * mism[r];
  }
}

template <bool STAGED>
void launch_tiles(const dim3 grid, const BinaryArgs& p, const uint32_t* a,
                  const uint32_t* b, int32_t* c, cudaStream_t s) {
  if (p.rm == 4)
    binary_tiles<4, STAGED><<<grid, p.threads, p.smem, s>>>(a, b, c, p);
  else if (p.rm == 2)
    binary_tiles<2, STAGED><<<grid, p.threads, p.smem, s>>>(a, b, c, p);
  else
    binary_tiles<1, STAGED><<<grid, p.threads, p.smem, s>>>(a, b, c, p);
}

}  // namespace

// a: (B, M, Kw) uint32, b: (B, N, Kw) uint32, c: (B, M, N) int32, all
// contiguous on the device; args: the launch plan. Launches on `stream` and
// returns cudaGetLastError() so a refused launch reaches the caller.
extern "C" int matpim_binary_matmul(const void* a, const void* b, void* c,
                                    const BinaryArgs* args, void* stream) {
  const BinaryArgs& p = *args;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.B);
  const uint32_t* ua = (const uint32_t*)a;
  const uint32_t* ub = (const uint32_t*)b;
  int32_t* uc = (int32_t*)c;
  if (p.rows_mode)
    binary_rows<<<grid, p.threads, p.smem, s>>>(ua, ub, uc, p);
  else if (p.staged)
    launch_tiles<true>(grid, p, ua, ub, uc, s);
  else
    launch_tiles<false>(grid, p, ua, ub, uc, s);
  return (int)cudaGetLastError();
}
