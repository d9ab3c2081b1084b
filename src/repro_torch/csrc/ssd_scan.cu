// The chunked SSD scan of Mamba-2 for Hopper (sm_90a): the function of
// models/mamba.py::_ssd (the port's plain version, kept unchanged beside
// this kernel) on a sequence of any length. x (b, s, h, p) and B, C (b, s,
// n) in float32 or bfloat16 (each pair of h, p and each n dense, the batch
// and sequence strided), dt (b, s, h) float32 (h dense), A (h,) and D (h,)
// float32, an optional initial state (b, h, p, n) float32. Out: y (b, s, h,
// p) in x's dtype and the final state (b, h, p, n) in float32. Built with
// nvcc into a plain C library and loaded with ctypes by
// repro_torch/kernels/ssd_scan.py, which checks the operands and sizes the
// scratch.
//
// Replaces no TPU kernel: the reference's src/repro/models/mamba.py
// computes the scan in plain jnp, which XLA fuses. Eager PyTorch cannot: the
// plain _ssd writes every intermediate to device memory in float32, the
// (c, h, l, l) decay matrix three times over (segment sums, their exp, the
// scores times them) and (c, l, h, n)-sized products for its three-operand
// einsums, and steps the chunks in a Python loop: about 100 launches and
// 4-5 GB of traffic a layer at a 5000-token prompt, for work of 4.2 MFLOP a
// token.
//
// The function, per chunk of L rows (the chunk the caller gives, at most
// 256) and head, with cs the inclusive cumulative sum of dt * A over the
// chunk's rows (cs falls: A < 0 < dt):
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j     (intra-chunk)
//       + exp(cs_i) C_i . S_prev                               (inter-chunk)
//       + D x_i
//   S_chunk = sum_j (dt_j exp(cs_last - cs_j) x_j) B_j^T        (its state)
//   S_prev(c + 1) = exp(cs_last(c)) S_prev(c) + S_chunk(c)      (recurrence)
// A ragged last chunk (and a sequence shorter than one chunk) is masked in
// the kernels: its missing rows load as dt = 0 and x = B = C = 0, so they
// neither decay nor add to the state, and are not written; that is the
// plain path's padded semantics.
//
// The arithmetic: float32 FMAs on the CUDA cores, and no tensor-core MMA,
// so no float32 operand is rounded to TF32 or bfloat16 (bf16 inputs widen
// exactly); that keeps the design simple, and its cost is the bound below.
// Three places keep more than the plain path. The cumulative sums are added
// in float64 and kept as float32 pairs (hi, lo): over a chunk they reach
// hundreds, and the plain path's distance from float64 is mostly the
// rounding of two such float32 sums in each decay exp(cs_i - cs_j); here the
// his cancel exactly where the decay is not small and the los correct it
// (exp_diff). C · B^T, 1/64 of the flops, is summed in float64. The GEMMs
// of launch 3 sum their depth in stages of 32 terms.
//
// What bounds it. The work is 2·s·L·n (C·B, once a chunk for all heads: one
// group) + 2·s·L·h·p (the intra-chunk products) + 4·s·h·p·n (states and the
// inter-chunk term) flops, about 4.2 MFLOP a token at granite's h 64, p 64,
// n 128, L 256: 21 GFLOP a 5000-token layer, 0.31 ms at the card's 67
// TFLOP/s of float32 FMAs, 11 ms over granite's 36 layers. Its operands are
// about 90 MB a layer, 27 us at 3.35 TB/s: the FMAs bound it. The design
// keeps every L x L and every (l, h, n)-sized intermediate out of device
// memory, takes no exp per element but on the diagonal tiles, and spends
// its instructions on register-tiled FMAs fed from shared memory, each
// stage's global loads issued into registers before the stage before it is
// computed:
//
// Three launches.
//  1. ssd_chunk_state: per (batch, chunk, head, p and n tile) one CTA scans
//     the chunk's dt * A (warp shuffles, float64), writes the cumulative
//     sums (b, c, h, L), and computes the chunk's state (p x n, K = L) as a
//     shared-memory-tiled GEMM, 4 x 8 outputs a thread. The same launch's
//     last CTAs compute C · B^T of each chunk, tile by tile on and below
//     the diagonal (64 x 64 tiles, K = n), once for all heads, into a (b, c,
//     L, L) scratch that the L2 cache holds.
//  2. ssd_state_pass: per element of a head's state, a loop over the chunks
//     that turns each chunk's state into the state before it, in place, and
//     writes the final state.
//  3. ssd_chunk_scan: per (batch, chunk, head, 64-row tile I from row i0, p
//     tile) one CTA computes its outputs, 4 x 4 a thread, in stages of 32
//     of depth. With r_i = exp(cs_i - cs_i0) and q_j = exp(cs_i0 - cs_j),
//     both at most 1, every row j < i0 decays to row i as r_i q_j, so
//       y_i = r_i [C_i . (exp(cs_i0) S_prev) + sum_{j<i0} CB_ij q_j dt_j x_j]
//             + sum_{i0<=j<=i} CB_ij exp(cs_i - cs_j) dt_j x_j + D x_i:
//     one GEMM of depth n + i0 whose operands carry the decays by row and
//     column, scaled by r_i, then the diagonal tile's decay formed element
//     by element in shared memory (zero above the diagonal), then D x_i;
//     y is written in x's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Launch parameters, filled by the Python wrapper (kernels/ssd_scan.py::
// _Args, same field order).
struct SsdArgs {
  int b, s, h, p, n;      // x (b, s, h, p); B, C (b, s, n); dt (b, s, h)
  int chunk;              // L: rows a chunk, 1..kMaxChunk
  int nchunks;            // ceil(s / L)
  int x_bf16, bc_bf16;    // x (and y), B and C: bfloat16, else float32
  int has_init;           // an initial state is given
  long long x_sb, x_ss;   // element strides of x over batch and sequence
  long long b_sb, b_ss;   // of B
  long long c_sb, c_ss;   // of C
  long long dt_sb, dt_ss; // of dt
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;  // a chunk's rows: one a thread in the scan
constexpr int kRows = 64;       // the rows of a tile of i or j
constexpr int kP = 64;          // the p tile
constexpr int kN = 128;         // the n tile of a state
constexpr int kK = 32;          // the depth staged in shared memory a step
constexpr int kPad = 68;        // the row of a transposed tile, in floats
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ld(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st_out(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void st_out(__nv_bfloat16* p, long long i,
                                       float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The valid rows of chunk ci: L, or fewer in a ragged last chunk.
__device__ __forceinline__ int chunk_rows(const SsdArgs& a, int ci) {
  return min(a.chunk, a.s - ci * a.chunk);
}

// Inclusive prefix sum of one value a thread over the block's 256 threads,
// in float64: within each warp by shuffles, then each warp's total added in
// order.
__device__ double block_scan(double v, double* warp_tot) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_tot[w] = v;
  __syncthreads();
  double off = 0.0;
  for (int k = 0; k < w; ++k) off += warp_tot[k];
  return v + off;
}

// Offsets into the scratch: the cumulative sums (b, c, h, L) as float32
// pairs, then the chunks' states (b, c, h, p, n) and C · B^T (b, c, L, L).
__device__ __forceinline__ long long cs_at(const SsdArgs& a, int bi, int ci,
                                           int hi) {
  return (((long long)bi * a.nchunks + ci) * a.h + hi) * a.chunk;
}
__device__ __forceinline__ long long state_at(const SsdArgs& a, int bi,
                                              int ci, int hi) {
  return (((long long)bi * a.nchunks + ci) * a.h + hi) * a.p * a.n;
}
__device__ __forceinline__ long long cb_at(const SsdArgs& a, int bi,
                                           int ci) {
  return ((long long)bi * a.nchunks + ci) * a.chunk * a.chunk;
}

// A float64 sum kept as a float32 pair: hi its rounding, lo the remainder.
__device__ __forceinline__ float2 split(double v) {
  const float hi = (float)v;
  return make_float2(hi, (float)(v - (double)hi));
}

// exp(a - b) of two such pairs, a <= b: the his' difference is exact where
// they are within a factor of two of each other (so wherever the decay is
// not small), and the los' difference corrects it to first order.
__device__ __forceinline__ float exp_diff(float2 a, float2 b) {
  const float e = expf(a.x - b.x);
  return fmaf(e, a.y - b.y, e);
}

// acc[i][j] += sum over kK depths of As[k][ty*4 + i] * Bs[k][tx*4 + j], the
// stage summed on its own first: a sum of K terms carries about kK + K/kK
// roundings in place of K.
__device__ __forceinline__ void stage_gemm(float (&acc)[4][4],
                                           const float* As, const float* Bs,
                                           int ty, int tx) {
  float part[4][4] = {};
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    const float4 a4 = ld4(&As[k * kPad + ty * 4]);
    const float4 b4 = ld4(&Bs[k * kPad + tx * 4]);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
}

// Shared memory of ssd_chunk_state, in floats: the cumulative sums and the
// warps' totals (float64), the rows' weights, then x (kK x kP) and B (kK x
// kN).
constexpr int kStateHead = 2 * kMaxChunk + 16 + kMaxChunk;
constexpr int kStateSmem = kStateHead + kK * kP + kK * kN;

// C · B^T on one 64 x 64 tile (I, J), J <= I, of chunk ci: K = n in steps
// of kK, C and B staged transposed, 4 x 4 outputs a thread, summed in
// float64 (1/64 of the scan's flops) and rounded once.
template <typename TB>
__device__ void cb_tile(const SsdArgs& a, int q, int bi, int ci,
                        const TB* __restrict__ Bm, const TB* __restrict__ Cm,
                        float* __restrict__ cb, float* sm) {
  int I = 0;
  while (q >= I + 1) {
    q -= I + 1;
    ++I;
  }
  const int J = q;
  const int rows = chunk_rows(a, ci);
  const int i0 = I * kRows, j0 = J * kRows;
  if (i0 >= rows) return;
  float* Ct = sm;               // Ct[k][i] = C[i0 + i][k0 + k]
  float* Bt = sm + kK * kPad;   // Bt[k][j] = B[j0 + j][k0 + k]
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const long long row0 = (long long)ci * a.chunk;
  double acc[4][4] = {};
  for (int k0 = 0; k0 < a.n; k0 += kK) {
    for (int e = t; e < kRows * kK; e += kThreads) {
      const int r = e / kK, k = e % kK;
      float cv = 0.f, bv = 0.f;
      if (k0 + k < a.n) {
        if (i0 + r < rows)
          cv = ld(Cm, bi * a.c_sb + (row0 + i0 + r) * a.c_ss + k0 + k);
        if (j0 + r < rows)
          bv = ld(Bm, bi * a.b_sb + (row0 + j0 + r) * a.b_ss + k0 + k);
      }
      Ct[k * kPad + r] = cv;
      Bt[k * kPad + r] = bv;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      const float4 c4 = ld4(&Ct[k * kPad + ty * 4]);
      const float4 b4 = ld4(&Bt[k * kPad + tx * 4]);
      const double cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const double bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(cv[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + cb_at(a, bi, ci);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
    if (gi >= a.chunk) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      if (gj < a.chunk) out[(long long)gi * a.chunk + gj] = (float)acc[i][j];
    }
  }
}

// Launch 1. blockIdx (x, chunk, batch): x below h * ptiles * ntiles is a
// state block (head, p tile, n tile), above it a C · B^T tile.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_state(const SsdArgs a, const TX* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ A, const TB* __restrict__ Bm,
                    const TB* __restrict__ Cm, float2* __restrict__ cs_out,
                    float* __restrict__ st, float* __restrict__ cb) {
  __shared__ __align__(16) float sm[kStateSmem];
  const int ci = blockIdx.y, bi = blockIdx.z;
  const int ptiles = (a.p + kP - 1) / kP, ntiles = (a.n + kN - 1) / kN;
  const int nstate = a.h * ptiles * ntiles;
  if ((int)blockIdx.x >= nstate) {
    cb_tile<TB>(a, blockIdx.x - nstate, bi, ci, Bm, Cm, cb, sm);
    return;
  }
  const int hi = blockIdx.x / (ptiles * ntiles);
  const int rem = blockIdx.x % (ptiles * ntiles);
  const int p0 = (rem / ntiles) * kP, n0 = (rem % ntiles) * kN;
  const int L = a.chunk, rows = chunk_rows(a, ci);
  const long long row0 = (long long)ci * L;
  double* cs_s = reinterpret_cast<double*>(sm);
  double* warp_tot = reinterpret_cast<double*>(sm + 2 * kMaxChunk);
  float* w_s = sm + 2 * kMaxChunk + 16;
  float* Xs = sm + kStateHead;   // Xs[k][p] = w_k x[k][p0 + p]
  float* Bs = Xs + kK * kP;      // Bs[k][n] = B[k][n0 + n]
  const int t = threadIdx.x;

  // the chunk's cumulative dt * A (each product rounded to float32, as the
  // plain version's, then summed in float64); missing rows add 0
  float dtv = 0.f, d = 0.f;
  if (t < rows) {
    dtv = dt[bi * a.dt_sb + (row0 + t) * a.dt_ss + hi];
    d = dtv * A[hi];
  }
  const double c = block_scan((double)d, warp_tot);
  cs_s[t] = c;
  if (p0 == 0 && n0 == 0 && t < L) cs_out[cs_at(a, bi, ci, hi) + t] = split(c);
  __syncthreads();
  // each row's weight in the state: dt_j exp(cs_last - cs_j)
  w_s[t] = t < rows ? dtv * expf((float)(cs_s[L - 1] - c)) : 0.f;

  // K = the chunk's rows in stages of kK, each stage's x and B loaded into
  // registers while the stage before it is computed
  const int ty = t >> 4, tx = t & 15;
  float acc[4][8] = {};
  float xr[kK * kP / kThreads], br[kK * kN / kThreads];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kK * kP / kThreads; ++q) {
      const int e = t + q * kThreads, k = e / kP, pp = e % kP, r = k0 + k;
      xr[q] = r < rows && p0 + pp < a.p
                  ? ld(x, bi * a.x_sb + (row0 + r) * a.x_ss +
                              (long long)hi * a.p + p0 + pp)
                  : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kK * kN / kThreads; ++q) {
      const int e = t + q * kThreads, k = e / kN, nn = e % kN, r = k0 + k;
      br[q] = r < rows && n0 + nn < a.n
                  ? ld(Bm, bi * a.b_sb + (row0 + r) * a.b_ss + n0 + nn)
                  : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < rows; k0 += kK) {
    __syncthreads();   // the weights written; the stage before computed
#pragma unroll
    for (int q = 0; q < kK * kP / kThreads; ++q) {
      const int e = t + q * kThreads, k = e / kP;
      Xs[e] = xr[q] * w_s[k0 + k];
    }
#pragma unroll
    for (int q = 0; q < kK * kN / kThreads; ++q) Bs[t + q * kThreads] = br[q];
    __syncthreads();
    if (k0 + kK < rows) load(k0 + kK);
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      const float4 x4 = ld4(&Xs[k * kP + ty * 4]);
      const float4 b0 = ld4(&Bs[k * kN + tx * 4]);
      const float4 b1 = ld4(&Bs[k * kN + 64 + tx * 4]);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }
  float* out = st + state_at(a, bi, ci, hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pp = p0 + ty * 4 + i;
    if (pp >= a.p) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (nn < a.n) out[(long long)pp * a.n + nn] = acc[i][j];
    }
  }
}

// Launch 2. blockIdx (element block, head, batch): each thread carries one
// element of a head's state over the chunks, replacing each chunk's state
// by the state before it, and writes the final state. Eight chunks' loads
// are issued before their stores.
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass(const SsdArgs a, const float2* __restrict__ cs,
                   float* __restrict__ st, const float* __restrict__ init,
                   float* __restrict__ final_state) {
  const int pn = a.p * a.n;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= pn) return;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const long long at = ((long long)bi * a.h + hi) * pn + e;
  float carry = a.has_init ? init[at] : 0.f;
  constexpr int U = 8;
  for (int c0 = 0; c0 < a.nchunks; c0 += U) {
    float sv[U], dv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < a.nchunks) {
        sv[u] = st[state_at(a, bi, c0 + u, hi) + e];
        dv[u] = exp_diff(cs[cs_at(a, bi, c0 + u, hi) + a.chunk - 1],
                         make_float2(0.f, 0.f));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < a.nchunks) {
        st[state_at(a, bi, c0 + u, hi) + e] = carry;
        carry = fmaf(carry, dv[u], sv[u]);
      }
    }
  }
  final_state[at] = carry;
}

// Shared memory of ssd_chunk_scan, in floats: the chunk's cumulative sums
// (pairs), dt, q_j dt_j for the rows before the tile, r_i for its rows, then
// a stage's two operands (kK x kPad each, both laid out k-major).
constexpr int kScanHead = 3 * kMaxChunk + kMaxChunk + kRows;
constexpr int kScanSmem = kScanHead + 2 * kK * kPad;

// Launch 3. blockIdx (tile, chunk, batch), the tile ((head, p tile), 64-row
// tile I of i). Stages of kK depth: ceil(n / kK) of C . (exp(cs_i0) S_prev),
// i0 / kK of the rows before the tile, then the diagonal tile's.
template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_scan(const SsdArgs a, const TX* __restrict__ x,
                   const float* __restrict__ dt, const TB* __restrict__ Cm,
                   const float* __restrict__ D, const float2* __restrict__ cs,
                   const float* __restrict__ st,
                   const float* __restrict__ cb, TX* __restrict__ y) {
  __shared__ __align__(16) float sm[kScanSmem];
  const int L = a.chunk;
  const int T = (L + kRows - 1) / kRows;
  const int ptiles = (a.p + kP - 1) / kP;
  const int I = blockIdx.x % T, rest = blockIdx.x / T;
  const int p0 = (rest % ptiles) * kP, hi = rest / ptiles;
  const int ci = blockIdx.y, bi = blockIdx.z;
  const int rows = chunk_rows(a, ci);
  const int i0 = I * kRows;
  if (i0 >= rows) return;
  const long long row0 = (long long)ci * L;
  float2* cs_s = reinterpret_cast<float2*>(sm);
  float* dt_s = sm + 2 * kMaxChunk;
  float* qs = sm + 3 * kMaxChunk;          // q_j dt_j, j < i0
  float* rs = sm + 4 * kMaxChunk;          // r_i of the tile's rows
  float* As = sm + kScanHead;              // As[k][i]
  float* Bs = As + kK * kPad;              // Bs[k][p]
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;

  if (t < L) cs_s[t] = cs[cs_at(a, bi, ci, hi) + t];
  dt_s[t] = t < rows ? dt[bi * a.dt_sb + (row0 + t) * a.dt_ss + hi] : 0.f;
  __syncthreads();
  const float2 c0 = cs_s[i0];
  if (t < i0) qs[t] = exp_diff(c0, cs_s[t]) * dt_s[t];
  if (t < kRows) rs[t] = i0 + t < rows ? exp_diff(cs_s[i0 + t], c0) : 0.f;
  const float e0 = exp_diff(c0, make_float2(0.f, 0.f));   // exp(cs_i0)

  const float* prev = st + state_at(a, bi, ci, hi);
  const float* cbc = cb + cb_at(a, bi, ci);
  const int n_inter = (a.n + kK - 1) / kK, n_off = i0 / kK;
  const int n_diag = (min(rows - i0, kRows) + kK - 1) / kK;
  const int n_stage = n_inter + n_off + n_diag;
  constexpr int kQ = kRows * kK / kThreads;   // each operand's loads a stage
  float ar[kQ], br[kQ];
  // stage s's operands into registers: C (i, k) and S_prev (p, k), then CB
  // (i, j) and x (j, p) of the rows j0..j0 + kK - 1
  auto load = [&](int s) {
    if (s < n_inter) {
      const int k0 = s * kK;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int e = t + q * kThreads, r = e / kK, k = e % kK;
        ar[q] = i0 + r < rows && k0 + k < a.n
                    ? ld(Cm, bi * a.c_sb + (row0 + i0 + r) * a.c_ss + k0 + k)
                    : 0.f;
        br[q] = p0 + r < a.p && k0 + k < a.n
                    ? prev[(long long)(p0 + r) * a.n + k0 + k]
                    : 0.f;
      }
    } else {
      const int j0 = (s - n_inter) * kK;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int e = t + q * kThreads;
        const int i = e / kK, j = e % kK, jr = e / kP, pp = e % kP;
        ar[q] = i0 + i < rows && j0 + j < rows
                    ? cbc[(long long)(i0 + i) * L + j0 + j]
                    : 0.f;
        br[q] = j0 + jr < rows && p0 + pp < a.p
                    ? ld(x, bi * a.x_sb + (row0 + j0 + jr) * a.x_ss +
                                (long long)hi * a.p + p0 + pp)
                    : 0.f;
      }
    }
  };
  // ... and into shared memory, the decays applied
  auto store = [&](int s) {
    if (s < n_inter) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int e = t + q * kThreads, r = e / kK, k = e % kK;
        As[k * kPad + r] = ar[q];
        Bs[k * kPad + r] = br[q] * e0;
      }
    } else {
      const int j0 = (s - n_inter) * kK;
      const bool diag = j0 >= i0;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int e = t + q * kThreads;
        const int i = e / kK, j = e % kK, jr = e / kP, pp = e % kP;
        const int gi = i0 + i, gj = j0 + j;
        float av = ar[q], bv = br[q];
        if (diag) {
          av = gj <= gi && gi < rows
                   ? av * exp_diff(cs_s[gi], cs_s[gj]) * dt_s[gj]
                   : 0.f;
        } else {
          bv *= qs[j0 + jr];
        }
        As[j * kPad + i] = av;
        Bs[jr * kPad + pp] = bv;
      }
    }
  };

  float acc[4][4] = {};
  load(0);
  for (int s = 0; s < n_stage; ++s) {
    __syncthreads();   // the prologue's factors written; stage s-1 computed
    store(s);
    __syncthreads();
    if (s + 1 < n_stage) load(s + 1);
    stage_gemm(acc, As, Bs, ty, tx);
    if (s == n_inter + n_off - 1) {   // every row before the tile: r_i
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= rs[ty * 4 + i];
    }
  }

  // D x_i, and y in x's dtype
  const float Dh = D[hi];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
    if (gi >= rows) continue;
    const long long xrow = bi * a.x_sb + (row0 + gi) * a.x_ss +
                           (long long)hi * a.p;
    const long long yrow = (((long long)bi * a.s + row0 + gi) * a.h + hi) *
                           a.p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = p0 + tx * 4 + j;
      if (pp < a.p) st_out(y, yrow + pp, acc[i][j] + Dh * ld(x, xrow + pp));
    }
  }
}

template <typename TX, typename TB>
int run(const SsdArgs& a, const void* x, const float* dt, const float* A,
        const void* B, const void* C, const float* D, const float* init,
        void* y, float* final_state, float* scratch, cudaStream_t s) {
  const int T = (a.chunk + kRows - 1) / kRows;
  const int ptiles = (a.p + kP - 1) / kP, ntiles = (a.n + kN - 1) / kN;
  float2* cs = reinterpret_cast<float2*>(scratch);
  float* st = scratch + 2LL * a.b * a.nchunks * a.h * a.chunk;
  float* cb = st + (long long)a.b * a.nchunks * a.h * a.p * a.n;
  const TX* xt = static_cast<const TX*>(x);
  const TB* Bt = static_cast<const TB*>(B);
  const TB* Ct = static_cast<const TB*>(C);
  ssd_chunk_state<TX, TB><<<dim3((unsigned)(a.h * ptiles * ntiles +
                                            T * (T + 1) / 2),
                                 (unsigned)a.nchunks, (unsigned)a.b),
                            kThreads, 0, s>>>(a, xt, dt, A, Bt, Ct, cs, st,
                                              cb);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_state_pass<<<dim3((unsigned)((a.p * a.n + kThreads - 1) / kThreads),
                        (unsigned)a.h, (unsigned)a.b),
                   kThreads, 0, s>>>(a, cs, st, init, final_state);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ssd_chunk_scan<TX, TB><<<dim3((unsigned)(T * ptiles * a.h),
                                (unsigned)a.nchunks, (unsigned)a.b),
                           kThreads, 0, s>>>(a, xt, dt, Ct, D, cs, st, cb,
                                             static_cast<TX*>(y));
  return (int)cudaGetLastError();
}

}  // namespace

// The scratch: b * nchunks * (2 * h * chunk + h * p * n + chunk * chunk)
// float32 elements (kernels/ssd_scan.py::scratch_elements), 8-byte aligned.
// init may be null (has_init 0). Launches the three kernels on `stream` and
// returns the first error cudaGetLastError() reports, so a refused launch
// reaches the caller; cudaErrorInvalidValue, launching nothing, for a chunk
// outside 1..256.
extern "C" int matpim_ssd_scan(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, const void* D,
                               const void* init, void* y, void* final_state,
                               void* scratch, const SsdArgs* args,
                               void* stream) {
  const SsdArgs& a = *args;
  if (a.chunk < 1 || a.chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* in = static_cast<const float*>(init);
  float* fs = static_cast<float*>(final_state);
  float* sc = static_cast<float*>(scratch);
  if (a.x_bf16 && a.bc_bf16)
    return run<__nv_bfloat16, __nv_bfloat16>(a, x, dtf, Af, B, C, Df, in, y,
                                             fs, sc, s);
  if (a.x_bf16)
    return run<__nv_bfloat16, float>(a, x, dtf, Af, B, C, Df, in, y, fs, sc,
                                     s);
  if (a.bc_bf16)
    return run<float, __nv_bfloat16>(a, x, dtf, Af, B, C, Df, in, y, fs, sc,
                                     s);
  return run<float, float>(a, x, dtf, Af, B, C, Df, in, y, fs, sc, s);
}
