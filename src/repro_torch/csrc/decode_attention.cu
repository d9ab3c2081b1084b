// Decode attention for Hopper (sm_90a): one query row of every batch slot
// against the valid rows of that slot's KV cache. q (B, 1, H, hd) in float32
// or bfloat16; k, v (B, S, KV, hd) in float32 or bfloat16 (both the same);
// pos (B,) int64; out (B, 1, H, hd) in q's dtype. Built with nvcc into a
// plain C library and loaded with ctypes by
// repro_torch/kernels/decode_attention.py, which holds the plain PyTorch
// version of the same function and chooses every launch's split
// (decode_launch_plan).
//
// Replaces no TPU kernel: the reference decodes through XLA's fused einsums
// over the whole cache (src/repro/models/layers.py, attention_decode and
// _sdpa), and the reference's model stack reaches no Pallas kernel. Added
// because eager PyTorch cannot do what XLA's fusion did: the port's _sdpa
// widened each layer's whole cache to float32 and laid it out again for
// two einsums, several times the bytes the step needs, at every step.
//
// The arithmetic is the reference's: head h of slot b takes the rows s <=
// pos[b] (rows past pos are never read: the reference masks them to -1e30,
// which gives them weight 0 exactly), float32 logits q . k_s divided by
// sqrt(hd), a float32 softmax over them and the float32 weighted sum of the
// v_s, cast to q's dtype. bf16 products are exact in float32, so only the
// order of the sums differs from the reference.
//
// What bounds it. A decode step reads each valid cache row once and does 2
// FMAs per element of it for each query head that shares it: at the chat
// shape (32 slots, 16 KV heads of 128, about 720 valid rows a slot, bf16)
// that is 189 MB a layer for 47 MFLOP, so device memory bounds it (56 us at
// 3.35 TB/s). The design reads every row once, in 16-byte loads:
//
// Split-K flash decoding. One CTA per (chunk of rows, KV head and group of
// up to RB of its query heads, slot) reads each of its rows once for all
// the query heads of the group (rep = H / KV of them, RB a power of two up
// to 8 covering rep, or several groups where rep > 8). A row of hd elements
// is `nvec` 16-byte vectors; `lanes` threads (a power of two) hold one
// vector each (two for float32 rows of more than 128), so a warp takes 32 /
// lanes rows at once and U such rows per step, all loads of a step in
// flight before any use. The lanes of a row sum their dot products by
// shuffles; each warp keeps an online softmax (running maximum, sum and
// float32 accumulator over v) shared by its rows, and the CTA's warps merge
// theirs in shared memory. A chunk that starts past pos[b] writes a neutral
// partial (maximum -inf, sum 0) and exits: pos is read on the device, so the
// host never waits for it. With more than one chunk, a second short kernel
// merges each head's chunks as spmd.softmax merges the ranks' blocks of a
// split axis: the global maximum, the partial sums and accumulators scaled
// by exp(m_c - M), one division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The variant this library holds, given on nvcc's command line by
// kernels/decode_attention.py::variant: the cache's element type
// (__nv_bfloat16 or float), the query heads a CTA takes (RB: 1, 2, 4 or 8)
// and the 16-byte vectors of a row a lane holds (VPL: 1, or 2 for float32
// rows of more than 128). One kernel pair a build keeps nvcc's time at the
// first decode step short.
#if !defined(DECODE_TC) || !defined(DECODE_RB) || !defined(DECODE_VPL)
#error "build with -DDECODE_TC=... -DDECODE_RB=... -DDECODE_VPL=..."
#endif

// Launch parameters, computed and cached by the Python wrapper
// (kernels/decode_attention.py::_Args, same field order).
struct DecodeArgs {
  int B, H, KV, S, hd;  // q (B, 1, H, hd); k, v (B, S, KV, hd)
  int rep;              // H / KV query heads a KV head serves
  int rb;               // query heads a CTA takes (1, 2, 4 or 8)
  int groups;           // CTAs a KV head's heads take: ceil(rep / rb)
  int lanes;            // threads a row (a power of two, at most 32)
  int nvec;             // 16-byte vectors a row
  int chunks;           // CTAs a slot's rows are split over
  int chunk_rows;       // rows a chunk
  int c_bf16, q_bf16;   // cache and q dtypes: bfloat16 or float32
  float scale;          // the logits are divided by it: sqrt(hd), or the
                        // inverse of the model's attention multiplier
};

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHd = 256;
constexpr unsigned kFull = 0xffffffffu;

// Elements of a cache dtype in one 16-byte vector.
template <typename TC>
struct Vec {
  static constexpr int n = 16 / (int)sizeof(TC);
};

// One 16-byte vector of cache elements as float32 (widening bf16 is exact;
// two a word, the low half first).
template <typename TC>
__device__ __forceinline__ void unpack(const uint4 u,
                                       float (&f)[Vec<TC>::n]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(TC) == 2) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      f[i] = __uint_as_float(w[i]);
    }
  }
}

__device__ __forceinline__ float load_q(const void* q, long long i,
                                        int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}

__device__ __forceinline__ void store_out(void* out, long long i, float x,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(out)[i] = x;
}

// The scratch of a multi-chunk launch: for each (slot, KV head group,
// chunk) and each of its rb heads, hd accumulator floats; after all of
// them, the (maximum, sum) pairs in the same order.
__device__ __forceinline__ float* partial_ml(float* part, const DecodeArgs& p) {
  return part + (long long)p.B * p.KV * p.groups * p.chunks * p.rb * p.hd;
}

// CTA (chunk, KV head * groups + head group, slot). Thread (warp, lane):
// lane group g = lane / lanes takes row g of the warp's 32 / lanes rows of
// a step, and lane sub = lane % lanes of it the vectors sub + j * lanes.
template <typename TC, int RB, int VPL>
__global__ void __launch_bounds__(kThreads)
    decode_split(const void* __restrict__ q, const TC* __restrict__ k,
                 const TC* __restrict__ v, const long long* __restrict__ pos,
                 void* __restrict__ out, float* __restrict__ part,
                 const DecodeArgs p) {
  constexpr int VEC = Vec<TC>::n;
  // rows a lane group has in flight a step: fewer where many heads hold
  // their accumulators in registers
  constexpr int U = RB == 1 ? 4 : RB == 2 ? 2 : 1;
  __shared__ float sm_acc[kWarps][RB][kMaxHd];
  __shared__ float sm_m[kWarps][RB], sm_l[kWarps][RB];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int T = p.lanes, RW = 32 / T;
  const int g = lane / T, sub = lane - g * T;
  const int hd = p.hd, chunk = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.groups;
  const int h0 = (blockIdx.y - kvh * p.groups) * RB;
  const long long slot =
      ((long long)b * gridDim.y + blockIdx.y) * p.chunks + chunk;
  const int end = (int)min((long long)p.S, pos[b] + 1);
  const int r0 = chunk * p.chunk_rows;
  const int r1 = min(r0 + p.chunk_rows, end);

  if (r0 >= r1 && p.chunks > 1) {  // past pos: a neutral partial
    for (int i = threadIdx.x; i < RB * hd; i += kThreads)
      part[slot * RB * hd + i] = 0.f;
    if (threadIdx.x < RB) {
      float* ml = partial_ml(part, p) + (slot * RB + threadIdx.x) * 2;
      ml[0] = -INFINITY;
      ml[1] = 0.f;
    }
    return;
  }

  float qv[RB][VPL][VEC];
#pragma unroll
  for (int h = 0; h < RB; ++h) {
    const long long qrow =
        ((long long)b * p.H + kvh * p.rep + h0 + h) * hd;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = sub + j * T;
      const bool ok = h0 + h < p.rep && c < p.nvec;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qv[h][j][e] = ok ? load_q(q, qrow + c * VEC + e, p.q_bf16) : 0.f;
    }
  }

  float m[RB], l[RB], acc[RB][VPL][VEC];
#pragma unroll
  for (int h = 0; h < RB; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[h][j][e] = 0.f;
  }

  const long long rs = (long long)p.KV * hd;  // elements between rows
  const TC* kb = k + (long long)b * p.S * rs + kvh * hd;
  const TC* vb = v + (long long)b * p.S * rs + kvh * hd;
  const int step = kWarps * RW * U;
  for (int base = r0; base < r1; base += step) {
    uint4 kr[U][VPL], vr[U][VPL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + (u * kWarps + warp) * RW + g;
      ok[u] = r < r1;
      const uint4* kp = reinterpret_cast<const uint4*>(kb + r * rs);
      const uint4* vp = reinterpret_cast<const uint4*>(vb + r * rs);
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int c = sub + j * T;
        const bool live = ok[u] && c < p.nvec;
        kr[u][j] = live ? __ldg(kp + c) : make_uint4(0u, 0u, 0u, 0u);
        vr[u][j] = live ? __ldg(vp + c) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // the logits of the step's rows, whole on each lane of a row
    float s[U][RB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VPL][VEC];
#pragma unroll
      for (int j = 0; j < VPL; ++j) unpack<TC>(kr[u][j], kf[j]);
#pragma unroll
      for (int h = 0; h < RB; ++h) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < VPL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qv[h][j][e], kf[j][e], d);
        for (int o = T >> 1; o > 0; o >>= 1)
          d += __shfl_xor_sync(kFull, d, o);
        s[u][h] = ok[u] ? d / p.scale : -INFINITY;
      }
    }
    // the warp's running maximum, and each row's weight under it
    float w[U][RB];
#pragma unroll
    for (int h = 0; h < RB; ++h) {
      float mx = s[0][h];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][h]);
      for (int o = T; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float mn = fmaxf(m[h], mx);
      // a warp with no row yet keeps its zeros
      const float sc = mn == -INFINITY ? 1.f : expf(m[h] - mn);
      m[h] = mn;
      l[h] *= sc;
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][j][e] *= sc;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        w[u][h] = ok[u] ? expf(s[u][h] - mn) : 0.f;
        l[h] += w[u][h];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VPL][VEC];
#pragma unroll
      for (int j = 0; j < VPL; ++j) unpack<TC>(vr[u][j], vf[j]);
#pragma unroll
      for (int h = 0; h < RB; ++h)
#pragma unroll
        for (int j = 0; j < VPL; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[h][j][e] = fmaf(w[u][h], vf[j][e], acc[h][j][e]);
    }
  }

  // the warp's row groups share its maximum: add their sums and
  // accumulators, then the warps meet in shared memory
#pragma unroll
  for (int h = 0; h < RB; ++h) {
    for (int o = T; o < 32; o <<= 1) {
      l[h] += __shfl_xor_sync(kFull, l[h], o);
#pragma unroll
      for (int j = 0; j < VPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[h][j][e] += __shfl_xor_sync(kFull, acc[h][j][e], o);
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int c = sub + j * T;
        if (c < p.nvec)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sm_acc[warp][h][c * VEC + e] = acc[h][j][e];
      }
    }
    if (lane == 0) {
      sm_m[warp][h] = m[h];
      sm_l[warp][h] = l[h];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < RB * hd; i += kThreads) {
    const int h = i / hd, d = i - h * hd;
    if (h0 + h >= p.rep) break;  // i only grows: every later head is out too
    float M = -INFINITY;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) M = fmaxf(M, sm_m[wi][h]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      const float mw = sm_m[wi][h];
      if (mw == -INFINITY) continue;  // a warp that had no row
      const float f = expf(mw - M);
      L = fmaf(f, sm_l[wi][h], L);
      A = fmaf(f, sm_acc[wi][h][d], A);
    }
    if (p.chunks == 1) {
      store_out(out, ((long long)b * p.H + kvh * p.rep + h0 + h) * hd + d,
                A / L, p.q_bf16);
    } else {
      part[(slot * RB + h) * hd + d] = A;
      if (d == 0) {
        float* ml = partial_ml(part, p) + (slot * RB + h) * 2;
        ml[0] = M;
        ml[1] = L;
      }
    }
  }
}

// CTA (query head, slot), thread d: element d of the head's output from the
// partials of its chunks.
__global__ void __launch_bounds__(kMaxHd)
    decode_merge(const float* __restrict__ part, void* __restrict__ out,
                 const DecodeArgs p) {
  const int head = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int kvh = head / p.rep, r = head - kvh * p.rep;
  const int y = kvh * p.groups + r / p.rb, h = r % p.rb;
  const long long s0 = ((long long)b * p.KV * p.groups + y) * p.chunks;
  const float* ml = partial_ml(const_cast<float*>(part), p);
  float M = -INFINITY;
  for (int c = 0; c < p.chunks; ++c)
    M = fmaxf(M, ml[((s0 + c) * p.rb + h) * 2]);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < p.chunks; ++c) {
    const long long i = (s0 + c) * p.rb + h;
    const float mc = ml[i * 2];
    if (mc == -INFINITY) continue;  // a chunk past pos
    const float f = expf(mc - M);
    L = fmaf(f, ml[i * 2 + 1], L);
    A = fmaf(f, part[i * p.hd + d], A);
  }
  store_out(out, ((long long)b * p.H + head) * p.hd + d, A / L, p.q_bf16);
}

}  // namespace

// q (B, 1, H, hd), k and v (B, S, KV, hd), pos (B,) int64, out (B, 1, H,
// hd), all contiguous on the device, k and v 16-byte aligned; part: float32
// scratch of B * KV * groups * chunks * rb * (hd + 2) when chunks > 1, else
// unused. Launches this library's variant of decode_split on `stream`, and
// decode_merge after it when chunks > 1, and returns cudaGetLastError() so a
// refused launch reaches the caller; cudaErrorInvalidValue, launching
// nothing, for arguments another variant takes.
extern "C" int matpim_decode_attention(const void* q, const void* k,
                                       const void* v, const void* pos,
                                       void* out, void* part,
                                       const DecodeArgs* args, void* stream) {
  const DecodeArgs& p = *args;
  if (p.rb != DECODE_RB || p.c_bf16 != (int)(sizeof(DECODE_TC) == 2) ||
      p.lanes * DECODE_VPL < p.nvec)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* pt = static_cast<float*>(part);
  const dim3 grid((unsigned)p.chunks, (unsigned)(p.KV * p.groups),
                  (unsigned)p.B);
  decode_split<DECODE_TC, DECODE_RB, DECODE_VPL><<<grid, kThreads, 0, s>>>(
      q, static_cast<const DECODE_TC*>(k), static_cast<const DECODE_TC*>(v),
      static_cast<const long long*>(pos), out, pt, p);
  if (p.chunks > 1) {
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    decode_merge<<<dim3((unsigned)p.H, (unsigned)p.B), p.hd, 0, s>>>(pt, out,
                                                                      p);
  }
  return (int)cudaGetLastError();
}
