// Matrix-vector product with f32 accumulation for Hopper (sm_90a):
// y[b, i] = sum_k A[b, i, k] * x[b, k], A and x in float32 or bfloat16 (each
// its own type), y float32. Built with nvcc into a plain C library and loaded
// with ctypes by repro_torch/kernels/splitk_matvec.py, which holds the plain
// PyTorch version of the same function.
//
// Replaces the TPU kernel splitk_matvec in src/repro/kernels/splitk_matvec.py
// (_splitk_kernel under pl.pallas_call). Each batch entry computes exactly
// that kernel's function, for any (M, K): the kernel masks the ragged edge
// itself, so the TPU's (256, 512) block divisibility is gone.
//
// Translation. The TPU runs a grid (M/bm, K/bk) in order on one core and
// carries each row's partial sum in the output block from one k-step to the
// next (MatPIM's split-K: block products summed in order). Hopper runs
// blocks in parallel and in no order, so nothing carries between blocks: one
// warp owns one output row and reduces the whole K axis itself. Its lanes
// stride over K with f32 accumulators, and a warp-shuffle tree sums the 32
// lane partials, the in-warp form of MatPIM's logarithmic reduction. A
// leading batch axis on blockIdx.y lets one launch serve every crossbar tile
// of a served bucket.
//
// What bounds it. The served path calls it with B = 27 tiles, M = 1024 rows,
// K = 39 (float32 holding 8-bit integers): it reads about 4.3 MB and does
// about 2.2 M flops, so device memory bounds it (about 1.3 us at 3.35 TB/s).
// At K = 39 only 7 of 32 lanes take a second element, so the warp idles
// most of the time; a warp per row is still the simple, coalesced layout
// (lanes read consecutive elements of one row). Several rows per warp for
// short K, and wide loads for long K, are later work. On integer inputs
// whose true sum stays below 2^24 the result is exact in any order; on
// float inputs it differs from the TPU's summation order in the last bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TA, typename TX>
__global__ void splitk_matvec_kernel(const TA* __restrict__ a,
                                     const TX* __restrict__ x,
                                     float* __restrict__ y, int M, int K) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  // every lane of a warp shares `row`, so a warp past the edge leaves whole
  // and the full-mask shuffles below stay well defined
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const long long batch = blockIdx.y;
  const TA* arow = a + (batch * M + row) * K;
  const TX* xb = x + batch * K;
  float acc = 0.f;
  for (int k = lane; k < K; k += 32) acc += to_f32(arow[k]) * to_f32(xb[k]);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[batch * M + row] = acc;
}

template <typename TA, typename TX>
void launch(const void* a, const void* x, void* y, int batch, int M, int K,
            cudaStream_t stream) {
  const long long blocks = ((long long)M + kWarpsPerBlock - 1) /
                           kWarpsPerBlock;
  dim3 grid((unsigned)blocks, (unsigned)batch);
  splitk_matvec_kernel<TA, TX><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      (const TA*)a, (const TX*)x, (float*)y, M, K);
}

}  // namespace

// a: (batch, M, K), x: (batch, K), y: (batch, M) float32, all contiguous on
// the device. a_bf16 / x_bf16 pick bfloat16 (1) or float32 (0) for each
// operand. Launches on `stream` and returns cudaGetLastError() so a refused
// launch reaches the caller.
extern "C" int matpim_splitk_matvec(const void* a, const void* x, void* y,
                                    int batch, int M, int K, int a_bf16,
                                    int x_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a_bf16 && x_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(a, x, y, batch, M, K, s);
  else if (a_bf16)
    launch<__nv_bfloat16, float>(a, x, y, batch, M, K, s);
  else if (x_bf16)
    launch<float, __nv_bfloat16>(a, x, y, batch, M, K, s);
  else
    launch<float, float>(a, x, y, batch, M, K, s);
  return (int)cudaGetLastError();
}
