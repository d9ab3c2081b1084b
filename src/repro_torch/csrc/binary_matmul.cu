// XNOR-popcount GEMM for Hopper (sm_90a): the ±1 dot product of bit-packed
// operands, C[b, i, j] = K - 2 * popcount(A[b, i, :] ^ B[b, j, :]),
// K = 32 * Kw. Built with nvcc into a plain C library and loaded with ctypes
// by repro_torch/kernels/binary_matmul.py, which holds the plain PyTorch
// version of the same function.
//
// Replaces the TPU kernel binary_matmul in src/repro/kernels/binary_matmul.py
// (_binary_matmul_kernel under pl.pallas_call). Each batch entry computes
// exactly that kernel's function, for any (M, N, Kw): the kernel masks the
// ragged edge itself, so no block-divisibility constraint is left.
//
// Translation. The TPU runs a grid (M/bm, N/bn, Kw/bk) in order on one core
// and carries the mismatch count in the output block from one k-step to the
// next. Hopper runs blocks in parallel and in no order, so nothing carries
// between blocks: one warp owns one output element and reduces the whole
// K axis itself. Its lanes stride over the Kw words (__popc of the XOR), and
// a warp-shuffle tree sums the 32 lane counts. A leading batch axis on
// blockIdx.y lets one launch serve every crossbar tile of a bucket.
//
// What bounds it. The main path calls it with N = 1 (a matrix-vector
// product per tile), M = 1024 rows and Kw = 13 words (416 bits), B = 20
// tiles: it reads about 1.1 MB and does about 0.8 M integer operations, so
// device memory bounds it (about 0.34 us at 3.35 TB/s) and in practice the
// launch itself (a few microseconds) dominates. The design keeps each warp's
// reads contiguous (lanes read consecutive words of one row) and issues one
// launch per bucket, not one per tile. Making it faster (several rows per
// warp so no lane idles at Kw = 13, B held in shared memory for N > 1) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void binary_matmul_kernel(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     int32_t* __restrict__ c,
                                     int M, int N, int Kw) {
  const long long mn = (long long)M * N;
  const long long out = (long long)blockIdx.x * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  // every lane of a warp shares `out`, so a warp past the edge leaves whole
  // and the full-mask shuffles below stay well defined
  if (out >= mn) return;
  const int lane = threadIdx.x & 31;
  const long long batch = blockIdx.y;
  const long long i = out / N;
  const long long j = out - i * N;
  const uint32_t* arow = a + (batch * M + i) * Kw;
  const uint32_t* brow = b + (batch * N + j) * Kw;
  int mism = 0;
  for (int w = lane; w < Kw; w += 32) mism += __popc(arow[w] ^ brow[w]);
  for (int off = 16; off > 0; off >>= 1)
    mism += __shfl_down_sync(0xffffffffu, mism, off);
  if (lane == 0) c[batch * mn + out] = 32 * Kw - 2 * mism;
}

}  // namespace

// a: (batch, M, Kw) uint32, b: (batch, N, Kw) uint32, c: (batch, M, N)
// int32, all contiguous on the device; launches on `stream` and returns
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int matpim_binary_matmul(const void* a, const void* b, void* c,
                                    int batch, int M, int N, int Kw,
                                    void* stream) {
  const long long mn = (long long)M * N;
  const long long blocks = (mn + kWarpsPerBlock - 1) / kWarpsPerBlock;
  dim3 grid((unsigned)blocks, (unsigned)batch);
  binary_matmul_kernel<<<grid, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int32_t*)c, M, N, Kw);
  return (int)cudaGetLastError();
}
