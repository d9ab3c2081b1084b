// Shift-and-add 2D convolutions for Hopper (sm_90a): valid cross-correlation
// (no flip, MatPIM Algorithm 1) with f32 accumulation, whole image and
// output-tiled, and the channel-packed binary (XNOR-popcount) conv. Built
// with nvcc into a plain C library and loaded with ctypes by
// repro_torch/kernels/conv2d_shift.py, which holds the plain PyTorch version
// of each function.
//
// Replaces the three TPU kernels of src/repro/kernels/conv2d_shift.py:
//   conv2d_shift        (_conv_kernel under pl.pallas_call)
//   conv2d_shift_tiled  (_conv_tiled_kernel)
//   binary_conv2d       (_binary_conv_kernel)
//
// Translation. The TPU kernels hold the whole image (or a halo tile) in
// VMEM and run the k*k taps as statically shifted slices, so no im2col
// buffer is ever built. Here each thread owns one output element and loops
// over the taps itself: the shift is address arithmetic, as on the TPU, and
// neighbouring threads read neighbouring pixels, so each tap's loads are
// coalesced and the k*k re-reads of a pixel hit L1/L2, not device memory.
// The tiled variant keeps the TPU kernel's halo tile: one thread block per
// bh x bw output tile stages its (bh+kh-1) x (bw+kw-1) input tile (as f32)
// and the taps in shared memory, so every pixel is read from device memory
// once per tile. At the default 128 x 128 tile with k = 3 that is
// 130 * 130 * 4 B = 67.6 KB, above the 48 KB default of dynamic shared
// memory, so the launch opts in to more (the H100 allows 227 KB a block).
// A batch axis (images, and one kernel per image or one shared) lets one
// launch serve every crossbar tile of a served bucket.
//
// What bounds them. The served conv calls conv2d_shift with B = 126 images
// of 64 x 8 float32 pixels and k = 3: it reads about 258 KB, writes about
// 190 KB and does about 0.8 M flops, so device memory bounds it (about
// 0.13 us at 3.35 TB/s) and in practice the launch itself dominates.
// binary_conv2d does 3 integer ops (xor, popc, add) per word per tap and
// reuses each input word k*k times, so at wide C its integer issue rate, not
// memory, is the bound. Register tiling of several outputs per thread (to
// reuse loaded pixels across taps) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
// dynamic shared memory a block may use on the H100 (227 KB); the wrapper
// rejects larger tiles before launch
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a: (batch, H, W); k: (batch or 1, kh, kw) with k_stride kh*kw or 0;
// out: (batch, OH, OW) float32
template <typename TA, typename TK>
__global__ void conv2d_shift_kernel(const TA* __restrict__ a,
                                    const TK* __restrict__ k,
                                    float* __restrict__ out, int H, int W,
                                    int kh, int kw, long long k_stride) {
  const int OH = H - kh + 1, OW = W - kw + 1;
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= (long long)OH * OW) return;
  const long long batch = blockIdx.y;
  const int oy = (int)(o / OW), ox = (int)(o - (long long)oy * OW);
  const TA* img = a + batch * H * W;
  const TK* taps = k + batch * k_stride;
  float acc = 0.f;
  for (int v = 0; v < kh; ++v) {
    const TA* src = img + (long long)(oy + v) * W + ox;
    for (int h = 0; h < kw; ++h)
      acc += to_f32(src[h]) * to_f32(taps[v * kw + h]);
  }
  out[batch * OH * OW + o] = acc;
}

// one block per bh x bw output tile: grid (OW/bw, OH/bh, batch); the halo
// input tile and the taps live in dynamic shared memory as f32
template <typename TA, typename TK>
__global__ void conv2d_shift_tiled_kernel(const TA* __restrict__ a,
                                          const TK* __restrict__ k,
                                          float* __restrict__ out, int H,
                                          int W, int kh, int kw,
                                          long long k_stride, int bh,
                                          int bw) {
  extern __shared__ float smem[];
  const int th = bh + kh - 1, tw = bw + kw - 1;
  float* tile = smem;
  float* taps = smem + th * tw;
  const int OH = H - kh + 1, OW = W - kw + 1;
  const long long batch = blockIdx.z;
  const int y0 = blockIdx.y * bh, x0 = blockIdx.x * bw;
  const TA* img = a + batch * H * W;
  for (int i = threadIdx.x; i < th * tw; i += blockDim.x) {
    const int r = i / tw, c = i - r * tw;
    tile[i] = to_f32(img[(long long)(y0 + r) * W + x0 + c]);
  }
  for (int i = threadIdx.x; i < kh * kw; i += blockDim.x)
    taps[i] = to_f32(k[batch * k_stride + i]);
  __syncthreads();
  float* dst = out + batch * OH * OW;
  for (int i = threadIdx.x; i < bh * bw; i += blockDim.x) {
    const int oy = i / bw, ox = i - oy * bw;
    float acc = 0.f;
    for (int v = 0; v < kh; ++v) {
      const float* src = tile + (oy + v) * tw + ox;
      for (int h = 0; h < kw; ++h) acc += src[h] * taps[v * kw + h];
    }
    dst[(long long)(y0 + oy) * OW + x0 + ox] = acc;
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

template <typename TA, typename TK>
void launch_conv(const void* a, const void* k, void* out, int batch, int H,
                 int W, int kh, int kw, long long k_stride,
                 cudaStream_t stream) {
  const long long n = (long long)(H - kh + 1) * (W - kw + 1);
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)batch);
  conv2d_shift_kernel<TA, TK><<<grid, kThreads, 0, stream>>>(
      (const TA*)a, (const TK*)k, (float*)out, H, W, kh, kw, k_stride);
}

template <typename TA, typename TK>
int launch_tiled(const void* a, const void* k, void* out, int batch, int H,
                 int W, int kh, int kw, long long k_stride, int bh, int bw,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(bh + kh - 1) * (bw + kw - 1) + kh * kw);
  if (smem > 48 * 1024) {
    // opt in once per card to the most a block may use, so later launches
    // (and launches captured into a CUDA graph) make no attribute call
    static bool opted[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
      e = cudaFuncSetAttribute(conv2d_shift_tiled_kernel<TA, TK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
      if (e != cudaSuccess) return (int)e;
      opted[dev] = true;
    }
  }
  dim3 grid((unsigned)((W - kw + 1) / bw), (unsigned)((H - kh + 1) / bh),
            (unsigned)batch);
  conv2d_shift_tiled_kernel<TA, TK><<<grid, kThreads, smem, stream>>>(
      (const TA*)a, (const TK*)k, (float*)out, H, W, kh, kw, k_stride, bh,
      bw);
  return 0;
}

}  // namespace

// a: (batch, H, W), k: (batch, kh, kw) when k_batched else (kh, kw), out:
// (batch, H-kh+1, W-kw+1) float32, all contiguous on the device; a_bf16 /
// k_bf16 pick bfloat16 (1) or float32 (0) for each operand. Launches on
// `stream` and returns cudaGetLastError() so a refused launch reaches the
// caller.
extern "C" int matpim_conv2d_shift(const void* a, const void* k, void* out,
                                   int batch, int H, int W, int kh, int kw,
                                   int k_batched, int a_bf16, int k_bf16,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long ks = k_batched ? (long long)kh * kw : 0;
  if (a_bf16 && k_bf16)
    launch_conv<__nv_bfloat16, __nv_bfloat16>(a, k, out, batch, H, W, kh,
                                              kw, ks, s);
  else if (a_bf16)
    launch_conv<__nv_bfloat16, float>(a, k, out, batch, H, W, kh, kw, ks, s);
  else if (k_bf16)
    launch_conv<float, __nv_bfloat16>(a, k, out, batch, H, W, kh, kw, ks, s);
  else
    launch_conv<float, float>(a, k, out, batch, H, W, kh, kw, ks, s);
  return (int)cudaGetLastError();
}

// As matpim_conv2d_shift, with the output tiled bh x bw; the caller
// guarantees that bh divides H-kh+1 and bw divides W-kw+1.
extern "C" int matpim_conv2d_shift_tiled(const void* a, const void* k,
                                         void* out, int batch, int H, int W,
                                         int kh, int kw, int k_batched,
                                         int a_bf16, int k_bf16, int bh,
                                         int bw, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long ks = k_batched ? (long long)kh * kw : 0;
  int err;
  if (a_bf16 && k_bf16)
    err = launch_tiled<__nv_bfloat16, __nv_bfloat16>(a, k, out, batch, H, W,
                                                     kh, kw, ks, bh, bw, s);
  else if (a_bf16)
    err = launch_tiled<__nv_bfloat16, float>(a, k, out, batch, H, W, kh, kw,
                                             ks, bh, bw, s);
  else if (k_bf16)
    err = launch_tiled<float, __nv_bfloat16>(a, k, out, batch, H, W, kh, kw,
                                             ks, bh, bw, s);
  else
    err = launch_tiled<float, float>(a, k, out, batch, H, W, kh, kw, ks, bh,
                                     bw, s);
  if (err != 0) return err;
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
