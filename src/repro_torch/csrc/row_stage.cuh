// Staging a span of whole rows into shared memory, shared by the kernels
// that reduce short rows from shared memory (splitk_matvec.cu,
// binary_matmul.cu; conv2d_shift.cu uses its cp.async helpers). The host
// side of the plan is repro_torch/kernels/__init__.py::staged_rows.
//
// A CTA that owns R consecutive rows of K elements owns one contiguous span
// of R*K elements. Rows of 39 floats or 13 words start off 16 bytes, and a
// caller may pass a view at any element offset, so the span is copied in
// three parts: the head, elements up to the first 16-byte boundary, one by
// one; the body, 16-byte chunks by cp.async; the tail, the last elements
// past the final whole chunk, one by one. A span with no whole aligned
// chunk is all head and tail (the 4-byte path, 2-byte for bf16). Element i
// of the span lands at dst[mis + i], mis being the span's misalignment in
// elements (src % 16 / sizeof(T)), so every chunk lands on a 16-byte
// boundary of shared memory too; dst itself is 16-byte aligned. The
// vector a kernel reduces the rows against is staged the same way, raw.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace row_stage {

// cp.async of N bytes (4, 8 or 16) from global to shared memory.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The span's misalignment in elements: where element 0 lands in dst.
template <typename T>
__device__ __forceinline__ int misalignment(const T* src) {
  return (int)(((uintptr_t)src & 15) / sizeof(T));
}

// Copy the n elements at src into dst[mis..mis+n) with threads t of
// nthreads; returns mis. 4-byte elements are all copied by cp.async, so a
// kernel can issue several spans before it waits once; 2-byte elements at
// the ends are copied by plain loads and stores, after the chunks are
// issued. The caller waits (cp_async_wait_all) and synchronises before
// reading.
template <typename T>
__device__ __forceinline__ int stage_span(T* __restrict__ dst,
                                          const T* __restrict__ src, int n,
                                          int t, int nthreads) {
  constexpr int V = 16 / (int)sizeof(T);  // elements per chunk
  const int mis = misalignment(src);
  const int head = min(n, (V - mis) % V);
  const int nvec = (n - head) / V;
  const int tail0 = head + nvec * V;
  T* d = dst + mis;
  for (int c = t; c < nvec; c += nthreads)
    cp_async<16>(d + head + c * V, src + head + c * V);
  for (int e = t; e < head + n - tail0; e += nthreads) {
    const int i = e < head ? e : tail0 + e - head;
    if constexpr (sizeof(T) == 4)
      cp_async<4>(d + i, src + i);
    else
      d[i] = src[i];
  }
  return mis;
}

}  // namespace row_stage
