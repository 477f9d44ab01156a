// Shared by the weighted-Gram sources (gram.cu, gram_mma_*.cu): the
// accumulate and weight types of an input type, cp.async copies, and the
// second pass of a row split. See gram.cu for the function and the design.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gram {

// accumulate (and output) type of an input type
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

// type in which the weights d arrive: x's own, except that bf16 problems
// get their (bf16-rounded) weights as float32, so that a row chunk of d can
// be copied in 4-byte pieces from any row offset
template <typename T> struct WeightOf { using type = T; };
template <> struct WeightOf<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; valid == false fills the 16
// bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int nbytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes)
               : "memory");
}

// 4- or 8-byte asynchronous copy of one element (a weight, or an element
// of rows that are no 16-byte multiple), zero-filled when !valid
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src,
                                              bool valid) {
  const int nbytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src,
                                              bool valid) {
  const int nbytes = valid ? 8 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(nbytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// upper-triangle tile pair (ti <= tj) of the linear index `pair` among the
// nt * (nt + 1) / 2 pairs, row by row
__device__ __forceinline__ void tile_pair(int pair, int nt, int* ti, int* tj) {
  int i = 0;
  while (pair >= nt - i) {
    pair -= nt - i;
    ++i;
  }
  *ti = i;
  *tj = i + pair;
}

// Second pass of a row split: out[b, m, n] = sum over splits, in the order
// of the splits, of ws[b, s, m, n] for m <= n, plus the diagonal, mirrored.
template <typename A>
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const A* __restrict__ ws, const A* __restrict__ pvi,
                   A* __restrict__ out, int64_t B, int F, int nsplit) {
  const int64_t FF = static_cast<int64_t>(F) * F;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= B * FF) return;
  const int64_t b = idx / FF;
  const int m = static_cast<int>((idx % FF) / F);
  const int n = static_cast<int>(idx % F);
  if (m > n) return;
  const A* p = ws + b * nsplit * FF + static_cast<int64_t>(m) * F + n;
  A v = A(0);
  for (int s = 0; s < nsplit; ++s) v += p[s * FF];
  if (m == n && pvi != nullptr) v += pvi[b * F + m];
  out[b * FF + static_cast<int64_t>(m) * F + n] = v;
  if (m != n) out[b * FF + static_cast<int64_t>(n) * F + m] = v;
}

template <typename A>
int launch_reduce(const void* ws, const void* pvi, void* out, long long B,
                  long long F, int nsplit, cudaStream_t st) {
  const long long total = B * F * F;
  gram_reduce_kernel<A><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                          st>>>(static_cast<const A*>(ws),
                                static_cast<const A*>(pvi),
                                static_cast<A*>(out), B, static_cast<int>(F),
                                nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gram
