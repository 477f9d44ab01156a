// Batched weighted Gram matrix for Hopper (sm_90a):
//   G[b] = X[b]' diag(d[b]) X[b] + diag(pvi[b]),   X (R, F) dense, G (F, F).
//
// Replaces mlease_tpu/ops/pallas/gram.py::gram_matrix (kernel _gram_kernel,
// batched by gram_batched): the Hessian of the per-item Newton step, of the
// Laplace posterior covariance and of the head-block preconditioner. The TPU
// kernel walks row tiles in order on one core and carries the (F, F) sum in
// scratch memory from one grid step to the next; it pads R to a tile
// multiple with d = 0 rows. Neither is carried over. Here blocks run in
// parallel, so the sequential grid axis becomes a loop over row chunks
// inside the block, the ragged last chunk is masked, and where one problem
// is too long for the blocks its output tiles give, rows are split across
// blocks and the partial sums are combined by a second pass.
//
// Design. A thread block owns one (TILE x TILE) output tile (ti <= tj: only
// the upper triangle of tiles is computed) of one batch entry over one row
// range. Row chunks of KC rows are staged through shared memory, A = d * X
// [:, tile ti] with the weight folded in at load, B = X[:, tile tj]; every
// thread keeps a TM x TM register tile whose rows and columns are strided
// by TILE/TM so that the shared-memory reads are free of bank conflicts.
// Products and sums are IEEE fused multiply-adds in the accumulate type
// (float for float and bf16 inputs, double for double): no tensor cores, no
// TF32. The lower triangle is mirrored from the upper one, inside diagonal
// tiles too, so G == G' holds exactly.
//
// Two regimes, one kernel. Many tiny problems (the per-item path: tens of
// thousands of entries, R = 8..256, F = 8..64): one block per entry and
// tile pair, 64 threads for F <= 16, no row split; these are bound by bytes
// and launch. One long problem (the head block: 3 lanes sharing one X, R up
// to millions, F = 128..512): rows are split over gridDim.z so that a few
// hundred blocks run; every split writes its partial tile into a workspace
// (B, nsplit, F, F) and gram_reduce_kernel adds the splits in a fixed
// order. No float atomics anywhere: the result is the same in every run.
//
// Bound. Operations for one long wide problem in float32: G is symmetric, so
// the function needs B*R*F*(F+1) FLOP for its upper triangle plus B*R*F to
// fold d in, against 67 TFLOP/s outside the tensor cores (about 0.51 ms at
// R = 131,072, F = 512, against 0.08 ms of bytes). Bytes for the item shapes:
// (B*R*F + B*R) * itemsize + B*F^2 * out_itemsize against 3.35 TB/s.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*, and each entry returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename A, int TILE, int TM, int KC>
__global__ void __launch_bounds__((TILE / TM) * (TILE / TM))
gram_tile_kernel(const T* __restrict__ x, const T* __restrict__ d,
                 const A* __restrict__ pvi, A* __restrict__ out,
                 A* __restrict__ ws, int64_t R, int F,
                 int64_t x_batch_stride, int nsplit) {
  constexpr int NT = TILE / TM;          // threads along each tile side
  constexpr int NTHREADS = NT * NT;
  __shared__ A As[KC][TILE];
  __shared__ A Bs[KC][TILE];

  const int64_t b = blockIdx.x;
  // upper-triangle tile pair (ti <= tj) from the linear index blockIdx.y
  const int nt = (F + TILE - 1) / TILE;
  int ti = 0;
  int rem = blockIdx.y;
  while (rem >= nt - ti) {
    rem -= nt - ti;
    ++ti;
  }
  const int tj = ti + rem;
  // this split's rows: whole chunks of KC rows, dealt evenly
  const int split = blockIdx.z;
  const int64_t nchunks = (R + KC - 1) / KC;
  const int64_t r_begin = (nchunks * split / nsplit) * KC;
  int64_t r_end = (nchunks * (split + 1) / nsplit) * KC;
  if (r_end > R) r_end = R;

  const T* xb = x + b * x_batch_stride;
  const T* db = d + b * R;
  const int tid = threadIdx.x;
  const int tx = tid % NT;
  const int ty = tid / NT;
  const int col_i = ti * TILE;
  const int col_j = tj * TILE;

  A acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = A(0);
  }

  for (int64_t r0 = r_begin; r0 < r_end; r0 += KC) {
    for (int idx = tid; idx < KC * TILE; idx += NTHREADS) {
      const int k = idx / TILE;
      const int c = idx % TILE;
      const int64_t r = r0 + k;
      A a = A(0);
      A bv = A(0);
      if (r < r_end) {               // the ragged last chunk is masked
        const A dv = widen(db[r]);
        const T* row = xb + r * F;
        if (col_i + c < F) a = dv * widen(row[col_i + c]);
        if (col_j + c < F) bv = widen(row[col_j + c]);
      }
      As[k][c] = a;
      Bs[k][c] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      A av[TM];
      A bv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[k][ty + i * NT];
#pragma unroll
      for (int j = 0; j < TM; ++j) bv[j] = Bs[k][tx + j * NT];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }

  const int64_t FF = static_cast<int64_t>(F) * F;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int m = col_i + ty + i * NT;
      const int n = col_j + tx + j * NT;
      if (m >= F || n >= F) continue;
      // a diagonal tile keeps its upper half and mirrors it: G == G' exactly
      if (ti == tj && m > n) continue;
      A v = acc[i][j];
      if (nsplit == 1) {
        A* ob = out + b * FF;
        if (m == n && pvi != nullptr) v += pvi[b * F + m];
        ob[static_cast<int64_t>(m) * F + n] = v;
        if (m != n) ob[static_cast<int64_t>(n) * F + m] = v;
      } else {
        ws[(b * nsplit + split) * FF + static_cast<int64_t>(m) * F + n] = v;
      }
    }
  }
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

template <typename T, int TILE, int TM, int KC>
int launch_tile(const void* x, const void* d, const void* pvi, void* out,
                void* ws, long long B, long long R, long long F,
                long long x_batch_stride, int nsplit, void* stream) {
  using A = typename AccOf<T>::type;
  constexpr int NT = TILE / TM;
  const int nt = static_cast<int>((F + TILE - 1) / TILE);
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>(nt * (nt + 1) / 2),
                  static_cast<unsigned>(nsplit));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gram_tile_kernel<T, A, TILE, TM, KC><<<grid, NT * NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(d),
      static_cast<const A*>(pvi), static_cast<A*>(out), static_cast<A*>(ws),
      R, static_cast<int>(F), x_batch_stride, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const long long total = B * F * F;
  gram_reduce_kernel<A><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                          st>>>(static_cast<const A*>(ws),
                                static_cast<const A*>(pvi),
                                static_cast<A*>(out), B, static_cast<int>(F),
                                nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* d, const void* pvi, void* out,
             void* ws, long long B, long long R, long long F,
             long long x_batch_stride, int tile, int nsplit, void* stream) {
  if (B <= 0 || F <= 0 || R < 0 || nsplit < 1 || nsplit > 65535 ||
      (nsplit > 1 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (tile) {
    case 16:
      return launch_tile<T, 16, 2, 32>(x, d, pvi, out, ws, B, R, F,
                                       x_batch_stride, nsplit, stream);
    case 32:
      return launch_tile<T, 32, 2, 16>(x, d, pvi, out, ws, B, R, F,
                                       x_batch_stride, nsplit, stream);
    case 64:
      return launch_tile<T, 64, 4, 16>(x, d, pvi, out, ws, B, R, F,
                                       x_batch_stride, nsplit, stream);
    case 128:
      if constexpr (sizeof(typename AccOf<T>::type) == 4) {
        return launch_tile<T, 128, 8, 16>(x, d, pvi, out, ws, B, R, F,
                                          x_batch_stride, nsplit, stream);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// x (B, R, F) row-major, or (R, F) shared by every entry with
// x_batch_stride = 0; d (B, R) in x's type; pvi (B, F) in the accumulate
// type or null; out (B, F, F) in the accumulate type; ws (B, nsplit, F, F)
// when nsplit > 1. tile is 16, 32, 64 or (float accumulate only) 128.
// Returns cudaGetLastError() after the launches.
int gram_batched_f32(const void* x, const void* d, const void* pvi, void* out,
                     void* ws, long long B, long long R, long long F,
                     long long x_batch_stride, int tile, int nsplit,
                     void* stream) {
  return dispatch<float>(x, d, pvi, out, ws, B, R, F, x_batch_stride, tile,
                         nsplit, stream);
}

int gram_batched_f64(const void* x, const void* d, const void* pvi, void* out,
                     void* ws, long long B, long long R, long long F,
                     long long x_batch_stride, int tile, int nsplit,
                     void* stream) {
  return dispatch<double>(x, d, pvi, out, ws, B, R, F, x_batch_stride, tile,
                          nsplit, stream);
}

int gram_batched_bf16(const void* x, const void* d, const void* pvi,
                      void* out, void* ws, long long B, long long R,
                      long long F, long long x_batch_stride, int tile,
                      int nsplit, void* stream) {
  return dispatch<__nv_bfloat16>(x, d, pvi, out, ws, B, R, F, x_batch_stride,
                                 tile, nsplit, stream);
}

}  // extern "C"
