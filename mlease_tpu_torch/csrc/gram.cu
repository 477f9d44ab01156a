// Batched weighted Gram matrix for Hopper (sm_90a):
//   G[b] = X[b]' diag(d[b]) X[b] + diag(pvi[b]),   X (R, F) dense, G (F, F).
//
// Replaces mlease_tpu/ops/pallas/gram.py::gram_matrix (kernel _gram_kernel,
// batched by gram_batched): the Hessian of the per-item Newton step, of the
// Laplace posterior covariance and of the head-block preconditioner. The TPU
// kernel walks row tiles in order on one core, multiplies each on the matrix
// unit (Precision.HIGHEST: a multi-pass bf16 emulation of float32) and
// carries the (F, F) sum in scratch memory from one grid step to the next;
// it pads R to a tile multiple with d = 0 rows. Here blocks run in
// parallel, the sequential grid axis is a loop over row chunks inside a
// block, the ragged last chunk is masked, and where one problem is too long
// for the blocks its output tiles give, rows are split across blocks and
// the partial sums are combined by a second pass in a fixed order.
//
// What bounds it, and the three variants that ops/gram.py::launch_config
// chooses between (each row of a measurement names the one that ran):
//
//  * "item", in this file: many tiny problems (the per-item buckets: tens
//    of thousands of entries, R 8..64, F <= 16). Bound by bytes: an entry is
//    4 KB of X for 16 x 16 outputs. A persistent grid; every warp walks
//    over its own run of entries, the whole entry (or its next 4 KB of
//    rows) fetched by 16-byte cp.async copies into a warp-private double
//    buffer, so that entry i+1 is in flight while entry i is multiplied.
//    X is staged once, the products are FMAs in the accumulate type (a
//    thread keeps a 4 x 2 block of G), and the F x F result leaves through
//    shared memory in 16-byte stores, the mirror included. No row split,
//    no workspace, no block-wide barrier.
//  * "mma", in gram_mma.cuh and gram_mma_{f32,bf16,f64}.cu: one long
//    problem or many mid-sized ones (F above 16; bf16 rows must be 16-byte
//    multiples). Bound by operations once F reaches the hundreds. A 3- or 4-stage
//    cp.async ring of row chunks feeds the tensor cores through mma.sync:
//    float32 as the split product 3xTF32, bf16-in as two bf16 products
//    (exact), float64 as DMMA, all with accumulation in the output type.
//    Up to three batch entries that share one X are done by one block over
//    one staged chunk, so a shared X is read once.
//  * "fma", in this file: the plain kernel, for what the other two do not
//    take: F <= 16 with ragged rows (F 13) or with too few entries for
//    the item variant, and bf16 rows that are no 16-byte multiple. One shared-memory stage,
//    register tiles, IEEE FMAs.
//
// All three compute only m <= n and mirror it, so G == G' exactly, and none
// uses float atomics: the result is the same in every run.
//
// Bound. Bytes: (B*R*F + B*R) * itemsize + B*F^2 * out_itemsize against
// 3.35 TB/s (a shared X counted once). Operations: G is symmetric, so the
// function needs B*R*F*(F+1) FLOP for its upper triangle plus B*R*F to fold
// d in; against the best rate this card offers a product of that accuracy:
// float32 495/3 = 165 TFLOP/s (three TF32 products), bf16 989 TFLOP/s,
// float64 67 TFLOP/s (DMMA).
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*, and each entry returns cudaGetLastError() of its launches. The
// weights d arrive in x's type, except float32 (bf16-rounded) for bf16 x.

#include "gram_common.cuh"

namespace {

using gram::AccOf;
using gram::WeightOf;
using gram::widen;

// ---------------------------------------------------------------------------
// "fma": one (TILE x TILE) output tile per block, one shared-memory stage
// ---------------------------------------------------------------------------

template <typename T, typename A, int TILE, int TM, int KC>
__global__ void __launch_bounds__((TILE / TM) * (TILE / TM))
gram_tile_kernel(const T* __restrict__ x,
                 const typename WeightOf<T>::type* __restrict__ d,
                 const A* __restrict__ pvi, A* __restrict__ out,
                 A* __restrict__ ws, int64_t R, int F,
                 int64_t x_batch_stride, int nsplit) {
  constexpr int NT = TILE / TM;          // threads along each tile side
  constexpr int NTHREADS = NT * NT;
  __shared__ A As[KC][TILE];
  __shared__ A Bs[KC][TILE];

  const int64_t b = blockIdx.x;
  int ti, tj;
  gram::tile_pair(blockIdx.y, (F + TILE - 1) / TILE, &ti, &tj);
  // this split's rows: whole chunks of KC rows, dealt evenly
  const int split = blockIdx.z;
  const int64_t nchunks = (R + KC - 1) / KC;
  const int64_t r_begin = (nchunks * split / nsplit) * KC;
  int64_t r_end = (nchunks * (split + 1) / nsplit) * KC;
  if (r_end > R) r_end = R;

  const T* xb = x + b * x_batch_stride;
  const typename WeightOf<T>::type* db = d + b * R;
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
      static_cast<const T*>(x),
      static_cast<const typename WeightOf<T>::type*>(d),
      static_cast<const A*>(pvi), static_cast<A*>(out), static_cast<A*>(ws),
      R, static_cast<int>(F), x_batch_stride, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return gram::launch_reduce<A>(ws, pvi, out, B, F, nsplit, st);
}

template <typename T>
int dispatch_fma(const void* x, const void* d, const void* pvi, void* out,
                 void* ws, long long B, long long R, long long F,
                 long long x_batch_stride, int tile, int nsplit,
                 void* stream) {
  if (B <= 0 || F <= 0 || R <= 0 || nsplit < 1 || nsplit > 65535 ||
      (nsplit > 1 && ws == nullptr) || B > 0x7fffffffLL) {
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

// ---------------------------------------------------------------------------
// "item": a warp per entry, entries streamed through a double buffer
// ---------------------------------------------------------------------------

constexpr int kItemWarps = 8;          // warps per block
constexpr int kItemF = 16;             // widest F: a warp's 4 x 8 threads
                                       // keep 4 x 2 outputs each
constexpr int kItemChunkBytes = 4096;  // of X per buffer

template <typename T> struct ItemShape {
  using A = typename AccOf<T>::type;
  using DT = typename WeightOf<T>::type;
  // rows per buffer: a whole entry where R is at most this
  static constexpr int kRows = kItemChunkBytes / (kItemF * sizeof(T));
  // per warp: two X buffers, two weight buffers, the staged result; the X
  // buffers first, so that every part stays 16-byte aligned
  static constexpr size_t kXBytes = 2 * kItemChunkBytes;
  static constexpr size_t kDBytes = 2 * kRows * sizeof(DT);
  static constexpr size_t kOutBytes = kItemF * kItemF * sizeof(A);
  static constexpr size_t kWarpBytes = kXBytes + kDBytes + kOutBytes;
  // slack after the last warp: threads of columns >= F read (and discard)
  // up to kItemF elements past a buffer's last row
  static constexpr size_t kSmemBytes = kItemWarps * kWarpBytes + 256;
};

// the thread's four A-side and two B-side values of row k
__device__ __forceinline__ void item_row(const float* row, int m0, int n0,
                                         float (&a)[4], float (&b)[2]) {
  const float4 av = *reinterpret_cast<const float4*>(row + m0);
  const float2 bv = *reinterpret_cast<const float2*>(row + n0);
  a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
  b[0] = bv.x; b[1] = bv.y;
}
__device__ __forceinline__ void item_row(const double* row, int m0, int n0,
                                         double (&a)[4], double (&b)[2]) {
  const double2 a0 = *reinterpret_cast<const double2*>(row + m0);
  const double2 a1 = *reinterpret_cast<const double2*>(row + m0 + 2);
  const double2 bv = *reinterpret_cast<const double2*>(row + n0);
  a[0] = a0.x; a[1] = a0.y; a[2] = a1.x; a[3] = a1.y;
  b[0] = bv.x; b[1] = bv.y;
}
__device__ __forceinline__ void item_row(const __nv_bfloat16* row, int m0,
                                         int n0, float (&a)[4],
                                         float (&b)[2]) {
  const uint2 av = *reinterpret_cast<const uint2*>(row + m0);
  const uint32_t bv = *reinterpret_cast<const uint32_t*>(row + n0);
  const float2 a0 =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av.x));
  const float2 a1 =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av.y));
  const float2 b0 =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv));
  a[0] = a0.x; a[1] = a0.y; a[2] = a1.x; a[3] = a1.y;
  b[0] = b0.x; b[1] = b0.y;
}

template <typename T>
__global__ void __launch_bounds__(kItemWarps * 32)
gram_item_kernel(const T* __restrict__ x,
                 const typename WeightOf<T>::type* __restrict__ d,
                 const typename AccOf<T>::type* __restrict__ pvi,
                 typename AccOf<T>::type* __restrict__ out, int64_t B,
                 int R, int F, int64_t x_batch_stride) {
  using S = ItemShape<T>;
  using A = typename S::A;
  using DT = typename S::DT;
  constexpr int RC = S::kRows;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* mine = smem_raw + warp * S::kWarpBytes;
  T* xs = reinterpret_cast<T*>(mine);                      // [2][4 KB]
  DT* dsm = reinterpret_cast<DT*>(mine + S::kXBytes);      // [2][RC]
  A* gs = reinterpret_cast<A*>(mine + S::kXBytes + S::kDBytes);  // [F][F]

  // this warp's run of entries, dealt evenly over all warps of the grid
  const int64_t nwarps = static_cast<int64_t>(gridDim.x) * kItemWarps;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kItemWarps + warp;
  const int64_t b_begin = B * w / nwarps;
  const int64_t b_end = B * (w + 1) / nwarps;
  const int cpi = (R + RC - 1) / RC;               // chunks per entry
  const int64_t nunits = (b_end - b_begin) * cpi;

  constexpr int EPC = 16 / sizeof(T);              // elements per copy
  auto fetch = [&](int64_t u) {
    const int64_t b = b_begin + u / cpi;
    const int r0 = static_cast<int>(u % cpi) * RC;
    const int rows = (R - r0 < RC) ? (R - r0) : RC;
    const T* src = x + b * x_batch_stride + static_cast<int64_t>(r0) * F;
    T* dst = xs + (u & 1) * (kItemChunkBytes / sizeof(T));
    const int ncopies = rows * F / EPC;            // rows are 16-byte multiples
    for (int i = lane; i < ncopies; i += 32)
      gram::cp_async16(dst + i * EPC, src + i * EPC, true);
    const DT* dsrc = d + b * R + r0;
    DT* ddst = dsm + (u & 1) * RC;
    for (int i = lane; i < rows; i += 32)
      gram::cp_async_elem(ddst + i, dsrc + i, true);
    gram::cp_async_commit();
  };

  const int m0 = (lane >> 3) * 4;       // this thread's 4 rows of G
  const int n0 = (lane & 7) * 2;        // ... and 2 columns
  A acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = A(0);

  if (nunits > 0) fetch(0);
  for (int64_t u = 0; u < nunits; ++u) {
    if (u + 1 < nunits) {
      fetch(u + 1);                     // the next chunk flies while ...
      gram::cp_async_wait<1>();
    } else {
      gram::cp_async_wait<0>();
    }
    __syncwarp();                       // ... this one is multiplied
    const int chunk = static_cast<int>(u % cpi);
    const int r0 = chunk * RC;
    const int rows = (R - r0 < RC) ? (R - r0) : RC;
    const T* xrow = xs + (u & 1) * (kItemChunkBytes / sizeof(T));
    const DT* dk = dsm + (u & 1) * RC;
#pragma unroll 4
    for (int k = 0; k < rows; ++k) {
      A a[4], bv[2];
      item_row(xrow + k * F, m0, n0, a, bv);
      const A dv = widen(dk[k]);
      bv[0] *= dv;                      // d folded into the 2-wide side
      bv[1] *= dv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += a[i] * bv[0];
        acc[i][1] += a[i] * bv[1];
      }
    }
    if (chunk == cpi - 1) {             // the entry is complete
      const int64_t b = b_begin + u / cpi;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = m0 + i, n = n0 + j;
          A v = acc[i][j];
          acc[i][j] = A(0);
          if (m > n || n >= F) continue;       // m <= n is kept ...
          if (m == n && pvi != nullptr) v += pvi[b * F + m];
          gs[m * F + n] = v;
          gs[n * F + m] = v;                   // ... and mirrored
        }
      }
      __syncwarp();
      constexpr int EPS = 16 / sizeof(A);      // elements per 16-byte store
      A* ob = out + b * F * F;
      for (int i = lane * EPS; i < F * F; i += 32 * EPS)
        *reinterpret_cast<uint4*>(ob + i) =
            *reinterpret_cast<const uint4*>(gs + i);
    }
    __syncwarp();      // every thread is done with this buffer and with gs
  }
}

template <typename T>
int launch_item(const void* x, const void* d, const void* pvi, void* out,
                long long B, long long R, long long F,
                long long x_batch_stride, int blocks, void* stream) {
  using S = ItemShape<T>;
  using A = typename S::A;
  if (B <= 0 || R <= 0 || F <= 0 || F > kItemF || blocks < 1 ||
      R > 0x7fffffffLL / kItemF ||
      (F * static_cast<long long>(sizeof(T))) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      gram_item_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_item_kernel<T><<<blocks, kItemWarps * 32, S::kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const typename S::DT*>(d),
      static_cast<const A*>(pvi), static_cast<A*>(out), B,
      static_cast<int>(R), static_cast<int>(F), x_batch_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// "fma". x (B, R, F) row-major, or (R, F) shared by every entry with
// x_batch_stride = 0; d (B, R) in x's type (float32 for bf16 x); pvi (B, F)
// in the accumulate type or null; out (B, F, F) in the accumulate type; ws
// (B, nsplit, F, F) when nsplit > 1. tile is 16, 32, 64 or (float
// accumulate only) 128. Returns cudaGetLastError() after the launches.
int gram_fma_f32(const void* x, const void* d, const void* pvi, void* out,
                 void* ws, long long B, long long R, long long F,
                 long long x_batch_stride, int tile, int nsplit,
                 void* stream) {
  return dispatch_fma<float>(x, d, pvi, out, ws, B, R, F, x_batch_stride,
                             tile, nsplit, stream);
}

int gram_fma_f64(const void* x, const void* d, const void* pvi, void* out,
                 void* ws, long long B, long long R, long long F,
                 long long x_batch_stride, int tile, int nsplit,
                 void* stream) {
  return dispatch_fma<double>(x, d, pvi, out, ws, B, R, F, x_batch_stride,
                              tile, nsplit, stream);
}

int gram_fma_bf16(const void* x, const void* d, const void* pvi, void* out,
                  void* ws, long long B, long long R, long long F,
                  long long x_batch_stride, int tile, int nsplit,
                  void* stream) {
  return dispatch_fma<__nv_bfloat16>(x, d, pvi, out, ws, B, R, F,
                                     x_batch_stride, tile, nsplit, stream);
}

// "item". Arguments as above, without a workspace; F <= 16 with 16-byte
// rows, x and out 16-byte aligned. `blocks` is the size of the persistent
// grid (8 warps a block, every warp takes B / (8 * blocks) entries).
int gram_item_f32(const void* x, const void* d, const void* pvi, void* out,
                  long long B, long long R, long long F,
                  long long x_batch_stride, int blocks, void* stream) {
  return launch_item<float>(x, d, pvi, out, B, R, F, x_batch_stride, blocks,
                            stream);
}

int gram_item_f64(const void* x, const void* d, const void* pvi, void* out,
                  long long B, long long R, long long F,
                  long long x_batch_stride, int blocks, void* stream) {
  return launch_item<double>(x, d, pvi, out, B, R, F, x_batch_stride, blocks,
                             stream);
}

int gram_item_bf16(const void* x, const void* d, const void* pvi, void* out,
                   long long B, long long R, long long F,
                   long long x_batch_stride, int blocks, void* stream) {
  return launch_item<__nv_bfloat16>(x, d, pvi, out, B, R, F, x_batch_stride,
                                    blocks, stream);
}

}  // extern "C"
