// The dense bfloat16 head's part of the solver's data passes, for Hopper
// (sm_90a):
//
//   Xv:   out[l, b Rb + r]      += sum_h x[b, r, h] w[l, b H + h]
//   X'v:  out[l, ids[b H + h]]  += sum_r D[l, b Rb + r] x_l[b, r, h]
//
// with x the (B, Rb, H) head stored in bfloat16 (an (R, H) head is B = 1),
// x_l = x for l < square_from and bf16_rn(x * x) from square_from on (the
// Jacobi diagonal's square, rounded as the solver's `hx * hx` rounds it:
// the product of two bfloat16 values is exact in float32, then rounded to
// nearest even), w, D and out float32, L <= 8 lanes a launch.
//
// Replaces no TPU kernel: on the TPU XLA fuses the head's widening into
// its matrix products. The port's first route widened each block to
// float32 in device memory and ran a cuBLAS float32 GEMM over the copy (X'v
// twice at the 2L site, once more for the square): 2 bytes read, 4 written
// and 4 read again for every head element, 10 bytes for the 2 the data
// takes. These kernels read the stored head once a pass and widen it in
// registers; every product and sum is float32 on the CUDA cores.
//
// Bound. Memory: the head, R H 2 bytes a pass (ctr-12m: 1,562,500 x 128 a
// block, 400 MB, 0.119 ms at 3.35 TB/s), plus L R 4 bytes of D, or of out
// read and written. The work is L multiply-adds a head element (2 bytes):
// 1.5 a byte at L 3, 3 at 2L 6, below the float32 peak's 10 a byte (33.5
// T multiply-adds a second over 3.35 TB/s); the unpacking, the squares and
// the shuffles add instructions, so HBM and the instruction rate bound
// it.
//
// Design.
//  * Rows. A group of G lanes takes a 128-column panel of one row: lane j
//    loads chunks j, j + G, ... of it (8 bfloat16 each, C chunks a lane:
//    G = 16 and C = 1, or G = 8 and C = 2 in Xv at L <= 4), neighbouring
//    lanes on neighbouring chunks, and 32 / G groups a warp take 32 / G
//    rows at once. A head of 128 columns (every cell's) is one panel; a
//    wider one is taken a panel at a time, a narrower one leaves the lanes
//    past its columns idle. A warp takes 32 rows at a time (a tile); each
//    lane has up to 8 loads in flight before it uses the first. The loads
//    are 16 bytes where the head's rows are 16-byte aligned (H a multiple
//    of 8) and element by element otherwise, each a kernel of its own: as
//    one kernel's branch the element loads slowed every 16-byte pass on an
//    H100 (ctr-12m's block: Xv 0.163 to 0.169 ms, X'v 0.139 to 0.143, the
//    2L pass 0.304 to 0.325).
//  * Xv. A lane holds its chunks' w (L x 8 floats each, registers) for the
//    panel; a row's dot is each lane's products in order, then a butterfly
//    of shuffles over the group, which leaves every lane of the group the
//    same bits; lane k keeps the tile's row k and adds it into out with
//    the warp's neighbouring lanes (coalesced; out read at the tile's
//    start). No (Rb, H) float32 transient exists.
//  * X'v. A block of the grid takes a fixed span of one head block's rows;
//    a lane sums its chunk's 8 columns for L lanes over its rows in
//    registers (D of a tile loaded once, coalesced, and passed by shuffle),
//    then the groups of a warp by a butterfly, the warps in order through
//    shared memory, and each grid block writes its (L, H) partial to the
//    workspace. A second kernel sums the partials of each (lane, column) in
//    grid order and adds the sum into out at the column's id. No float
//    atomics: the order of every sum is fixed by the shapes and the card
//    (the grid is the occupancy query's, asked once), so the same inputs
//    give the same bits in every run, eagerly and inside a CUDA graph.
//  * Eight kernels (Xv and X'v, at most 4 or 8 lanes, 16-byte or element
//    loads): the lanes' registers are sized at compile time, everything
//    else is an argument.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*, and each entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                 // rows a warp takes at a time
constexpr int kPanel = 128;               // columns a group takes at a time
constexpr int kMaxLanes = 8;
constexpr unsigned kFull = 0xffffffffu;

// Two grid blocks an SM: at most 128 registers a lane. With one (the
// compiler's choice without the bound) the 2L pass took 0.85 ms a ctr-12m
// block on an H100, against 0.30; three spilled and took 1.22.
constexpr int kMinBlocks = 2;
constexpr int kLoads = 8;         // 16-byte loads a lane keeps in flight

// Chunks of a row a lane takes in Xv: two where the lanes' w fit the
// registers twice (L <= 4), which halves the butterfly's shuffles a byte
// (0.167 ms a ctr-12m block against 0.181 with one).
__host__ __device__ constexpr int xv_chunks(int lmax) {
  return lmax > 4 ? 1 : 2;
}

// Lanes a group: a panel's 16 chunks, C a lane.
__host__ __device__ constexpr int group_of(int chunks_a_lane) {
  return kPanel / 8 / chunks_a_lane;
}

// X'v's rows in flight a lane: fewer where 8 lanes' sums take the
// registers
template <int LMAX>
__host__ __device__ constexpr int xtv_batch() {
  return LMAX > 4 ? kLoads / 2 : kLoads;
}

// Chunk h0 / 8 of a row (8 bfloat16 bits, the columns past H as zeros).
template <bool kVec>
__device__ __forceinline__ uint4 load_chunk(const uint16_t* row, int h0,
                                            int H) {
  if (kVec) return __ldcs(reinterpret_cast<const uint4*>(row + h0));
  uint32_t w[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int h = h0 + 2 * m;
    const uint32_t lo = h < H ? row[h] : 0u;
    const uint32_t hi = h + 1 < H ? row[h + 1] : 0u;
    w[m] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct HeadArgs {
  const uint16_t* x;      // bfloat16 bits
  long long sb, sr;       // block and row strides, elements
  long long Rb;           // rows a block
  int H;
  long long span;         // rows a grid block takes (a multiple of kTile)
};

// q[u][k] = chunk h0 + k step of row r0 + u, zeros past the head's
// columns or the span's rows r_hi; all N C loads issued before any use.
template <bool kVec, int N, int C>
__device__ __forceinline__ void fetch_rows(uint4 (&q)[N][C],
                                           const HeadArgs& a,
                                           const uint16_t* xb, long long r0,
                                           long long r_hi, int h0,
                                           int step) {
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int h = h0 + k * step;
      const long long r = r0 + u;
      q[u][k] = (h < a.H && r < r_hi)
                    ? load_chunk<kVec>(xb + r * a.sr, h, a.H)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
}

// 8 bfloat16 to float32, exactly (the low half of a word is the first).
__device__ __forceinline__ void widen8(const uint4 q, float (&x)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    x[2 * m] = __uint_as_float(w[m] << 16);
    x[2 * m + 1] = __uint_as_float(w[m] & 0xffff0000u);
  }
}

// bf16_rn(x * x) of each, widened back: the float32 product of two
// bfloat16 values is exact, so this is the bfloat16 multiply's result.
__device__ __forceinline__ void square8(const float (&x)[8], float (&s)[8]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float a = __fmul_rn(x[2 * m], x[2 * m]);
    const float b = __fmul_rn(x[2 * m + 1], x[2 * m + 1]);
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    s[2 * m] = __low2float(p);
    s[2 * m + 1] = __high2float(p);
  }
}

template <int LMAX, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    head_xv_kernel(const HeadArgs a, const float* __restrict__ w,
                   long long ldw, float* __restrict__ out, long long ldo,
                   int L) {
  constexpr int C = xv_chunks(LMAX);
  constexpr int G = group_of(C);
  constexpr int kB = (kLoads / C) < G ? (kLoads / C) : G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / G, j = lane % G;
  const int b = blockIdx.y;
  const int np = (a.H + kPanel - 1) / kPanel;
  const long long r_lo = blockIdx.x * a.span;
  const long long r_hi = min(a.Rb, r_lo + a.span);
  const uint16_t* xb = a.x + b * a.sb;
  const float* wb = w + static_cast<long long>(b) * a.H;
  float* ob = out + b * a.Rb;

  // lane j's chunks of panel p: (p C + k) G + j, k < C
  float wr[C][LMAX][8];
  auto load_w = [&](int p) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int h0 = ((p * C + k) * G + j) * 8;
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wr[k][l][e] =
              (l < L && h0 + e < a.H) ? wb[l * ldw + h0 + e] : 0.f;
    }
  };
  if (np == 1) load_w(0);

  for (long long t0 = r_lo + warp * kTile; t0 < r_hi;
       t0 += kWarps * kTile) {
    // out's values for the tile's rows, read before its rows' loads
    const long long rr = t0 + lane;
    float mine[LMAX], prev[LMAX];
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      mine[l] = 0.f;
      prev[l] = (l < L && rr < r_hi) ? ob[l * ldo + rr] : 0.f;
    }
    for (int p = 0; p < np; ++p) {
      if (np > 1) load_w(p);
#pragma unroll
      for (int i0 = 0; i0 < G; i0 += kB) {
        uint4 q[kB][C];
        fetch_rows<kVec>(q, a, xb, t0 + i0 + G * g, r_hi,
                         (p * C * G + j) * 8, G * 8);
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          float x[C][8];
#pragma unroll
          for (int k = 0; k < C; ++k) widen8(q[u][k], x[k]);
#pragma unroll
          for (int l = 0; l < LMAX; ++l) {
            if (l < L) {
              float s = 0.f;
#pragma unroll
              for (int k = 0; k < C; ++k)
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  s = fmaf(x[k][e], wr[k][l][e], s);
#pragma unroll
              for (int off = G / 2; off > 0; off >>= 1)
                s += __shfl_xor_sync(kFull, s, off);
              if (j == i0 + u) mine[l] += s;
            }
          }
        }
      }
    }
    if (rr < r_hi) {
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < L) ob[l * ldo + rr] = prev[l] + mine[l];
    }
  }
}

template <int LMAX, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    head_xtv_kernel(const HeadArgs a, const float* __restrict__ D,
                    long long ldd, int L, int nplain,
                    float* __restrict__ ws) {
  constexpr int G = group_of(1);
  constexpr int kB = xtv_batch<LMAX>();
  __shared__ float red[kWarps][G * 8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / G, j = lane % G;
  const int b = blockIdx.y;
  const int np = (a.H + kPanel - 1) / kPanel;
  const long long r_lo = blockIdx.x * a.span;
  const long long r_hi = min(a.Rb, r_lo + a.span);
  const uint16_t* xb = a.x + b * a.sb;
  const float* db = D + b * a.Rb;
  float* wsb = ws + (static_cast<long long>(b) * gridDim.x + blockIdx.x) *
                        L * a.H;

  for (int p = 0; p < np; ++p) {
    const int h0 = (p * G + j) * 8;
    float acc[LMAX][8];
#pragma unroll
    for (int l = 0; l < LMAX; ++l)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[l][e] = 0.f;

    for (long long t0 = r_lo + warp * kTile; t0 < r_hi;
         t0 += kWarps * kTile) {
      float d[LMAX];
      const long long rr = t0 + lane;
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        d[l] = (l < L && rr < r_hi) ? db[l * ldd + rr] : 0.f;
#pragma unroll
      for (int i0 = 0; i0 < G; i0 += kB) {
        uint4 q[kB][1];
        fetch_rows<kVec>(q, a, xb, t0 + i0 + G * g, r_hi, h0, 0);
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const int src = i0 + u + G * g;
          float x[8];
          widen8(q[u][0], x);
          float dl[LMAX];
#pragma unroll
          for (int l = 0; l < LMAX; ++l)
            dl[l] = l < L ? __shfl_sync(kFull, d[l], src) : 0.f;
#pragma unroll
          for (int l = 0; l < LMAX; ++l)
            if (l < nplain)
#pragma unroll
              for (int e = 0; e < 8; ++e)
                acc[l][e] = fmaf(dl[l], x[e], acc[l][e]);
          if (nplain < L) {
            float s[8];
            square8(x, s);
#pragma unroll
            for (int l = 0; l < LMAX; ++l)
              if (l >= nplain && l < L)
#pragma unroll
                for (int e = 0; e < 8; ++e)
                  acc[l][e] = fmaf(dl[l], s[e], acc[l][e]);
          }
        }
      }
    }
    // the warp's groups, then its warps in order, one lane at a time
#pragma unroll
    for (int off = G; off < 32; off <<= 1)
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        if (l < L)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            acc[l][e] += __shfl_xor_sync(kFull, acc[l][e], off);
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      if (l >= L) break;
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp][j * 8 + e] = acc[l][e];
      }
      __syncthreads();
      for (int c = threadIdx.x; c < G * 8; c += kThreads) {
        const int h = p * G * 8 + c;
        if (h < a.H) {
          float s = red[0][c];
#pragma unroll
          for (int k = 1; k < kWarps; ++k) s += red[k][c];
          wsb[l * a.H + h] = s;
        }
      }
      __syncthreads();
    }
  }
}

// out[l, ids[b H + h]] += the partials of (b, l, h), summed in grid order.
template <typename Id>
__global__ void head_xtv_finish(const float* __restrict__ ws, int cx, int B,
                                int L, int H, const Id* __restrict__ ids,
                                float* __restrict__ out, long long ldo) {
  const long long k = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (k >= static_cast<long long>(L) * B * H) return;
  const int h = static_cast<int>(k % H);
  const long long q = k / H;
  const int b = static_cast<int>(q % B);
  const int l = static_cast<int>(q / B);
  const long long step = static_cast<long long>(L) * H;
  const float* p = ws + (static_cast<long long>(b) * cx * L + l) * H + h;
  float s = p[0];
  for (int c = 1; c < cx; ++c) s += p[c * step];
  out[l * ldo + static_cast<long long>(ids[static_cast<long long>(b) * H +
                                           h])] += s;
}

bool vec_ok(const void* x, long long sb, long long sr, int H) {
  return (reinterpret_cast<uintptr_t>(x) & 15u) == 0 && H % 8 == 0 &&
         sr % 8 == 0 && sb % 8 == 0;
}

template <bool kVec>
const void* kernel_of(bool xtv, bool wide) {
  if (xtv)
    return wide ? reinterpret_cast<const void*>(head_xtv_kernel<8, kVec>)
                : reinterpret_cast<const void*>(head_xtv_kernel<4, kVec>);
  return wide ? reinterpret_cast<const void*>(head_xv_kernel<8, kVec>)
              : reinterpret_cast<const void*>(head_xv_kernel<4, kVec>);
}

// Grid blocks of a kernel that fit on the card at once (the occupancy
// query, cached: a process drives one kind of card); 0 when it fails.
long long ctas_on_card(bool xtv, bool wide, bool vec) {
  static long long cache[2][2][2] = {};
  long long& slot = cache[xtv][wide][vec];
  if (slot == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm,
            vec ? kernel_of<true>(xtv, wide) : kernel_of<false>(xtv, wide),
            kThreads, 0) != cudaSuccess)
      return 0;
    slot = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  return slot;
}

// Grid blocks along a head block's rows: the card's resident blocks shared
// over the B head blocks, at least a tile of rows each.
long long grid_x(bool xtv, bool wide, bool vec, long long B, long long Rb) {
  const long long ctas = ctas_on_card(xtv, wide, vec);
  if (ctas <= 0) return 0;
  long long cx = (ctas + B - 1) / B;
  const long long tiles = (Rb + kTile - 1) / kTile;
  if (cx > tiles) cx = tiles;
  return cx < 1 ? 1 : cx;
}

long long span_of(long long Rb, long long cx) {
  const long long rows = (Rb + cx - 1) / cx;
  return (rows + kTile - 1) / kTile * kTile;
}

}  // namespace

// One launch of KERNEL at the lanes' width (up to 4 or 8) and loads
// (vec: 16-byte, else element by element).
#define HEAD_LAUNCH(KERNEL, ...)                                           \
  do {                                                                     \
    if (L > 4 && vec)                                                      \
      KERNEL<8, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);         \
    else if (L > 4)                                                        \
      KERNEL<8, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);        \
    else if (vec)                                                          \
      KERNEL<4, true><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);         \
    else                                                                   \
      KERNEL<4, false><<<grid, kThreads, 0, stream>>>(__VA_ARGS__);        \
  } while (0)

extern "C" {

// Grid blocks along a block's rows for a launch of this shape (the X'v
// workspace holds B * that * L * H floats); 0 when the occupancy query
// fails or L is outside [1, 8].
long long head_pass_grid(int xtv, const void* x, long long sb, long long sr,
                         long long B, long long Rb, long long H,
                         long long L) {
  if (L < 1 || L > kMaxLanes || B < 1 || Rb < 1 || H < 1) return 0;
  return grid_x(xtv != 0, L > 4, vec_ok(x, sb, sr, static_cast<int>(H)), B,
                Rb);
}

// x (B, Rb, H) bfloat16 with strides (sb, sr, 1); w (L, >= B H) float32,
// lane stride ldw; out (L, >= B Rb) float32, lane stride ldo, added into.
int head_xv(const void* x, long long sb, long long sr, long long B,
            long long Rb, long long H, const void* w, long long ldw,
            void* out, long long ldo, long long L, long long cx,
            void* stream_ptr) {
  if (B < 1 || Rb < 1 || H < 1 || L < 1) return 0;
  if (L > kMaxLanes || cx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const HeadArgs a{static_cast<const uint16_t*>(x), sb, sr, Rb,
                   static_cast<int>(H), span_of(Rb, cx)};
  const bool vec = vec_ok(x, sb, sr, a.H);
  const dim3 grid(static_cast<unsigned>(cx), static_cast<unsigned>(B));
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  const int Li = static_cast<int>(L);
  HEAD_LAUNCH(head_xv_kernel, a, wp, ldw, op, ldo, Li);
  return static_cast<int>(cudaGetLastError());
}

// x as head_xv's; D (L, >= B Rb) float32, lane stride ldd; lanes from
// square_from on take the squared head; ids (B H) int32 or int64
// (ids64), distinct; out (L, >= max id + 1) float32, lane stride ldo,
// added into at the ids; ws B * cx * L * H floats (head_pass_grid).
int head_xtv(const void* x, long long sb, long long sr, long long B,
             long long Rb, long long H, const void* D, long long ldd,
             long long L, long long square_from, const void* ids, int ids64,
             void* out, long long ldo, void* ws, long long cx,
             void* stream_ptr) {
  if (B < 1 || Rb < 1 || H < 1 || L < 1) return 0;
  if (L > kMaxLanes || cx < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const HeadArgs a{static_cast<const uint16_t*>(x), sb, sr, Rb,
                   static_cast<int>(H), span_of(Rb, cx)};
  const bool vec = vec_ok(x, sb, sr, a.H);
  const dim3 grid(static_cast<unsigned>(cx), static_cast<unsigned>(B));
  const float* dp = static_cast<const float*>(D);
  float* wsp = static_cast<float*>(ws);
  const int Li = static_cast<int>(L);
  const int nplain = static_cast<int>(
      square_from < 0 ? 0 : (square_from < L ? square_from : L));
  HEAD_LAUNCH(head_xtv_kernel, a, dp, ldd, Li, nplain, wsp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = L * B * H;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  const int cxi = static_cast<int>(cx), Bi = static_cast<int>(B);
  if (ids64)
    head_xtv_finish<long long><<<blocks, 256, 0, stream>>>(
        wsp, cxi, Bi, Li, a.H, static_cast<const long long*>(ids),
        static_cast<float*>(out), ldo);
  else
    head_xtv_finish<int><<<blocks, 256, 0, stream>>>(
        wsp, cxi, Bi, Li, a.H, static_cast<const int*>(ids),
        static_cast<float*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
