// The long-problem variant of the weighted Gram kernel: a cp.async ring of
// row chunks feeding warp-level tensor-core products (mma.sync), one
// instantiation per input type (gram_mma_f32.cu, gram_mma_bf16.cu,
// gram_mma_f64.cu). See gram.cu for the function and for how the variants
// divide the shapes.
//
// A block owns one TILE x TILE output tile (ti <= tj) of NL batch entries
// ("lanes") that share one X, over one row range. A row chunk is KC rows of
// the tile's columns, copied as they lie in memory (rows of X, F
// contiguous) into a ring of STAGES shared-memory stages by 16-byte
// cp.async copies (element by element, 4 or 8 bytes, where the rows of a
// float32 or float64 X are no 16-byte multiple): the column panel of tile ti, the panel of tile tj unless
// ti == tj (a diagonal tile stages its columns once), and the chunk of each
// lane's weights. The copies of chunk c + STAGES - 1 are in flight while
// chunk c is multiplied; one __syncthreads per chunk.
//
// The product is G[m][n] = sum_k A[m][k] * B[k][n] with k the row index,
// A[m][k] = d[k] * x[k][m] and B[k][n] = x[k][n]. Both operands are read
// from the staged panel with k as the slow axis, which is how the mma.sync
// fragments want them (A "row", B "col"): a thread reads its fragment
// elements straight from the panel, panel rows padded so that the reads
// are free of bank conflicts (ldmatrix.trans for 16-bit elements). The
// weight is folded in and the value is split in registers, per lane, on the
// way from the raw fragment to the operand (the Policy, one per type). The
// B fragments are shared by the NL lanes, so a shared X is read, staged and
// split once for all of them.
//
// Symmetry: only tile pairs ti <= tj are computed; in a diagonal tile a
// warp skips the rows of mma sub-blocks (16 or 8 output rows by the warp's
// width) that lie wholly below the diagonal, the others keep m <= n, and
// every kept entry is written to (m, n) and (n, m): G == G' exactly. The
// multiply loop is compiled twice, with and without that test, so that an
// off-diagonal tile runs without a branch between its mmas. A row split writes partial tiles to
// the workspace and gram_reduce_kernel adds them in the order of the
// splits: no atomics, the same bits in every run.

#pragma once

#include "gram_common.cuh"

namespace gram {

// One Policy per input type:
//   T, DT, A          storage, weight and accumulate types
//   KC, KSTEP         rows per staged chunk, rows per mma
//   MROWS             output rows of one mma (its columns are always 8)
//   PAD               elements added to a panel row against bank conflicts
//   CREGS             accumulator registers per mma and thread
//   load_a / load_b   raw A fragments / operand-ready B fragments of a warp
//   load_d, fold      a lane's weights for one k-step; raw A -> operand
//   mma_row           acc[nt] += A * B[nt] for a row of n-tiles, in the
//                     accumulate type
template <typename P, int WARPS_M, int WARPS_N, int MT, int NT, int NL,
          int STAGES>
struct MmaShape {
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  static constexpr int kTile = WARPS_M * MT * P::MROWS;
  static_assert(kTile == WARPS_N * NT * 8, "square output tile");
  static constexpr int kLd = kTile + P::PAD;
  static constexpr int kPanel = P::KC * kLd;            // elements
  static constexpr int kElemsPerCopy = 16 / sizeof(typename P::T);
  static constexpr int kCopiesPerRow = kTile / kElemsPerCopy;
  static constexpr int kCopies = P::KC * kCopiesPerRow;
  static_assert(kCopies % kThreads == 0, "whole copies per thread");
  static constexpr size_t kPanelBytes =
      static_cast<size_t>(STAGES) * 2 * kPanel * sizeof(typename P::T);
  static constexpr size_t kSmemBytes =
      kPanelBytes + static_cast<size_t>(STAGES) * NL * P::KC *
                        sizeof(typename P::DT);
};

// One staged chunk: acc[l][mt][nt] += A_l * B over its KC rows, for this
// warp's MT x NT sub-blocks and the block's nl lanes.
template <typename P, int MT, int NT, int NL, bool DIAG>
__device__ __forceinline__ void mma_chunk(
    typename P::A (&acc)[NL][MT][NT][P::CREGS], const typename P::T* pa,
    const typename P::T* pb, const typename P::DT* ds, int ld, int m_base,
    int n_base, int nl, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < P::KC; k0 += P::KSTEP) {
    typename P::BFrag bf[NT];
    typename P::ARaw ar[MT];
    P::template load_b<NT>(bf, pb, ld, k0, n_base, lane);
    P::template load_a<MT>(ar, pa, ld, k0, m_base, lane);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (NL > 1 && l >= nl) break;
      const typename P::DFrag dv = P::load_d(ds + l * P::KC, k0, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // a row of sub-blocks wholly below the diagonal is never computed
        if (DIAG && m_base + mt * P::MROWS > n_base + NT * 8 - 1) continue;
        P::template mma_row<NT>(acc[l][mt], P::fold(ar[mt], dv), bf);
      }
    }
  }
}

template <typename P, int WARPS_M, int WARPS_N, int MT, int NT, int NL,
          int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, MIN_BLOCKS)
gram_mma_kernel(const typename P::T* __restrict__ x,
                const typename P::DT* __restrict__ d,
                const typename P::A* __restrict__ pvi,
                typename P::A* __restrict__ out,
                typename P::A* __restrict__ ws, int64_t R, int F,
                int64_t x_batch_stride, int B, int nsplit, bool rows16) {
  using T = typename P::T;
  using DT = typename P::DT;
  using A = typename P::A;
  using S = MmaShape<P, WARPS_M, WARPS_N, MT, NT, NL, STAGES>;
  constexpr int KC = P::KC;
  constexpr int LD = S::kLd;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* panels = reinterpret_cast<T*>(smem_raw);
  DT* dsm = reinterpret_cast<DT*>(smem_raw + S::kPanelBytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;
  const int tig = lane & 3;

  const int b0 = blockIdx.x * NL;
  const int nl = (B - b0 < NL) ? (B - b0) : NL;       // lanes of this block
  int ti, tj;
  tile_pair(blockIdx.y, (F + S::kTile - 1) / S::kTile, &ti, &tj);
  const bool diag = ti == tj;
  const int col_i = ti * S::kTile;
  const int col_j = tj * S::kTile;
  const int m_base = wm * MT * P::MROWS;    // this warp's corner in the tile
  const int n_base = wn * NT * 8;
  // a warp whose whole sub-tile lies below the diagonal has nothing to add
  const bool warp_idle = diag && m_base > n_base + NT * 8 - 1;

  // this split's rows: whole chunks of KC rows, dealt evenly
  const int split = blockIdx.z;
  const int64_t nchunks_all = (R + KC - 1) / KC;
  const int64_t c_begin = nchunks_all * split / nsplit;
  const int64_t c_end = nchunks_all * (split + 1) / nsplit;
  const int nchunks = static_cast<int>(c_end - c_begin);
  int64_t r_end = c_end * KC;
  if (r_end > R) r_end = R;

  const T* xb = x + static_cast<int64_t>(b0) * x_batch_stride;

  auto load_chunk = [&](int c, int stage) {
    const int64_t r0 = (c_begin + c) * KC;
    T* pa = panels + static_cast<size_t>(stage) * 2 * S::kPanel;
    T* pb = pa + S::kPanel;
    if constexpr (sizeof(T) >= 4) {
      if (!rows16) {        // ragged rows: element by element, as pipelined
        for (int i = tid; i < KC * S::kTile; i += S::kThreads) {
          const int row = i / S::kTile;
          const int cc = i % S::kTile;
          const int64_t r = r0 + row;
          const bool ok_a = r < r_end && col_i + cc < F;
          cp_async_elem(pa + row * LD + cc,
                        ok_a ? xb + r * F + col_i + cc : xb, ok_a);
          if (!diag) {
            const bool ok_b = r < r_end && col_j + cc < F;
            cp_async_elem(pb + row * LD + cc,
                          ok_b ? xb + r * F + col_j + cc : xb, ok_b);
          }
        }
      }
    }
#pragma unroll
    for (int it = 0; rows16 && it < S::kCopies / S::kThreads; ++it) {
      const int i = tid + it * S::kThreads;
      const int row = i / S::kCopiesPerRow;
      const int cc = (i % S::kCopiesPerRow) * S::kElemsPerCopy;
      const int64_t r = r0 + row;
      const bool row_ok = r < r_end;       // the ragged last chunk: zeros
      const bool ok_a = row_ok && col_i + cc < F;
      cp_async16(pa + row * LD + cc, ok_a ? xb + r * F + col_i + cc : xb,
                 ok_a);
      if (!diag) {
        const bool ok_b = row_ok && col_j + cc < F;
        cp_async16(pb + row * LD + cc, ok_b ? xb + r * F + col_j + cc : xb,
                   ok_b);
      }
    }
    for (int i = tid; i < KC * NL; i += S::kThreads) {
      const int l = i / KC;
      const int64_t r = r0 + (i % KC);
      const bool ok = r < r_end && l < nl;
      cp_async_elem(dsm + (static_cast<size_t>(stage) * NL + l) * KC +
                          (i % KC),
                      ok ? d + static_cast<int64_t>(b0 + l) * R + r : d, ok);
    }
  };

  A acc[NL][MT][NT][P::CREGS];
#pragma unroll
  for (int l = 0; l < NL; ++l)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < P::CREGS; ++i) acc[l][mt][nt][i] = A(0);

  // fill the ring: chunks 0 .. STAGES-2 (one group per chunk, empty groups
  // past the end keep the group count in step)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load_chunk(s, s);
    cp_async_commit();
  }

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();           // chunk c has landed (this thread)
    __syncthreads();                       // ... for all; chunk c-1 is done
    {
      const int next = c + STAGES - 1;     // into the stage chunk c-1 left
      if (next < nchunks) load_chunk(next, next % STAGES);
      cp_async_commit();
    }
    if (warp_idle) continue;
    const int stage = c % STAGES;
    const T* pa = panels + static_cast<size_t>(stage) * 2 * S::kPanel;
    const DT* ds = dsm + static_cast<size_t>(stage) * NL * KC;
#ifdef GRAM_ABLATE_LOADS_ONLY   // tools/torch_gram_probe.py: the ring alone
    continue;
#endif
    if (diag) {
      mma_chunk<P, MT, NT, NL, true>(acc, pa, pa, ds, LD, m_base, n_base, nl,
                                     lane);
    } else {
      mma_chunk<P, MT, NT, NL, false>(acc, pa, pa + S::kPanel, ds, LD, m_base,
                                      n_base, nl, lane);
    }
  }
  cp_async_wait<0>();

  if (warp_idle) return;
  const int64_t FF = static_cast<int64_t>(F) * F;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    if (l >= nl) break;
    const int64_t b = b0 + l;
    A* ob = out + b * FF;
    A* wb = ws + (b * nsplit + split) * FF;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < P::CREGS; ++i) {
          const int m = col_i + m_base + mt * P::MROWS + g + 8 * (i / 2);
          const int n = col_j + n_base + nt * 8 + 2 * tig + (i & 1);
          if (m >= F || n >= F) continue;
          // a diagonal tile keeps m <= n and mirrors it: G == G' exactly
          if (diag && m > n) continue;
          A v = acc[l][mt][nt][i];
          if (nsplit == 1) {
            if (m == n && pvi != nullptr) v += pvi[b * F + m];
            ob[static_cast<int64_t>(m) * F + n] = v;
            if (m != n) ob[static_cast<int64_t>(n) * F + m] = v;
          } else {
            wb[static_cast<int64_t>(m) * F + n] = v;
          }
        }
      }
    }
  }
}

template <typename P, int WARPS_M, int WARPS_N, int MT, int NT, int NL,
          int STAGES, int MIN_BLOCKS>
int launch_mma(const void* x, const void* d, const void* pvi, void* out,
               void* ws, long long B, long long R, long long F,
               long long x_batch_stride, int nsplit, void* stream) {
  using S = MmaShape<P, WARPS_M, WARPS_N, MT, NT, NL, STAGES>;
  using A = typename P::A;
  auto kernel =
      gram_mma_kernel<P, WARPS_M, WARPS_N, MT, NT, NL, STAGES, MIN_BLOCKS>;
  // rows of a 16-byte multiple from a 16-byte aligned x are copied 16 bytes
  // at a time; any other float32 or float64 x element by element
  const bool rows16 =
      (F * static_cast<long long>(sizeof(typename P::T))) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (!rows16 && sizeof(typename P::T) < 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = static_cast<int>((F + S::kTile - 1) / S::kTile);
  const dim3 grid(static_cast<unsigned>((B + NL - 1) / NL),
                  static_cast<unsigned>(nt * (nt + 1) / 2),
                  static_cast<unsigned>(nsplit));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, S::kThreads, S::kSmemBytes, st>>>(
      static_cast<const typename P::T*>(x),
      static_cast<const typename P::DT*>(d), static_cast<const A*>(pvi),
      static_cast<A*>(out), static_cast<A*>(ws), R, static_cast<int>(F),
      x_batch_stride, static_cast<int>(B), nsplit, rows16);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  return launch_reduce<A>(ws, pvi, out, B, F, nsplit, st);
}

// The C entry of one type. tile selects the block shape: `big` (one lane,
// for F above 64) or 64 (one lane, or up to three lanes sharing X when
// x_batch_stride == 0 and lanes == 3). Anything else is refused.
template <typename Big, typename Small1, typename Small3>
int dispatch_mma(const void* x, const void* d, const void* pvi, void* out,
                 void* ws, long long B, long long R, long long F,
                 long long x_batch_stride, int tile, int lanes, int nsplit,
                 void* stream) {
  if (B <= 0 || F <= 0 || R <= 0 || nsplit < 1 || nsplit > 65535 ||
      (nsplit > 1 && ws == nullptr) || B > 0x7fffffffLL ||
      (lanes != 1 && (lanes != 3 || x_batch_stride != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lanes == 3) {
    if (tile != Small3::kTile) return static_cast<int>(cudaErrorInvalidValue);
    return Small3::launch(x, d, pvi, out, ws, B, R, F, x_batch_stride, nsplit,
                          stream);
  }
  if (tile == Big::kTile) {
    return Big::launch(x, d, pvi, out, ws, B, R, F, x_batch_stride, nsplit,
                       stream);
  }
  if (tile == Small1::kTile) {
    return Small1::launch(x, d, pvi, out, ws, B, R, F, x_batch_stride, nsplit,
                          stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A block shape bound to its launcher, for dispatch_mma. MIN_BLOCKS is the
// number of blocks per SM that the register allocation must leave room for.
template <typename P, int WARPS_M, int WARPS_N, int MT, int NT, int NL,
          int STAGES, int MIN_BLOCKS>
struct MmaVariant {
  static constexpr int kTile =
      MmaShape<P, WARPS_M, WARPS_N, MT, NT, NL, STAGES>::kTile;
  static int launch(const void* x, const void* d, const void* pvi, void* out,
                    void* ws, long long B, long long R, long long F,
                    long long x_batch_stride, int nsplit, void* stream) {
    return launch_mma<P, WARPS_M, WARPS_N, MT, NT, NL, STAGES, MIN_BLOCKS>(
        x, d, pvi, out, ws, B, R, F, x_batch_stride, nsplit, stream);
  }
};

}  // namespace gram
