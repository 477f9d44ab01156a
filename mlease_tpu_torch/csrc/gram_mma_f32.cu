// Weighted Gram, long problems, float32: the split product "3xTF32" on the
// tensor cores (mma.sync.m16n8k8 TF32, float32 accumulation) over the
// pipeline of gram_mma.cuh. See gram.cu for the function.
//
// TF32 alone keeps 11 significant bits. Each operand value v is split in
// registers into hi = tf32(v) and lo = tf32(v - hi) (21 bits together: both
// are cut, not rounded), and a product is hi*hi + hi*lo + lo*hi; the dropped
// lo*lo term is 2^-20 of the product. The tensor core adds into its accumulator with truncation,
// which over a long chain is a bias, so the three products of one k-step (8
// rows) start from zero and their sum is added to the running float32
// accumulator by an ordinary rounded add. Measured error against float64:
// see PERF.md; the tolerance is 1e-5 * sum_r |d x_i x_j|.
//
// The weight is folded in before the split: A = d * x in float32.

#include "gram_mma.cuh"

namespace {

struct PolicyTf32 {
  using T = float;
  using DT = float;
  using A = float;
  static constexpr int KC = 32;
  static constexpr int KSTEP = 8;
  static constexpr int MROWS = 16;
  static constexpr int PAD = 8;      // row stride = 8 mod 32 banks
  static constexpr int CREGS = 4;

  struct ARaw { float v[4]; };
  struct AFrag { uint32_t hi[4], lo[4]; };
  struct BFrag { uint32_t hi[2], lo[2]; };
  struct DFrag { float v[2]; };

  // hi = v cut to TF32's 11 bits, lo = the rest (exact) cut to 11 bits: two
  // logic operations and a subtraction, 21 bits kept. cvt.rna.tf32.f32
  // would round both (22 bits) but is several times slower, and the split
  // is the largest cost of this kernel beside the mmas (PERF.md).
  static __device__ __forceinline__ void split(float v, uint32_t& hi,
                                               uint32_t& lo) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
  }

  // thread (g, tig) of m16n8k8: a0 (m g, k tig), a1 (m g+8, k tig),
  // a2 (m g, k tig+4), a3 (m g+8, k tig+4); b0 (k tig, n g), b1 (k tig+4)
  template <int MT>
  static __device__ __forceinline__ void load_a(ARaw (&ar)[MT], const T* pa,
                                                int ld, int k0, int m_base,
                                                int lane) {
    const int g = lane >> 2, tig = lane & 3;
    const T* p = pa + (k0 + tig) * ld + m_base + g;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      ar[mt].v[0] = p[mt * 16];
      ar[mt].v[1] = p[mt * 16 + 8];
      ar[mt].v[2] = p[4 * ld + mt * 16];
      ar[mt].v[3] = p[4 * ld + mt * 16 + 8];
    }
  }

  template <int NT>
  static __device__ __forceinline__ void load_b(BFrag (&bf)[NT], const T* pb,
                                                int ld, int k0, int n_base,
                                                int lane) {
    const int g = lane >> 2, tig = lane & 3;
    const T* p = pb + (k0 + tig) * ld + n_base + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      split(p[nt * 8], bf[nt].hi[0], bf[nt].lo[0]);
      split(p[4 * ld + nt * 8], bf[nt].hi[1], bf[nt].lo[1]);
    }
  }

  static __device__ __forceinline__ DFrag load_d(const DT* ds, int k0,
                                                 int lane) {
    const int tig = lane & 3;
    return DFrag{{ds[k0 + tig], ds[k0 + tig + 4]}};
  }

  static __device__ __forceinline__ AFrag fold(const ARaw& ar,
                                               const DFrag& dv) {
    AFrag af;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split(ar.v[i] * dv.v[i >> 1], af.hi[i], af.lo[i]);
    return af;
  }

  // d = a * b + c
  static __device__ __forceinline__ void mma_tf32(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2],
                                                  const float (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }

  // the three products of every n-tile start from zero, one product at a
  // time across the row so that consecutive mmas are independent
  template <int NT>
  static __device__ __forceinline__ void mma_row(A (&acc)[NT][4],
                                                 const AFrag& af,
                                                 const BFrag (&bf)[NT]) {
#ifdef GRAM_ABLATE_NO_FLUSH
    // tools/torch_gram_probe.py: what accumulating in the tensor core
    // itself costs in accuracy
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma_tf32(acc[nt], af.lo, bf[nt].hi, acc[nt]);
      mma_tf32(acc[nt], af.hi, bf[nt].lo, acc[nt]);
      mma_tf32(acc[nt], af.hi, bf[nt].hi, acc[nt]);
    }
    return;
#endif
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)     // the small terms first
      mma_tf32(c[nt], af.lo, bf[nt].hi, zero);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[nt], af.hi, bf[nt].lo, c[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_tf32(c[nt], af.hi, bf[nt].hi, c[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += c[nt][i];
  }
};

// 128 x 128 tile, 8 warps of 64 x 32, one lane, a ring of 4 chunks (139 KB)
using Big = gram::MmaVariant<PolicyTf32, 2, 4, 4, 4, 1, 4, 1>;
// 64 x 64 tile, 4 warps of 32 x 32, one lane or three lanes sharing X
using Small1 = gram::MmaVariant<PolicyTf32, 2, 2, 2, 4, 1, 3, 4>;
using Small3 = gram::MmaVariant<PolicyTf32, 2, 2, 2, 4, 3, 3, 2>;

}  // namespace

extern "C" {

// x (B, R, F) row-major float32, 16-byte aligned rows, or (R, F) shared by
// every entry with x_batch_stride = 0; d (B, R) float32; pvi (B, F) float32
// or null; out (B, F, F); ws (B, nsplit, F, F) when nsplit > 1. tile is 128
// or 64; lanes is 1, or 3 with tile 64 and a shared x. Returns
// cudaGetLastError() after the launches.
int gram_mma_f32(const void* x, const void* d, const void* pvi, void* out,
                 void* ws, long long B, long long R, long long F,
                 long long x_batch_stride, int tile, int lanes, int nsplit,
                 void* stream) {
  return gram::dispatch_mma<Big, Small1, Small3>(
      x, d, pvi, out, ws, B, R, F, x_batch_stride, tile, lanes, nsplit,
      stream);
}

}  // extern "C"
