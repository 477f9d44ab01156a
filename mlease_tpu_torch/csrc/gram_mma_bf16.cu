// Weighted Gram, long problems, bfloat16 inputs with float32 accumulation
// and output: two bf16 tensor-core products per k-step (mma.sync.m16n8k16)
// over the pipeline of gram_mma.cuh. See gram.cu for the function.
//
// x is bf16 and the weights are bf16 values (they arrive widened to
// float32), so the exact product A = d * x has at most 16 significant bits
// and is exactly hi + lo with hi = bf16(A), lo = bf16(A - hi); B = x is
// bf16 as it stands. G = hi*B + lo*B loses nothing against a float32
// product of the same inputs. As in the float32 variant the two products of
// a k-step (16 rows) start from zero and are added to the running float32
// accumulator by a rounded add, because the tensor core's own accumulation
// truncates.
//
// The panels hold X as it lies in memory, k (rows) slow; ldmatrix.trans
// hands every thread the pairs of consecutive k that the fragments want.

#include "gram_mma.cuh"

namespace {

struct PolicyBf16 {
  using T = __nv_bfloat16;
  using DT = float;
  using A = float;
  static constexpr int KC = 64;
  static constexpr int KSTEP = 16;
  static constexpr int MROWS = 16;
  static constexpr int PAD = 8;      // row stride = 16 bytes mod 128
  static constexpr int CREGS = 4;

  struct ARaw { uint32_t v[4]; };            // bf16 pairs (k, k+1)
  struct AFrag { uint32_t hi[4], lo[4]; };
  struct BFrag { uint32_t v[2]; };
  struct DFrag { uint32_t v[2]; };          // bf16 pairs (k, k+1)

  static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                           const T* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(gram::smem_addr(p)));
  }

  // lanes 8j..8j+7 address the rows of 8x8 matrix j. A (m16 x k16):
  // matrix 0 (k 0-7, m 0-7), 1 (k 0-7, m 8-15), 2 (k 8-15, m 0-7),
  // 3 (k 8-15, m 8-15) give a0..a3 of m16n8k16
  template <int MT>
  static __device__ __forceinline__ void load_a(ARaw (&ar)[MT], const T* pa,
                                                int ld, int k0, int m_base,
                                                int lane) {
    const int j = lane >> 3, r = lane & 7;
    const T* p = pa + (k0 + r + ((j & 2) ? 8 : 0)) * ld + m_base +
                 ((j & 1) ? 8 : 0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4_trans(ar[mt].v, p + mt * 16);
  }

  // B (k16 x n8), two n-tiles a load: matrix 0 (k 0-7, n 0-7), 1 (k 8-15,
  // n 0-7), 2 (k 0-7, n 8-15), 3 (k 8-15, n 8-15) give b0, b1 of each
  template <int NT>
  static __device__ __forceinline__ void load_b(BFrag (&bf)[NT], const T* pb,
                                                int ld, int k0, int n_base,
                                                int lane) {
    static_assert(NT % 2 == 0, "n-tiles are loaded in pairs");
    const int j = lane >> 3, r = lane & 7;
    const T* p = pb + (k0 + r + ((j & 1) ? 8 : 0)) * ld + n_base +
                 ((j & 2) ? 8 : 0);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t v[4];
      ldmatrix_x4_trans(v, p + nt * 8);
      bf[nt].v[0] = v[0];
      bf[nt].v[1] = v[1];
      bf[nt + 1].v[0] = v[2];
      bf[nt + 1].v[1] = v[3];
    }
  }

  // the weights of k = 2 tig, 2 tig + 1 (a0, a1) and of k + 8 (a2, a3), as
  // two bf16 pairs: they are bf16 values held as float32, so the upper
  // halves of their bits are the values
  static __device__ __forceinline__ DFrag load_d(const DT* ds, int k0,
                                                 int lane) {
    const int tig = lane & 3;
    const uint2 lo = *reinterpret_cast<const uint2*>(ds + k0 + 2 * tig);
    const uint2 hi = *reinterpret_cast<const uint2*>(ds + k0 + 2 * tig + 8);
    return DFrag{{__byte_perm(lo.x, lo.y, 0x7632),
                  __byte_perm(hi.x, hi.y, 0x7632)}};
  }

  // p = d * x has at most 16 significant bits, so with hi = bf16(p), which
  // a packed bf16 multiply gives, the rest p - hi has at most 8: a packed
  // bf16 fused multiply-add gives it exactly. Three instructions for two
  // values.
  static __device__ __forceinline__ AFrag fold(const ARaw& ar,
                                               const DFrag& dv) {
    AFrag af;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 x2 =
          *reinterpret_cast<const __nv_bfloat162*>(&ar.v[i]);
      const __nv_bfloat162 d2 =
          *reinterpret_cast<const __nv_bfloat162*>(&dv.v[i >> 1]);
      const __nv_bfloat162 h = __hmul2(d2, x2);
      const __nv_bfloat162 l = __hfma2(d2, x2, __hneg2(h));
      af.hi[i] = *reinterpret_cast<const uint32_t*>(&h);
      af.lo[i] = *reinterpret_cast<const uint32_t*>(&l);
    }
    return af;
  }

  // d = a * b + c
  static __device__ __forceinline__ void mma_bf16(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2],
                                                  const float (&c)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
  }

  // the two products of every n-tile start from zero, one product at a
  // time across the row so that consecutive mmas are independent
  template <int NT>
  static __device__ __forceinline__ void mma_row(A (&acc)[NT][4],
                                                 const AFrag& af,
                                                 const BFrag (&bf)[NT]) {
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    float c[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(c[nt], af.lo, bf[nt].v, zero);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(c[nt], af.hi, bf[nt].v, c[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += c[nt][i];
  }
};

// 128 x 128 tile, 8 warps of 32 x 64, one lane, a ring of 4 chunks (139 KB)
using Big = gram::MmaVariant<PolicyBf16, 4, 2, 2, 8, 1, 4, 1>;
// 64 x 64 tile, 4 warps of 32 x 32, one lane or three lanes sharing X
using Small1 = gram::MmaVariant<PolicyBf16, 2, 2, 2, 4, 1, 3, 4>;
using Small3 = gram::MmaVariant<PolicyBf16, 2, 2, 2, 4, 3, 3, 2>;

}  // namespace

extern "C" {

// As gram_mma_f32, with x bfloat16 and d float32 holding bf16-rounded
// values; pvi, out and ws float32.
int gram_mma_bf16(const void* x, const void* d, const void* pvi, void* out,
                  void* ws, long long B, long long R, long long F,
                  long long x_batch_stride, int tile, int lanes, int nsplit,
                  void* stream) {
  return gram::dispatch_mma<Big, Small1, Small3>(
      x, d, pvi, out, ws, B, R, F, x_batch_stride, tile, lanes, nsplit,
      stream);
}

}  // extern "C"
