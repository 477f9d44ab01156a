// Weighted Gram, long problems, float64: double-precision tensor-core
// products (DMMA, mma.sync.m16n8k8.f64) over the pipeline of gram_mma.cuh.
// See gram.cu for the function.
//
// DMMA multiplies and accumulates in IEEE float64, so there is nothing to
// split: A = d * x is folded in registers and the accumulator is the mma's
// own C operand. The shape matters: m8n8k4, the only one before sm_90,
// reaches 33 TFLOP/s on this card, m16n8k8 reaches 66 (PERF.md).

#include "gram_mma.cuh"

namespace {

struct PolicyF64 {
  using T = double;
  using DT = double;
  using A = double;
  static constexpr int KC = 16;
  static constexpr int KSTEP = 8;
  static constexpr int MROWS = 16;
  static constexpr int PAD = 4;      // row stride = 32 bytes mod 128
  static constexpr int CREGS = 4;

  struct ARaw { double v[4]; };
  struct AFrag { double v[4]; };
  struct BFrag { double v[2]; };
  struct DFrag { double v[2]; };

  // thread (g, tig) of m16n8k8: a0 (m g, k tig), a1 (m g+8, k tig),
  // a2 (m g, k tig+4), a3 (m g+8, k tig+4); b0 (k tig, n g), b1 (k tig+4);
  // c0, c1 (m g, n 2 tig, 2 tig + 1), c2, c3 (m g+8)
  template <int MT>
  static __device__ __forceinline__ void load_a(ARaw (&ar)[MT], const T* pa,
                                                int ld, int k0, int m_base,
                                                int lane) {
    const T* p = pa + (k0 + (lane & 3)) * ld + m_base + (lane >> 2);
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
    const T* p = pb + (k0 + (lane & 3)) * ld + n_base + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      bf[nt].v[0] = p[nt * 8];
      bf[nt].v[1] = p[4 * ld + nt * 8];
    }
  }

  static __device__ __forceinline__ DFrag load_d(const DT* ds, int k0,
                                                 int lane) {
    return DFrag{{ds[k0 + (lane & 3)], ds[k0 + (lane & 3) + 4]}};
  }

  static __device__ __forceinline__ AFrag fold(const ARaw& ar,
                                               const DFrag& dv) {
    return AFrag{{ar.v[0] * dv.v[0], ar.v[1] * dv.v[0], ar.v[2] * dv.v[1],
                  ar.v[3] * dv.v[1]}};
  }

  template <int NT>
  static __device__ __forceinline__ void mma_row(A (&acc)[NT][4],
                                                 const AFrag& af,
                                                 const BFrag (&bf)[NT]) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+d"(acc[nt][0]), "+d"(acc[nt][1]), "+d"(acc[nt][2]),
            "+d"(acc[nt][3])
          : "d"(af.v[0]), "d"(af.v[1]), "d"(af.v[2]), "d"(af.v[3]),
            "d"(bf[nt].v[0]), "d"(bf[nt].v[1]));
    }
  }
};

// 64 x 64 tile, 8 warps of 32 x 16, a ring of 4 chunks; one lane, or three
// lanes sharing X
using Small1 = gram::MmaVariant<PolicyF64, 2, 4, 2, 2, 1, 4, 2>;
using Small3 = gram::MmaVariant<PolicyF64, 2, 4, 2, 2, 3, 4, 1>;

}  // namespace

extern "C" {

// As gram_mma_f32 in float64 throughout; tile is 64.
int gram_mma_f64(const void* x, const void* d, const void* pvi, void* out,
                 void* ws, long long B, long long R, long long F,
                 long long x_batch_stride, int tile, int lanes, int nsplit,
                 void* stream) {
  return gram::dispatch_mma<Small1, Small1, Small3>(
      x, d, pvi, out, ws, B, R, F, x_batch_stride, tile, lanes, nsplit,
      stream);
}

}  // extern "C"
