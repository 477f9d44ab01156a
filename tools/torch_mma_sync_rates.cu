// Rates of warp-level tensor-core instructions (mma.sync) on the card: the
// ceiling of the weighted-Gram kernel's "mma" variant
// (mlease_tpu_torch/csrc/gram_mma*.cu), which feeds the tensor cores from
// registers. Every warp runs 8 independent mma chains on constant
// operands, no memory traffic; 4 to 32 warps per SM.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rates \
//        tools/torch_mma_sync_rates.cu && ./mma_rates
//
// (tools/torch_gram_probe.py builds and runs it.) Prints one line per
// occupancy: TFLOP/s of TF32 m16n8k8, bf16 m16n8k16 and float64 m8n8k4,
// m16n8k8 and m16n8k16 (the two wider float64 shapes exist from sm_90 on).

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

constexpr int kChains = 8;

template <int KIND>
__global__ void rate_f32(float* out, int iters) {
  float c[kChains][4];
  for (int i = 0; i < kChains; ++i)
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3, 7, 9};
  const uint32_t b[2] = {threadIdx.x, 5};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (KIND == 0) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
    }
  }
  float s = 0;
  for (int i = 0; i < kChains; ++i)
    for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// K = 4, 8 or 16: float64 m8n8k4, m16n8k8, m16n8k16
template <int K>
__global__ void rate_f64(double* out, int iters) {
  double c[kChains][4];
  for (int i = 0; i < kChains; ++i)
    for (int j = 0; j < 4; ++j) c[i][j] = 0;
  const double a[8] = {1.0 * threadIdx.x, 2, 3, 4, 5, 6, 7, 8};
  const double b[4] = {3.0, 1.0, 2.0, 5.0};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < kChains; ++i) {
      if (K == 4) {
        asm volatile(
            "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
            "{%0,%1}, {%2}, {%3}, {%0,%1};\n"
            : "+d"(c[i][0]), "+d"(c[i][1])
            : "d"(a[0]), "d"(b[0]));
      } else if (K == 8) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
              "d"(b[1]));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, "
            "{%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
            : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
              "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]),
              "d"(b[2]), "d"(b[3]));
      }
    }
  }
  double s = 0;
  for (int i = 0; i < kChains; ++i)
    for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename F>
float time_ms(F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch();                          // warm
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  launch();
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  void* out = nullptr;
  cudaMalloc(&out, static_cast<size_t>(sms) * 4 * 256 * sizeof(double));
  const int iters = 16000;
  for (int warps : {4, 8, 16, 32}) {
    const int blocks = sms * (warps > 8 ? warps / 8 : 1);
    const int threads = (warps > 8 ? 8 : warps) * 32;
    auto f32 = static_cast<float*>(out);
    auto f64 = static_cast<double*>(out);
    // TFLOP/s of `n` mmas of `flop` operations each in `ms`
    auto rate = [&](float ms, int its, double flop) {
      return 1.0 * sms * warps * its * kChains * flop / ms / 1e9;
    };
    const float tf32 = time_ms(
        [&] { rate_f32<0><<<blocks, threads>>>(f32, iters); });
    const float bf16 = time_ms(
        [&] { rate_f32<1><<<blocks, threads>>>(f32, iters); });
    const float d4 = time_ms(
        [&] { rate_f64<4><<<blocks, threads>>>(f64, iters); });
    const float d8 = time_ms(
        [&] { rate_f64<8><<<blocks, threads>>>(f64, iters / 4); });
    const float d16 = time_ms(
        [&] { rate_f64<16><<<blocks, threads>>>(f64, iters / 8); });
    printf("{\"device\": \"%s\", \"warps_per_sm\": %d, "
           "\"tf32_m16n8k8_tflops\": %.1f, \"bf16_m16n8k16_tflops\": %.1f, "
           "\"f64_m8n8k4_tflops\": %.1f, \"f64_m16n8k8_tflops\": %.1f, "
           "\"f64_m16n8k16_tflops\": %.1f}\n",
           prop.name, warps, rate(tf32, iters, 2048), rate(bf16, iters, 4096),
           rate(d4, iters, 512), rate(d8, iters / 4, 2048),
           rate(d16, iters / 8, 4096));
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
