// Sorted-stream segment sum for Hopper (sm_90a): out[l, seg[i]] += contrib[l, i].
//
// Replaces mlease_tpu/ops/pallas/tile_sum.py::tile_segment_sum, the TPU
// kernel that sums a COO tail's contributions into 128-column tiles with a
// (P, 128) one-hot contraction on the MXU. That kernel reads a slab in which
// every tile is padded to the longest tile P. On the power-law (zipf 1.3)
// tails this solver trains on, that slab holds ~22x the stream's entries at
// the JAX bench's default shape and ~1,470x at ctr-12m widths with 1M rows
// (3.5G slots for 2.4M entries; tools/torch_tail_slab_sizes.py), so the port
// keeps the kernel's function and drops its layout: it reduces the ragged
// sorted stream itself, unpadded.
//
// Design. The stream is sorted by segment id (rows for Xv, columns for X'v),
// so every segment is one contiguous run. Each block takes a fixed chunk of
// kThreads * kItems entries, which balances work however skewed the
// segments are: a hot column spreads over many blocks instead of serialising
// onto one SM. A thread sums the runs inside its kItems entries serially; a
// block-wide segmented scan (warp shuffles, then one value per warp in
// shared memory) carries the run that crosses thread boundaries. A run that
// lies wholly inside the chunk is stored once with a plain store; only the
// chunk's first and last segments, which may continue in the neighbouring
// chunks, are added with atomicAdd (native for float and double on sm_90).
// The caller zero-fills the output, so empty segments stay exactly 0.
// Lanes (the lambda path, L <= ~6) loop inside the block and share the
// segment ids loaded once.
//
// Bound. Memory-bound: it must read L*T values and T int32 ids and write
// L*S values, (L*T + L*S) * sizeof(T) + 4*T bytes, against 3.35 TB/s on an
// H100 SXM. It does one add per entry and lane, far below any compute peak.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*, and each entry returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ void emit(T* out_l, int s, T v, int64_t S,
                                     int first_seg, int last_seg) {
  if (s < 0 || s >= S) return;  // ids are validated by the caller
  if (s == first_seg || s == last_seg) {
    atomicAdd(out_l + s, v);    // may continue in a neighbouring chunk
  } else {
    out_l[s] = v;               // wholly inside this chunk: one owner
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_sorted_kernel(const T* __restrict__ contrib,
                          const int* __restrict__ seg, T* __restrict__ out,
                          int64_t L, int64_t n, int64_t S) {
  __shared__ int s_first[kThreads];
  __shared__ int s_last[kThreads];
  __shared__ T s_scan[kThreads];
  __shared__ T s_warp_val[kWarps];
  __shared__ int s_warp_flag[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = (n - base < kChunk) ? n : base + kChunk;
  const int first_seg = seg[base];
  const int last_seg = seg[end - 1];
  const int64_t t0 = base + static_cast<int64_t>(tid) * kItems;

  // Entries past the end of the stream join the last segment with value 0.
  int sg[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = t0 + k;
    sg[k] = (i < end) ? seg[i] : last_seg;
  }
  s_first[tid] = sg[0];
  s_last[tid] = sg[kItems - 1];
  __syncthreads();

  bool multi = false;
#pragma unroll
  for (int k = 1; k < kItems; ++k) multi |= (sg[k] != sg[k - 1]);
  // carries_in: this thread's first run started in an earlier thread.
  const bool carries_in = tid > 0 && sg[0] == s_last[tid - 1];
  // head: this thread's last run starts inside this thread.
  const int head = (!carries_in || multi) ? 1 : 0;
  // ends_here: this thread's last run does not continue into the next one.
  const bool ends_here =
      tid == kThreads - 1 || s_first[tid + 1] != sg[kItems - 1];

  for (int64_t l = 0; l < L; ++l) {
    const T* c = contrib + l * n;
    T* o = out + l * S;
    T v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t i = t0 + k;
      v[k] = (i < end) ? c[i] : T(0);
    }

    // Sum of this thread's last run, over this thread's entries only.
    T run = v[0];
#pragma unroll
    for (int k = 1; k < kItems; ++k) run = (sg[k] != sg[k - 1]) ? v[k] : run + v[k];

    // Block-wide inclusive segmented scan of (head, run): after it, sv is
    // the sum of the run ending at this thread's last entry, from the
    // run's start inside the chunk.
    T sv = run;
    int sf = head;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T ov = __shfl_up_sync(0xffffffffu, sv, d);
      const int of = __shfl_up_sync(0xffffffffu, sf, d);
      if (lane >= d) {
        if (!sf) sv += ov;
        sf |= of;
      }
    }
    if (lane == 31) {
      s_warp_val[warp] = sv;
      s_warp_flag[warp] = sf;
    }
    __syncthreads();
    if (!sf) {  // the run reaches back past this warp's first thread
      T acc = T(0);
      for (int w = warp - 1; w >= 0; --w) {
        acc += s_warp_val[w];
        if (s_warp_flag[w]) break;
      }
      sv += acc;
    }
    s_scan[tid] = sv;
    __syncthreads();

    // Emit every run that ends inside this thread's entries.
    T acc = (carries_in ? s_scan[tid - 1] : T(0)) + v[0];
#pragma unroll
    for (int k = 1; k < kItems; ++k) {
      if (sg[k] != sg[k - 1]) {
        emit(o, sg[k - 1], acc, S, first_seg, last_seg);
        acc = v[k];
      } else {
        acc += v[k];
      }
    }
    if (ends_here) emit(o, sg[kItems - 1], acc, S, first_seg, last_seg);
    __syncthreads();  // shared scan buffers are reused by the next lane
  }
}

template <typename T>
int launch(const void* contrib, const void* seg, void* out, long long L,
           long long n, long long S, void* stream) {
  if (L <= 0 || n <= 0) return 0;
  const long long blocks = (n + kChunk - 1) / kChunk;
  segment_sum_sorted_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(contrib), static_cast<const int*>(seg),
      static_cast<T*>(out), L, n, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// contrib (L, n) row-major, seg (n,) int32 non-decreasing, out (L, S)
// zero-filled by the caller. Returns cudaGetLastError() after the launch.
int segment_sum_sorted_f32(const void* contrib, const void* seg, void* out,
                           long long L, long long n, long long S,
                           void* stream) {
  return launch<float>(contrib, seg, out, L, n, S, stream);
}

int segment_sum_sorted_f64(const void* contrib, const void* seg, void* out,
                           long long L, long long n, long long S,
                           void* stream) {
  return launch<double>(contrib, seg, out, L, n, S, stream);
}

}  // extern "C"
