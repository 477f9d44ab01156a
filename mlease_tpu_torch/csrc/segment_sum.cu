// Sorted-stream segment sum with its producer inside, for Hopper (sm_90a):
//
//   out[l, seg[i]] += w_l(vals[i]) * V[l, idx[i]]     (gather form)
//   out[l, seg[i]] += w_l(contrib[l, i])              (contrib form)
//
// with w_l(v) = v for l < square_from and v * v from square_from on, seg
// non-decreasing, out the caller's (L, S) accumulator updated in place.
//
// Replaces mlease_tpu/ops/pallas/tile_sum.py::tile_segment_sum, the TPU
// kernel that sums a COO tail's contributions into 128-column tiles with a
// (P, 128) one-hot contraction on the MXU. That kernel reads a slab in which
// every tile is padded to the longest tile P; on the power-law (zipf 1.3)
// tails this solver trains on the slab holds ~22x the stream's entries at
// the JAX bench's default shape and ~1,470x at ctr-12m widths with 1M rows
// (tools/torch_tail_slab_sizes.py). The port keeps the function and drops
// the layout: it reduces the ragged sorted stream itself. The JAX code
// writes each solver call site as one expression,
// segment_sum(where(use_sq, tv*tv, tv) * d[rows], cols, sorted)
// (mlease_tpu/ops/tron_multi.py), which XLA fuses; the gather form is that
// expression, so the (L, T) contributions never reach device memory.
//
// Bound. Memory: one call must read the stream (vals, idx, seg: T * (itemsize
// + 8) bytes), the V entries it touches (L * min(T, m_hit) * itemsize), and
// read and write the touched outputs (2 * L * S_hit * itemsize); the contrib
// form reads (L * T) * itemsize + 4 * T and writes L * S * itemsize. Over
// 3.35 TB/s (H100 SXM). It does two operations per entry and lane, far
// below any compute peak. ops/segment_sum.py::min_bytes computes the bound.
//
// Design, against what held the first version (PR 1) back
// (tools/torch_segsum_probe.py times the switches named here):
//  * Loads. The stream is cut into steps of 256 entries; lane k of a warp
//    takes entries 8k..8k+7 of a step. A step's stream (seg; idx and vals,
//    or each lane's contributions) reaches shared memory by 16-byte
//    cp.async copies, neighbouring lanes on neighbouring 16-byte words (L1
//    bypassed), through a ring of SEGSUM_DEPTH (2) steps private to the
//    warp, so the next step is in flight while this one is scanned, with no
//    register held per byte in flight; lanes read their entries back by
//    16-byte loads. Scalar loads only at the stream's ragged end, or where
//    a pointer is not 16-byte aligned.
//  * Grid. Persistent: as many blocks as fit on the card at once (the
//    occupancy query, cached), each warp taking every (warps)-th step, so
//    that neighbouring warps read neighbouring memory at any time (one
//    contiguous span per warp, or carries every 4 steps, measured slower on
//    the column stream).
//  * Gathers. All lanes' gathers of a step (up to four lanes a pass) are
//    issued before its scan, so their latencies overlap. V may be
//    lanes-major (L, m) or a lanes-minor (m, L) view, which puts an entry's
//    lanes in one sector: the kernel takes V's two strides.
//  * Scan. A step's segmented scan is shuffles only, its head flags taken
//    once for all lanes (a ballot and five shift masks); each thread first
//    sums the runs inside its 8 entries serially. No __syncthreads: warps
//    share nothing.
//  * Writes. A step's run ends are compacted in shared memory in stream
//    order (one prefix sum for all lanes; one lane's sums at a time, which
//    keeps a warp's shared memory small and the warps per SM many) and
//    written by consecutive lanes:
//    neighbouring segments give coalesced read-modify-writes of out (plain
//    stores into the wrapper's zero-filled out), not one scattered 4-byte
//    store per thread and entry.
//  * No float atomics. Each segment has one owner. A run wholly inside a
//    step is written as above. A step's first and last runs, which may
//    continue in its neighbours, go to a carry stream: entries (first id,
//    first-run sum) and (last id, last-run sum) per step, (L, 2 * steps).
//    That stream is itself sorted, so the same kernel reduces it (contrib
//    form, into out), level after level until one step is left: T = 29.7M
//    entries take four launches (116K steps, then 907, then 8, then 1).
//    The order of every sum is fixed by the shapes and the card, so the
//    same inputs give the same bits in every run; a segment spanning every
//    step is reduced by a tree of steps, never by one thread. Untouched
//    segments keep their bits.
//
// Types. segment_sum_f32 and _f64 read, sum and write one type.
// segment_sum_bf16 reads bfloat16 vals, V and out (8 entries per 16-byte
// load), segment_sum_bf16_f32 the same vals and V into a float32 out (the
// solver's scores, kept in float32), and both do everything else in
// float32: each product w_l(v) * V is
// formed from the widened values (v * v squared in float32), the runs, the
// scan and the carry stream between steps and levels are float32 (a bf16
// carry would round again at every step boundary), and a segment is
// written once, on the level where its run closes, as its old value
// widened plus the sum, rounded to nearest even (__float2bfloat16_rn). The
// kernel is one template over (In, Acc, Out): the stream's type, the
// accumulate type and out's type; the carry levels of a bf16 call are
// <float, float, bf16>, those of float32 and float64 the first level's.
//
// Plain C interface, loaded with ctypes: pointers and the stream arrive as
// void*, and the entry returns the first nonzero cudaGetLastError() of its
// launches (cudaErrorInvalidValue when the workspace is too small).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifndef SEGSUM_DEPTH
#define SEGSUM_DEPTH 2        // steps of a warp's stream in flight or ready
#endif

#ifndef SEGSUM_VEC
#define SEGSUM_VEC 8          // entries a lane takes in a step
#endif

constexpr int kVec = SEGSUM_VEC;                // entries per lane and step
constexpr int kStep = 32 * kVec;                // 256 entries
constexpr int kMaxWarps = 8;                    // warps of a block, at most
constexpr int kSmemBudget = 200 * 1024;         // a block's shared memory
constexpr int kDepth = SEGSUM_DEPTH;
constexpr int kEnds = kStep + 4;                // run ends a step can hold
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kCarryAlign = 4;              // carry lane stride, entries

using bf16 = __nv_bfloat16;

// The three types of a launch: In, the type the stream's values and V are
// read in; Acc, the type every product, sum and carry is formed in; Out,
// the type of out. float32 and float64 take one type for all three (the
// arithmetic of the first versions); bfloat16 reads and writes bf16 and
// accumulates in float32, and its carry levels read the float32 carry
// stream (In = Acc = float, Out = bf16 or float). widen() reads a value into Acc,
// Narrow<Out>::of rounds an Acc into Out (to nearest even for bf16).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename Out>
struct Narrow {
  template <typename A>
  __device__ __forceinline__ static Out of(A v) { return static_cast<Out>(v); }
};
template <>
struct Narrow<bf16> {
  __device__ __forceinline__ static bf16 of(float v) {
    return __float2bfloat16_rn(v);
  }
};

template <typename In, typename Acc, typename Out>
struct Params {
  const In* vals;       // gather form (T,); contrib form (L, lane stride)
  int64_t vals_lane;
  const In* V;          // gather form: V[l * v_lane + idx * v_id]
  int64_t v_lane, v_id;
  const int* idx;
  const int* seg;
  Out* out;             // (L, S) contiguous
  int64_t S;
  Acc* carry_val;       // (L, carry_lane): 2 entries per step; null on
  int* carry_seg;       // the last level (one step)
  int64_t carry_lane;
  int64_t n;            // stream entries
  int L, square_from, accumulate, vec;
};

// Bytes of one step of the stream in a warp's ring: seg, then idx and vals
// (gather form) or the lanes' contributions (contrib form).
template <typename In, int NL, bool kGather>
__host__ __device__ constexpr int stage_bytes() {
  return kStep * (4 + (kGather ? 4 + static_cast<int>(sizeof(In))
                               : NL * static_cast<int>(sizeof(In))));
}

// Shared memory of one warp: its ring of kDepth steps, then the step's run
// ends compacted (segment ids, then one lane's sums at a time).
template <typename In, typename Acc, int NL, bool kGather>
__host__ __device__ constexpr int warp_smem_bytes() {
  return kDepth * stage_bytes<In, NL, kGather>() +
         kEnds * (4 + static_cast<int>(sizeof(Acc)));
}

// Warps of a block: as many as the shared-memory budget holds, up to 8.
template <typename In, typename Acc, int NL, bool kGather>
__host__ __device__ constexpr int block_warps() {
  return kSmemBudget / warp_smem_bytes<In, Acc, NL, kGather>() >= kMaxWarps
             ? kMaxWarps
             : (kSmemBudget / warp_smem_bytes<In, Acc, NL, kGather>() > 0
                    ? kSmemBudget / warp_smem_bytes<In, Acc, NL, kGather>()
                    : 1);
}

// kVec consecutive U of shared memory from a 16-byte boundary, by 16-byte
// loads (one for a lane's 8 bf16 entries).
template <typename U>
__device__ __forceinline__ void lds_vec(const U* p, U (&d)[kVec]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(U));
  static_assert(kVec % kPer == 0, "a lane's entries fill 16-byte words");
#pragma unroll
  for (int w = 0; w < kVec / kPer; ++w) {
    const int4 v = reinterpret_cast<const int4*>(p)[w];
    const U* u = reinterpret_cast<const U*>(&v);
#pragma unroll
    for (int e = 0; e < kPer; ++e) d[w * kPer + e] = u[e];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kStep * sizeof(U) bytes from global to a warp's stage: 16-byte copies,
// neighbouring lanes on neighbouring words.
template <typename U>
__device__ __forceinline__ void copy_row(U* dst, const U* src, int lane) {
  constexpr int kWords = kStep * static_cast<int>(sizeof(U)) / 16;
#pragma unroll
  for (int w = lane; w < kWords; w += 32)
    cp_async16(reinterpret_cast<char*>(dst) + 16 * w,
               reinterpret_cast<const char*>(src) + 16 * w);
}

// Stage one step (entries sbase .. sbase + kStep) of a warp's stream. Full
// steps of aligned streams by cp.async; the stream's ragged end, or
// unaligned pointers, by scalar loads, entries past the end joining its
// last segment with value 0 (idx -1: no gather).
template <typename In, typename Acc, typename Out, int NL, bool kGather>
__device__ __forceinline__ void stage_step(const Params<In, Acc, Out>& p,
                                           char* stage, int64_t sbase,
                                           int l0, int seg_pad, int lane) {
  int* sg = reinterpret_cast<int*>(stage);
  int* id = sg + kStep;
  In* tv = reinterpret_cast<In*>(sg + (kGather ? 2 : 1) * kStep);
  if (sbase + kStep <= p.n && p.vec) {
    copy_row(sg, p.seg + sbase, lane);
    if constexpr (kGather) {
      copy_row(id, p.idx + sbase, lane);
      copy_row(tv, p.vals + sbase, lane);
    } else {
#pragma unroll
      for (int j = 0; j < NL; ++j)
        if (l0 + j < p.L)
          copy_row(tv + j * kStep, p.vals + (l0 + j) * p.vals_lane + sbase,
                   lane);
    }
    return;
  }
  const In zero = Narrow<In>::of(0.0f);
  for (int k = lane; k < kStep; k += 32) {
    const int64_t i = sbase + k;
    const bool in = i < p.n;
    sg[k] = in ? p.seg[i] : seg_pad;
    if constexpr (kGather) {
      id[k] = in ? p.idx[i] : -1;
      tv[k] = in ? p.vals[i] : zero;
    } else {
#pragma unroll
      for (int j = 0; j < NL; ++j)
        if (l0 + j < p.L)
          tv[j * kStep + k] = in ? p.vals[(l0 + j) * p.vals_lane + i] : zero;
    }
  }
}

// Shift masks of the segmented Hillis-Steele scan across the warp: bit k set
// when this lane adds the partial of lane - 2^k, i.e. no run starts in
// lanes (lane - 2^k, lane]. `heads` holds one bit per lane.
__device__ __forceinline__ unsigned scan_takes(unsigned heads, int lane) {
  unsigned takes = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int d = 1 << k;
    if (lane >= d && ((heads >> (lane - d + 1)) & ((1u << d) - 1u)) == 0)
      takes |= 1u << k;
  }
  return takes;
}

template <typename T>
__device__ __forceinline__ T warp_scan(T v, unsigned takes) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const T o = __shfl_up_sync(kFull, v, 1 << k);
    if ((takes >> k) & 1u) v += o;
  }
  return v;
}

template <typename In, typename Acc, typename Out, int NL, bool kGather>
__global__ void __launch_bounds__(kMaxWarps * 32)
segment_sum_kernel(const Params<In, Acc, Out> p) {
  constexpr int kWarps = block_warps<In, Acc, NL, kGather>();
  extern __shared__ __align__(16) char smem[];
  constexpr int kStage = stage_bytes<In, NL, kGather>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  char* ring = smem + warp * warp_smem_bytes<In, Acc, NL, kGather>();
  int* end_seg = reinterpret_cast<int*>(ring + kDepth * kStage);
  Acc* end_val = reinterpret_cast<Acc*>(end_seg + kEnds);   // [kEnds]
  // The warp takes steps first, first + stride, ...: neighbouring warps
  // read neighbouring memory at any time.
  const int64_t nsteps = (p.n + kStep - 1) / kStep;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  if (first >= nsteps) return;                   // the whole warp
  const int seg_pad = __ldg(p.seg + p.n - 1);
  const bool last_level = p.carry_val == nullptr;

  for (int l0 = 0; l0 < p.L; l0 += NL) {
#pragma unroll
    for (int q = 0; q < kDepth - 1; ++q) {
      if (first + q * stride < nsteps)
        stage_step<In, Acc, Out, NL, kGather>(
            p, ring + q * kStage, (first + q * stride) * kStep, l0, seg_pad,
            lane);
      cp_async_commit();
    }

#pragma unroll 1
    for (int64_t q = 0, step = first; step < nsteps; ++q, step += stride) {
      __syncwarp();      // every lane is done with the slot refilled here
      const int64_t ahead = step + (kDepth - 1) * stride;
      if (ahead < nsteps)
        stage_step<In, Acc, Out, NL, kGather>(
            p, ring + ((q + kDepth - 1) % kDepth) * kStage, ahead * kStep,
            l0, seg_pad, lane);
      cp_async_commit();
      cp_async_wait<kDepth - 1>();   // this lane's copies of this step
      __syncwarp();                  // ... and every lane's
      const char* stage = ring + (q % kDepth) * kStage;
      const int* ssg = reinterpret_cast<const int*>(stage);
      const In* stv = reinterpret_cast<const In*>(
          ssg + (kGather ? 2 : 1) * kStep);
      int sg[kVec];
      lds_vec(ssg + lane * kVec, sg);
      if (!last_level && l0 == 0) {              // the step's end ids
        if (lane == 0) p.carry_seg[2 * step] = sg[0];
        if (lane == 31) p.carry_seg[2 * step + 1] = sg[kVec - 1];
      }

      // contributions in Acc (every lane's gathers issued before the scan)
      Acc c[NL][kVec];
      if constexpr (kGather) {
        int id[kVec];
        lds_vec(ssg + kStep + lane * kVec, id);
        In tv[kVec];
        lds_vec(stv + lane * kVec, tv);
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          const int l = l0 + j;
          const bool sq = l >= p.square_from;
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            Acc v = Acc(0);
            if (l < p.L && id[k] >= 0) {
              const Acc x = widen(tv[k]);
              const Acc w = sq ? x * x : x;
              v = w * widen(__ldg(p.V + l * p.v_lane + id[k] * p.v_id));
            }
            c[j][k] = v;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < NL; ++j) {
          const bool sq = l0 + j >= p.square_from;
          if (l0 + j < p.L) {
            In raw[kVec];
            lds_vec(stv + j * kStep + lane * kVec, raw);
#pragma unroll
            for (int k = 0; k < kVec; ++k) c[j][k] = widen(raw[k]);
          } else {
#pragma unroll
            for (int k = 0; k < kVec; ++k) c[j][k] = Acc(0);
          }
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            if (sq) c[j][k] *= c[j][k];
        }
      }

      // run structure, the same for every lane l (every shuffle runs on
      // all 32 lanes): hb = a run starts at this entry, eb = a run ends at
      // this entry, fr = the entry is in the step's first run
      const int up = __shfl_up_sync(kFull, sg[kVec - 1], 1);
      int prev = lane > 0 ? up : sg[0];
      unsigned hb = 0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (sg[k] != prev) hb |= 1u << k;
        prev = sg[k];
      }
      const unsigned down = __shfl_down_sync(kFull, hb & 1u, 1);
      const unsigned eb = (hb >> 1) | ((lane < 31 ? down : 1u) << (kVec - 1));
      const unsigned heads = __ballot_sync(kFull, hb != 0);
      const unsigned takes = scan_takes(heads, lane);
      unsigned fr = 0;
      if ((heads & ((1u << lane) - 1u)) == 0)
        fr = hb ? (1u << (__ffs(hb) - 1)) - 1u : (1u << kVec) - 1u;
      // the step's last entry ends its last run
      const unsigned last = lane == 31 ? 1u << (kVec - 1) : 0u;
      // Run ends written to out: all of them on the last level (one step),
      // else those of runs wholly inside the step. They are compacted in
      // shared memory, in stream order, and written by consecutive lanes,
      // so neighbouring segments give coalesced read-modify-writes. The
      // step's first and last runs go to the carry stream instead.
      const unsigned ib = last_level ? eb : eb & ~fr & ~last;
      const int cnt = __popc(ib);
      int incl_cnt = cnt;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int o = __shfl_up_sync(kFull, incl_cnt, 1 << k);
        if (lane >= (1 << k)) incl_cnt += o;
      }
      const int at = incl_cnt - cnt;            // this thread's first slot
      const int total = __shfl_sync(kFull, incl_cnt, 31);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if ((ib >> k) & 1u)
          end_seg[at + __popc(ib & ((1u << k) - 1u))] = sg[k];

#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const int l = l0 + j;
        if (l >= p.L) break;
        Acc tail = Acc(0);  // this thread's last run, its own entries only
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          tail = ((hb >> k) & 1u) ? c[j][k] : tail + c[j][k];
        const Acc incl = warp_scan(tail, takes);
        Acc acc = __shfl_up_sync(kFull, incl, 1);
        if (lane == 0) acc = Acc(0);
        if (j > 0) __syncwarp();   // the previous lane's sums are written
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          acc = ((hb >> k) & 1u) ? c[j][k] : acc + c[j][k];
          if ((ib >> k) & 1u) {
            end_val[at + __popc(ib & ((1u << k) - 1u))] = acc;
          } else if (!last_level && ((eb >> k) & 1u)) {
            Acc* cv = p.carry_val + l * p.carry_lane + 2 * step;
            if ((last >> k) & 1u) {
              cv[1] = acc;                       // the step's last run
              if (heads == 0) cv[0] = Acc(0);    // ... is also its first
            } else {
              cv[0] = acc;                       // the step's first run
            }
          }
        }
        __syncwarp();
        // each segment is written once, on the level where its run ends
        // inside a step: out's value widened, the sum added in Acc, one
        // rounding into Out
        for (int i = lane; i < total; i += 32) {
          const int sid = end_seg[i];
          if (sid < 0 || sid >= p.S) continue;   // ids are validated by the
          Out* o = p.out + l * p.S + sid;        // caller; others drop
#ifdef SEGSUM_ABLATE_NO_STORE
          if (end_val[i] == Acc(12345)) *o = Narrow<Out>::of(Acc(0));  // probe
#else
          *o = Narrow<Out>::of(p.accumulate ? widen(*o) + end_val[i]
                                            : end_val[i]);
#endif
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();        // the ring is refilled by the next lane pass
  }
}

// Lanes a pass takes: L up to 4, else 3 or 4 (the 2L = 6 lanes of the
// gradient + diagonal pass as two passes of 3: more warps per SM, whose
// gathers in flight matter more than the re-read stream).
int lanes_per_pass(int L) {
  if (L <= 4) return L;
  return L % 3 == 0 ? 3 : 4;
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t round_up(int64_t a, int64_t b) { return ceil_div(a, b) * b; }

template <typename In, typename Acc, int NL, bool kGather>
constexpr int smem_bytes() {
  return block_warps<In, Acc, NL, kGather>() *
         warp_smem_bytes<In, Acc, NL, kGather>();
}

// Warps of a kernel that fit on the card at once (blocks per SM from the
// occupancy query, times the SMs); 0 when a query fails. Asked once per
// build: a process drives one kind of card.
template <typename In, typename Acc, typename Out, int NL, bool kGather>
int64_t warps_on_card() {
  static int64_t warps = 0;
  if (warps == 0) {
    auto* kernel = segment_sum_kernel<In, Acc, Out, NL, kGather>;
    constexpr int kSmem = smem_bytes<In, Acc, NL, kGather>();
    constexpr int kWarps = block_warps<In, Acc, NL, kGather>();
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, 32 * kWarps, kSmem) != cudaSuccess)
      return 0;
    warps = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) * kWarps;
  }
  return warps;
}

template <typename In, typename Acc, bool kGather>
int64_t level_block_warps(int L) {
  switch (lanes_per_pass(L)) {
    case 1: return block_warps<In, Acc, 1, kGather>();
    case 2: return block_warps<In, Acc, 2, kGather>();
    case 3: return block_warps<In, Acc, 3, kGather>();
    default: return block_warps<In, Acc, 4, kGather>();
  }
}

template <typename In, typename Acc, typename Out, bool kGather>
int64_t level_warps(int L) {
  switch (lanes_per_pass(L)) {
    case 1: return warps_on_card<In, Acc, Out, 1, kGather>();
    case 2: return warps_on_card<In, Acc, Out, 2, kGather>();
    case 3: return warps_on_card<In, Acc, Out, 3, kGather>();
    default: return warps_on_card<In, Acc, Out, 4, kGather>();
  }
}

// One level's launch: its steps and the persistent grid's blocks (no more
// warps than fit on the card at once, nor than steps); zero steps when the
// occupancy query fails.
struct Plan {
  int64_t steps, blocks;
};

template <typename In, typename Acc, typename Out>
Plan level_plan(int64_t n, int L, bool gather) {
  const int64_t warps = gather ? level_warps<In, Acc, Out, true>(L)
                               : level_warps<In, Acc, Out, false>(L);
  if (warps <= 0) return {0, 0};
  const int64_t steps = ceil_div(n, kStep);
  const int64_t per_block = gather ? level_block_warps<In, Acc, true>(L)
                                   : level_block_warps<In, Acc, false>(L);
  return {steps, ceil_div(steps < warps ? steps : warps, per_block)};
}

int64_t carry_lane(int64_t steps) { return round_up(2 * steps, kCarryAlign); }

int64_t carry_bytes(int64_t steps, int64_t L, int64_t itemsize) {
  return round_up(L * carry_lane(steps) * itemsize, 16) +
         round_up(carry_lane(steps) * 4, 16);
}

// Bytes of carry stream (in Acc) all levels need; -1 on a failed query.
// The first level reads In, the carry levels Acc.
template <typename In, typename Acc, typename Out>
int64_t workspace(int64_t n, int64_t L, bool gather) {
  int64_t total = 0;
  for (bool first = true;; first = false) {
    const Plan plan =
        first ? level_plan<In, Acc, Out>(n, static_cast<int>(L), gather)
              : level_plan<Acc, Acc, Out>(n, static_cast<int>(L), false);
    if (plan.steps == 0) return -1;
    if (plan.steps == 1) return total;
    total += carry_bytes(plan.steps, L, sizeof(Acc));
    n = 2 * plan.steps;
  }
}

template <typename In, typename Acc, typename Out, int NL, bool kGather>
void launch_kernel(const Params<In, Acc, Out>& p, int64_t blocks,
                   cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<In, Acc, NL, kGather>();
  const dim3 grid(static_cast<unsigned>(blocks));
  constexpr int kThreads = 32 * block_warps<In, Acc, NL, kGather>();
  segment_sum_kernel<In, Acc, Out, NL, kGather>
      <<<grid, kThreads, kSmem, stream>>>(p);
}

template <typename In, typename Acc, typename Out, bool kGather>
cudaError_t launch_level(const Params<In, Acc, Out>& p, int64_t blocks,
                         cudaStream_t stream) {
  switch (lanes_per_pass(p.L)) {
    case 1: launch_kernel<In, Acc, Out, 1, kGather>(p, blocks, stream); break;
    case 2: launch_kernel<In, Acc, Out, 2, kGather>(p, blocks, stream); break;
    case 3: launch_kernel<In, Acc, Out, 3, kGather>(p, blocks, stream); break;
    default: launch_kernel<In, Acc, Out, 4, kGather>(p, blocks, stream); break;
  }
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// One level: its carry stream carved from the workspace (none on the last
// level, one step), then its launch. Returns the CUDA error, or
// cudaErrorInvalidValue when the workspace is too small; *steps gets the
// level's steps (0 on a failed occupancy query).
template <typename In, typename Acc, typename Out>
int run_level(Params<In, Acc, Out>& p, bool gather, char* ws, int64_t& used,
              int64_t workspace_bytes, cudaStream_t stream, int64_t* steps) {
  const Plan plan = level_plan<In, Acc, Out>(p.n, p.L, gather);
  *steps = plan.steps;
  if (plan.steps == 0) return static_cast<int>(cudaGetLastError());
  p.carry_val = nullptr;
  p.carry_seg = nullptr;
  p.carry_lane = 0;
  if (plan.steps > 1) {
    p.carry_lane = carry_lane(plan.steps);
    const int64_t bytes = carry_bytes(plan.steps, p.L, sizeof(Acc));
    if (used + bytes > workspace_bytes) return cudaErrorInvalidValue;
    p.carry_val = reinterpret_cast<Acc*>(ws + used);
    p.carry_seg = reinterpret_cast<int*>(
        ws + used + round_up(p.L * p.carry_lane * sizeof(Acc), 16));
    used += bytes;
  }
  const cudaError_t err =
      gather ? launch_level<In, Acc, Out, true>(p, plan.blocks, stream)
             : launch_level<In, Acc, Out, false>(p, plan.blocks, stream);
  return static_cast<int>(err);
}

template <typename In, typename Acc, typename Out>
int run(const void* vals, long long vals_lane, const void* V,
        long long v_lane, long long v_id, const void* idx, const void* seg,
        void* out, long long L, long long n, long long S,
        long long square_from, int accumulate, void* workspace_ptr,
        long long workspace_bytes, void* stream_ptr) {
  if (L <= 0 || n <= 0 || S <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool gather = V != nullptr;
  Params<In, Acc, Out> p{};
  p.vals = static_cast<const In*>(vals);
  p.vals_lane = vals_lane;
  p.V = static_cast<const In*>(V);
  p.v_lane = v_lane;
  p.v_id = v_id;
  p.idx = static_cast<const int*>(idx);
  p.seg = static_cast<const int*>(seg);
  p.out = static_cast<Out*>(out);
  p.S = S;
  p.n = n;
  p.L = static_cast<int>(L);
  p.square_from = static_cast<int>(square_from < L ? square_from : L);
  p.accumulate = accumulate;
  p.vec = aligned16(vals) && aligned16(seg) &&
          (gather ? aligned16(idx)
                  : (vals_lane * static_cast<long long>(sizeof(In))) % 16 ==
                        0);
  char* ws = static_cast<char*>(workspace_ptr);
  int64_t used = 0, steps = 0;
  int err = run_level(p, gather, ws, used, workspace_bytes, stream, &steps);
  if (err != 0 || steps <= 1) return err;
  // the carry stream: (L, 2 * steps) partial sums in Acc, added into out
  // level after level until one step is left
  Params<Acc, Acc, Out> c{};
  c.vals = p.carry_val;
  c.vals_lane = p.carry_lane;
  c.seg = p.carry_seg;
  c.out = p.out;
  c.S = S;
  c.n = 2 * steps;
  c.L = p.L;
  c.square_from = p.L;
  c.accumulate = 1;
  c.vec = 1;
  for (;;) {
    err = run_level(c, false, ws, used, workspace_bytes, stream, &steps);
    if (err != 0 || steps <= 1) return err;
    c.vals = c.carry_val;
    c.vals_lane = c.carry_lane;
    c.seg = c.carry_seg;
    c.n = 2 * steps;
  }
}

}  // namespace

extern "C" {

// vals: the gather form's (n,) entry values, or the contrib form's (L, n)
// contributions with lane stride vals_lane. V: null for the contrib form,
// else read as V[l * v_lane + idx[i] * v_id]. seg (n,) int32 non-decreasing;
// out (L, S) contiguous, added into when accumulate is nonzero, else
// zero-filled by the caller. workspace: segment_sum_workspace_bytes(n, L,
// itemsize) bytes. Returns 0 or the first CUDA error of the launches.
int segment_sum_f32(const void* vals, long long vals_lane, const void* V,
                    long long v_lane, long long v_id, const void* idx,
                    const void* seg, void* out, long long L, long long n,
                    long long S, long long square_from, int accumulate,
                    void* workspace, long long workspace_bytes,
                    void* stream) {
  return run<float, float, float>(vals, vals_lane, V, v_lane, v_id, idx, seg,
                                  out, L, n, S, square_from, accumulate,
                                  workspace, workspace_bytes, stream);
}

int segment_sum_f64(const void* vals, long long vals_lane, const void* V,
                    long long v_lane, long long v_id, const void* idx,
                    const void* seg, void* out, long long L, long long n,
                    long long S, long long square_from, int accumulate,
                    void* workspace, long long workspace_bytes,
                    void* stream) {
  return run<double, double, double>(vals, vals_lane, V, v_lane, v_id, idx,
                                     seg, out, L, n, S, square_from,
                                     accumulate, workspace, workspace_bytes,
                                     stream);
}

// bfloat16 vals, V and out; products, sums and the carry stream in float32;
// one rounding into out per segment.
int segment_sum_bf16(const void* vals, long long vals_lane, const void* V,
                     long long v_lane, long long v_id, const void* idx,
                     const void* seg, void* out, long long L, long long n,
                     long long S, long long square_from, int accumulate,
                     void* workspace, long long workspace_bytes,
                     void* stream) {
  return run<bf16, float, bf16>(vals, vals_lane, V, v_lane, v_id, idx, seg,
                                out, L, n, S, square_from, accumulate,
                                workspace, workspace_bytes, stream);
}

// bfloat16 vals and V into a float32 out; the arithmetic of
// segment_sum_bf16, and the sum added into out without a rounding.
int segment_sum_bf16_f32(const void* vals, long long vals_lane, const void* V,
                         long long v_lane, long long v_id, const void* idx,
                         const void* seg, void* out, long long L, long long n,
                         long long S, long long square_from, int accumulate,
                         void* workspace, long long workspace_bytes,
                         void* stream) {
  return run<bf16, float, float>(vals, vals_lane, V, v_lane, v_id, idx, seg,
                                 out, L, n, S, square_from, accumulate,
                                 workspace, workspace_bytes, stream);
}

// Bytes of carry stream that the entry points need for n entries and L
// lanes, gather form or not (the wrapper allocates them); itemsize and
// out_itemsize name the entry point (4 4, 8 8, 2 2 or 2 4); -1 when the
// occupancy query fails.
long long segment_sum_workspace_bytes(long long n, long long L,
                                      long long itemsize,
                                      long long out_itemsize, int gather) {
  if (n <= 0 || L <= 0) return 0;
  switch (itemsize) {
    case 8: return workspace<double, double, double>(n, L, gather != 0);
    case 2:
      return out_itemsize == 4
                 ? workspace<bf16, float, float>(n, L, gather != 0)
                 : workspace<bf16, float, bf16>(n, L, gather != 0);
    default: return workspace<float, float, float>(n, L, gather != 0);
  }
}

}  // extern "C"
