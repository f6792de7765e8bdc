// The int16 probe kernels, for sm_90a: one unit kernel per probe site of
// benchmarks/probe_i16/{a..i}.py (P1-P9), each body a fragment of the banded
// DP step on a [T, B] int16 block, computed with the device functions that
// the scorers of banded_dp.cu run (dp_core.cuh).  A change to the DP step
// that breaks a fragment breaks its probe first.
//
// Semantics are JAX's int16 semantics, bit for bit: adds and subtracts wrap
// modulo 2^16, >> is arithmetic, a cast of a negative value to uint16 wraps,
// an int32-widened min narrows back.  So the bodies compute in int16_t
// (ProbeOps), or on two int16 at once that wrap the same way (ProbeOps2),
// not in the scorers' int32 registers.
//
// Two layouts, by what a body reads:
// - elementwise bodies (no other lane's value): a grid-stride loop over
//   16-byte vectors, eight int16 a thread, lane = index mod B, with a grid
//   of a few blocks per SM;
// - row bodies (lane shifts, Kogge-Stone scans, row reductions, the DP step
//   and its pieces): one warp per row, several rows per block, B / 32 values
//   a thread in registers, every exchange a shuffle of dp_core's warp-level
//   pieces, in the Kogge-Stone order of the block-level ones.  No barrier.
//   narrow_out (a.py's first lane of each row) reads that lane alone.
// B is 64, 128 or 256; any other lane count is refused.
// What bounds it: bytes.  A body does a few int16 operations on each element
// it reads once and writes once (the scans log2(B) rounds of a few), far
// below the card's operation rate, so the bound is 2 bytes in and 2 out an
// element at the card's memory rate.

#include <array>
#include <cstdint>
#include <cstring>
#include <utility>

#include <cuda_runtime.h>

#include "dp_core.cuh"

namespace {

using namespace dp;
using i16 = int16_t;

// the bodies in the probes' order, stage by stage
enum Body : int {
  // a
  kCopy, kAddSat, kConcatShift, kWhereIota, kSelectCast, kWidenReduce, kNarrowOut,
  kScratchI16, kKoggeStone,
  // b
  kAddFull, kAddOnlyScalar, kMinOnlyScalar, kKsFull,
  // c
  kMinWhere, kKsWhere, kReduceI32,
  // d
  kAmin, kKsAmin,
  // e
  kSub, kShr, kBand, kVecAdd,
  // f
  kI32Min, kU16Min, kF32Min, kMulSel, kI32Cmp,
  // g
  kReduce, kWhere1d, kWhere1dI32Cmp, kSelect2, kStep,
  // h
  kS1Diag, kS2Ins, kS3ChainOpen, kS4KsLoop,
  // i
  kAScalarSelectAdd, kBAddImin, kCSelectOfImin, kDSelectFeedImin,
  kNumBodies
};
constexpr int kStageStart[10] = {0, 9, 13, 16, 18, 22, 27, 32, 36, 40};
static_assert(kStageStart[9] == kNumBodies, "one entry per stage");

// bodies whose output is one value a row ([T, 1])
__host__ __device__ constexpr bool reduces(int body) {
  return body == kWidenReduce || body == kNarrowOut || body == kReduceI32 ||
         body == kReduce || body == kWhere1d || body == kWhere1dI32Cmp;
}
// bodies that read other lanes of their row, or reduce it
__host__ __device__ constexpr bool row_body(int body) {
  return reduces(body) || body == kConcatShift || body == kKoggeStone || body == kKsFull ||
         body == kKsWhere || body == kKsAmin || body == kStep || body == kS2Ins ||
         body == kS3ChainOpen || body == kS4KsLoop;
}

constexpr i16 kInf = kInf16;
constexpr i16 kMinConst = 37;  // f.py's CONST
constexpr int kEwThreads = 256;
constexpr int kEwVecs = 2;  // 16-byte vectors a thread of the elementwise layout
constexpr int kEwBlocksPerSm = 8;
constexpr int kRowWarps = 8;  // rows a block of the row layout

// the Kogge-Stone bodies of a, b, c and d extend by step * 3 (d with the
// arithmetic min); g.step and h.*: ins_open 63, ins_ext 18, del_open 60,
// del_ext 15
__device__ __forceinline__ ProbeOps<false> ks_ops() { return {0, 0, 0, 3}; }
__device__ __forceinline__ ProbeOps<true> amin_ops() { return {0, 0, 0, 3}; }
__device__ __forceinline__ ProbeOps<false> step_ops() { return {63, 18, 60, 15}; }

__device__ __forceinline__ i16 best0(int k) { return k <= 100 ? i16(0) : kInf; }

// One element of an elementwise body at lane k.
template <int kBody>
__device__ __forceinline__ i16 element(i16 v, int k) {
  const auto ops = ks_ops();
  if constexpr (kBody == kCopy || kBody == kScratchI16) return v;
  if constexpr (kBody == kAddSat || kBody == kAddFull || kBody == kBAddImin) {
    return ops.sat(ops.add(v, 3));
  }
  if constexpr (kBody == kWhereIota) return k < 40 ? v : i16(5);
  if constexpr (kBody == kSelectCast) return v == 1 ? 0 : v == 2 ? 1 : v == 4 ? 2 : v == 8 ? 3 : 4;
  if constexpr (kBody == kAddOnlyScalar) return ops.add(v, 3);
  if constexpr (kBody == kMinOnlyScalar) return ops.min(v, 90);
  if constexpr (kBody == kMinWhere) return ops.min(ops.add(v, 7), 50);
  if constexpr (kBody == kAmin) return amin_ops().min(ops.add(v, 7), 50);
  if constexpr (kBody == kSub) return static_cast<i16>(v - 3);
  if constexpr (kBody == kShr) return static_cast<i16>(v >> 15);
  if constexpr (kBody == kBand) return static_cast<i16>(v & 7);
  if constexpr (kBody == kVecAdd) return ops.add(v, v);
  if constexpr (kBody == kI32Min) return static_cast<i16>(vmin<int>(ops.add(v, 7), kMinConst));
  if constexpr (kBody == kU16Min) {
    return static_cast<i16>(vmin<uint16_t>(static_cast<uint16_t>(ops.add(v, 7)), kMinConst));
  }
  if constexpr (kBody == kF32Min) {
    return static_cast<i16>(fminf(static_cast<float>(ops.add(v, 7)), static_cast<float>(kMinConst)));
  }
  if constexpr (kBody == kMulSel) {
    const i16 d = static_cast<i16>(ops.add(v, 7) - kMinConst);
    const i16 neg = static_cast<i16>((d >> 15) & 1);
    return static_cast<i16>(kMinConst + static_cast<i16>(d * neg));
  }
  if constexpr (kBody == kI32Cmp) {
    const i16 a = ops.add(v, 7);
    return static_cast<int>(a) < static_cast<int>(kMinConst) ? a : i16(kMinConst);
  }
  if constexpr (kBody == kSelect2) return k < 50 ? v : i16(3);
  if constexpr (kBody == kS1Diag) return dp_diag(step_ops(), best0(k), v, k < 120);
  if constexpr (kBody == kAScalarSelectAdd) return ops.add(best0(k), v);
  if constexpr (kBody == kCSelectOfImin) return k < 120 ? ops.sat(ops.add(v, 3)) : kInf;
  if constexpr (kBody == kDSelectFeedImin) return dp_diag(ops, best0(k), v, true);
  return 0;
}

// Elementwise bodies: vector i holds elements [8i, 8i + 8) of the flat
// [rows, B] block (B a multiple of 8, so all eight lie in one row);
// `lane_mask` is B - 1 (B a power of two).  A block takes kEwVecs *
// kEwThreads vectors at a time, each thread kEwVecs of them, all loads
// issued before the first store.
template <int kBody>
__global__ void __launch_bounds__(kEwThreads) probe_elementwise_kernel(
    const int4* __restrict__ x, int4* __restrict__ out, int64_t num_vectors, int lane_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* const scratch = reinterpret_cast<int4*>(smem);  // kEwVecs vectors a thread
  constexpr int64_t kChunk = static_cast<int64_t>(kEwThreads) * kEwVecs;
  for (int64_t base = blockIdx.x * kChunk; base < num_vectors; base += gridDim.x * kChunk) {
    int4 raw[kEwVecs];
#pragma unroll
    for (int j = 0; j < kEwVecs; ++j) {
      const int64_t i = base + j * kEwThreads + threadIdx.x;
      if (i < num_vectors) raw[j] = x[i];
    }
#pragma unroll
    for (int j = 0; j < kEwVecs; ++j) {
      const int64_t i = base + j * kEwThreads + threadIdx.x;
      if (i >= num_vectors) continue;
      if constexpr (kBody == kScratchI16) {  // through scratch memory, as a.py's VMEM scratch
        scratch[j * kEwThreads + threadIdx.x] = raw[j];
        __threadfence_block();  // the load below reads shared memory, not the register
        raw[j] = scratch[j * kEwThreads + threadIdx.x];
      }
      const int k0 = static_cast<int>((i * 8) & lane_mask);
      i16 v[8];
      static_assert(sizeof(v) == sizeof(int4), "eight int16 a vector");
      memcpy(v, &raw[j], sizeof(v));
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = element<kBody>(v[e], k0 + e);
      memcpy(&raw[j], v, sizeof(v));
      out[i] = raw[j];
    }
  }
}

template <int P>
__device__ __forceinline__ void load_row(const i16* src, uint32_t (&v)[P]) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  if constexpr (P == 4) {
    const uint4 r = *reinterpret_cast<const uint4*>(s);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  } else if constexpr (P == 2) {
    const uint2 r = *reinterpret_cast<const uint2*>(s);
    v[0] = r.x; v[1] = r.y;
  } else {
    v[0] = s[0];
  }
}

template <int P>
__device__ __forceinline__ void store_row(i16* dst, const uint32_t (&v)[P]) {
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  if constexpr (P == 4) {
    *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
  } else if constexpr (P == 2) {
    *reinterpret_cast<uint2*>(d) = make_uint2(v[0], v[1]);
  } else {
    d[0] = v[0];
  }
}

// per-half masks of a lane condition over the thread's lanes
template <int P, class Cond>
__device__ __forceinline__ void lane_masks(int k0, Cond cond, uint32_t (&mask)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) mask[p] = mask2(cond(k0 + 2 * p), cond(k0 + 2 * p + 1));
}

template <int P, class Cond>
__device__ __forceinline__ void select_lanes(int k0, Cond cond, const uint32_t (&a)[P], i16 b,
                                             uint32_t (&out)[P]) {
  uint32_t mask[P];
  lane_masks<P>(k0, cond, mask);
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = select2(mask[p], a[p], splat2(b));
}

// The min of the row's lanes, each thread's own lanes first.
template <int P>
__device__ __forceinline__ i16 row_min(const uint32_t (&v)[P]) {
  int m = lo16(v[0]);
#pragma unroll
  for (int p = 0; p < P; ++p) m = vmin(vmin(m, lo16(v[p])), hi16(v[p]));
  return static_cast<i16>(warp_min(m));
}

// Row bodies: one warp per row of 64 * P lanes, thread t holding lanes
// [2P t, 2P t + 2P).
template <int kBody, int P>
__global__ void __launch_bounds__(32 * kRowWarps) probe_row_kernel(
    const i16* __restrict__ x, i16* __restrict__ out, int64_t rows) {
  constexpr int kLanes = 64 * P;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowWarps + warp;
  if (row >= rows) return;  // the whole warp
  if constexpr (kBody == kNarrowOut) {  // lane 0 alone: no other lane of the row is read
    if (t == 0) out[row] = x[row * kLanes];
    return;
  }
  const int k0 = 2 * P * t;
  uint32_t v[P], o[P];
  load_row<P>(x + row * kLanes + k0, v);
  const ProbeOps2<false> ops{ks_ops()};
  const ProbeOps2<true> amin{amin_ops()};
  const ProbeOps2<false> step{step_ops()};
  const uint32_t inf = splat2(kInf);

  if constexpr (reduces(kBody)) {
    i16 r = row_min<P>(v);
    if constexpr (kBody == kWhere1d || kBody == kWhere1dI32Cmp) r = r > 0 ? r : i16(7);
    if (t == 0) out[row] = r;
    return;
  } else {
    if constexpr (kBody == kConcatShift) {
      warp_shift_up_x2<1, P>(v, o, splat2(7), t);
    } else if constexpr (kBody == kKoggeStone || kBody == kKsFull || kBody == kKsWhere) {
      dp_ks_scan_w(ops, v, t);
#pragma unroll
      for (int p = 0; p < P; ++p) o[p] = v[p];
    } else if constexpr (kBody == kKsAmin) {
      dp_ks_scan_w(amin, v, t);
#pragma unroll
      for (int p = 0; p < P; ++p) o[p] = v[p];
    } else if constexpr (kBody == kS4KsLoop) {
      dp_ks_scan_w(step, v, t);
#pragma unroll
      for (int p = 0; p < P; ++p) o[p] = v[p];
    } else if constexpr (kBody == kS3ChainOpen) {
      uint32_t best_after[P];
      select_lanes<P>(k0, [](int k) { return k <= 100; }, v, kInf, best_after);
      dp_chain_open_w(step, best_after, o, t);
    } else {
      // g.step and h.s2: best starts at best0, ins at INF; the window cell
      // is valid below lane 120
      uint32_t best[P], ins[P], live[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        best[p] = pack2(best0(k0 + 2 * p), best0(k0 + 2 * p + 1));
        ins[p] = inf;
      }
      lane_masks<P>(k0, [](int k) { return k < 120; }, live);
      if constexpr (kBody == kStep) {
        // best and ins through the warp's scratch rows, as g.py's VMEM scratch
        uint32_t* const best_s = reinterpret_cast<uint32_t*>(smem) + warp * 2 * 32 * P;
        uint32_t* const ins_s = best_s + 32 * P;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          best_s[P * t + p] = best[p];
          ins_s[P * t + p] = ins[p];
        }
        __syncwarp();
#pragma unroll
        for (int p = 0; p < P; ++p) {
          best[p] = best_s[P * t + p];
          ins[p] = ins_s[P * t + p];
        }
        dp_step_w(step, v, live, best, ins, t);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          best_s[P * t + p] = best[p];
          ins_s[P * t + p] = ins[p];
          o[p] = best[p];
        }
      } else {  // kS2Ins
        uint32_t diag_new[P], ins_new[P];
        dp_diag_w(step, best, v, live, diag_new);
        dp_ins_shift_w(step, best, ins, ins_new, t);
#pragma unroll
        for (int p = 0; p < P; ++p) o[p] = step.min(diag_new[p], ins_new[p]);
      }
    }
    store_row<P>(out + row * kLanes + k0, o);
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    return 0;
  }
  return sms;
}

using Launch = int (*)(const i16*, i16*, int64_t, int, cudaStream_t);

template <int kBody>
int launch_body(const i16* x, i16* out, int64_t rows, int lanes, cudaStream_t stream) {
  if constexpr (row_body(kBody)) {
    const auto grid = static_cast<unsigned>((rows + kRowWarps - 1) / kRowWarps);
    const size_t smem = kBody == kStep ? kRowWarps * 2 * 32 * 4 * sizeof(uint32_t) : 0;
    if (lanes == 64) {
      probe_row_kernel<kBody, 1><<<grid, 32 * kRowWarps, smem, stream>>>(x, out, rows);
    } else if (lanes == 128) {
      probe_row_kernel<kBody, 2><<<grid, 32 * kRowWarps, smem, stream>>>(x, out, rows);
    } else {
      probe_row_kernel<kBody, 4><<<grid, 32 * kRowWarps, smem, stream>>>(x, out, rows);
    }
  } else {
    const int64_t vectors = rows * lanes / 8;
    const int64_t cap = static_cast<int64_t>(kEwBlocksPerSm) * (sm_count() > 0 ? sm_count() : 1);
    int64_t grid = (vectors + kEwThreads * kEwVecs - 1) / (kEwThreads * kEwVecs);
    grid = grid < cap ? grid : cap;
    const size_t smem = kBody == kScratchI16 ? kEwThreads * kEwVecs * sizeof(int4) : 0;
    probe_elementwise_kernel<kBody><<<static_cast<unsigned>(grid), kEwThreads, smem, stream>>>(
        reinterpret_cast<const int4*>(x), reinterpret_cast<int4*>(out), vectors, lanes - 1);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int... kBodies>
constexpr std::array<Launch, sizeof...(kBodies)> launch_table(std::integer_sequence<int, kBodies...>) {
  return {&launch_body<kBodies>...};
}
constexpr auto kLaunch = launch_table(std::make_integer_sequence<int, kNumBodies>{});

}  // namespace

// Runs body `body` of stage `stage` (0 = a ... 8 = i) on x [rows, lanes]
// into out: [rows, 1] where the body reduces a row (out_cols == 1), else
// [rows, lanes].  x and out are 16-byte aligned.  Returns the CUDA error,
// cudaErrorInvalidValue for a stage, body or shape the kernel does not take
// (lanes other than 64, 128 or 256).
extern "C" int mapper_probe_i16(int stage, int body, const int16_t* x, int16_t* out,
                                int64_t rows, int lanes, int out_cols, void* stream) {
  if (stage < 0 || stage > 8 || body < 0 || body >= kStageStart[stage + 1] - kStageStart[stage] ||
      (lanes != 64 && lanes != 128 && lanes != 256) || rows < 0 ||
      rows >= (int64_t{1} << 31) / kRowWarps ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int code = kStageStart[stage] + body;
  if (out_cols != (reduces(code) ? 1 : lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  return kLaunch[code](x, out, rows, lanes, static_cast<cudaStream_t>(stream));
}
