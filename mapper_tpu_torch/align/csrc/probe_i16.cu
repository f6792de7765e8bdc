// The int16 probe kernels, for sm_90a: one unit kernel per probe site of
// benchmarks/probe_i16/{a..i}.py (P1-P9), each body a fragment of the banded
// DP step on a [T, B] int16 block, computed with the device functions that
// the scorers of banded_dp.cu run (dp_core.cuh).  A change to the DP step
// that breaks a fragment breaks its probe first.
//
// Semantics are JAX's int16 semantics, bit for bit: adds and subtracts wrap
// modulo 2^16, >> is arithmetic, a cast of a negative value to uint16 wraps,
// an int32-widened min narrows back.  So the bodies compute in int16_t
// (ProbeOps), not in the scorers' int32 registers.
//
// Layout: one block per row of [T, B], one thread per lane (B <= 1024).  Lane
// shifts and Kogge-Stone steps exchange through dp_core's ping-pong shared
// buffers; row reductions ([T, 1] outputs) take capture()'s min-reduce; the
// scratch bodies keep their scratch in shared memory.
// What bounds it: nothing of the card's — a few int16 operations per element
// and one barrier per exchange, launch-bound at the probes' own [64, 128].

#include <cstdint>
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

__host__ __device__ constexpr bool reduces(int body) {
  return body == kWidenReduce || body == kNarrowOut || body == kReduceI32 ||
         body == kReduce || body == kWhere1d || body == kWhere1dI32Cmp;
}

static_assert(kStageStart[9] == kNumBodies, "one entry per stage");

constexpr i16 kInf = kInf16;
constexpr i16 kMinConst = 37;  // f.py's CONST

__global__ void probe_kernel(int body, const i16* __restrict__ x, i16* __restrict__ out,
                             int lanes) {
  extern __shared__ __align__(16) unsigned char smem[];
  i16* const bufs = reinterpret_cast<i16*>(smem);  // two ping-pong buffers
  i16* const scratch = bufs + 2 * lanes;            // two scratch rows
  // the Kogge-Stone bodies of a, b, c and d extend by step * 3 (d with the
  // arithmetic min); g.step and h.*: ins_open 63, ins_ext 18, del_open 60,
  // del_ext 15
  const ProbeOps<false> ops{0, 0, 0, 3};
  const ProbeOps<true> amin_ops{0, 0, 0, 3};
  const ProbeOps<false> step_ops{63, 18, 60, 15};
  const int64_t row = blockIdx.x;
  const int k = threadIdx.x;
  const i16 v = x[row * lanes + k];
  const i16 best0 = k <= 100 ? i16(0) : kInf;  // the step probes' initial best
  int p = 0;
  i16 o = 0;
  switch (body) {
    case kCopy: o = v; break;
    case kAddSat:
    case kAddFull:
    case kBAddImin: o = ops.sat(ops.add(v, 3)); break;
    case kConcatShift: o = lane_shift(bufs, lanes, p, k, v, -1, k > 0, i16(7)); break;
    case kWhereIota: o = k < 40 ? v : i16(5); break;
    case kSelectCast:
      o = v == 1 ? 0 : v == 2 ? 1 : v == 4 ? 2 : v == 8 ? 3 : 4;
      break;
    case kWidenReduce:
    case kReduceI32:
    case kReduce: o = capture(bufs, k, k, lanes, v); break;
    case kNarrowOut: o = v; break;
    case kScratchI16:
      scratch[k] = v;
      __syncthreads();
      o = scratch[k];
      break;
    case kKoggeStone:
    case kKsFull:
    case kKsWhere: o = dp_ks_scan(ops, bufs, lanes, p, k, k, lanes, v); break;
    case kAddOnlyScalar: o = ops.add(v, 3); break;
    case kMinOnlyScalar: o = ops.min(v, 90); break;
    case kMinWhere: o = ops.min(ops.add(v, 7), 50); break;
    case kAmin: o = amin_ops.min(ops.add(v, 7), 50); break;
    case kKsAmin: o = dp_ks_scan(amin_ops, bufs, lanes, p, k, k, lanes, v); break;
    case kSub: o = static_cast<i16>(v - 3); break;
    case kShr: o = static_cast<i16>(v >> 15); break;
    case kBand: o = static_cast<i16>(v & 7); break;
    case kVecAdd: o = ops.add(v, v); break;
    case kI32Min: o = static_cast<i16>(vmin<int>(ops.add(v, 7), kMinConst)); break;
    case kU16Min:
      o = static_cast<i16>(vmin<uint16_t>(static_cast<uint16_t>(ops.add(v, 7)), kMinConst));
      break;
    case kF32Min:
      o = static_cast<i16>(fminf(static_cast<float>(ops.add(v, 7)), static_cast<float>(kMinConst)));
      break;
    case kMulSel: {
      const i16 d = static_cast<i16>(ops.add(v, 7) - kMinConst);
      const i16 neg = static_cast<i16>((d >> 15) & 1);
      o = static_cast<i16>(kMinConst + static_cast<i16>(d * neg));
      break;
    }
    case kI32Cmp: {
      const i16 a = ops.add(v, 7);
      o = static_cast<int>(a) < static_cast<int>(kMinConst) ? a : i16(kMinConst);
      break;
    }
    case kWhere1d:
    case kWhere1dI32Cmp: {
      const i16 cap = capture(bufs, k, k, lanes, v);
      o = cap > 0 ? cap : i16(7);
      break;
    }
    case kSelect2: o = k < 50 ? v : i16(3); break;
    case kStep: {
      // best and ins through their scratch rows, as g.py's VMEM scratch
      i16* const best_s = scratch;
      i16* const ins_s = scratch + lanes;
      best_s[k] = best0;
      ins_s[k] = kInf;
      __syncthreads();
      i16 best = best_s[k];
      i16 ins = ins_s[k];
      dp_step(step_ops, bufs, lanes, p, k, k, lanes, v, k < 120, true, best, ins);
      best_s[k] = best;
      ins_s[k] = ins;
      o = best;
      break;
    }
    case kS1Diag: o = dp_diag(step_ops, best0, v, k < 120); break;
    case kS2Ins: {
      const i16 diag_new = dp_diag(step_ops, best0, v, k < 120);
      const i16 ins_new = dp_ins_shift(step_ops, bufs, lanes, p, k, k, lanes, best0, kInf, true);
      o = step_ops.min(diag_new, ins_new);
      break;
    }
    case kS3ChainOpen:
      o = dp_chain_open(step_ops, bufs, lanes, p, k, k, k <= 100 ? v : i16(kInf));
      break;
    case kS4KsLoop: o = dp_ks_scan(step_ops, bufs, lanes, p, k, k, lanes, v); break;
    case kAScalarSelectAdd: o = ops.add(best0, v); break;
    case kCSelectOfImin: o = k < 120 ? ops.sat(ops.add(v, 3)) : kInf; break;
    case kDSelectFeedImin: o = dp_diag(ops, best0, v, true); break;
    default: break;
  }
  if (!reduces(body)) {
    out[row * lanes + k] = o;
  } else if (k == 0) {
    out[row] = o;
  }
}

}  // namespace

// Runs body `body` of stage `stage` (0 = a ... 8 = i) on x [rows, lanes]
// into out: [rows, 1] where the body reduces a row (out_cols == 1), else
// [rows, lanes].  Returns the CUDA error, cudaErrorInvalidValue for a stage,
// body or shape the kernel does not take.
extern "C" int mapper_probe_i16(int stage, int body, const int16_t* x, int16_t* out,
                                int64_t rows, int lanes, int out_cols, void* stream) {
  if (stage < 0 || stage > 8 || body < 0 || body >= kStageStart[stage + 1] - kStageStart[stage] ||
      lanes < 1 || lanes > 1024 || rows < 0 || rows >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int code = kStageStart[stage] + body;
  if (out_cols != (reduces(code) ? 1 : lanes)) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0) {
    const size_t smem = 4 * static_cast<size_t>(lanes) * sizeof(int16_t);
    probe_kernel<<<static_cast<unsigned>(rows), lanes, smem, static_cast<cudaStream_t>(stream)>>>(
        code, x, out, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}
