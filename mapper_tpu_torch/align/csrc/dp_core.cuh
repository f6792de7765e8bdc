// The banded DP step and its pieces, shared by every kernel of this package:
// the scorers of banded_dp.cu and the unit kernels of probe_i16.cu, which
// hold each piece against the JAX package's probe bodies.
//
// An Ops struct fixes the arithmetic and the penalties:
//   I16Ops    int16 units of 1/scale held in int32 registers, every sum
//             clamped to INF16 where the reference clamps it (K1, K3);
//   F32Ops    float32 with no contracted multiply-add (K2, K4, K5);
//   ProbeOps  int16_t arithmetic that wraps modulo 2^16 as JAX's int16 does,
//             with the probes' own constants; its min is the plain min, or
//             the arithmetic min b + (d & (d >> 15)) of benchmarks/probe_i16/d.py.
//
// Exchanges between lanes go through two ping-pong shared-memory buffers
// (buffer p is bufs + p * slots), one barrier per exchange.  `t` is the
// thread's slot, `sub` its lane within its candidate's `width` lanes, so no
// shift or Kogge-Stone step crosses into another candidate.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dp {

constexpr int kInf16 = 16384;
constexpr float kBig = 1e9f;

__device__ __forceinline__ int popcount4(int u) { return __popc(u & 15); }

template <class T>
__device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }

struct I16Ops {
  using T = int;
  int mutation, amb_unit, ins_open, ins_ext, del_open, del_ext;
  float inv;  // f32(1) / f32(scale)

  __device__ __forceinline__ T inf() const { return kInf16; }
  __device__ __forceinline__ T add(T a, T b) const { return a + b; }
  __device__ __forceinline__ T min(T a, T b) const { return vmin(a, b); }
  __device__ __forceinline__ T sat(T v) const { return v < kInf16 ? v : kInf16; }
  __device__ __forceinline__ T pen(int q, int w) const {
    return (q & w) != 0 ? amb_unit * (popcount4(q | w) - 1) : mutation;
  }
  __device__ __forceinline__ T step_ext(int step) const { return step * del_ext; }
  __device__ __forceinline__ float score(T r) const {
    return r >= kInf16 ? kBig : __fmul_rn(__int2float_rn(r), inv);
  }
  __device__ __forceinline__ float diag(T d) const { return __fmul_rn(__int2float_rn(d), inv); }
};

struct F32Ops {
  using T = float;
  float mutation, ambiguity, ins_open, ins_ext, del_open, del_ext;

  __device__ __forceinline__ T inf() const { return kBig; }
  __device__ __forceinline__ T add(T a, T b) const { return __fadd_rn(a, b); }
  __device__ __forceinline__ T min(T a, T b) const { return vmin(a, b); }
  __device__ __forceinline__ T sat(T v) const { return v; }
  __device__ __forceinline__ T pen(int q, int w) const {
    if ((q & w) == 0) return mutation;
    return __fdiv_rn(__fmul_rn(ambiguity, __int2float_rn(popcount4(q | w) - 1)), 3.0f);
  }
  __device__ __forceinline__ T step_ext(int step) const {
    return __fmul_rn(__int2float_rn(step), del_ext);
  }
  __device__ __forceinline__ float score(T r) const { return r; }
  __device__ __forceinline__ float diag(T d) const { return d; }
};

template <bool kArithMin>
struct ProbeOps {
  using T = int16_t;
  T ins_open, ins_ext, del_open, del_ext;

  __device__ __forceinline__ T inf() const { return kInf16; }
  __device__ __forceinline__ T add(T a, T b) const { return static_cast<T>(a + b); }
  __device__ __forceinline__ T min(T a, T b) const {
    if (kArithMin) {
      const T d = static_cast<T>(a - b);
      return static_cast<T>(b + (d & (d >> 15)));
    }
    return vmin(a, b);
  }
  __device__ __forceinline__ T sat(T v) const { return min(v, inf()); }
  __device__ __forceinline__ T step_ext(int step) const { return static_cast<T>(step * del_ext); }
};

// One exchange: every lane publishes v; lane t reads slot t + offset where
// `ok` (the source lane belongs to its candidate), else `fill`.
template <class T>
__device__ __forceinline__ T lane_shift(T* bufs, int slots, int& p, int t, T v, int offset,
                                        bool ok, T fill) {
  bufs[p * slots + t] = v;
  __syncthreads();
  const T r = ok ? bufs[p * slots + t + offset] : fill;
  p ^= 1;
  return r;
}

// Diagonal move (x, y) -> (x + 1, y + 1): the penalty added to `best`,
// where the window cell is valid and the lane active.
template <class Ops>
__device__ __forceinline__ typename Ops::T dp_diag(const Ops& ops, typename Ops::T best,
                                                   typename Ops::T pen, bool live) {
  return live ? ops.sat(ops.add(best, pen)) : ops.inf();
}

// Query insertion (x, y) -> (x + 1, y): the band shifts down by one lane.
template <class Ops>
__device__ __forceinline__ typename Ops::T dp_ins_shift(const Ops& ops, typename Ops::T* bufs,
                                                        int slots, int& p, int t, int sub,
                                                        int width, typename Ops::T best,
                                                        typename Ops::T ins, bool active) {
  const auto cand = ops.sat(ops.min(ops.add(ins, ops.ins_ext), ops.add(best, ops.ins_open)));
  const auto shifted = lane_shift(bufs, slots, p, t, cand, 1, sub + 1 < width, ops.inf());
  return active ? shifted : ops.inf();
}

// Deletion chain opening: the lane above's value plus the opening penalty.
template <class Ops>
__device__ __forceinline__ typename Ops::T dp_chain_open(const Ops& ops, typename Ops::T* bufs,
                                                         int slots, int& p, int t, int sub,
                                                         typename Ops::T best_after) {
  const auto shifted = lane_shift(bufs, slots, p, t, best_after, -1, sub > 0, ops.inf());
  return ops.sat(ops.add(shifted, ops.del_open));
}

// Deletion chain extension: min-plus Kogge-Stone scan over the lanes,
// chain = min(chain, moved + step * del_ext) for step = 1, 2, 4, ... < width.
template <class Ops>
__device__ __forceinline__ typename Ops::T dp_ks_scan(const Ops& ops, typename Ops::T* bufs,
                                                      int slots, int& p, int t, int sub,
                                                      int width, typename Ops::T chain) {
  for (int step = 1; step < width; step <<= 1) {
    const auto moved = lane_shift(bufs, slots, p, t, chain, -step, sub >= step, ops.inf());
    chain = ops.min(chain, ops.sat(ops.add(moved, ops.step_ext(step))));
  }
  return chain;
}

// One query position of the banded DP, for one lane of one candidate.
// `active` is x < n: an inactive lane keeps its state but still takes part
// in every barrier.
template <class Ops>
__device__ __forceinline__ void dp_step(const Ops& ops, typename Ops::T* bufs, int slots,
                                        int& p, int t, int sub, int width,
                                        typename Ops::T pen, bool w_valid, bool active,
                                        typename Ops::T& best, typename Ops::T& ins) {
  using T = typename Ops::T;
  const bool live = w_valid && active;
  const T diag_new = dp_diag(ops, best, pen, live);
  const T ins_new = dp_ins_shift(ops, bufs, slots, p, t, sub, width, best, ins, active);
  const T best_after = ops.min(diag_new, ins_new);
  T chain = dp_chain_open(ops, bufs, slots, p, t, sub, best_after);
  chain = dp_ks_scan(ops, bufs, slots, p, t, sub, width, chain);
  if (!live) chain = ops.inf();
  if (active) {
    best = ops.min(best_after, chain);
    ins = ins_new;
  }
}

// The min of `fin` over the candidate's `width` lanes (the score captured
// at x + 1 == n; the probes' row min-reduce).  Every thread of the block
// calls it; the result is returned to every lane.
template <class T>
__device__ __forceinline__ T capture(T* buf, int t, int sub, int width, T fin) {
  __syncthreads();  // the last readers of buf are done
  buf[t] = fin;
  __syncthreads();
  for (int w = width; w > 1;) {
    const int half = (w + 1) / 2;
    if (sub < w - half) buf[t] = vmin(buf[t], buf[t + half]);
    __syncthreads();
    w = half;
  }
  return buf[t - sub];
}

template <class Ops>
__device__ __forceinline__ typename Ops::T final_lane(const Ops& ops, int n, int64_t lq, int sub,
                                                      int m, typename Ops::T best) {
  return n >= 1 && n <= lq && n + sub <= m ? best : ops.inf();
}

}  // namespace dp
