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
// Two sets of pieces run that step.  The block-level ones (K5, and K1, K2
// and K4, at bands other than 64 and 128) hold one lane a thread, thread k
// lane k of the block's one candidate, and exchange through two ping-pong
// shared-memory buffers of `band` values (buffer p is bufs + p * band), one
// barrier per exchange.  The warp-level ones (K3, and K1, K2, K4 and K5 at
// bands 64 and 128, and the probes' row bodies) are below, after final_lane.

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

// One exchange: every lane publishes v; lane k reads slot k + offset where
// `ok` (the source lane is in the band), else `fill`.
template <class T>
__device__ __forceinline__ T lane_shift(T* bufs, int band, int& p, int k, T v, int offset,
                                        bool ok, T fill) {
  bufs[p * band + k] = v;
  __syncthreads();
  const T r = ok ? bufs[p * band + k + offset] : fill;
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
                                                        int band, int& p, int k,
                                                        typename Ops::T best,
                                                        typename Ops::T ins) {
  const auto cand = ops.sat(ops.min(ops.add(ins, ops.ins_ext), ops.add(best, ops.ins_open)));
  return lane_shift(bufs, band, p, k, cand, 1, k + 1 < band, ops.inf());
}

// Deletion chain opening: the lane above's value plus the opening penalty.
template <class Ops>
__device__ __forceinline__ typename Ops::T dp_chain_open(const Ops& ops, typename Ops::T* bufs,
                                                         int band, int& p, int k,
                                                         typename Ops::T best_after) {
  const auto shifted = lane_shift(bufs, band, p, k, best_after, -1, k > 0, ops.inf());
  return ops.sat(ops.add(shifted, ops.del_open));
}

// Deletion chain extension: min-plus Kogge-Stone scan over the lanes,
// chain = min(chain, moved + step * del_ext) for step = 1, 2, 4, ... < band.
template <class Ops>
__device__ __forceinline__ typename Ops::T dp_ks_scan(const Ops& ops, typename Ops::T* bufs,
                                                      int band, int& p, int k,
                                                      typename Ops::T chain) {
  for (int step = 1; step < band; step <<= 1) {
    const auto moved = lane_shift(bufs, band, p, k, chain, -step, k >= step, ops.inf());
    chain = ops.min(chain, ops.sat(ops.add(moved, ops.step_ext(step))));
  }
  return chain;
}

// One query position of the banded DP, for lane k of an active row (the
// caller runs x < min(n, lq) only).
template <class Ops>
__device__ __forceinline__ void dp_step(const Ops& ops, typename Ops::T* bufs, int band, int& p,
                                        int k, typename Ops::T pen, bool w_valid,
                                        typename Ops::T& best, typename Ops::T& ins) {
  using T = typename Ops::T;
  const T diag_new = dp_diag(ops, best, pen, w_valid);
  const T ins_new = dp_ins_shift(ops, bufs, band, p, k, best, ins);
  const T best_after = ops.min(diag_new, ins_new);
  T chain = dp_chain_open(ops, bufs, band, p, k, best_after);
  chain = dp_ks_scan(ops, bufs, band, p, k, chain);
  if (!w_valid) chain = ops.inf();
  best = ops.min(best_after, chain);
  ins = ins_new;
}

// The min of `fin` over the block's `band` lanes (the score captured at
// x + 1 == n).  Every thread of the block calls it; the result is returned
// to every lane.
template <class T>
__device__ __forceinline__ T capture(T* buf, int k, int band, T fin) {
  __syncthreads();  // the last readers of buf are done
  buf[k] = fin;
  __syncthreads();
  for (int w = band; w > 1;) {
    const int half = (w + 1) / 2;
    if (k < w - half) buf[k] = vmin(buf[k], buf[k + half]);
    __syncthreads();
    w = half;
  }
  return buf[0];
}

template <class Ops>
__device__ __forceinline__ typename Ops::T final_lane(const Ops& ops, int n, int64_t lq, int k,
                                                      int m, typename Ops::T best) {
  return n >= 1 && n <= lq && n + k <= m ? best : ops.inf();
}

// ---------------------------------------------------------------------------
// Warp-level pieces.  One warp holds one band, thread t a run of consecutive
// lanes in P registers, in one of two layouts, kRegLanes of the Ops struct:
// - two lanes a register (kRegLanes 2), int16, 64 * P lanes: thread t holds
//   lanes [2P t, 2P t + 2P) in P registers of two int16 each (s16x2: lane
//   2(P t + p) in the low half of register p, the next lane in its high
//   half).  A shift by one lane crosses halves (__byte_perm);
// - one lane a register (kRegLanes 1), 32 * P lanes: thread t holds lanes
//   [P t, P t + P), lane P t + p in register p, a float32 (F32x1Ops) or an
//   s16x2 pair of two candidates' lane (I16PairOps: the low half the first
//   candidate's, the high half the second's).  Every shift moves whole
//   registers, so both halves of a pair move in step.  This blocked layout
//   keeps a shift by fewer than P lanes mostly inside the thread: at band
//   128 a float step takes 25 shuffles, against 28 for lanes strided over the
//   threads.
// Every exchange is a register shuffle inside the warp plus in-thread moves,
// so no piece has a barrier.  The order of the operations, the Kogge-Stone
// strides and the clamps are those of the block-level pieces above, so each
// lane computes the same expression as there, bit for bit.
//
// An Ops struct fixes the arithmetic on the registers; kRegLanes is the
// lanes a register holds:
//   I16x2Ops       the scorers' int16 units with Hopper's DPX instruction
//                  __viaddmin_s16x2 (min(a + b, c) per half, one
//                  instruction) and the SIMD min __vmins2.  Exact because
//                  no sum leaves int16: the
//                  quantizer (banded._quantize_params, after
//                  mapper_tpu/align/pallas_dp.py:200) takes a scale only when
//                  INF16 + band * (largest unit) < 2^15 - 1, every state is
//                  in [0, INF16] and every unit in [0, 255];
//   ProbeOps2<A>   the probes' int16 arithmetic that wraps modulo 2^16, per
//                  half (__vadd2 wraps); with A, the arithmetic min of
//                  ProbeOps<true>, half by half;
//   I16PairOps     I16x2Ops's arithmetic on the one-lane layout: each half
//                  is its own candidate, and the sums and mins never mix
//                  halves, so a register holds the same lane of two
//                  candidates (K3's pairs);
//   F32x1Ops       F32Ops's expressions on one float lane a register:
//                  every add __fadd_rn, step_ext __fmul_rn(f32(S), del_ext),
//                  no clamp; its min is fminf (one FMNMX, where vmin takes
//                  a compare and a select), which equals vmin unless an
//                  operand is NaN or the two are +0 and -0.  No state is
//                  either with finite penalties: every state starts at +0
//                  or kBig and is a sum with a state as one operand, and a
//                  sum is -0 only when both operands are.
// A lane mask is a per-half uint32_t for the s16x2 registers, a bool per
// register for the float32 ones.

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}
__device__ __forceinline__ int lo16(uint32_t v) { return static_cast<int16_t>(v & 0xffffu); }
__device__ __forceinline__ int hi16(uint32_t v) { return static_cast<int16_t>(v >> 16); }
__device__ __forceinline__ int half16(uint32_t v, int h) { return h ? hi16(v) : lo16(v); }
__device__ __forceinline__ uint32_t splat2(int v) { return pack2(v, v); }
// per-half masks and select: a's half where the mask's half is set, else b's
__device__ __forceinline__ uint32_t mask2(bool lo, bool hi) {
  return (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u);
}
__device__ __forceinline__ uint32_t select2(uint32_t mask, uint32_t a, uint32_t b) {
  return (a & mask) | (b & ~mask);
}
// the float32 layout's select: one lane, one bool
__device__ __forceinline__ float select2(bool mask, float a, float b) { return mask ? a : b; }

struct I16x2Ops {
  static constexpr int kRegLanes = 2;
  uint32_t ins_open, ins_ext, del_open;  // each unit in both halves
  int del_ext;

  static __device__ __forceinline__ I16x2Ops of(const I16Ops& s) {
    return {splat2(s.ins_open), splat2(s.ins_ext), splat2(s.del_open), s.del_ext};
  }
  __device__ __forceinline__ uint32_t del_open2() const { return del_open; }
  __device__ __forceinline__ uint32_t inf() const { return splat2(kInf16); }
  __device__ __forceinline__ uint32_t min(uint32_t a, uint32_t b) const {
    return __vmins2(a, b);
  }
  // sat(a + b)
  __device__ __forceinline__ uint32_t add_sat(uint32_t a, uint32_t b) const {
    return __viaddmin_s16x2(a, b, inf());
  }
  // sat(min(ins + ins_ext, best + ins_open))
  __device__ __forceinline__ uint32_t ins_cand(uint32_t best, uint32_t ins) const {
    return __viaddmin_s16x2(best, ins_open, __viaddmin_s16x2(ins, ins_ext, inf()));
  }
  // min(chain, sat(moved + ext))
  __device__ __forceinline__ uint32_t chain_ext(uint32_t chain, uint32_t moved, uint32_t ext) const {
    return __vmins2(chain, __viaddmin_s16x2(moved, ext, inf()));
  }
  __device__ __forceinline__ uint32_t step_ext(int step) const { return splat2(step * del_ext); }
};

// Two band-64 candidates in step: lane k of the first in the low half, lane
// k of the second in the high half of one register.
struct I16PairOps : I16x2Ops {
  static constexpr int kRegLanes = 1;
};

template <bool kArithMin>
struct ProbeOps2 {
  static constexpr int kRegLanes = 2;
  ProbeOps<kArithMin> s;

  __device__ __forceinline__ uint32_t inf() const { return splat2(kInf16); }
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const { return __vadd2(a, b); }
  __device__ __forceinline__ uint32_t min(uint32_t a, uint32_t b) const {
    if constexpr (kArithMin) {
      // b + (d & (d >> 15)) with d = a - b, both halves at once: the two
      // sign bits shifted to bits 0 and 16 and widened to half masks
      const uint32_t d = __vsub2(a, b);
      return __vadd2(b, d & (((d >> 15) & 0x00010001u) * 0xffffu));
    } else {
      return __vmins2(a, b);
    }
  }
  __device__ __forceinline__ uint32_t add_sat(uint32_t a, uint32_t b) const {
    return min(add(a, b), inf());
  }
  __device__ __forceinline__ uint32_t ins_cand(uint32_t best, uint32_t ins) const {
    return min(min(add(ins, splat2(s.ins_ext)), add(best, splat2(s.ins_open))), inf());
  }
  __device__ __forceinline__ uint32_t chain_ext(uint32_t chain, uint32_t moved, uint32_t ext) const {
    return min(chain, min(add(moved, ext), inf()));
  }
  __device__ __forceinline__ uint32_t step_ext(int step) const { return splat2(s.step_ext(step)); }
  __device__ __forceinline__ uint32_t del_open2() const { return splat2(s.del_open); }
};

struct F32x1Ops {
  static constexpr int kRegLanes = 1;
  F32Ops s;

  __device__ __forceinline__ float inf() const { return kBig; }
  __device__ __forceinline__ float min(float a, float b) const { return fminf(a, b); }
  __device__ __forceinline__ float add_sat(float a, float b) const { return __fadd_rn(a, b); }
  __device__ __forceinline__ float ins_cand(float best, float ins) const {
    return min(__fadd_rn(ins, s.ins_ext), __fadd_rn(best, s.ins_open));
  }
  __device__ __forceinline__ float chain_ext(float chain, float moved, float ext) const {
    return min(chain, __fadd_rn(moved, ext));
  }
  __device__ __forceinline__ float step_ext(int step) const { return s.step_ext(step); }
  __device__ __forceinline__ float del_open2() const { return s.del_open; }
};

// The two-lanes-a-register layout's shifts.  Lane k takes lane k - S, `fill`
// below lane 0 (S = 1, or S even).  `t` is the thread's lane in the warp.
template <int S, int P>
__device__ __forceinline__ void warp_shift_up_x2(const uint32_t (&v)[P], uint32_t (&out)[P],
                                                 uint32_t fill, int t) {
  if constexpr (S == 1) {
    uint32_t carry = __shfl_up_sync(kFullMask, v[P - 1], 1);
    if (t == 0) carry = fill;
#pragma unroll
    for (int p = 0; p < P; ++p) out[p] = __byte_perm(p > 0 ? v[p - 1] : carry, v[p], 0x5432);
  } else {
    static_assert(S % 2 == 0, "a shift of more than one lane moves whole registers");
    constexpr int kRegs = S / 2, kThreads = kRegs / P, kRest = kRegs % P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int dist = p >= kRest ? kThreads : kThreads + 1;
      const uint32_t src = p >= kRest ? v[p - kRest] : v[p - kRest + P];
      const uint32_t got = dist == 0 ? src : __shfl_up_sync(kFullMask, src, dist);
      out[p] = t >= dist ? got : fill;
    }
  }
}

// Lane k takes lane k + 1, `fill` in the top lane.
template <int P>
__device__ __forceinline__ void warp_shift_down1_x2(const uint32_t (&v)[P], uint32_t (&out)[P],
                                                    uint32_t fill, int t) {
  uint32_t carry = __shfl_down_sync(kFullMask, v[0], 1);
  if (t == 31) carry = fill;
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = __byte_perm(v[p], p + 1 < P ? v[p + 1] : carry, 0x5432);
}

// The one-lane-a-register layout's shifts, on a float or on an s16x2 pair.
// Lane k takes lane k - S, `fill` below lane 0: for S < P, register p takes
// register p - S of its own thread, or register p - S + P of the thread
// below; for S >= P (S and P powers of two, so S / P threads exactly),
// register p of the thread S / P below.
template <int S, int P, class R>
__device__ __forceinline__ void warp_shift_up_x1(const R (&v)[P], R (&out)[P], R fill, int t) {
  if constexpr (S < P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int src = p >= S ? p - S : p - S + P;
      if (p >= S) {
        out[p] = v[src];
      } else {
        const R got = __shfl_up_sync(kFullMask, v[src], 1);
        out[p] = t >= 1 ? got : fill;
      }
    }
  } else {
    static_assert(S % P == 0, "a shift of P lanes or more moves whole threads");
    constexpr int kThreads = S / P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const R got = __shfl_up_sync(kFullMask, v[p], kThreads);
      out[p] = t >= kThreads ? got : fill;
    }
  }
}

// Lane k takes lane k + 1, `fill` in the top lane.
template <int P, class R>
__device__ __forceinline__ void warp_shift_down1_x1(const R (&v)[P], R (&out)[P], R fill, int t) {
  R carry = __shfl_down_sync(kFullMask, v[0], 1);
  if (t == 31) carry = fill;
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = p + 1 < P ? v[p + 1] : carry;
}

// The shifts of Ops's layout: chosen by kRegLanes, not by the register type,
// which is uint32_t in both int16 layouts.
template <class Ops, int S, int P, class R>
__device__ __forceinline__ void warp_shift_up(const R (&v)[P], R (&out)[P], R fill, int t) {
  if constexpr (Ops::kRegLanes == 2) {
    warp_shift_up_x2<S, P>(v, out, fill, t);
  } else {
    warp_shift_up_x1<S, P>(v, out, fill, t);
  }
}
template <class Ops, int P, class R>
__device__ __forceinline__ void warp_shift_down1(const R (&v)[P], R (&out)[P], R fill, int t) {
  if constexpr (Ops::kRegLanes == 2) {
    warp_shift_down1_x2<P>(v, out, fill, t);
  } else {
    warp_shift_down1_x1<P>(v, out, fill, t);
  }
}

// dp_diag: live ? sat(best + pen) : inf, `live` a lane mask.
template <class Ops, class R, class M, int P>
__device__ __forceinline__ void dp_diag_w(const Ops& ops, const R (&best)[P], const R (&pen)[P],
                                          const M (&live)[P], R (&out)[P]) {
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = select2(live[p], ops.add_sat(best[p], pen[p]), ops.inf());
}

// dp_ins_shift of an active row.
template <class Ops, class R, int P>
__device__ __forceinline__ void dp_ins_shift_w(const Ops& ops, const R (&best)[P],
                                               const R (&ins)[P], R (&out)[P], int t) {
  R cand[P];
#pragma unroll
  for (int p = 0; p < P; ++p) cand[p] = ops.ins_cand(best[p], ins[p]);
  warp_shift_down1<Ops, P>(cand, out, ops.inf(), t);
}

// dp_chain_open.
template <class Ops, class R, int P>
__device__ __forceinline__ void dp_chain_open_w(const Ops& ops, const R (&best_after)[P],
                                                R (&out)[P], int t) {
  warp_shift_up<Ops, 1, P>(best_after, out, ops.inf(), t);
#pragma unroll
  for (int p = 0; p < P; ++p) out[p] = ops.add_sat(out[p], ops.del_open2());
}

// dp_ks_scan: the rounds at strides S, 2S, ... below the band.
template <class Ops, int P, int S = 1, class R>
__device__ __forceinline__ void dp_ks_scan_w(const Ops& ops, R (&chain)[P], int t) {
  if constexpr (S < 32 * Ops::kRegLanes * P) {
    R moved[P];
    warp_shift_up<Ops, S, P>(chain, moved, ops.inf(), t);
    const R ext = ops.step_ext(S);
#pragma unroll
    for (int p = 0; p < P; ++p) chain[p] = ops.chain_ext(chain[p], moved[p], ext);
    dp_ks_scan_w<Ops, P, 2 * S>(ops, chain, t);
  }
}

// dp_step of an active row: `live` is the lane mask of w_valid.
template <class Ops, class R, class M, int P>
__device__ __forceinline__ void dp_step_w(const Ops& ops, const R (&pen)[P], const M (&live)[P],
                                          R (&best)[P], R (&ins)[P], int t) {
  R diag_new[P], ins_new[P], best_after[P], chain[P];
  dp_diag_w(ops, best, pen, live, diag_new);
  dp_ins_shift_w(ops, best, ins, ins_new, t);
#pragma unroll
  for (int p = 0; p < P; ++p) best_after[p] = ops.min(diag_new[p], ins_new[p]);
  dp_chain_open_w(ops, best_after, chain, t);
  dp_ks_scan_w(ops, chain, t);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    chain[p] = select2(live[p], chain[p], ops.inf());
    best[p] = ops.min(best_after[p], chain[p]);
    ins[p] = ins_new[p];
  }
}

// The min over the warp's lanes of a value each thread has already reduced
// over its own lanes (capture's warp-level counterpart).
__device__ __forceinline__ int warp_min(int v) { return __reduce_min_sync(kFullMask, v); }
// __reduce_min_sync takes integers: a float's is an xor-shuffle tree (a
// min is exact in any order)
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = vmin(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}
// the pair layout's: each half's min, both at once
__device__ __forceinline__ uint32_t warp_min2(uint32_t v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = __vmins2(v, __shfl_xor_sync(kFullMask, v, offset));
  }
  return v;
}

}  // namespace dp
