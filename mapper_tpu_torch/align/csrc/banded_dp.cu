// Banded affine-gap DP scoring of candidate windows, for sm_90a.
//
// Five kernels, one per TPU kernel of mapper_tpu/align/pallas_dp.py:
//   banded_i16         <- _pen_kernel_x_i16 (int16 units of 1/scale, driven by
//                         _pen_core_i16), used when _quantize_params finds an
//                         exact scale;
//   banded_f32         <- _pen_kernel_x (float32, driven by _pen_core), used
//                         otherwise (e.g. reads above 512 bp at default
//                         penalties);
//   banded_i16_packed  <- _pen_kernel_x_i16_packed (two band-64 candidates in
//                         one register's two halves), on host rows at band 64;
//   banded_roll_f32    <- _pallas_kernel_roll (whole rows staged once);
//   banded_chunk_f32   <- _pallas_kernel (rows staged chunk by chunk).
// All five run the same DP step (dp_core.cuh): banded_i16_packed always, and
// the other four at bands 64 and 128, through its warp-level pieces; the
// other four at other bands through its block-level ones.
//
// What bounds them on this card: per DP cell the work is a few integer or
// float adds, mins and selects on data already in registers, and the bytes
// per cell are tiny (one query byte per row, one window byte per cell, staged
// in shared memory).  They are bound by instruction issue and by latency:
// each query position of a candidate depends on the previous one, so one
// candidate's x loop is serial, and the deletion chain inside a row needs
// log2(band) dependent exchange steps between lanes.
// What the design does about it: at bands 64 and 128 every scorer runs one
// warp per candidate (banded_i16_packed one warp per pair), its exchanges
// register shuffles: banded_i16 with two or four lanes a thread and its
// arithmetic on two int16 lanes at once (see banded_i16_warp_kernel),
// banded_i16_packed with two lanes of each of its two candidates a thread
// (see banded_i16_packed_warp_kernel), the float32 three with two or four
// float lanes a thread (see banded_f32_warp_kernel).  At other bands the
// four that take a band run one block per candidate and one thread per band
// lane, so the band-wide vector ops of the TPU kernels become per-thread
// scalar ops and the lane shifts become shared-memory exchanges through two
// ping-pong buffers (one barrier per exchange).
//
// Bit-parity with the reference: the float path uses __fadd_rn/__fmul_rn/
// __fdiv_rn so no multiply-add is ever contracted, keeps the Kogge-Stone
// order min(chain, moved + f32(step) * del_ext), computes the ambiguity
// penalty as (ambiguity * f32(popcount - 1)) / 3 and sums the diagonals in
// x order, in the block and the warp kernels alike.  The int path clamps
// every sum to INF16 exactly where the reference clamps it, with its int16
// state in int32 registers (block kernels) or two to a 32-bit register (warp
// kernels; no sum leaves int16, see I16x2Ops).

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_core.cuh"
#include "launch.cuh"

namespace {

using namespace dp;
using cuda_launch::launch_kernel;

constexpr int kHalf = 64;  // the packed kernel's per-candidate band
constexpr int kCandsPerBlock = 4;  // the warp kernels' candidates a block, one warp each
constexpr int kPairsPerBlock = 8;  // the packed kernel's pairs a block, one warp each
constexpr int kPenTable = 16 * 16;  // the warp kernels' penalty table: (query, window) code pairs

// The bands the warp kernels take (kernels.py's WARP_BANDS); any other band
// takes a block kernel.
bool warp_band(int band) { return band == 64 || band == 128; }

// Dynamic shared memory of each layout (kernels.py's smem_bytes computes the
// same sums).  `width` is the query positions staged at once: the read width,
// or banded_chunk_f32's chunk.
// A block kernel: two ping-pong buffers of `band` 4-byte values (int for
// I16Ops, float for F32Ops), then the query codes [width] and the window
// [width + band].
size_t block_smem(int64_t width, int band) {
  return 2 * band * sizeof(float) + static_cast<size_t>(2 * width + band);
}
// A warp kernel: the penalty table of `entry`-byte values, then per warp its
// query codes [width] and window [width + band].
size_t warp_smem(int64_t width, int band, size_t entry) {
  return kPenTable * entry + static_cast<size_t>(kCandsPerBlock * (2 * width + band));
}
// The packed kernel: the int16 penalty table, then per warp its pair's
// query codes [lq] and windows [lq + kHalf], the two rows' codes a byte.
size_t pair_smem(int64_t lq) {
  return kPenTable * sizeof(int16_t) + static_cast<size_t>(kPairsPerBlock * (2 * lq + kHalf));
}

unsigned warp_grid(int64_t num_cands) {
  return static_cast<unsigned>((num_cands + kCandsPerBlock - 1) / kCandsPerBlock);
}

// banded_i16 / banded_f32.
// grid: one block per candidate; block: `band` threads, thread k = lane k.
// Shared memory: two ping-pong buffers of `band` values, the query row
// [lq] and the window [lq + band].
// One launch also does everything _gathered_core does around the Pallas
// call: the read gather, the reverse complement on the device, the window
// gather clamped to the end of the reference, the penalty from the nibble
// codes, the per-diagonal ungapped sums and their pick at the voted lane.
// Output: out[0, b] the banded score (BIG where no path fits the band),
// out[1, b] the ungapped penalty of diagonal clamp(lane[b], 0, band - 1),
// and, where diag_out is not null, every diagonal's sum in
// diag_out[b * band + k].  Window starts are int64, so references beyond
// 2^31 bases need no other path.  The host-window entry (banded_scores,
// variant "pen") drives this kernel with its rows as the reads and its
// windows, laid end to end, as the reference.
template <class Ops>
__global__ void banded_kernel(
    const uint8_t* __restrict__ reads, int64_t lq,
    const uint8_t* __restrict__ concat, int64_t concat_len,
    const int64_t* __restrict__ read_id, const uint8_t* __restrict__ reversed,
    const int64_t* __restrict__ win_start, const int64_t* __restrict__ lane,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
    int64_t num_cands, int band, Ops ops, float* __restrict__ out,
    float* __restrict__ diag_out) {
  using T = typename Ops::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const bufs = reinterpret_cast<T*>(smem);
  uint8_t* s_q = reinterpret_cast<uint8_t*>(bufs + 2 * band);
  uint8_t* s_w = s_q + lq;

  const int64_t b = blockIdx.x;
  const int k = threadIdx.x;
  const int n = n_arr[b];
  const int m = m_arr[b];
  const bool rev = reversed[b] != 0;
  const int64_t ws = win_start[b];
  const uint8_t* row = reads + read_id[b] * lq;

  // query codes: forward row, or its reverse complement over the first n
  // (complement = nibble bit-reversal), zero past n
  for (int64_t x = k; x < lq; x += band) {
    int c = row[x];
    if (rev) {
      int64_t src = static_cast<int64_t>(n) - 1 - x;
      src = src < 0 ? 0 : (src > lq - 1 ? lq - 1 : src);
      const int f = row[src];
      const int comp = ((f & 1) << 3) | ((f & 2) << 1) | ((f & 4) >> 1) | ((f & 8) >> 3);
      c = x < n ? comp : 0;
    }
    s_q[x] = static_cast<uint8_t>(c);
  }
  // window codes, gathers clamped to the reference's bounds
  for (int64_t j = k; j < lq + band; j += band) {
    int64_t idx = ws + j;
    idx = idx < 0 ? 0 : (idx > concat_len - 1 ? concat_len - 1 : idx);
    s_w[j] = concat[idx];
  }
  __syncthreads();

  const int nx = n < lq ? n : static_cast<int>(lq);
  T best = k <= m ? T(0) : ops.inf();
  T ins = ops.inf();
  T diag = T(0);
  int p = 0;
  for (int x = 0; x < nx; ++x) {
    const T pen = ops.pen(s_q[x], s_w[x + k]);
    diag = ops.add(diag, pen);
    dp_step(ops, bufs, band, p, k, pen, x + k < m, best, ins);
  }

  const T r = capture(bufs, k, band, final_lane(ops, n, lq, k, m, best));
  if (k == 0) out[b] = ops.score(r);
  int64_t pick = lane[b];
  pick = pick < 0 ? 0 : (pick > band - 1 ? band - 1 : pick);
  if (k == pick) out[num_cands + b] = ops.diag(diag);
  if (diag_out != nullptr) diag_out[b * band + k] = ops.diag(diag);
}

// A warp stages its candidate's query row [lq] and window [lq + band] in
// its own shared memory with banded_kernel's gathers: the reverse complement
// over the first n, zero past n, window indices clamped to the reference's
// bounds.  Codes are 4-bit (basepairs); the mask only keeps the table
// lookups in bounds.
__device__ __forceinline__ void warp_stage_gathered(
    const uint8_t* __restrict__ row, int64_t lq, int n, bool rev,
    const uint8_t* __restrict__ concat, int64_t concat_len, int64_t ws, int band,
    uint8_t* s_q, uint8_t* s_w, int t) {
  for (int64_t x = t; x < lq; x += 32) {
    int c = __ldg(row + x);
    if (rev) {
      int64_t src = static_cast<int64_t>(n) - 1 - x;
      src = src < 0 ? 0 : (src > lq - 1 ? lq - 1 : src);
      const int f = __ldg(row + src);
      const int comp = ((f & 1) << 3) | ((f & 2) << 1) | ((f & 4) >> 1) | ((f & 8) >> 3);
      c = x < n ? comp : 0;
    }
    s_q[x] = static_cast<uint8_t>(c & 15);
  }
  for (int64_t j = t; j < lq + band; j += 32) {
    int64_t idx = ws + j;
    idx = idx < 0 ? 0 : (idx > concat_len - 1 ? concat_len - 1 : idx);
    s_w[j] = static_cast<uint8_t>(__ldg(concat + idx) & 15);
  }
  __syncwarp();
}

// banded_i16 at bands 64 and 128 (band = 64 * P): one warp per candidate,
// kCandsPerBlock candidates per block.  Thread t of a warp holds lanes
// [2P t, 2P t + 2P) as P registers of two int16 (dp_core's warp-level
// pieces): the insertion shift, the chain opening and the log2(band)
// Kogge-Stone rounds are register shuffles inside the warp, and the sums
// and mins are DPX instructions on both halves at once (I16x2Ops).  The x
// loop has no barrier: each warp runs its own candidate's n steps.
// Shared memory: the penalty of every (query code, window code) pair,
// int16 [16 * 16], built once per block; per warp its query row [lq] and
// window [lq + band], staged by the warp alone.  The prologue and epilogue
// are banded_kernel's: the same gathers, reverse complement and clamps, the
// same diagonal sums in x order (int32), the same capture and lane pick.
// Other bands take banded_kernel<I16Ops> (the wrapper's dispatch).
// What bounds it: the int16 operations of the DP cells (about 10 a cell with
// DPX's fused add and min, two int16 a lane each clock); the block kernel lost
// most of its time to one block barrier and shared-memory round trip per
// exchange, 2 + log2(band) exchanges a step.  Staging the row and window in shared memory measured
// 1.6x faster than reading them through the read-only path inside the x
// loop (experiments/k1_staging.py, NVIDIA H100 80GB HBM3, 700 W).
template <int P>
__global__ void __launch_bounds__(32 * kCandsPerBlock) banded_i16_warp_kernel(
    const uint8_t* __restrict__ reads, int64_t lq,
    const uint8_t* __restrict__ concat, int64_t concat_len,
    const int64_t* __restrict__ read_id, const uint8_t* __restrict__ reversed,
    const int64_t* __restrict__ win_start, const int64_t* __restrict__ lane,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
    int64_t num_cands, I16Ops ops, float* __restrict__ out, float* __restrict__ diag_out) {
  constexpr int kBand = 64 * P;
  constexpr int kLanes = 2 * P;  // lanes a thread holds
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* const pen_tab = reinterpret_cast<int16_t*>(smem);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  uint8_t* const s_q =
      smem + kPenTable * sizeof(int16_t) + static_cast<int64_t>(warp) * (2 * lq + kBand);
  uint8_t* const s_w = s_q + lq;

  for (int i = threadIdx.x; i < kPenTable; i += blockDim.x) {
    pen_tab[i] = static_cast<int16_t>(ops.pen(i >> 4, i & 15));
  }
  __syncthreads();  // the table is the block's; from here on each warp works alone

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kCandsPerBlock + warp;
  if (b >= num_cands) return;
  const int n = n_arr[b];
  const int m = m_arr[b];
  const bool rev = reversed[b] != 0;
  const int64_t ws = win_start[b];
  const uint8_t* row = reads + read_id[b] * lq;
  warp_stage_gathered(row, lq, n, rev, concat, concat_len, ws, kBand, s_q, s_w, t);

  const I16x2Ops ops2 = I16x2Ops::of(ops);
  const int nx = n < lq ? n : static_cast<int>(lq);
  const int k0 = kLanes * t;  // the thread's first lane
  uint32_t best[P], ins[P];
  int diag[kLanes];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = pack2(k0 + 2 * p <= m ? 0 : kInf16, k0 + 2 * p + 1 <= m ? 0 : kInf16);
    ins[p] = ops2.inf();
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i) diag[i] = 0;

  for (int x = 0; x < nx; ++x) {
    const int q16 = s_q[x] << 4;
    const uint8_t* const wx = s_w + x + k0;
    int pen[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      pen[i] = pen_tab[q16 | wx[i]];
      diag[i] += pen[i];
    }
    const int lim = m - x - k0;  // lane k0 + i has a window cell (x + k < m) iff i < lim
    uint32_t pen2[P], live[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      pen2[p] = pack2(pen[2 * p], pen[2 * p + 1]);
      live[p] = mask2(2 * p < lim, 2 * p + 1 < lim);
    }
    dp_step_w(ops2, pen2, live, best, ins, t);
  }

  int fin = kInf16;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    fin = vmin(fin, final_lane(ops, n, lq, k0 + i, m, half16(best[i / 2], i % 2)));
  }
  const int r = warp_min(fin);
  if (t == 0) out[b] = ops.score(r);
  int64_t pick = lane[b];
  pick = pick < 0 ? 0 : (pick > kBand - 1 ? kBand - 1 : pick);
  if (pick >= k0 && pick < k0 + kLanes) out[num_cands + b] = ops.diag(diag[pick - k0]);
  if (diag_out != nullptr) {
#pragma unroll
    for (int i = 0; i < kLanes; ++i) diag_out[b * kBand + k0 + i] = ops.diag(diag[i]);
  }
}

// The float32 warp kernels' shared pieces.  The penalty of every (query
// code, window code) pair, F32Ops::pen's expression, built once per block.
__device__ __forceinline__ void f32_pen_table(const F32Ops& ops, float* pen_tab) {
  for (int i = threadIdx.x; i < kPenTable; i += blockDim.x) pen_tab[i] = ops.pen(i >> 4, i & 15);
  __syncthreads();  // the table is the block's; from here on each warp works alone
}

// One query position's penalties for the thread's lanes k0 .. k0 + P - 1
// from its window cells wx[0 .. P), and `live` where the lane has a window
// cell (x + k < m, i.e. p < lim with lim = m - x - k0).
template <int P>
__device__ __forceinline__ void f32_row(const float* pen_tab, int q, const uint8_t* wx, int lim,
                                        float (&pen)[P], bool (&live)[P]) {
  const int q16 = q << 4;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pen[p] = pen_tab[q16 | wx[p]];
    live[p] = p < lim;
  }
}

// The candidate's score: final_lane over the band, its min over the warp.
// The thread's own min starts at its first lane, so a state above kBig
// passes as it does through capture.
template <int P>
__device__ __forceinline__ float f32_capture(const F32Ops& ops, int n, int64_t lq, int k0, int m,
                                             const float (&best)[P]) {
  float fin = final_lane(ops, n, lq, k0, m, best[0]);
#pragma unroll
  for (int p = 1; p < P; ++p) fin = vmin(fin, final_lane(ops, n, lq, k0 + p, m, best[p]));
  return warp_min(fin);
}

// banded_f32 at bands 64 and 128 (band = 32 * P): one warp per candidate,
// kCandsPerBlock candidates per block, as banded_i16_warp_kernel.  Thread t
// of a warp holds lanes [P t, P t + P) as P float registers (dp_core's
// float32 warp-level pieces, F32x1Ops): the insertion shift, the chain
// opening and the log2(band) Kogge-Stone rounds are register shuffles and
// in-thread moves, and every lane computes the float expression of
// banded_kernel<F32Ops> in the same order, so the two are bit-identical
// (its min as fminf: see F32x1Ops).
// The x loop has no barrier.  Shared memory: the penalty table, float
// [16 * 16], built once per block; per warp its query row [lq] and window
// [lq + band].  The prologue and epilogue are banded_kernel's: the same
// gathers, the same diagonal sums in x order, the same capture, lane pick
// and diag_out.  Other bands take banded_kernel<F32Ops>.
// What bounds it: the float32 operations of the DP cells (12 a cell at one a
// lane a clock) and, at band 128, the 25 warp shuffles a step; the block
// kernel lost most of its time to one block barrier and shared-memory round
// trip per exchange, 2 + log2(band) exchanges a step.  fminf in place of a
// compare and a select took the warp kernels 1.23-1.39x faster
// (experiments/f32_warp_variants.py, NVIDIA H100 80GB HBM3, 700 W).
template <int P>
__global__ void __launch_bounds__(32 * kCandsPerBlock) banded_f32_warp_kernel(
    const uint8_t* __restrict__ reads, int64_t lq,
    const uint8_t* __restrict__ concat, int64_t concat_len,
    const int64_t* __restrict__ read_id, const uint8_t* __restrict__ reversed,
    const int64_t* __restrict__ win_start, const int64_t* __restrict__ lane,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
    int64_t num_cands, F32Ops ops, float* __restrict__ out, float* __restrict__ diag_out) {
  constexpr int kBand = 32 * P;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const pen_tab = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  uint8_t* const s_q =
      smem + kPenTable * sizeof(float) + static_cast<int64_t>(warp) * (2 * lq + kBand);
  uint8_t* const s_w = s_q + lq;
  f32_pen_table(ops, pen_tab);
  const F32x1Ops ops1{ops};

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kCandsPerBlock + warp;
  if (b >= num_cands) return;
  const int n = n_arr[b];
  const int m = m_arr[b];
  warp_stage_gathered(reads + read_id[b] * lq, lq, n, reversed[b] != 0, concat, concat_len,
                      win_start[b], kBand, s_q, s_w, t);

  const int nx = n < lq ? n : static_cast<int>(lq);
  const int k0 = P * t;  // the thread's first lane
  float best[P], ins[P], diag[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = k0 + p <= m ? 0.0f : kBig;
    ins[p] = kBig;
    diag[p] = 0.0f;
  }
  for (int x = 0; x < nx; ++x) {
    float pen[P];
    bool live[P];
    f32_row<P>(pen_tab, s_q[x], s_w + x + k0, m - x - k0, pen, live);
#pragma unroll
    for (int p = 0; p < P; ++p) diag[p] = ops.add(diag[p], pen[p]);
    dp_step_w(ops1, pen, live, best, ins, t);
  }

  const float r = f32_capture(ops, n, lq, k0, m, best);
  if (t == 0) out[b] = r;
  int64_t pick = lane[b];
  pick = pick < 0 ? 0 : (pick > kBand - 1 ? kBand - 1 : pick);
  if (pick >= k0 && pick < k0 + P) out[num_cands + b] = diag[pick - k0];
  if (diag_out != nullptr) {
#pragma unroll
    for (int p = 0; p < P; ++p) diag_out[b * kBand + k0 + p] = diag[p];
  }
}

// One step of banded_i16_packed_warp_kernel at query position x, both rows'
// lanes k0 .. k0 + P - 1 of the pair in best/ins (low half row A, high half
// row B).  s_q[x] holds qA << 4 | qB, s_w[j] wB << 4 | wA, so each row's
// table index is one bitwise select of the two bytes: (qA, wA) for row A,
// (wB, qB) for row B, the same penalty since pen(q, w) = pen(w, q).
// With kSteady, both rows are active and every lane of the warp has its
// window cell (x + 63 < m of both rows), so no mask is built and no half is
// kept; otherwise `live` masks the window cells, a half whose row has ended
// (x >= nX) keeps its best and ins, and its diagonal sums stop.
template <bool kSteady, int P>
__device__ __forceinline__ void pair_step(const I16PairOps& ops2, const int16_t* pen_tab,
                                          const uint8_t* s_q, const uint8_t* s_w,
                                          const int (&m)[2], const int (&nx)[2], int x, int k0,
                                          uint32_t (&best)[P], uint32_t (&ins)[P],
                                          int (&diag)[2][P], int t) {
  const bool active0 = kSteady || x < nx[0], active1 = kSteady || x < nx[1];
  const int qq = s_q[x];
  const int lim0 = m[0] - x - k0, lim1 = m[1] - x - k0;  // lane k0 + p has a window cell iff p < lim
  uint32_t pen2[P], live[P], step_best[P], step_ins[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ww = s_w[x + k0 + p];
    const int pen_a = pen_tab[(qq & 0xf0) | (ww & 0x0f)];
    const int pen_b = pen_tab[(ww & 0xf0) | (qq & 0x0f)];
    if (active0) diag[0][p] += pen_a;
    if (active1) diag[1][p] += pen_b;
    pen2[p] = pack2(pen_a, pen_b);
    live[p] = kSteady ? 0xffffffffu : mask2(p < lim0, p < lim1);
    step_best[p] = best[p];
    step_ins[p] = ins[p];
  }
  dp_step_w(ops2, pen2, live, step_best, step_ins, t);
  const uint32_t active = mask2(active0, active1);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = select2(active, step_best[p], best[p]);
    ins[p] = select2(active, step_ins[p], ins[p]);
  }
}

// banded_i16_packed: the int16 DP at band 64 for two candidates at once, one
// warp a pair, kPairsPerBlock pairs a block.  Pair i is rows i and i + hb,
// hb = ceil(B / 2), as the reference's host split pairs them; with B odd the
// last pair's second row is a pad (n = m = 0, zero codes) whose outputs are
// dropped.  Thread t holds lanes 2t and 2t + 1 of both rows in two s16x2
// registers, row i's lane in the low half and row i + hb's in the high half
// (dp_core's one-lane-a-register layout, I16PairOps): every shift moves whole
// registers, so a step is 13 shuffles and no byte permute for 128 cells, and
// the sums and mins are DPX instructions on both rows at once.
// The x loop runs to max(nA, nB) with nX = min(n, lq).  dp_step_w is the step
// of an active row, so the step of a half whose row has ended is computed
// and dropped: best and ins keep that half, and its diagonal sums stop
// (pair_step).  The steps where both rows are active and every lane has its
// window cell, most of them, take pair_step's steady form.  Each warp stages
// its pair's codes, the two rows' 4-bit codes in one byte, in its own shared
// memory; the penalty table, int16 [16 * 16], is built once a block, as in
// banded_i16_warp_kernel.  The capture is final_lane per half and one warp
// min of both halves at once.
// Output: scores[row] (BIG at or above INF16, else * inv) and the diagonal
// sums diag_out[row * 64 + k] (int32 in x order, * inv).
// What bounds it: as banded_i16_warp_kernel, the int16 operations of its
// cells, with no byte permutes in the shifts; the pairing costs the longer of
// the two x loops.  The steady form takes the step from 139 SASS
// instructions to 94 and the kernel from 0.3117 to 0.2363 ms at 16,384 x 192;
// four pairs a block took 0.2401 ms, eight 0.2365
// (experiments/k3_pair_variants.py, NVIDIA H100 80GB HBM3, 700 W).
__global__ void __launch_bounds__(32 * kPairsPerBlock) banded_i16_packed_warp_kernel(
    const uint8_t* __restrict__ q, int64_t lq, const uint8_t* __restrict__ w, int64_t lw,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
    int64_t num_cands, I16Ops ops, float* __restrict__ out, float* __restrict__ diag_out) {
  constexpr int P = kHalf / 32;  // lanes a thread holds of each row
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* const pen_tab = reinterpret_cast<int16_t*>(smem);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  uint8_t* const s_q =
      smem + kPenTable * sizeof(int16_t) + static_cast<int64_t>(warp) * (2 * lq + kHalf);
  uint8_t* const s_w = s_q + lq;
  for (int i = threadIdx.x; i < kPenTable; i += blockDim.x) {
    pen_tab[i] = static_cast<int16_t>(ops.pen(i >> 4, i & 15));
  }
  __syncthreads();  // the table is the block's; from here on each warp works alone

  const int64_t hb = (num_cands + 1) / 2;
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kPairsPerBlock + warp;
  if (pair >= hb) return;
  const int64_t row[2] = {pair, pair + hb};
  const bool real_b = row[1] < num_cands;
  const int n[2] = {n_arr[row[0]], real_b ? n_arr[row[1]] : 0};
  const int m[2] = {m_arr[row[0]], real_b ? m_arr[row[1]] : 0};
  const int nx[2] = {n[0] < lq ? n[0] : static_cast<int>(lq), n[1] < lq ? n[1] : static_cast<int>(lq)};
  const uint8_t* const q_a = q + row[0] * lq;
  const uint8_t* const q_b = q + row[1] * lq;
  const uint8_t* const w_a = w + row[0] * lw;
  const uint8_t* const w_b = w + row[1] * lw;
  for (int64_t x = t; x < lq; x += 32) {
    const int qb = real_b ? __ldg(q_b + x) & 15 : 0;
    s_q[x] = static_cast<uint8_t>((__ldg(q_a + x) & 15) << 4 | qb);
  }
  for (int64_t j = t; j < lq + kHalf; j += 32) {
    const int wb = real_b ? __ldg(w_b + j) & 15 : 0;
    s_w[j] = static_cast<uint8_t>(wb << 4 | (__ldg(w_a + j) & 15));
  }
  __syncwarp();

  const I16PairOps ops2{I16x2Ops::of(ops)};
  const int k0 = P * t;  // the thread's first lane
  uint32_t best[P], ins[P];
  int diag[2][P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = pack2(k0 + p <= m[0] ? 0 : kInf16, k0 + p <= m[1] ? 0 : kInf16);
    ins[p] = ops2.inf();
    diag[0][p] = diag[1][p] = 0;
  }
  // steady while x < nX and x + kHalf - 1 < m for both rows
  const int steady0 = nx[0] < m[0] - kHalf + 1 ? nx[0] : m[0] - kHalf + 1;
  const int steady1 = nx[1] < m[1] - kHalf + 1 ? nx[1] : m[1] - kHalf + 1;
  const int x_steady = steady0 < steady1 ? steady0 : steady1;
  const int x_end = nx[0] > nx[1] ? nx[0] : nx[1];
  int x = 0;
  for (; x < x_steady; ++x) pair_step<true>(ops2, pen_tab, s_q, s_w, m, nx, x, k0, best, ins, diag, t);
  for (; x < x_end; ++x) pair_step<false>(ops2, pen_tab, s_q, s_w, m, nx, x, k0, best, ins, diag, t);

  uint32_t fin = ops2.inf();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    fin = __vmins2(fin, pack2(final_lane(ops, n[0], lq, k0 + p, m[0], lo16(best[p])),
                              final_lane(ops, n[1], lq, k0 + p, m[1], hi16(best[p]))));
  }
  fin = warp_min2(fin);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 1 && !real_b) break;
    if (t == 0) out[row[h]] = ops.score(half16(fin, h));
#pragma unroll
    for (int p = 0; p < P; ++p) diag_out[row[h] * kHalf + k0 + p] = ops.diag(diag[h][p]);
  }
}

// banded_roll_f32: the f32 banded DP on host-built rows, penalty computed in
// the kernel from the codes.  Like _pallas_kernel_roll, which carries the
// whole query and window arrays through its x loop, it stages the whole
// query row [lq] and its window [lq + band] in shared memory once.  At
// bands 64 and 128 that is banded_chunk_f32_warp_kernel with one chunk the
// width of the row; at other bands this kernel.
// grid: one block per candidate; block: `band` threads.  Scores only.
// What bounds it: as above; its shared memory grows with the read length,
// which banded_chunk_f32 avoids.
__global__ void banded_roll_kernel(
    const uint8_t* __restrict__ q, int64_t lq, const uint8_t* __restrict__ w, int64_t lw,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr, int band,
    F32Ops ops, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const bufs = reinterpret_cast<float*>(smem);
  uint8_t* s_q = reinterpret_cast<uint8_t*>(bufs + 2 * band);
  uint8_t* s_w = s_q + lq;

  const int64_t b = blockIdx.x;
  const int k = threadIdx.x;
  const int n = n_arr[b];
  const int m = m_arr[b];
  for (int64_t x = k; x < lq; x += band) s_q[x] = q[b * lq + x];
  for (int64_t j = k; j < lq + band; j += band) s_w[j] = w[b * lw + j];
  __syncthreads();

  const int nx = n < lq ? n : static_cast<int>(lq);
  float best = k <= m ? 0.0f : kBig;
  float ins = kBig;
  int p = 0;
  for (int x = 0; x < nx; ++x) {
    dp_step(ops, bufs, band, p, k, ops.pen(s_q[x], s_w[x + k]), x + k < m, best, ins);
  }
  const float r = capture(bufs, k, band, final_lane(ops, n, lq, k, m, best));
  if (k == 0) out[b] = r;
}

// banded_chunk_f32: the same function, staged the way _pallas_kernel walks
// its grid: for each chunk of `chunk` query positions, the chunk's query
// codes and its window slab [c * chunk, c * chunk + chunk + band) are loaded
// into shared memory, with a barrier between chunks.  The DP state stays in
// registers across the chunk seam, so shared memory does not grow with the
// read length.  grid: one block per candidate; block: `band` threads.
// What bounds it: as above, plus one extra barrier and staging pass per
// chunk.
__global__ void banded_chunk_kernel(
    const uint8_t* __restrict__ q, int64_t lq, const uint8_t* __restrict__ w, int64_t lw,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr, int band,
    int chunk, F32Ops ops, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* const bufs = reinterpret_cast<float*>(smem);
  uint8_t* s_q = reinterpret_cast<uint8_t*>(bufs + 2 * band);
  uint8_t* s_w = s_q + chunk;

  const int64_t b = blockIdx.x;
  const int k = threadIdx.x;
  const int n = n_arr[b];
  const int m = m_arr[b];
  const int nx = n < lq ? n : static_cast<int>(lq);
  float best = k <= m ? 0.0f : kBig;
  float ins = kBig;
  int p = 0;
  for (int c0 = 0; c0 < nx; c0 += chunk) {
    __syncthreads();  // the previous chunk's readers are done
    for (int j = k; j < chunk; j += band) s_q[j] = c0 + j < lq ? q[b * lq + c0 + j] : 0;
    for (int j = k; j < chunk + band; j += band) {
      s_w[j] = c0 + j < lw ? w[b * lw + c0 + j] : 0;
    }
    __syncthreads();
    const int x_end = c0 + chunk < nx ? c0 + chunk : nx;
    for (int x = c0; x < x_end; ++x) {
      dp_step(ops, bufs, band, p, k, ops.pen(s_q[x - c0], s_w[x - c0 + k]), x + k < m, best,
              ins);
    }
  }
  const float r = capture(bufs, k, band, final_lane(ops, n, lq, k, m, best));
  if (k == 0) out[b] = r;
}

// banded_chunk_f32 at bands 64 and 128 (band = 32 * P): one warp per
// candidate, kCandsPerBlock candidates per block, on the float32 warp-level
// pieces as banded_f32_warp_kernel, staged as banded_chunk_kernel: for each
// chunk of `chunk` query positions the warp stages that chunk's query codes
// [chunk] and its window slab [c0, c0 + chunk + band) into its own shared
// memory, zero past lq and lw, with __syncwarp() between chunks.  The DP
// state stays in registers across the seam.  Shared memory: the penalty
// table, then per warp 2 * chunk + band bytes, whatever the read width.
// banded_roll_f32 launches it with chunk = lq: the whole row and window
// staged once, before the x loop, as _pallas_kernel_roll holds them.
// What bounds it: as banded_f32_warp_kernel, plus one staging pass a chunk.
template <int P>
__global__ void __launch_bounds__(32 * kCandsPerBlock) banded_chunk_f32_warp_kernel(
    const uint8_t* __restrict__ q, int64_t lq, const uint8_t* __restrict__ w, int64_t lw,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr, int64_t num_cands,
    int chunk, F32Ops ops, float* __restrict__ out) {
  constexpr int kBand = 32 * P;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const pen_tab = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  uint8_t* const s_q =
      smem + kPenTable * sizeof(float) + static_cast<int64_t>(warp) * (2 * chunk + kBand);
  uint8_t* const s_w = s_q + chunk;
  f32_pen_table(ops, pen_tab);
  const F32x1Ops ops1{ops};

  const int64_t b = static_cast<int64_t>(blockIdx.x) * kCandsPerBlock + warp;
  if (b >= num_cands) return;
  const int n = n_arr[b];
  const int m = m_arr[b];
  const uint8_t* const q_row = q + b * lq;
  const uint8_t* const w_row = w + b * lw;
  const int nx = n < lq ? n : static_cast<int>(lq);
  const int k0 = P * t;
  float best[P], ins[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = k0 + p <= m ? 0.0f : kBig;
    ins[p] = kBig;
  }
  for (int c0 = 0; c0 < nx; c0 += chunk) {
    __syncwarp();  // the previous chunk's readers are done
    for (int j = t; j < chunk; j += 32) {
      s_q[j] = static_cast<uint8_t>(c0 + j < lq ? __ldg(q_row + c0 + j) & 15 : 0);
    }
    for (int j = t; j < chunk + kBand; j += 32) {
      s_w[j] = static_cast<uint8_t>(c0 + j < lw ? __ldg(w_row + c0 + j) & 15 : 0);
    }
    __syncwarp();
    const int x_end = c0 + chunk < nx ? c0 + chunk : nx;
    for (int x = c0; x < x_end; ++x) {
      float pen[P];
      bool live[P];
      f32_row<P>(pen_tab, s_q[x - c0], s_w + (x - c0) + k0, m - x - k0, pen, live);
      dp_step_w(ops1, pen, live, best, ins, t);
    }
  }
  const float r = f32_capture(ops, n, lq, k0, m, best);
  if (t == 0) out[b] = r;
}

template <class Ops>
int launch(const uint8_t* reads, int64_t lq, const uint8_t* concat, int64_t concat_len,
           const int64_t* read_id, const uint8_t* reversed, const int64_t* win_start,
           const int64_t* lane, const int32_t* n, const int32_t* m, int64_t num_cands,
           int band, Ops ops, float* out, float* diag_out, void* stream) {
  return launch_kernel(banded_kernel<Ops>, static_cast<unsigned>(num_cands), band,
                       block_smem(lq, band), stream, reads, lq, concat, concat_len, read_id,
                       reversed, win_start, lane, n, m, num_cands, band, ops, out, diag_out);
}

// banded_chunk_f32_warp_kernel at its band, `span` query positions staged at once.
int launch_rows_f32_warp(const uint8_t* q, int64_t lq, const uint8_t* w, int64_t lw,
                         const int32_t* n, const int32_t* m, int64_t num_cands, int band,
                         int span, F32Ops ops, float* out, void* stream) {
  const auto kernel =
      band == 64 ? banded_chunk_f32_warp_kernel<2> : banded_chunk_f32_warp_kernel<4>;
  return launch_kernel(kernel, warp_grid(num_cands), 32 * kCandsPerBlock,
                       warp_smem(span, band, sizeof(float)), stream, q, lq, w, lw, n, m,
                       num_cands, span, ops, out);
}

}  // namespace

extern "C" int mapper_banded_i16(
    const uint8_t* reads, int64_t lq, const uint8_t* concat, int64_t concat_len,
    const int64_t* read_id, const uint8_t* reversed, const int64_t* win_start,
    const int64_t* lane, const int32_t* n, const int32_t* m, int64_t num_cands, int band,
    int mutation, int amb_unit, int ins_open, int ins_ext, int del_open, int del_ext,
    float inv, float* out, float* diag_out, void* stream) {
  if (num_cands == 0) return 0;
  I16Ops ops{mutation, amb_unit, ins_open, ins_ext, del_open, del_ext, inv};
  if (!warp_band(band)) {
    return launch(reads, lq, concat, concat_len, read_id, reversed, win_start, lane, n, m,
                  num_cands, band, ops, out, diag_out, stream);
  }
  const auto kernel = band == 64 ? banded_i16_warp_kernel<1> : banded_i16_warp_kernel<2>;
  return launch_kernel(kernel, warp_grid(num_cands), 32 * kCandsPerBlock,
                       warp_smem(lq, band, sizeof(int16_t)), stream, reads, lq, concat,
                       concat_len, read_id, reversed, win_start, lane, n, m, num_cands, ops,
                       out, diag_out);
}

extern "C" int mapper_banded_f32(
    const uint8_t* reads, int64_t lq, const uint8_t* concat, int64_t concat_len,
    const int64_t* read_id, const uint8_t* reversed, const int64_t* win_start,
    const int64_t* lane, const int32_t* n, const int32_t* m, int64_t num_cands, int band,
    float mutation, float ambiguity, float ins_open, float ins_ext, float del_open,
    float del_ext, float* out, float* diag_out, void* stream) {
  if (num_cands == 0) return 0;
  F32Ops ops{mutation, ambiguity, ins_open, ins_ext, del_open, del_ext};
  if (!warp_band(band)) {
    return launch(reads, lq, concat, concat_len, read_id, reversed, win_start, lane, n, m,
                  num_cands, band, ops, out, diag_out, stream);
  }
  const auto kernel = band == 64 ? banded_f32_warp_kernel<2> : banded_f32_warp_kernel<4>;
  return launch_kernel(kernel, warp_grid(num_cands), 32 * kCandsPerBlock,
                       warp_smem(lq, band, sizeof(float)), stream, reads, lq, concat,
                       concat_len, read_id, reversed, win_start, lane, n, m, num_cands, ops,
                       out, diag_out);
}

extern "C" int mapper_banded_i16_packed(
    const uint8_t* q, int64_t lq, const uint8_t* w, int64_t lw, const int32_t* n,
    const int32_t* m, int64_t num_cands, int mutation, int amb_unit, int ins_open, int ins_ext,
    int del_open, int del_ext, float inv, float* out, float* diag_out, void* stream) {
  if (num_cands == 0) return 0;
  I16Ops ops{mutation, amb_unit, ins_open, ins_ext, del_open, del_ext, inv};
  const int64_t pairs = (num_cands + 1) / 2;
  return launch_kernel(banded_i16_packed_warp_kernel,
                       static_cast<unsigned>((pairs + kPairsPerBlock - 1) / kPairsPerBlock),
                       32 * kPairsPerBlock, pair_smem(lq), stream, q, lq, w, lw, n, m, num_cands,
                       ops, out, diag_out);
}

extern "C" int mapper_banded_roll_f32(
    const uint8_t* q, int64_t lq, const uint8_t* w, int64_t lw, const int32_t* n,
    const int32_t* m, int64_t num_cands, int band, float mutation, float ambiguity,
    float ins_open, float ins_ext, float del_open, float del_ext, float* out, void* stream) {
  if (num_cands == 0) return 0;
  F32Ops ops{mutation, ambiguity, ins_open, ins_ext, del_open, del_ext};
  if (!warp_band(band)) {
    return launch_kernel(banded_roll_kernel, static_cast<unsigned>(num_cands), band,
                         block_smem(lq, band), stream, q, lq, w, lw, n, m, band, ops, out);
  }
  const int span = static_cast<int>(lq);  // the whole row as one chunk
  return launch_rows_f32_warp(q, lq, w, lw, n, m, num_cands, band, span, ops, out, stream);
}

extern "C" int mapper_banded_chunk_f32(
    const uint8_t* q, int64_t lq, const uint8_t* w, int64_t lw, const int32_t* n,
    const int32_t* m, int64_t num_cands, int band, int chunk, float mutation, float ambiguity,
    float ins_open, float ins_ext, float del_open, float del_ext, float* out, void* stream) {
  if (num_cands == 0) return 0;
  F32Ops ops{mutation, ambiguity, ins_open, ins_ext, del_open, del_ext};
  if (!warp_band(band)) {
    return launch_kernel(banded_chunk_kernel, static_cast<unsigned>(num_cands), band,
                         block_smem(chunk, band), stream, q, lq, w, lw, n, m, band, chunk, ops,
                         out);
  }
  // a chunk wider than the rows stages the rows: the same single chunk
  const int span = chunk < lq ? chunk : static_cast<int>(lq);
  return launch_rows_f32_warp(q, lq, w, lw, n, m, num_cands, band, span, ops, out, stream);
}
