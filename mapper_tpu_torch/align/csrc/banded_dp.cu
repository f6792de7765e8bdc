// Banded affine-gap DP scoring of candidate windows, for sm_90a.
//
// Five kernels, one per TPU kernel of mapper_tpu/align/pallas_dp.py:
//   banded_i16         <- _pen_kernel_x_i16 (int16 units of 1/scale, driven by
//                         _pen_core_i16), used when _quantize_params finds an
//                         exact scale;
//   banded_f32         <- _pen_kernel_x (float32, driven by _pen_core), used
//                         otherwise (e.g. reads above 512 bp at default
//                         penalties);
//   banded_i16_packed  <- _pen_kernel_x_i16_packed (two band-64 candidates per
//                         block), used in place of banded_i16 for host rows at
//                         band 64;
//   banded_roll_f32    <- _pallas_kernel_roll (whole rows staged once);
//   banded_chunk_f32   <- _pallas_kernel (rows staged chunk by chunk).
// All five run the same DP step (dp_step in dp_core.cuh).
//
// What bounds them on this card: per DP cell the work is a few integer or
// float adds, mins and selects on data already in registers, and the bytes
// per cell are tiny (one query byte per row, one window byte per cell, staged
// in shared memory).  They are bound by instruction issue and by latency:
// each query position of a candidate depends on the previous one, so one
// candidate's x loop is serial, and the deletion chain inside a row needs
// log2(band) dependent exchange steps between lanes.
// What the design does about it: one block per candidate (per pair for the
// packed kernel) and one thread per band lane, so the band-wide vector ops of
// the TPU kernels become per-thread scalar ops and the lane shifts become
// shared-memory exchanges through two ping-pong buffers (one barrier per
// exchange).  Many independent candidates run on each SM (up to 32 blocks of
// 64 lanes, or 16 of 128) to hide the barrier and shared-memory latency.
//
// Bit-parity with the reference: the float path uses __fadd_rn/__fmul_rn/
// __fdiv_rn so no multiply-add is ever contracted, keeps the Kogge-Stone
// order min(chain, moved + f32(step) * del_ext), computes the ambiguity
// penalty as (ambiguity * f32(popcount - 1)) / 3 and sums the diagonals in
// x order.  The int path holds int16 state in int32 registers and clamps
// every sum to INF16 exactly where the reference clamps it.

#include <cstdint>
#include <cuda_runtime.h>

#include "dp_core.cuh"

namespace {

using namespace dp;

constexpr int kHalf = 64;  // the packed kernel's per-candidate band

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
    dp_step(ops, bufs, band, p, k, k, band, pen, x + k < m, true, best, ins);
  }

  const T r = capture(bufs, k, k, band, final_lane(ops, n, lq, k, m, best));
  if (k == 0) out[b] = ops.score(r);
  int64_t pick = lane[b];
  pick = pick < 0 ? 0 : (pick > band - 1 ? band - 1 : pick);
  if (k == pick) out[num_cands + b] = ops.diag(diag);
  if (diag_out != nullptr) diag_out[b * band + k] = ops.diag(diag);
}

// banded_i16_packed: two band-64 candidates per block of 128 threads.
// Block i holds row i in threads [0, 64) and row i + hb in [64, 128), where
// hb = ceil(B / 2), as the reference's host split pairs them.  With B odd the
// last block's second half is a pad candidate (n = m = 1, zero codes) whose
// outputs are dropped.  Every exchange stays inside a half (dp_step's
// `sub`/`width`), the capture is one min-reduce per half, and the x loop
// runs to max(nA, nB): a finished half is masked inactive and keeps taking
// part in every barrier.
// Shared memory: two ping-pong buffers of 128 ints; per half the query row
// [lq] and the window [lq + 64].
// Output: scores[row] (BIG at or above INF16, else * inv) and the diagonal
// sums diag_out[row * 64 + sub] (* inv).
// What bounds it: as above; the pairing halves the block count at band 64
// and fills 128-thread blocks, at the cost of the longer of the two x loops.
__global__ void banded_packed_kernel(
    const uint8_t* __restrict__ q, int64_t lq, const uint8_t* __restrict__ w, int64_t lw,
    const int32_t* __restrict__ n_arr, const int32_t* __restrict__ m_arr,
    int64_t num_cands, I16Ops ops, float* __restrict__ out, float* __restrict__ diag_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* const bufs = reinterpret_cast<int*>(smem);
  const int t = threadIdx.x;
  const int h = t / kHalf;
  const int sub = t % kHalf;
  const int64_t hb = (num_cands + 1) / 2;
  const int64_t row = blockIdx.x + h * hb;
  const bool real = row < num_cands;
  uint8_t* s_q = reinterpret_cast<uint8_t*>(bufs + 2 * 2 * kHalf) + h * (2 * lq + kHalf);
  uint8_t* s_w = s_q + lq;

  const int n = real ? n_arr[row] : 1;
  const int m = real ? m_arr[row] : 1;
  for (int64_t x = sub; x < lq; x += kHalf) s_q[x] = real ? q[row * lq + x] : 0;
  for (int64_t j = sub; j < lq + kHalf; j += kHalf) s_w[j] = real ? w[row * lw + j] : 0;
  __syncthreads();

  // the x loop bound is the same for the whole block
  int x_end = 0;
  for (int i = 0; i < 2; ++i) {
    const int64_t row_i = blockIdx.x + i * hb;
    const int ni = row_i < num_cands ? n_arr[row_i] : 1;
    const int nxi = ni < lq ? ni : static_cast<int>(lq);
    x_end = nxi > x_end ? nxi : x_end;
  }
  const int nx = n < lq ? n : static_cast<int>(lq);
  int best = sub <= m ? 0 : kInf16;
  int ins = kInf16;
  int diag = 0;
  int p = 0;
  for (int x = 0; x < x_end; ++x) {
    const bool active = x < nx;
    const int pen = ops.pen(s_q[x], s_w[x + sub]);
    if (active) diag += pen;
    dp_step(ops, bufs, 2 * kHalf, p, t, sub, kHalf, pen, x + sub < m, active, best, ins);
  }

  const int r = capture(bufs, t, sub, kHalf, final_lane(ops, n, lq, sub, m, best));
  if (real) {
    if (sub == 0) out[row] = ops.score(r);
    diag_out[row * kHalf + sub] = ops.diag(diag);
  }
}

// banded_roll_f32: the f32 banded DP on host-built rows, penalty computed in
// the kernel from the codes.  Like _pallas_kernel_roll, which carries the
// whole query and window arrays through its x loop, it stages the whole
// query row [lq] and its window [lq + band] in shared memory once.
// grid: one block per candidate; block: `band` threads.  Scores only.
// What bounds it: as above; its shared memory grows with the read length
// (the wrapper checks the 48 KB bound), which banded_chunk_f32 avoids.
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
    dp_step(ops, bufs, band, p, k, k, band, ops.pen(s_q[x], s_w[x + k]), x + k < m, true,
            best, ins);
  }
  const float r = capture(bufs, k, k, band, final_lane(ops, n, lq, k, m, best));
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
      dp_step(ops, bufs, band, p, k, k, band, ops.pen(s_q[x - c0], s_w[x - c0 + k]),
              x + k < m, true, best, ins);
    }
  }
  const float r = capture(bufs, k, k, band, final_lane(ops, n, lq, k, m, best));
  if (k == 0) out[b] = r;
}

template <class Ops>
int launch(const uint8_t* reads, int64_t lq, const uint8_t* concat, int64_t concat_len,
           const int64_t* read_id, const uint8_t* reversed, const int64_t* win_start,
           const int64_t* lane, const int32_t* n, const int32_t* m, int64_t num_cands,
           int band, Ops ops, float* out, float* diag_out, void* stream) {
  if (num_cands > 0) {
    const size_t smem = 2 * band * sizeof(typename Ops::T) + static_cast<size_t>(2 * lq + band);
    banded_kernel<Ops><<<static_cast<unsigned>(num_cands), band, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        reads, lq, concat, concat_len, read_id, reversed, win_start, lane, n, m,
        num_cands, band, ops, out, diag_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mapper_banded_i16(
    const uint8_t* reads, int64_t lq, const uint8_t* concat, int64_t concat_len,
    const int64_t* read_id, const uint8_t* reversed, const int64_t* win_start,
    const int64_t* lane, const int32_t* n, const int32_t* m, int64_t num_cands, int band,
    int mutation, int amb_unit, int ins_open, int ins_ext, int del_open, int del_ext,
    float inv, float* out, float* diag_out, void* stream) {
  I16Ops ops{mutation, amb_unit, ins_open, ins_ext, del_open, del_ext, inv};
  return launch(reads, lq, concat, concat_len, read_id, reversed, win_start, lane, n, m,
                num_cands, band, ops, out, diag_out, stream);
}

extern "C" int mapper_banded_f32(
    const uint8_t* reads, int64_t lq, const uint8_t* concat, int64_t concat_len,
    const int64_t* read_id, const uint8_t* reversed, const int64_t* win_start,
    const int64_t* lane, const int32_t* n, const int32_t* m, int64_t num_cands, int band,
    float mutation, float ambiguity, float ins_open, float ins_ext, float del_open,
    float del_ext, float* out, float* diag_out, void* stream) {
  F32Ops ops{mutation, ambiguity, ins_open, ins_ext, del_open, del_ext};
  return launch(reads, lq, concat, concat_len, read_id, reversed, win_start, lane, n, m,
                num_cands, band, ops, out, diag_out, stream);
}

extern "C" int mapper_banded_i16_packed(
    const uint8_t* q, int64_t lq, const uint8_t* w, int64_t lw, const int32_t* n,
    const int32_t* m, int64_t num_cands, int mutation, int amb_unit, int ins_open, int ins_ext,
    int del_open, int del_ext, float inv, float* out, float* diag_out, void* stream) {
  if (num_cands > 0) {
    I16Ops ops{mutation, amb_unit, ins_open, ins_ext, del_open, del_ext, inv};
    const size_t smem = 2 * 2 * kHalf * sizeof(int) + static_cast<size_t>(2 * (2 * lq + kHalf));
    banded_packed_kernel<<<static_cast<unsigned>((num_cands + 1) / 2), 2 * kHalf, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        q, lq, w, lw, n, m, num_cands, ops, out, diag_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mapper_banded_roll_f32(
    const uint8_t* q, int64_t lq, const uint8_t* w, int64_t lw, const int32_t* n,
    const int32_t* m, int64_t num_cands, int band, float mutation, float ambiguity,
    float ins_open, float ins_ext, float del_open, float del_ext, float* out, void* stream) {
  if (num_cands > 0) {
    F32Ops ops{mutation, ambiguity, ins_open, ins_ext, del_open, del_ext};
    const size_t smem = 2 * band * sizeof(float) + static_cast<size_t>(2 * lq + band);
    banded_roll_kernel<<<static_cast<unsigned>(num_cands), band, smem,
                         static_cast<cudaStream_t>(stream)>>>(q, lq, w, lw, n, m, band, ops, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mapper_banded_chunk_f32(
    const uint8_t* q, int64_t lq, const uint8_t* w, int64_t lw, const int32_t* n,
    const int32_t* m, int64_t num_cands, int band, int chunk, float mutation, float ambiguity,
    float ins_open, float ins_ext, float del_open, float del_ext, float* out, void* stream) {
  if (num_cands > 0) {
    F32Ops ops{mutation, ambiguity, ins_open, ins_ext, del_open, del_ext};
    const size_t smem = 2 * band * sizeof(float) + static_cast<size_t>(2 * chunk + band);
    banded_chunk_kernel<<<static_cast<unsigned>(num_cands), band, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        q, lq, w, lw, n, m, band, chunk, ops, out);
  }
  return static_cast<int>(cudaGetLastError());
}
