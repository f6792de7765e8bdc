// Candidate generation on the card, for sm_90a: the device-candidates
// program of mapper_tpu_torch/batch/device_candidates.py as two kernels.
//
//   candidates_kernel  (KC1) <- _device_candidates_core,
//                         mapper_tpu/batch/device_candidates.py:406-567 (one
//                         XLA program, jitted at :569-587): the pyramid of
//                         content-defined blocks, the gapmers, the index
//                         lookup, the offset votes and the per-read top-K;
//   fused_rows_kernel  (KC2) <- the half of _fused_core before the scorer,
//                         device_candidates.py:748-797: the keep rule, the
//                         key decode, the chunk-wide compaction of the kept
//                         rows and their scoring geometry.
// Neither program has a pallas_call; on the TPU XLA compiled each into one
// program.  In eager PyTorch (candidates_plain, fused_rows_plain) they are
// about 3,975 small operations a 4,096-read chunk, each issued by the host.
//
// What bounds KC1 on this card: per read it walks 16 pyramid levels of at
// most the read's length in blocks, with integer hashing, one compaction a
// level, then up to 512 seeds' index gathers, up to 1,024 vote keys to sort
// and K rounds of a block-wide pick.  The bytes it must move are few (the
// codes, one 32-byte sector per gather, the [B, 2K+1] table); the work is
// integer operations and block barriers, dependent from level to level.  The
// design keeps everything a read needs on chip: one block of kThreads threads
// per read, the pyramid as a compacted list of the level's valid blocks in
// slot order (each block's right neighbour is the next entry, so no
// next-valid search), the gapmer prefix tables, the seed list, the vote keys
// and their counts in shared memory.  Each level appends its passing seeds
// and compacts its surviving blocks by warp ballots; the votes are a bitonic
// sort of the keys and a binary search for each run's end; the top-K rounds
// are block-wide maxima of (votes, -sorted index).  A read too wide for the
// shared memory keeps its two lists and prefix tables in a scratch buffer
// (one slice a resident block) and walks the reads with a grid stride.
//
// What bounds KC2: one pass over the B x K table entries with a block-wide
// scan (the kept rows keep read-major, rank-minor order across the whole
// chunk), then a few gathers a kept row.  It runs as one block of
// kRowsThreads threads that walks the table a tile at a time, carrying the
// running count of kept rows.
//
// Both equal their plain versions bit for bit: Java's long arithmetic of
// mergeHashes in uint64_t reinterpreted, the uint32 gapmer products in
// uint32_t, floor division and modulo written out where the plain version
// takes torch.remainder or rounding_mode="floor", truncation where it takes
// Java's int division or torch.fmod.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

using cuda_launch::launch_kernel;

// The budgets of batch/device_candidates.py (kernels.py's test holds them
// equal to the Python module's).
constexpr int kNumLevels = 16;  // NUM_LEVELS
constexpr int kVSlots = 512;  // V_SLOTS
constexpr int kPSlots = 1024;  // P_SLOTS
constexpr int kMaxMatches = 12;  // MAX_MATCHES_PER_SEED
constexpr int64_t kNoKey = 2147483647;  // _NO_KEY: the key of an empty rank
// HashBlock.java's multipliers (index/hashblock.py).
constexpr int64_t kMergeMultiplier = 54323;  // MERGE_MULTIPLIER
constexpr int64_t kMergeLengthMultiplier = 323;  // MERGE_LENGTH_MULTIPLIER
constexpr uint32_t kGapmerMultiplier = 7654337u;  // GAPMER_MULTIPLIER
constexpr uint32_t kGapmerInverse = 242828353u;  // its inverse mod 2^32

constexpr int kThreads = 256;  // KC1's threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kRowsThreads = 1024;  // KC2's threads (its one block)
constexpr int kRowsWarps = kRowsThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// A block's flag bits in the pyramid lists.
constexpr uint8_t kReqL = 1, kReqR = 2, kNextL = 4, kNextR = 8;

// Shared memory of KC1 (kernels.py's candidates_smem mirrors both sums).
// Fixed part: the vote keys [kPSlots] int64, the block-max slots [32]
// uint64, the vote counts [kPSlots] int32, the scan slots [2 x 32] int32,
// the seeds' key, size, start and length [kVSlots] int32 each and their
// primary flags [kVSlots] bytes.
constexpr size_t kFixedSmem = kPSlots * 8 + 32 * 8 + kPSlots * 4 + 2 * 32 * 4 + kVSlots * 4 * 4 +
                              kVSlots;
// The row of a read `width` wide, in shared memory or in its scratch slice:
// two lists of `width` blocks (start, length, fwd and rev int32, a flag
// byte) and the two gapmer prefix tables [width + 1] uint32, rounded up to
// 16 bytes.
__host__ __device__ size_t row_bytes(int64_t width) {
  return static_cast<size_t>((2 * width * 17 + 2 * (width + 1) * 4 + 15) / 16 * 16);
}
size_t candidates_smem(int64_t width, bool scratch) {
  return kFixedSmem + (scratch ? 0 : row_bytes(width));
}
// KC2: the scan slots [32] int32.
size_t rows_smem() { return kRowsWarps * 4; }

template <class T>
__device__ __forceinline__ T min_of(T a, T b) { return a < b ? a : b; }
template <class T>
__device__ __forceinline__ T max_of(T a, T b) { return a < b ? b : a; }

// Floor division and modulo of int64 values (numpy's // and %), d != 0.
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t d) {
  const int64_t q = a / d;
  return (a % d != 0 && ((a < 0) != (d < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t d) {
  const int64_t r = a % d;
  return (r != 0 && ((r < 0) != (d < 0))) ? r + d : r;
}

// Java's (int) cast.
__device__ __forceinline__ int32_t wrap32(uint64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}

// HashBlock.mergeHashes (HashBlock.java:261-269) in Java long arithmetic:
// rotated_left = ((long) l_hash + 1) * (54323 + 323 * r_len),
// rotated_right = (long)(int)(r_hash + 1) * (long) l_len,
// (int)(sum + (sum >> 32)) with an arithmetic shift.  The products wrap in
// uint64_t, as a Java long does.
__device__ __forceinline__ int32_t merge_hashes(int32_t l_len, int32_t l_hash, int32_t r_len,
                                                int32_t r_hash) {
  const uint64_t left = static_cast<uint64_t>(static_cast<int64_t>(l_hash) + 1) *
                        static_cast<uint64_t>(kMergeMultiplier + kMergeLengthMultiplier * r_len);
  const int32_t r1 = static_cast<int32_t>(static_cast<uint32_t>(r_hash) + 1u);
  const uint64_t right = static_cast<uint64_t>(static_cast<int64_t>(r1)) *
                         static_cast<uint64_t>(static_cast<int64_t>(l_len));
  const uint64_t total = left + right;
  const int64_t high = static_cast<int64_t>(total) >> 32;
  return wrap32(total + static_cast<uint64_t>(high));
}

__device__ __forceinline__ uint32_t pow_u32(uint32_t base, int64_t e) {
  uint32_t r = 1u;
  while (e > 0) {
    if (e & 1) r *= base;
    base *= base;
    e >>= 1;
  }
  return r;
}

// nibble -> 2-bit code (A=0 C=1 G=2 T=3, -1 elsewhere), gapmer value
// (A..T -> 1..4, 0 elsewhere) and complemented value (4..1).
__device__ __forceinline__ int32_t two_bit(int c) {
  return c == 1 ? 0 : c == 2 ? 1 : c == 4 ? 2 : c == 8 ? 3 : -1;
}
__device__ __forceinline__ uint32_t gap_val(int c) {
  return c == 1 ? 1u : c == 2 ? 2u : c == 4 ? 3u : c == 8 ? 4u : 0u;
}
__device__ __forceinline__ uint32_t gap_val_comp(int c) {
  return c == 1 ? 4u : c == 2 ? 3u : c == 4 ? 2u : c == 8 ? 1u : 0u;
}

// ---- block-wide pieces: every thread of the block calls them, equally often

__device__ __forceinline__ int lane_id() { return static_cast<int>(threadIdx.x & 31u); }
__device__ __forceinline__ int warp_id() { return static_cast<int>(threadIdx.x >> 5); }

// The number of threads before this one (in thread order) whose `flag` is
// set, and in `total` the block's count.
template <int kW>
__device__ int block_rank(bool flag, int* slots, int* total) {
  const unsigned mask = __ballot_sync(kFull, flag);
  if (lane_id() == 0) slots[warp_id()] = __popc(mask);
  __syncthreads();
  int before = __popc(mask & ((1u << lane_id()) - 1u));
  int sum = 0;
  for (int w = 0; w < kW; ++w) {
    const int c = slots[w];
    if (w < warp_id()) before += c;
    sum += c;
  }
  __syncthreads();
  *total = sum;
  return before;
}

// The exclusive prefix sum of `v` in thread order (wrapping for unsigned T),
// and in `total` the block's sum.
template <int kW, class T>
__device__ T block_exclusive_sum(T v, T* slots, T* total) {
  T incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const T up = __shfl_up_sync(kFull, incl, d);
    if (lane_id() >= d) incl += up;
  }
  if (lane_id() == 31) slots[warp_id()] = incl;
  __syncthreads();
  T base = 0, sum = 0;
  for (int w = 0; w < kW; ++w) {
    const T s = slots[w];
    if (w < warp_id()) base += s;
    sum += s;
  }
  __syncthreads();
  *total = sum;
  return base + incl - v;
}

template <int kW>
__device__ uint64_t block_max(uint64_t v, uint64_t* slots) {
  for (int d = 16; d > 0; d >>= 1) v = max_of(v, __shfl_xor_sync(kFull, v, d));
  if (lane_id() == 0) slots[warp_id()] = v;
  __syncthreads();
  uint64_t m = 0;
  for (int w = 0; w < kW; ++w) m = max_of(m, slots[w]);
  __syncthreads();
  return m;
}

// ---- the pyramid

struct Block {
  int32_t start, len, fwd, rev;
  uint8_t flags;
};

// The two lists of a read's pyramid (list c at offset c * width of each
// array) and its gapmer prefix tables.
struct Row {
  int32_t* start;
  int32_t* len;
  int32_t* fwd;
  int32_t* rev;
  uint8_t* flags;
  uint32_t* pref_fwd;
  uint32_t* pref_comp;

  __device__ Row(unsigned char* base, int64_t width) {
    pref_fwd = reinterpret_cast<uint32_t*>(base);
    pref_comp = pref_fwd + (width + 1);
    start = reinterpret_cast<int32_t*>(pref_comp + (width + 1));
    len = start + 2 * width;
    fwd = len + 2 * width;
    rev = fwd + 2 * width;
    flags = reinterpret_cast<uint8_t*>(rev + 2 * width);
  }
  __device__ Block load(int64_t i) const {
    return Block{start[i], len[i], fwd[i], rev[i], flags[i]};
  }
  __device__ void store(int64_t i, const Block& b) const {
    start[i] = b.start;
    len[i] = b.len;
    fwd[i] = b.fwd;
    rev[i] = b.rev;
    flags[i] = b.flags;
  }
};

__device__ __forceinline__ bool bit(uint8_t flags, uint8_t b) { return (flags & b) != 0; }

// One pyramid level for a valid block `l` and its next valid neighbour `r`
// (has_r; zero otherwise): HashBlock_ParentRow.shouldMergeBlocks and the
// merging constructor, the flag algebra of _merge_row_device.  Returns
// whether the merged block stays valid; `out` keeps the left block's start.
__device__ bool merge(const Block& l, const Block& r, bool has_r, Block* out, int* gap_dir,
                      int32_t* extra) {
  const bool should = (l.start + l.len >= r.start) && (bit(l.flags, kReqR) || bit(r.flags, kReqL));
  const int32_t length = r.start + r.len - l.start;
  const int32_t fwd = merge_hashes(l.len, l.fwd, r.len, r.fwd);
  const int32_t rev = merge_hashes(r.len, r.rev, l.len, l.rev);

  const bool anchor_exists = l.fwd != r.rev;
  const bool anchor_is_right = l.fwd > r.rev;
  const bool asym = anchor_exists && fwd != rev;
  const bool invert = (fwd < rev) == anchor_is_right;

  bool a_nl = anchor_is_right ? bit(r.flags, kNextL) : bit(l.flags, kNextL);
  bool a_nr = anchor_is_right ? bit(r.flags, kNextR) : bit(l.flags, kNextR);
  const bool both = a_nl && a_nr;
  if (both && anchor_is_right) a_nr = false;
  if (both && !anchor_is_right) a_nl = false;
  bool o_nl = anchor_is_right ? bit(l.flags, kNextL) : bit(r.flags, kNextL);
  bool o_nr = anchor_is_right ? bit(l.flags, kNextR) : bit(r.flags, kNextR);
  const bool both_o = o_nl && o_nr;
  if (both_o && !anchor_is_right) o_nl = false;
  if (both_o && anchor_is_right) o_nr = false;

  bool req_l = asym ? (a_nl != invert) : true;
  bool req_r = asym ? (a_nr != invert) : true;
  bool next_l = asym ? (o_nl != invert) : true;
  bool next_r = asym ? (o_nr != invert) : true;

  if (l.len != r.len) {
    const bool lg = l.len > r.len;
    req_l = lg;
    req_r = !lg;
    next_l = !lg;
    next_r = lg;
  }
  const bool asym_hash = fwd != rev;
  if (asym_hash && req_l && req_r) {
    req_l = fwd > rev;
    req_r = !req_l;
  }
  if (asym_hash && next_l && next_r) {
    next_l = req_l;
    next_r = !req_l;
  }
  *gap_dir = req_l != req_r ? (req_l ? 1 : -1) : (anchor_exists ? (anchor_is_right ? 1 : -1) : 0);
  // extraGapmerLength: Java int division truncates toward zero, as C++'s
  *extra = (l.len + r.len - length) / 4;
  out->start = l.start;
  out->len = length;
  out->fwd = fwd;
  out->rev = rev;
  out->flags = static_cast<uint8_t>((req_l ? kReqL : 0) | (req_r ? kReqR : 0) |
                                    (next_l ? kNextL : 0) | (next_r ? kNextR : 0));
  return has_r && should;
}

struct Seed {
  int32_t key, num_bp, start, len;
  bool primary;
};

// HashBlock.withGapAndExtension (HashBlock.java:67-150) for a merged block,
// as _expand_gapmers_device: the gapmer's key, size, start, length and
// strand.  Returns whether it stays inside the read (the reference returns
// null otherwise).
__device__ bool gapmer(const Block& b, int gap_dir, int32_t extra, int64_t read_len,
                       int64_t width, const uint32_t* pref_fwd, const uint32_t* pref_comp,
                       Seed* s) {
  // targetExtraLength = length + |max(fwd, rev)| % 3 + extra, in Java: the
  // abs of INT_MIN stays INT_MIN and % truncates, as C++'s
  const int32_t m = max_of(b.fwd, b.rev);
  const int32_t abs_m = m < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(m)) : m;
  const int32_t rem = abs_m % 3;
  const int32_t gap = b.len / 2;  // len >= 1: floor
  const int32_t ext_len = b.len + rem + extra - gap;
  const bool left = gap_dir < 0, right = gap_dir > 0, none = gap_dir == 0;
  const int64_t ext_start = left ? int64_t{b.start} - gap - ext_len
                                 : right ? int64_t{b.start} + b.len + gap : 0;
  const int64_t ext_end = left ? int64_t{b.start} - gap
                               : right ? int64_t{b.start} + b.len + gap + ext_len : 0;
  const bool in_bounds = none || (left && ext_start >= 0) || (right && ext_end <= read_len);

  int32_t fwd = b.fwd, rev = b.rev;
  if (!none) {
    const int64_t cs = min_of(max_of(ext_start, int64_t{0}), width);
    const int64_t ce = min_of(max_of(ext_end, int64_t{0}), width);
    const uint32_t hash =
        left ? (pref_fwd[ce] - pref_fwd[cs]) * pow_u32(kGapmerInverse, cs)
             : (pref_comp[ce] - pref_comp[cs]) * pow_u32(kGapmerMultiplier, max_of(ce, int64_t{1}) - 1);
    fwd = static_cast<int32_t>(static_cast<uint32_t>(fwd) + hash);
    rev = static_cast<int32_t>(static_cast<uint32_t>(rev) + hash);
  }
  const bool flags_differ = bit(b.flags, kReqL) != bit(b.flags, kReqR);
  s->primary = (none && flags_differ) ? bit(b.flags, kReqL) : fwd >= rev;
  s->key = s->primary ? fwd : rev;
  s->num_bp = none ? b.len : b.len + ext_len;
  s->len = none ? b.len : b.len + gap + ext_len;
  s->start = left ? static_cast<int32_t>(ext_start) : b.start;
  return in_bounds;
}

// ---- lookup and votes

struct Index {
  const int64_t* capacities;
  const int64_t* caps;
  const int64_t* bases;
  int64_t num_sizes;
  const int32_t* counts;
  const int32_t* offsets;
  const int32_t* values;
  const int64_t* rev_flags;
  const int64_t* fwd_index;
  const int64_t* seq_lengths;
  const int64_t* rc_index;
  const int64_t* seq_starts;
  const int64_t* seq_starts_tail;
  int64_t num_tail;
};

struct Scalars {
  int64_t max_size, min_size, n_seqs, span, bias;
};

// The vote key of a seed's match at global position `pos`: the position's
// sequence (the number of sequence starts after the first that are <= pos,
// searchsorted(right=True)), folded to (strand, forward contig, offset).
__device__ int64_t vote_key(int64_t pos, int64_t start, int64_t len, bool primary,
                            int64_t read_len, const Index& ix, const Scalars& sc) {
  int64_t lo = 0, hi = ix.num_tail;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (ix.seq_starts_tail[mid] <= pos) lo = mid + 1;
    else hi = mid;
  }
  const int64_t seq = lo;
  const int64_t pos_off = pos - ix.seq_starts[seq];
  int64_t folded_seq = seq, folded_off = pos_off;
  if (!primary) {
    folded_seq = ix.rc_index[seq];
    folded_off = ix.seq_lengths[folded_seq] - pos_off - len;
  }
  const bool mrev = ix.rev_flags[folded_seq] != 0;
  const int64_t fwd_idx = ix.fwd_index[folded_seq];
  const int64_t offv = mrev ? (ix.seq_lengths[fwd_idx] - (folded_off + len)) - (read_len - (start + len))
                            : folded_off - start;
  return ((mrev ? 1 : 0) * sc.n_seqs + fwd_idx) * sc.span + (offv + sc.bias);
}

// KC1.  grid: one block per read in shared memory, `gridDim.x` resident
// blocks walking the reads with a grid stride when the row lives in
// `scratch` (a slice of row_bytes(width) a block); block: kThreads threads.
// Output: out[b, :K] the top-K vote keys (kNoKey where a rank is empty),
// out[b, K:2K] their votes, out[b, 2K] the fallback flag (unconverged after
// kNumLevels levels, more than kVSlots seeds or kPSlots vote entries).
template <bool kScratch>
__global__ void __launch_bounds__(kThreads)
    candidates_kernel(const uint8_t* __restrict__ codes, int64_t width,
                      const int64_t* __restrict__ lengths, int64_t num_reads, Index ix,
                      Scalars sc, int k_out, int32_t* __restrict__ out,
                      unsigned char* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* vote_keys = reinterpret_cast<int64_t*>(smem);
  uint64_t* max_slots = reinterpret_cast<uint64_t*>(vote_keys + kPSlots);
  int32_t* vote_counts = reinterpret_cast<int32_t*>(max_slots + 32);
  int* scan0 = vote_counts + kPSlots;
  int* scan1 = scan0 + 32;
  int32_t* seed_key = scan1 + 32;
  int32_t* seed_nbp = seed_key + kVSlots;
  int32_t* seed_start = seed_nbp + kVSlots;
  int32_t* seed_len = seed_start + kVSlots;
  uint8_t* seed_primary = reinterpret_cast<uint8_t*>(seed_len + kVSlots);
  const Row row(kScratch ? scratch + blockIdx.x * row_bytes(width) : smem + kFixedSmem, width);
  const int tid = static_cast<int>(threadIdx.x);
  const int row_width = 2 * k_out + 1;

  for (int64_t b = blockIdx.x; b < num_reads; b += gridDim.x) {
    const uint8_t* code = codes + b * width;
    const int64_t read_len = lengths[b];
    const int n0 = static_cast<int>(min_of(max_of(read_len, int64_t{0}), width));

    // the gapmer prefix tables over the whole width (uint32 sums wrap as
    // the plain version's int64 sums taken mod 2^32), and the base row: one
    // 1-bp block per position of the read
    if (tid == 0) {
      row.pref_fwd[0] = 0u;
      row.pref_comp[0] = 0u;
    }
    uint32_t pow_f = pow_u32(kGapmerMultiplier, tid), pow_c = pow_u32(kGapmerInverse, tid);
    const uint32_t step_f = pow_u32(kGapmerMultiplier, kThreads);
    const uint32_t step_c = pow_u32(kGapmerInverse, kThreads);
    uint32_t carry_f = 0u, carry_c = 0u;
    for (int64_t t0 = 0; t0 < width; t0 += kThreads) {
      const int64_t i = t0 + tid;
      uint32_t term_f = 0u, term_c = 0u;
      if (i < width) {
        const int c = code[i];
        term_f = gap_val(c) * pow_f;
        term_c = gap_val_comp(c) * pow_c;
        if (i < n0) {
          const int32_t v = two_bit(c);
          row.store(i, Block{static_cast<int32_t>(i), 1, v, 3 - v,
                             static_cast<uint8_t>((v < 2 ? kReqL : 0) | (v >= 2 ? kReqR : 0) |
                                                  ((v & 1) == 0 ? kNextL : 0) |
                                                  ((v & 1) == 1 ? kNextR : 0))});
        }
      }
      uint32_t total_f, total_c;
      const uint32_t before_f = block_exclusive_sum<kWarps>(term_f, reinterpret_cast<uint32_t*>(scan0), &total_f);
      const uint32_t before_c = block_exclusive_sum<kWarps>(term_c, reinterpret_cast<uint32_t*>(scan1), &total_c);
      if (i < width) {
        row.pref_fwd[i + 1] = carry_f + before_f + term_f;
        row.pref_comp[i + 1] = carry_c + before_c + term_c;
      }
      carry_f += total_f;
      carry_c += total_c;
      pow_f *= step_f;
      pow_c *= step_c;
    }
    __syncthreads();

    // the levels: each merges the list's valid blocks with their right
    // neighbours, appends the passing gapmers to the seed list in slot
    // order, and compacts the merged blocks that stay valid into the other list
    int n = n0, cur = 0, seeds = 0, short_left = 0;
    for (int level = 0; level < kNumLevels; ++level) {
      const int64_t in = int64_t{cur} * width, nxt = int64_t{cur ^ 1} * width;
      int kept = 0;
      for (int t0 = 0; t0 < n; t0 += kThreads) {
        const int t = t0 + tid;
        bool valid = false, ok = false;
        Block merged{};
        Seed seed{};
        if (t < n) {
          const bool has_r = t + 1 < n;
          const Block l = row.load(in + t);
          const Block r = has_r ? row.load(in + t + 1) : Block{};
          int gap_dir;
          int32_t extra;
          valid = merge(l, r, has_r, &merged, &gap_dir, &extra);
          const bool inside =
              gapmer(merged, gap_dir, extra, read_len, width, row.pref_fwd, row.pref_comp, &seed);
          ok = valid && inside && seed.num_bp >= sc.min_size && seed.num_bp <= sc.max_size;
        }
        int total_valid, total_ok;
        const int rank_valid = block_rank<kWarps>(valid, scan0, &total_valid);
        const int rank_ok = block_rank<kWarps>(ok, scan1, &total_ok);
        if (valid) row.store(nxt + kept + rank_valid, merged);
        if (ok && seeds + rank_ok < kVSlots) {
          const int s = seeds + rank_ok;
          seed_key[s] = seed.key;
          seed_nbp[s] = seed.num_bp;
          seed_start[s] = seed.start;
          seed_len[s] = seed.len;
          seed_primary[s] = seed.primary;
        }
        if (level == kNumLevels - 1 && valid && merged.len <= sc.max_size) short_left = 1;
        kept += total_valid;
        seeds += total_ok;
      }
      __syncthreads();  // the next level reads what this one stored
      n = kept;
      cur ^= 1;
    }
    // blocks left that the host path would keep merging
    const bool unconverged = __syncthreads_or(short_left) != 0 && n >= 2;
    const bool seed_overflow = seeds > kVSlots;

    // each kept seed's bin, then its matches' vote keys, seed-major and
    // match-minor, into the first kPSlots slots
    const int num_seeds = min_of(seeds, kVSlots);
    int entries = 0;
    for (int v0 = 0; v0 < num_seeds; v0 += kThreads) {
      const int v = v0 + tid;
      int count = 0;
      int64_t first = 0;
      if (v < num_seeds) {
        const int64_t nb = min_of(max_of(int64_t{seed_nbp[v]}, int64_t{0}), ix.num_sizes - 1);
        const int64_t bin = ix.bases[nb] + floor_mod(seed_key[v], ix.capacities[nb]);
        const int64_t cnt = ix.counts[bin];
        const int64_t limit = min_of(ix.caps[nb], int64_t{kMaxMatches});
        if (cnt > 0 && cnt <= limit) {
          count = static_cast<int>(cnt);
          first = ix.offsets[bin];
        }
      }
      int total;
      const int before = block_exclusive_sum<kWarps>(count, scan0, &total);
      for (int j = 0; j < count && entries + before + j < kPSlots; ++j) {
        vote_keys[entries + before + j] = vote_key(ix.values[first + j], seed_start[v], seed_len[v],
                                                   seed_primary[v] != 0, read_len, ix, sc);
      }
      entries += total;
    }
    const bool entry_overflow = entries > kPSlots;
    const int num_entries = min_of(entries, kPSlots);

    // the votes: sort the keys (bitonic, padded to a power of two), then each
    // run's length at its first slot
    int padded = 1;
    while (padded < num_entries) padded <<= 1;
    for (int i = num_entries + tid; i < padded; i += kThreads) vote_keys[i] = INT64_MAX;
    __syncthreads();
    for (int k = 2; k <= padded; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < padded; i += kThreads) {
          const int p = i ^ j;
          if (p > i) {
            const int64_t a = vote_keys[i], c = vote_keys[p];
            if ((a > c) == ((i & k) == 0)) {
              vote_keys[i] = c;
              vote_keys[p] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int i = tid; i < num_entries; i += kThreads) {
      const int64_t key = vote_keys[i];
      int votes = 0;
      if (i == 0 || vote_keys[i - 1] != key) {
        int lo = i + 1, hi = num_entries;  // the first slot past the run
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (vote_keys[mid] > key) hi = mid;
          else lo = mid + 1;
        }
        votes = lo - i;
      }
      vote_counts[i] = votes;
    }
    __syncthreads();

    // top-K rounds: votes descending, then key ascending (the lowest sorted
    // slot of the highest count)
    int32_t* out_row = out + b * row_width;
    for (int r = 0; r < k_out; ++r) {
      uint64_t best = 0;
      for (int i = tid; i < num_entries; i += kThreads) {
        const int votes = vote_counts[i];
        if (votes > 0) {
          best = max_of(best, (static_cast<uint64_t>(votes) << 32) | (kFull - static_cast<uint32_t>(i)));
        }
      }
      best = block_max<kWarps>(best, max_slots);
      if (tid == 0) {
        int64_t key = kNoKey;
        int votes = 0;
        if (best != 0) {
          const int i = static_cast<int>(kFull - static_cast<uint32_t>(best));
          key = vote_keys[i];
          votes = static_cast<int>(best >> 32);
          vote_counts[i] = 0;
        }
        out_row[r] = wrap32(static_cast<uint64_t>(key));
        out_row[k_out + r] = votes;
      }
      __syncthreads();
    }
    if (tid == 0) out_row[2 * k_out] = (unconverged || seed_overflow || entry_overflow) ? 1 : 0;
    __syncthreads();  // the next read reuses the shared memory
  }
}

// The scoring geometry of one candidate row (the plain version's, which the
// host replays in numpy), written to slot `s`.
__device__ void write_row(int64_t s, int64_t read, int64_t mrev, int64_t seq, int64_t offv,
                          bool valid, const int64_t* lengths, const int64_t* shift,
                          const int64_t* seq_lengths, const int64_t* seq_starts, int band,
                          int64_t* c_read, bool* c_mrev, int64_t* win_start, int64_t* lane,
                          int32_t* n, int32_t* m) {
  const int64_t n_row = lengths[read];
  const int64_t shift_row = shift[read];
  const int64_t start_local = max_of(offv - shift_row, int64_t{0});
  const int64_t end_local = min_of(seq_lengths[seq], offv + n_row + shift_row);
  c_read[s] = read;
  c_mrev[s] = mrev != 0;
  win_start[s] = seq_starts[seq] + start_local;
  lane[s] = min_of(max_of(offv - start_local, int64_t{0}), int64_t{band - 1});
  n[s] = static_cast<int32_t>(valid ? max_of(n_row, int64_t{1}) : int64_t{1});
  m[s] = static_cast<int32_t>(max_of(end_local - start_local, int64_t{1}));
}

// KC2.  grid: one block; block: kRowsThreads threads, walking the table's
// B x K entries in read-major, rank-minor order a tile at a time.  The kept
// entries fill the first c_slots rows in that order; a kept entry past them
// sets its read's fallback flag in `table` (in place); the rows after the
// last kept one take the plain version's padding (read 0, contig 0, offset
// 0, n = 1).
__global__ void __launch_bounds__(kRowsThreads)
    fused_rows_kernel(int32_t* __restrict__ table, int64_t num_reads, int k_out,
                      const int64_t* __restrict__ lengths, const int64_t* __restrict__ shift,
                      const int64_t* __restrict__ seq_lengths,
                      const int64_t* __restrict__ seq_starts, int64_t n_seqs, int64_t span,
                      int64_t bias, int64_t c_slots, int band, int64_t* c_read, bool* c_mrev,
                      int64_t* win_start, int64_t* lane, int32_t* n, int32_t* m) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* scan = reinterpret_cast<int*>(smem);
  const int64_t entries = num_reads * k_out;
  const int row_width = 2 * k_out + 1;
  int64_t kept = 0;
  for (int64_t e0 = 0; e0 < entries; e0 += kRowsThreads) {
    const int64_t e = e0 + threadIdx.x;
    bool keep = false;
    int64_t read = 0, key = 0;
    if (e < entries) {
      read = e / k_out;
      const int32_t* t = table + read * row_width;
      const int64_t votes = t[k_out + e % k_out], top = t[k_out];
      keep = votes > 0 && (top < 6 || votes * 3 >= top);
      key = t[e % k_out];
    }
    int total;
    const int64_t slot = kept + block_rank<kRowsWarps>(keep, scan, &total);
    if (keep && slot < c_slots) {
      const int64_t rest = floor_div(key, span);
      write_row(slot, read, floor_div(rest, n_seqs), floor_mod(rest, n_seqs),
                floor_mod(key, span) - bias, true, lengths, shift, seq_lengths, seq_starts, band,
                c_read, c_mrev, win_start, lane, n, m);
    } else if (keep) {
      atomicOr(table + read * row_width + 2 * k_out, 1);
    }
    kept += total;
  }
  for (int64_t s = min_of(kept, c_slots) + threadIdx.x; s < c_slots; s += kRowsThreads) {
    write_row(s, 0, 0, 0, 0, false, lengths, shift, seq_lengths, seq_starts, band, c_read,
              c_mrev, win_start, lane, n, m);
  }
}

}  // namespace

extern "C" int mapper_candidates(
    const uint8_t* codes, int64_t width, const int64_t* lengths, int64_t num_reads,
    const int64_t* capacities, const int64_t* caps, const int64_t* bases, int64_t num_sizes,
    const int32_t* counts, const int32_t* offsets, const int32_t* values,
    const int64_t* rev_flags, const int64_t* fwd_index, const int64_t* seq_lengths,
    const int64_t* rc_index, const int64_t* seq_starts, const int64_t* seq_starts_tail,
    int64_t num_tail, int64_t max_size, int64_t min_size, int64_t n_seqs, int64_t span,
    int64_t bias, int k_out, int32_t* out, unsigned char* scratch, int64_t grid, void* stream) {
  if (num_reads == 0) return 0;
  if (k_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Index ix{capacities, caps,      bases,       num_sizes,  counts,     offsets,
                 values,     rev_flags, fwd_index,   seq_lengths, rc_index,  seq_starts,
                 seq_starts_tail, num_tail};
  const Scalars sc{max_size, min_size, n_seqs, span, bias};
  const bool in_scratch = scratch != nullptr;
  const auto kernel = in_scratch ? candidates_kernel<true> : candidates_kernel<false>;
  return launch_kernel(kernel, static_cast<unsigned>(grid), kThreads,
                       candidates_smem(width, in_scratch), stream, codes, width, lengths,
                       num_reads, ix, sc, k_out, out, scratch);
}

extern "C" int mapper_fused_rows(
    int32_t* table, int64_t num_reads, int k_out, const int64_t* lengths, const int64_t* shift,
    const int64_t* seq_lengths, const int64_t* seq_starts, int64_t n_seqs, int64_t span,
    int64_t bias, int64_t c_slots, int band, int64_t* c_read, bool* c_mrev, int64_t* win_start,
    int64_t* lane, int32_t* n, int32_t* m, void* stream) {
  if (c_slots == 0) return 0;
  if (k_out < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(fused_rows_kernel, 1u, kRowsThreads, rows_smem(), stream, table,
                       num_reads, k_out, lengths, shift, seq_lengths, seq_starts, n_seqs, span,
                       bias, c_slots, band, c_read, c_mrev, win_start, lane, n, m);
}
