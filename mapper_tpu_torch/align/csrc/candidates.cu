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
// What bounds KC1 on this card: per read it walks up to 16 pyramid levels of
// at most the read's length in blocks, with integer hashing, one compaction
// a level, then up to 512 seeds' index gathers and up to 1,024 vote entries
// to count and rank.  The bytes are few (the codes, a sector a gather, the
// [B, 2K+1] table); the time is dependent steps: level after level, and
// each entry's chain of gathers (bin, count, offset, value, sequence search,
// the per-sequence tables).  The design:
// - a team of threads a read, sized to the read: two warps, two reads a
//   block, for rows up to kNarrowWidth (in turns on the card this beat one
//   warp and four, and one to four reads a block), a block of 256 threads
//   for wider ones.  A team's barrier is __syncwarp or a named barrier over
//   the team alone (bar.sync id, n), and its scans, ranks and maxima
//   exchange one word a warp through double-buffered slots: one barrier
//   each;
// - the gapmer hashes' powers read from two tables the prefix pass writes
//   beside the prefix tables, not raised by a loop a gapmer;
// - the pyramid as a compacted list of the level's valid blocks in slot
//   order (a block's right neighbour is the next entry), both flags of a
//   tile ranked in one pass, and the level loop left once fewer than two
//   blocks remain (no merge is possible then, as the plain version finds);
// - the lookup spread over its matches: a scan of the seeds' match counts,
//   then one (seed, match) entry a thread, found by a binary search of the
//   scan, so a seed's values and their vote-key chains are in flight
//   together;
// - the votes counted without a sort: the int32 keys in an open-addressing
//   table of kHashSlots slots filled by atomicCAS, a 16-bit count beside
//   each (equal keys of a warp merged first by __match_any_sync), the top K
//   as team maxima of (votes << 32 | 0x7fffffff - key), votes descending
//   and key ascending, over the table's keys compacted into the seed
//   arrays, which the lookup no longer needs;
// - the row and the hash table share one region (the row is dead once the
//   levels end), so a narrow read takes about 20.6 KB of shared memory.  A
//   row that would leave room for fewer than two reads on a
//   multiprocessor (a 5,000 bp read) lives in a scratch buffer instead, one
//   slice a resident block, the blocks walking the reads.
//
// What bounds KC2: one pass over the table's B x K entries and a few gathers
// a kept row; the kept rows keep read-major, rank-minor order across the
// whole chunk.  It runs one thread a read over many blocks of kRowsTile
// reads in a single pass: a block stages its tile's table rows, counts
// each read's kept entries, scans them, and takes its base from a
// decoupled look-back over the earlier tiles' status words (tiles numbered
// by an atomic ticket, so a block only ever waits on a tile that is running
// or done); each thread then writes its read's kept rows at base + rank.
//
// Both equal their plain versions bit for bit: Java's long arithmetic of
// mergeHashes in uint64_t reinterpreted, the uint32 gapmer products in
// uint32_t, floor division and modulo written out where the plain version
// takes torch.remainder or rounding_mode="floor", truncation where it takes
// Java's int division or torch.fmod.  The vote keys fit int32: the program
// declines a batch whose key space passes it (device_candidates.py's
// program_inputs).

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

using cuda_launch::kSmemOptIn;
using cuda_launch::launch_kernel;

// The budgets of batch/device_candidates.py (kernels.py's test holds them
// equal to the Python module's).
constexpr int kNumLevels = 16;  // NUM_LEVELS
constexpr int kVSlots = 512;  // V_SLOTS
constexpr int kPSlots = 1024;  // P_SLOTS
constexpr int kMaxMatches = 12;  // MAX_MATCHES_PER_SEED
constexpr int64_t kNoKey = 2147483647;  // _NO_KEY: the key of an empty rank, and of an empty slot
// HashBlock.java's multipliers (index/hashblock.py).
constexpr int64_t kMergeMultiplier = 54323;  // MERGE_MULTIPLIER
constexpr int64_t kMergeLengthMultiplier = 323;  // MERGE_LENGTH_MULTIPLIER
constexpr uint32_t kGapmerMultiplier = 7654337u;  // GAPMER_MULTIPLIER
constexpr uint32_t kGapmerInverse = 242828353u;  // its inverse mod 2^32

// KC1's teams: a read's threads.  Rows up to kNarrowWidth (a 150 bp read's
// 192) take kNarrowWarps warps, kNarrowReads reads a block; wider rows one
// block of kWideWarps warps.
constexpr int kNarrowWidth = 256;
constexpr int kNarrowWarps = 2;
constexpr int kNarrowReads = 2;
constexpr int kWideWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// The vote table: 2 x P_SLOTS int32 keys (kNoKey where empty) and their
// 16-bit counts, two a word (a count is at most P_SLOTS).
constexpr int kHashBits = 11;
constexpr int kHashSlots = 1 << kHashBits;
constexpr uint32_t kHashMultiplier = 2654435769u;  // 2^32 / golden ratio

// A block's flag bits in the pyramid lists.
constexpr uint8_t kReqL = 1, kReqR = 2, kNextL = 4, kNextR = 8;

// Shared memory of a KC1 team (kernels.py's candidates_smem mirrors the
// sums).  Fixed part: the exchange slots [2][8] uint64, the seeds' key,
// size, start and signed length [kVSlots] int32 each.  Then one region for
// the row, while the levels run, and the vote table after.
constexpr size_t kSlotBytes = 2 * 8 * 8;
constexpr size_t kSeedBytes = kVSlots * 4 * 4;
constexpr size_t kTeamFixedSmem = kSlotBytes + kSeedBytes;
constexpr size_t kHashBytes = kHashSlots * 4 + kHashSlots * 2;
// A row whose team takes more than this keeps it in the scratch buffer.
constexpr size_t kRowSmemLimit = kSmemOptIn / 2;
// The row of a read `width` wide, in shared memory or in its scratch slice:
// two lists of `width` blocks (start, length, fwd and rev int32, a flag
// byte), the two gapmer prefix tables and their two power tables [width +
// 1] uint32, rounded up to 16 bytes.
__host__ __device__ size_t row_bytes(int64_t width) {
  return static_cast<size_t>((2 * width * 17 + 4 * (width + 1) * 4 + 15) / 16 * 16);
}
__host__ __device__ size_t team_smem(int64_t width, bool scratch) {
  return kTeamFixedSmem + (!scratch && row_bytes(width) > kHashBytes ? row_bytes(width) : kHashBytes);
}
bool narrow(int64_t width, bool scratch) { return !scratch && width <= kNarrowWidth; }
size_t candidates_smem(int64_t width, bool scratch) {
  return (narrow(width, scratch) ? kNarrowReads : 1) * team_smem(width, scratch);
}
// KC2: the tile's ticket and base (16 bytes), the scan slots [kRowsWarps]
// int32, and up to kStagedRanks ranks the tile's table rows [kRowsTile x
// (2K+1)] int32; with more ranks a read's row is read where it lies.
constexpr int kRowsTile = 128;
constexpr int kRowsWarps = kRowsTile / 32;
constexpr int kStagedRanks = 32;
size_t rows_smem(int k_out) {
  return 16 + kRowsWarps * 4 + (k_out <= kStagedRanks ? kRowsTile * (2 * k_out + 1) * 4 : 0);
}

// experiments/candidates_stages.py builds KC1 stopped after stage KC1_STAGE
// (1 the prefix tables and the base row, 2 the levels, 3 the lookup, 4 the
// votes), writing one word that depends on what the stage made; the
// library never defines it.
#ifdef KC1_STAGE
constexpr int kStopAfter = KC1_STAGE;
#else
constexpr int kStopAfter = 5;
#endif
#define KC1_CUT(n, value)                                                           \
  if (kStopAfter == (n)) {                                                          \
    const int32_t cut = static_cast<int32_t>(value);                                \
    if (team.tid == 0 || cut == 0x7fffffff) out[b * row_width] = cut;               \
    team.sync();                                                                    \
    continue;                                                                       \
  }

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

__device__ __forceinline__ int32_t floor_mod32(int32_t a, int32_t d) {
  const int32_t r = a % d;
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

// ---- a team: the threads of one read, a warp or a few, or a whole block

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(threads) : "memory");
}

// Every thread of the team calls the collectives below equally often, in
// the same order.  A collective over several warps posts one word a warp
// into one of two slot rows, alternately, and waits at the team's barrier
// once: the next collective writes the other row, and the one after that
// comes after a barrier every thread passed after its last read of this
// row.
template <int kWarps>
struct Team {
  static constexpr int kThreads = kWarps * 32;
  int tid;  // the thread's index in the team
  int id;  // the team's index in the block: its named barrier
  uint64_t* slots;  // [2][8]
  int parity;

  __device__ int lane() const { return tid & 31; }
  __device__ int warp() const { return tid >> 5; }
  __device__ void sync() const {
    if constexpr (kWarps == 1) {
      __syncwarp();
    } else {
      named_barrier(id, kThreads);
    }
  }
  // Each warp's lane 0 posts `v`; returns the team's kWarps posts.
  __device__ const uint64_t* exchange(uint64_t v) {
    uint64_t* row = slots + parity * 8;
    parity ^= 1;
    if (lane() == 0) row[warp()] = v;
    sync();
    return row;
  }
};

// The number of team threads before this one (in team order) whose `a`,
// and whose `b`, is set, and the team's counts of both: one pass.
template <int kWarps>
__device__ void team_rank2(Team<kWarps>& team, bool a, bool b, int* before_a, int* before_b,
                           int* total_a, int* total_b) {
  const unsigned ma = __ballot_sync(kFull, a), mb = __ballot_sync(kFull, b);
  const unsigned lower = (1u << team.lane()) - 1u;
  int ba = __popc(ma & lower), bb = __popc(mb & lower);
  int ta = __popc(ma), tb = __popc(mb);
  if constexpr (kWarps > 1) {
    const uint64_t* posts = team.exchange((static_cast<uint64_t>(tb) << 32) | static_cast<uint32_t>(ta));
    ta = tb = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int ca = static_cast<int>(static_cast<uint32_t>(posts[w]));
      const int cb = static_cast<int>(posts[w] >> 32);
      if (w < team.warp()) {
        ba += ca;
        bb += cb;
      }
      ta += ca;
      tb += cb;
    }
  }
  *before_a = ba;
  *before_b = bb;
  *total_a = ta;
  *total_b = tb;
}

// Exclusive prefix sums (in team order, wrapping) of two uint32 values at
// once, in place, and the team's sums.
template <int kWarps>
__device__ void team_scan2(Team<kWarps>& team, uint32_t* x, uint32_t* y, uint32_t* total_x,
                           uint32_t* total_y) {
  uint32_t ix = *x, iy = *y;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t ux = __shfl_up_sync(kFull, ix, d), uy = __shfl_up_sync(kFull, iy, d);
    if (team.lane() >= d) {
      ix += ux;
      iy += uy;
    }
  }
  uint32_t tx = __shfl_sync(kFull, ix, 31), ty = __shfl_sync(kFull, iy, 31);
  uint32_t bx = ix - *x, by = iy - *y;
  if constexpr (kWarps > 1) {
    const uint64_t* posts = team.exchange((static_cast<uint64_t>(ty) << 32) | tx);
    tx = ty = 0u;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t px = static_cast<uint32_t>(posts[w]), py = static_cast<uint32_t>(posts[w] >> 32);
      if (w < team.warp()) {
        bx += px;
        by += py;
      }
      tx += px;
      ty += py;
    }
  }
  *x = bx;
  *y = by;
  *total_x = tx;
  *total_y = ty;
}

template <int kWarps>
__device__ uint64_t team_max(Team<kWarps>& team, uint64_t v) {
  for (int d = 16; d > 0; d >>= 1) v = max_of(v, __shfl_xor_sync(kFull, v, d));
  if constexpr (kWarps > 1) {
    const uint64_t* posts = team.exchange(v);
    for (int w = 0; w < kWarps; ++w) v = max_of(v, posts[w]);
  }
  return v;
}

template <int kWarps>
__device__ bool team_any(Team<kWarps>& team, bool p) {
  bool any = __any_sync(kFull, p);
  if constexpr (kWarps > 1) {
    const uint64_t* posts = team.exchange(any ? 1u : 0u);
    any = false;
    for (int w = 0; w < kWarps; ++w) any = any || posts[w] != 0;
  }
  return any;
}

// ---- the pyramid

struct Block {
  int32_t start, len, fwd, rev;
  uint8_t flags;
};

// The two lists of a read's pyramid (list c at offset c * width of each
// array), its gapmer prefix tables and the powers they take.
struct Row {
  int2* pos;  // (start, length)
  int2* hash;  // (fwd, rev)
  uint8_t* flags;
  uint32_t* pref_fwd;
  uint32_t* pref_comp;
  uint32_t* pow_fwd;  // GAPMER_MULTIPLIER^i
  uint32_t* pow_inv;  // its inverse's

  __device__ Row(unsigned char* base, int64_t width) {
    pref_fwd = reinterpret_cast<uint32_t*>(base);
    pref_comp = pref_fwd + (width + 1);
    pow_fwd = pref_comp + (width + 1);
    pow_inv = pow_fwd + (width + 1);
    pos = reinterpret_cast<int2*>(pow_inv + (width + 1));
    hash = pos + 2 * width;
    flags = reinterpret_cast<uint8_t*>(hash + 2 * width);
  }
  __device__ Block load(int64_t i) const {
    const int2 p = pos[i], h = hash[i];
    return Block{p.x, p.y, h.x, h.y, flags[i]};
  }
  __device__ void store(int64_t i, const Block& b) const {
    pos[i] = make_int2(b.start, b.len);
    hash[i] = make_int2(b.fwd, b.rev);
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
__device__ bool gapmer(const Block& b, int gap_dir, int32_t extra, int32_t read_len, int32_t width,
                       const Row& row, Seed* s) {
  // targetExtraLength = length + |max(fwd, rev)| % 3 + extra, in Java: the
  // abs of INT_MIN stays INT_MIN and % truncates, as C++'s
  const int32_t m = max_of(b.fwd, b.rev);
  const int32_t abs_m = m < 0 ? static_cast<int32_t>(0u - static_cast<uint32_t>(m)) : m;
  const int32_t rem = abs_m % 3;
  const int32_t gap = b.len / 2;  // len >= 1: floor
  const int32_t ext_len = b.len + rem + extra - gap;
  // every position below is within a few read widths of the row: int32
  const bool left = gap_dir < 0, right = gap_dir > 0, none = gap_dir == 0;
  const int32_t ext_start = left ? b.start - gap - ext_len : right ? b.start + b.len + gap : 0;
  const int32_t ext_end = left ? b.start - gap : right ? b.start + b.len + gap + ext_len : 0;
  const bool in_bounds = none || (left && ext_start >= 0) || (right && ext_end <= read_len);

  int32_t fwd = b.fwd, rev = b.rev;
  if (!none) {
    const int32_t cs = min_of(max_of(ext_start, 0), width);
    const int32_t ce = min_of(max_of(ext_end, 0), width);
    const uint32_t hash =
        left ? (row.pref_fwd[ce] - row.pref_fwd[cs]) * row.pow_inv[cs]
             : (row.pref_comp[ce] - row.pref_comp[cs]) * row.pow_fwd[max_of(ce, 1) - 1];
    fwd = static_cast<int32_t>(static_cast<uint32_t>(fwd) + hash);
    rev = static_cast<int32_t>(static_cast<uint32_t>(rev) + hash);
  }
  const bool flags_differ = bit(b.flags, kReqL) != bit(b.flags, kReqR);
  s->primary = (none && flags_differ) ? bit(b.flags, kReqL) : fwd >= rev;
  s->key = s->primary ? fwd : rev;
  s->num_bp = none ? b.len : b.len + ext_len;
  s->len = none ? b.len : b.len + gap + ext_len;
  s->start = left ? ext_start : b.start;
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
// The per-sequence tables are small and read by every entry of the chunk:
// they go through the read-only path.
__device__ int64_t vote_key(int64_t pos, int64_t start, int64_t len, bool primary,
                            int64_t read_len, const Index& ix, const Scalars& sc) {
  int64_t lo = 0, hi = ix.num_tail;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (__ldg(ix.seq_starts_tail + mid) <= pos) lo = mid + 1;
    else hi = mid;
  }
  const int64_t seq = lo;
  const int64_t pos_off = pos - __ldg(ix.seq_starts + seq);
  int64_t folded_seq = seq, folded_off = pos_off;
  if (!primary) {
    folded_seq = __ldg(ix.rc_index + seq);
    folded_off = __ldg(ix.seq_lengths + folded_seq) - pos_off - len;
  }
  const bool mrev = __ldg(ix.rev_flags + folded_seq) != 0;
  const int64_t fwd_idx = __ldg(ix.fwd_index + folded_seq);
  const int64_t offv = mrev ? (__ldg(ix.seq_lengths + fwd_idx) - (folded_off + len)) - (read_len - (start + len))
                            : folded_off - start;
  return ((mrev ? 1 : 0) * sc.n_seqs + fwd_idx) * sc.span + (offv + sc.bias);
}

// ---- the votes

// Counts `n` votes for `key` in the team's table: linear probing from the
// key's multiplicative hash; a slot is claimed by atomicCAS from kNoKey.
// The table has room for P_SLOTS keys twice over.
__device__ void vote(int32_t* keys, uint32_t* counts, int32_t key, uint32_t n) {
  uint32_t slot = (static_cast<uint32_t>(key) * kHashMultiplier) >> (32 - kHashBits);
  for (;;) {
    const int32_t was = atomicCAS(keys + slot, static_cast<int32_t>(kNoKey), key);
    if (was == static_cast<int32_t>(kNoKey) || was == key) {
      atomicAdd(counts + (slot >> 1), n << (16 * (slot & 1u)));
      return;
    }
    slot = (slot + 1u) & (kHashSlots - 1);
  }
}

// KC1.  grid: kReads reads a block (the read of team t of block g is g *
// kReads + t), or, when the row lives in `scratch` (a slice of
// row_bytes(width) a block), `gridDim.x` resident blocks walking the reads
// with a grid stride; block: kReads teams of kWarps warps.
// Output: out[b, :K] the top-K vote keys (kNoKey where a rank is empty),
// out[b, K:2K] their votes, out[b, 2K] the fallback flag (unconverged after
// kNumLevels levels, more than kVSlots seeds or kPSlots vote entries).
template <int kWarps, int kReads, bool kScratch>
__global__ void __launch_bounds__(kWarps * 32 * kReads)
    candidates_kernel(const uint8_t* __restrict__ codes, int64_t width,
                      const int64_t* __restrict__ lengths, int64_t num_reads, Index ix,
                      Scalars sc, int k_out, int32_t* __restrict__ out,
                      unsigned char* __restrict__ scratch) {
  constexpr int kT = kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int team_index = static_cast<int>(threadIdx.x) / kT;
  unsigned char* const base = smem + team_index * team_smem(width, kScratch);
  Team<kWarps> team{static_cast<int>(threadIdx.x) % kT, team_index, reinterpret_cast<uint64_t*>(base), 0};
  // the seeds; the lookup turns key into the seed's first value and size
  // into its first vote entry; the top-K takes the four arrays for its
  // compacted (votes, key) words
  int32_t* const seed_key = reinterpret_cast<int32_t*>(base + kSlotBytes);
  int32_t* const seed_nbp = seed_key + kVSlots;
  int32_t* const seed_start = seed_nbp + kVSlots;
  int32_t* const seed_len = seed_start + kVSlots;  // negated off the primary strand
  uint64_t* const ranked = reinterpret_cast<uint64_t*>(seed_key);
  unsigned char* const region = base + kTeamFixedSmem;
  int32_t* const hash_keys = reinterpret_cast<int32_t*>(region);
  uint32_t* const hash_counts = reinterpret_cast<uint32_t*>(hash_keys + kHashSlots);
  const Row row(kScratch ? scratch + blockIdx.x * row_bytes(width) : region, width);
  const int tid = team.tid;
  const int row_width = 2 * k_out + 1;
  const uint32_t step_f = pow_u32(kGapmerMultiplier, kT), step_c = pow_u32(kGapmerInverse, kT);
  const uint32_t pow_f0 = pow_u32(kGapmerMultiplier, tid), pow_c0 = pow_u32(kGapmerInverse, tid);
  const uint32_t pow_f_width = pow_u32(kGapmerMultiplier, width), pow_c_width = pow_u32(kGapmerInverse, width);

  for (int64_t b = int64_t{blockIdx.x} * kReads + team_index; b < num_reads;
       b += int64_t{gridDim.x} * kReads) {
    const uint8_t* code = codes + b * width;
    const int64_t read_len = lengths[b];
    const int n0 = static_cast<int>(min_of(max_of(read_len, int64_t{0}), width));
    // a read's length past its row bounds nothing the row's positions reach
    const int32_t read_len32 = static_cast<int32_t>(min_of(read_len, int64_t{INT32_MAX}));

    // the gapmer prefix tables over the whole width (uint32 sums wrap as
    // the plain version's int64 sums taken mod 2^32), their powers, and the
    // base row: one 1-bp block per position of the read
    if (tid == 0) {
      row.pref_fwd[0] = 0u;
      row.pref_comp[0] = 0u;
      row.pow_fwd[width] = pow_f_width;
      row.pow_inv[width] = pow_c_width;
    }
    uint32_t pow_f = pow_f0, pow_c = pow_c0, carry_f = 0u, carry_c = 0u;
    for (int64_t t0 = 0; t0 < width; t0 += kT) {
      const int64_t i = t0 + tid;
      uint32_t term_f = 0u, term_c = 0u;
      if (i < width) {
        const int c = code[i];
        term_f = gap_val(c) * pow_f;
        term_c = gap_val_comp(c) * pow_c;
        row.pow_fwd[i] = pow_f;
        row.pow_inv[i] = pow_c;
        if (i < n0) {
          const int32_t v = two_bit(c);
          row.store(i, Block{static_cast<int32_t>(i), 1, v, 3 - v,
                             static_cast<uint8_t>((v < 2 ? kReqL : 0) | (v >= 2 ? kReqR : 0) |
                                                  ((v & 1) == 0 ? kNextL : 0) |
                                                  ((v & 1) == 1 ? kNextR : 0))});
        }
      }
      uint32_t before_f = term_f, before_c = term_c, total_f, total_c;
      team_scan2(team, &before_f, &before_c, &total_f, &total_c);
      if (i < width) {
        row.pref_fwd[i + 1] = carry_f + before_f + term_f;
        row.pref_comp[i + 1] = carry_c + before_c + term_c;
      }
      carry_f += total_f;
      carry_c += total_c;
      pow_f *= step_f;
      pow_c *= step_c;
    }
    team.sync();
    KC1_CUT(1, row.pref_fwd[width] ^ row.pref_comp[width] ^ static_cast<uint32_t>(row.pos[n0 > 0 ? n0 - 1 : 0].y))

    // the levels: each merges the list's valid blocks with their right
    // neighbours, appends the passing gapmers to the seed list in slot
    // order, and compacts the merged blocks that stay valid into the other
    // list.  A list of fewer than two blocks merges nothing: the levels end.
    int n = n0, cur = 0, seeds = 0;
    bool short_left = false;
    for (int level = 0; level < kNumLevels && n >= 2; ++level) {
      const int64_t in = int64_t{cur} * width, nxt = int64_t{cur ^ 1} * width;
      int kept = 0;
      for (int t0 = 0; t0 < n; t0 += kT) {
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
              gapmer(merged, gap_dir, extra, read_len32, static_cast<int32_t>(width), row, &seed);
          ok = valid && inside && seed.num_bp >= sc.min_size && seed.num_bp <= sc.max_size;
        }
        int rank_valid, rank_ok, total_valid, total_ok;
        team_rank2(team, valid, ok, &rank_valid, &rank_ok, &total_valid, &total_ok);
        if (valid) row.store(nxt + kept + rank_valid, merged);
        if (ok && seeds + rank_ok < kVSlots) {
          const int s = seeds + rank_ok;
          seed_key[s] = seed.key;
          seed_nbp[s] = seed.num_bp;
          seed_start[s] = seed.start;
          seed_len[s] = seed.primary ? seed.len : -seed.len;
        }
        if (level == kNumLevels - 1 && valid && merged.len <= sc.max_size) short_left = true;
        kept += total_valid;
        seeds += total_ok;
      }
      team.sync();  // the next level reads what this one stored
      n = kept;
      cur ^= 1;
    }
    // blocks left that the host path would keep merging
    const bool unconverged = team_any(team, short_left) && n >= 2;
    const bool seed_overflow = seeds > kVSlots;
    const int num_seeds = min_of(seeds, kVSlots);
    KC1_CUT(2, seeds + (unconverged ? 1 : 0) + (num_seeds > 0 ? seed_key[num_seeds - 1] : 0))

    // the lookup, first by seed: its bin's count and first value, and the
    // scan of the usable seeds' match counts (each seed's first vote entry,
    // seed-major and match-minor).  The row is dead: the vote table takes
    // its region.
    const int empty = static_cast<int>(kNoKey);
    for (int i = tid; i < kHashSlots / 4; i += kT) {
      reinterpret_cast<int4*>(hash_keys)[i] = make_int4(empty, empty, empty, empty);
    }
    for (int i = tid; i < kHashSlots / 8; i += kT) reinterpret_cast<int4*>(hash_counts)[i] = make_int4(0, 0, 0, 0);
    int entries = 0;
    for (int v0 = 0; v0 < num_seeds; v0 += kT) {
      const int v = v0 + tid;
      uint32_t count = 0u, unused = 0u;
      int32_t first = 0;
      if (v < num_seeds) {
        const int64_t nb = min_of(max_of(int64_t{seed_nbp[v]}, int64_t{0}), ix.num_sizes - 1);
        // a capacity is a bin count, below 2^31
        const int64_t bin = __ldg(ix.bases + nb) + floor_mod32(seed_key[v], static_cast<int32_t>(__ldg(ix.capacities + nb)));
        const int32_t cnt = __ldg(ix.counts + bin);
        first = __ldg(ix.offsets + bin);
        const int64_t limit = min_of(__ldg(ix.caps + nb), int64_t{kMaxMatches});
        if (cnt > 0 && cnt <= limit) count = static_cast<uint32_t>(cnt);
      }
      uint32_t total, unused_total;
      team_scan2(team, &count, &unused, &total, &unused_total);
      if (v < num_seeds) {
        seed_key[v] = first;
        seed_nbp[v] = entries + static_cast<int>(count);
      }
      entries += static_cast<int>(total);
    }
    const bool entry_overflow = entries > kPSlots;
    const int num_entries = min_of(entries, kPSlots);
    team.sync();

    // then by entry: one (seed, match) a thread, the seed found by a binary
    // search of the scan (the last seed whose first entry is <= e holds e:
    // the seeds after it start past e, and one with no usable match shares
    // its first entry with the next); its value, vote key and vote.
    uint32_t lookup_check = 0u;
    for (int e0 = 0; e0 < num_entries; e0 += kT) {
      const int e = e0 + tid;
      const bool has = e < num_entries;
      int32_t key = 0;
      if (has) {
        int lo = 0, hi = num_seeds;  // the last seed whose first entry is <= e
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (seed_nbp[mid] <= e) lo = mid + 1;
          else hi = mid;
        }
        const int v = lo - 1;
        const int32_t len = seed_len[v];
        const int64_t pos = __ldg(ix.values + (int64_t{seed_key[v]} + (e - seed_nbp[v])));
        key = static_cast<int32_t>(vote_key(pos, seed_start[v], len > 0 ? len : -len, len > 0, read_len, ix, sc));
      }
      if constexpr (kStopAfter == 3) {
        lookup_check ^= static_cast<uint32_t>(key);
      } else {
        const unsigned active = __ballot_sync(kFull, has);
        if (has) {
          const unsigned same = __match_any_sync(active, key);
          if (team.lane() == __ffs(same) - 1) vote(hash_keys, hash_counts, key, __popc(same));
        }
      }
    }
    team.sync();
    KC1_CUT(3, lookup_check + entries)
    KC1_CUT(4, hash_keys[tid] ^ hash_counts[tid])

    // the top K: the table's keys compacted into the seed arrays as
    // (votes << 32 | 0x7fffffff - key), then K rounds of the team's largest
    // word below the last round's: votes descending, then key ascending.
    // Each thread counts the keys of its four-slot words, a team scan
    // places them, and a second pass writes them.
    const int4* const keys4 = reinterpret_cast<const int4*>(hash_keys);
    const uint2* const counts2 = reinterpret_cast<const uint2*>(hash_counts);
    uint32_t at = 0u, unused = 0u, distinct, unused_total;
    for (int q = tid; q < kHashSlots / 4; q += kT) {
      const int4 k = keys4[q];
      at += (k.x != empty ? 1u : 0u) + (k.y != empty ? 1u : 0u) + (k.z != empty ? 1u : 0u) +
            (k.w != empty ? 1u : 0u);
    }
    team_scan2(team, &at, &unused, &distinct, &unused_total);
    for (int q = tid; q < kHashSlots / 4; q += kT) {
      const int4 k = keys4[q];
      const uint2 c = counts2[q];  // slots 4q and 4q + 1, then 4q + 2 and 4q + 3
      const int32_t keys[4] = {k.x, k.y, k.z, k.w};
      const uint32_t votes[4] = {c.x & 0xffffu, c.x >> 16, c.y & 0xffffu, c.y >> 16};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (keys[j] != empty) ranked[at++] = (uint64_t{votes[j]} << 32) | static_cast<uint32_t>(kNoKey - keys[j]);
      }
    }
    team.sync();
    int32_t* out_row = out + b * row_width;
    uint64_t last = ~uint64_t{0};
    for (int r = 0; r < k_out; ++r) {
      uint64_t best = 0;
      for (int i = tid; i < static_cast<int>(distinct); i += kT) {
        const uint64_t w = ranked[i];
        if (w < last && w > best) best = w;
      }
      best = team_max(team, best);
      if (tid == 0) {
        out_row[r] = best != 0 ? static_cast<int32_t>(kNoKey - static_cast<int64_t>(static_cast<uint32_t>(best)))
                               : static_cast<int32_t>(kNoKey);
        out_row[k_out + r] = static_cast<int32_t>(best >> 32);
      }
      last = best;
    }
    if (tid == 0) out_row[2 * k_out] = (unconverged || seed_overflow || entry_overflow) ? 1 : 0;
    team.sync();  // the next read reuses the shared memory
  }
}

// The scoring geometry of one candidate row (the plain version's, which the
// host replays in numpy).
struct Geometry {
  int64_t read, win_start, lane;
  bool mrev;
  int32_t n, m;
};

__device__ Geometry geometry(int64_t read, int64_t mrev, int64_t seq, int64_t offv, bool valid,
                             const int64_t* lengths, const int64_t* shift,
                             const int64_t* seq_lengths, const int64_t* seq_starts, int band) {
  const int64_t n_row = lengths[read];
  const int64_t shift_row = shift[read];
  const int64_t start_local = max_of(offv - shift_row, int64_t{0});
  const int64_t end_local = min_of(seq_lengths[seq], offv + n_row + shift_row);
  return Geometry{read, seq_starts[seq] + start_local,
                  min_of(max_of(offv - start_local, int64_t{0}), int64_t{band - 1}), mrev != 0,
                  static_cast<int32_t>(valid ? max_of(n_row, int64_t{1}) : int64_t{1}),
                  static_cast<int32_t>(max_of(end_local - start_local, int64_t{1}))};
}

// KC2's look-back status words (status[1 + t] for tile t; status[0] is the
// ticket counter): a tile's kept count, posted with kAggregate as soon as
// the tile has counted, then its count with those of all earlier tiles,
// with kInclusive.  Zero: not posted yet.
constexpr uint64_t kAggregate = uint64_t{1} << 62;
constexpr uint64_t kInclusive = uint64_t{2} << 62;
constexpr uint64_t kCountMask = kAggregate - 1;

// The kept rows of the tiles before `tile`: warp 0 reads 32 earlier status
// words at a time, nearest first, each lane waiting for its own to be
// posted; the sum runs up to the nearest inclusive word (a tile before the
// first counts as an inclusive 0).
__device__ uint64_t look_back(const unsigned long long* status, int64_t tile) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  uint64_t sum = 0;
  for (int64_t j = tile - 1;; j -= 32) {
    const int64_t t = j - lane;
    uint64_t word = kInclusive;
    if (t >= 0) {
      const volatile unsigned long long* at = status + 1 + t;
      do {
        word = *at;
      } while (word == 0);
    }
    const unsigned inclusive = __ballot_sync(kFull, (word & kInclusive) != 0);
    const int stop = inclusive != 0u ? __ffs(inclusive) - 1 : 31;
    uint64_t part = lane <= stop ? (word & kCountMask) : 0;
    for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFull, part, d);
    sum += part;
    if (inclusive != 0u) return sum;
  }
}

// KC2.  grid: ceil(B / kRowsTile) blocks of kRowsTile threads, one read a
// thread; block t (by ticket) takes reads [t kRowsTile, (t + 1) kRowsTile),
// their table rows staged in shared memory (up to kStagedRanks ranks).
// The kept entries fill the first c_slots rows in read-major, rank-minor
// order; a kept entry past them sets its read's fallback flag in `table`
// (in place); the rows after the last kept one take the plain version's
// padding (read 0, contig 0, offset 0, n = 1: one geometry), written by the
// last tile.
// `status` holds 1 + gridDim.x zeroed words.
__global__ void __launch_bounds__(kRowsTile)
    fused_rows_kernel(int32_t* __restrict__ table, int64_t num_reads, int k_out,
                      const int64_t* __restrict__ lengths, const int64_t* __restrict__ shift,
                      const int64_t* __restrict__ seq_lengths,
                      const int64_t* __restrict__ seq_starts, int64_t n_seqs, int64_t span,
                      int64_t bias, int64_t c_slots, int band, int64_t* c_read, bool* c_mrev,
                      int64_t* win_start, int64_t* lane, int32_t* n, int32_t* m,
                      unsigned long long* status) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* const head = reinterpret_cast<int64_t*>(smem);  // the tile, its base
  int* const scan = reinterpret_cast<int*>(smem + 16);
  const int row_width = 2 * k_out + 1;
  const int tid = static_cast<int>(threadIdx.x);
  const int lane_id = tid & 31, warp = tid >> 5;
  const auto store_row = [&](int64_t s, const Geometry& g) {
    c_read[s] = g.read;
    c_mrev[s] = g.mrev;
    win_start[s] = g.win_start;
    lane[s] = g.lane;
    n[s] = g.n;
    m[s] = g.m;
  };

  if (tid == 0) head[0] = static_cast<int64_t>(atomicAdd(status, 1ull));
  __syncthreads();
  const int64_t tile = head[0];
  const int64_t first_read = tile * kRowsTile;
  const int reads = static_cast<int>(min_of(int64_t{kRowsTile}, num_reads - first_read));
  const int32_t* rows = table + first_read * row_width;
  if (k_out <= kStagedRanks) {
    int32_t* const staged = scan + kRowsWarps;
    for (int i = tid; i < reads * row_width; i += kRowsTile) staged[i] = rows[i];
    rows = staged;
    __syncthreads();
  }

  // this thread's read: its kept ranks, and the tile's kept rows before it
  const int32_t* own = rows + tid * row_width;
  const auto kept = [&](int q) {
    const int64_t votes = own[k_out + q], top = own[k_out];
    return votes > 0 && (top < 6 || votes * 3 >= top);
  };
  int count = 0;
  if (tid < reads) {
    for (int q = 0; q < k_out; ++q) count += kept(q) ? 1 : 0;
  }
  int before = count;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, before, d);
    if (lane_id >= d) before += up;
  }
  if (lane_id == 31) scan[warp] = before;
  before -= count;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kRowsWarps; ++w) {
    if (w < warp) before += scan[w];
    total += scan[w];
  }
  if (warp == 0) {
    if (lane_id == 0) atomicExch(status + 1 + tile, kAggregate | static_cast<uint64_t>(total));
    const uint64_t tile_base = look_back(status, tile);
    if (lane_id == 0) {
      atomicExch(status + 1 + tile, kInclusive | (tile_base + static_cast<uint64_t>(total)));
      head[1] = static_cast<int64_t>(tile_base);
    }
  }
  __syncthreads();
  const int64_t tile_base = head[1];

  if (tid < reads) {
    const int64_t read = first_read + tid;
    int64_t slot = tile_base + before;
    for (int q = 0; q < k_out; ++q) {
      if (!kept(q)) continue;
      if (slot < c_slots) {
        const int64_t key = own[q];
        const int64_t rest = floor_div(key, span);
        store_row(slot, geometry(read, floor_div(rest, n_seqs), floor_mod(rest, n_seqs), floor_mod(key, span) - bias,
                                 true, lengths, shift, seq_lengths, seq_starts, band));
      } else {
        atomicOr(table + read * row_width + 2 * k_out, 1);
      }
      ++slot;
    }
  }
  if (tile == gridDim.x - 1) {
    const Geometry pad = geometry(0, 0, 0, 0, false, lengths, shift, seq_lengths, seq_starts, band);
    for (int64_t s = min_of(tile_base + total, c_slots) + tid; s < c_slots; s += kRowsTile) store_row(s, pad);
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
  // `grid` counts the resident blocks that walk the reads when the row
  // lives in `scratch`; otherwise each read has its team
  const bool in_scratch = scratch != nullptr;
  const size_t smem = candidates_smem(width, in_scratch);
  if (narrow(width, in_scratch)) {
    return launch_kernel(candidates_kernel<kNarrowWarps, kNarrowReads, false>,
                         static_cast<unsigned>((num_reads + kNarrowReads - 1) / kNarrowReads),
                         kNarrowWarps * 32 * kNarrowReads, smem, stream, codes, width, lengths,
                         num_reads, ix, sc, k_out, out, scratch);
  }
  const auto kernel = in_scratch ? candidates_kernel<kWideWarps, 1, true> : candidates_kernel<kWideWarps, 1, false>;
  return launch_kernel(kernel, static_cast<unsigned>(in_scratch ? grid : num_reads), kWideWarps * 32,
                       smem, stream, codes, width, lengths, num_reads, ix, sc, k_out, out, scratch);
}

extern "C" int mapper_fused_rows(
    int32_t* table, int64_t num_reads, int k_out, const int64_t* lengths, const int64_t* shift,
    const int64_t* seq_lengths, const int64_t* seq_starts, int64_t n_seqs, int64_t span,
    int64_t bias, int64_t c_slots, int band, int64_t* c_read, bool* c_mrev, int64_t* win_start,
    int64_t* lane, int32_t* n, int32_t* m, unsigned long long* status, void* stream) {
  if (c_slots == 0) return 0;
  if (k_out < 1 || num_reads < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_kernel(fused_rows_kernel, static_cast<unsigned>((num_reads + kRowsTile - 1) / kRowsTile),
                       kRowsTile, rows_smem(k_out), stream, table, num_reads, k_out, lengths, shift,
                       seq_lengths, seq_starts, n_seqs, span, bias, c_slots, band, c_read, c_mrev,
                       win_start, lane, n, m, status);
}
