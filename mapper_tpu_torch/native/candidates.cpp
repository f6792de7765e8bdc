// Native candidate generation: hashblock pyramid -> gapmer expansion ->
// merged-index lookup -> offset voting -> per-read top-K.
//
// Scalar port of the exact semantics of mapper_tpu/index/hashblock.py
// (itself a bit-for-bit reimplementation of the reference's HashBlock.java /
// HashBlock_ParentRow.java hashing scheme) and of the voting pipeline in
// mapper_tpu/batch/candidates.py::generate_candidates.  Reads are independent,
// so the loop parallelizes over fixed contiguous read chunks (fixed chunk
// count => deterministic output order regardless of thread count).
//
// Java arithmetic notes (must match the numpy path bit-for-bit):
//  - all hash arithmetic wraps in two's complement (int32 via uint32 casts,
//    int64 via uint64); HashBlock.mergeHashes wraps (rightContentHash + 1) in
//    int32 *before* the widening multiply, but not (leftContentHash + 1);
//  - Java's % truncates toward zero (C++ % matches); numpy's % floors (the
//    lookup bin uses floor-mod, emulated explicitly);
//  - Math.abs(Integer.MIN_VALUE) stays negative.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t MERGE_MULTIPLIER = 54323;
constexpr int64_t MERGE_LENGTH_MULTIPLIER = 323;
constexpr uint32_t GAPMER_MULTIPLIER = 7654337u;
// modular inverse of GAPMER_MULTIPLIER mod 2^32
constexpr uint32_t GAPMER_MULTIPLIER_INV = 242828353u;

inline int32_t wrap32(uint64_t x) { return (int32_t)(uint32_t)x; }

inline int32_t merge_hashes(int32_t l_len, int32_t l_hash, int32_t r_len,
                            int32_t r_hash) {
  uint64_t rotated_left =
      (uint64_t)((int64_t)l_hash + 1) *
      (uint64_t)(MERGE_MULTIPLIER + MERGE_LENGTH_MULTIPLIER * (int64_t)r_len);
  uint64_t rotated_right =
      (uint64_t)(int64_t)wrap32((uint64_t)((int64_t)r_hash + 1)) *
      (uint64_t)(int64_t)l_len;
  uint64_t long_top = rotated_left + rotated_right;
  int64_t shifted = ((int64_t)long_top) >> 32;  // arithmetic shift
  return wrap32(long_top + (uint64_t)shifted);
}

struct Block {
  int32_t start;   // in-read coordinate
  int32_t length;
  int32_t fwd;
  int32_t rev;
  int32_t extra;   // extraGapmerLength
  int8_t gap_dir;  // -1 left gap, +1 right gap, 0 none
  bool req_l, req_r, next_l, next_r;
};

// nibble -> 2-bit hashChar value (A=0 C=1 G=2 T=3), -1 for ambiguity
const int8_t TWO_BIT[16] = {-1, 0, 1, -1, 2, -1, -1, -1,
                            3,  -1, -1, -1, -1, -1, -1, -1};
// nibble -> gapmer charToInt (A..T -> 1..4)
const int8_t GAP_VAL[16] = {0, 1, 2, 0, 3, 0, 0, 0, 4, 0, 0, 0, 0, 0, 0, 0};
// nibble -> complemented nibble's gapmer value
const int8_t GAP_VAL_COMP[16] = {0, 4, 3, 0, 2, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0};

inline int64_t max_gapmer_num_bp(int64_t starting_length) {
  return starting_length + starting_length * 9 / 8 + 1;
}

struct Seed {
  int32_t start;   // in-read start of the gapped shape
  int32_t length;  // total span including the gap
  int32_t num_bp;
  int32_t key;     // lookup key (fwd if primary else rev)
  bool primary;
};

struct Group {
  int64_t key;
  int32_t votes;
};

struct Scratch {
  std::vector<Block> row, next;
  std::vector<uint32_t> pref_fwd, pref_comp;
  std::vector<Seed> seeds;
  std::vector<int64_t> bins;
  std::vector<int64_t> cnts, offs;
  std::vector<int64_t> votes;
  std::vector<Group> groups;
  std::vector<int64_t> map_keys;
  std::vector<int32_t> map_slot;
};

struct Out {
  std::vector<int32_t> read;
  std::vector<uint8_t> rev;
  std::vector<int32_t> seq;
  std::vector<int64_t> offset;
  std::vector<int32_t> votes;
};

// Base row of the pyramid (HashBlock_BaseRow.java non-ambiguous branch);
// returns false on ambiguity (caller falls back to numpy/scalar).
bool init_base_row(const uint8_t* codes, int64_t len, std::vector<Block>& row) {
  row.resize(len);
  for (int64_t i = 0; i < len; i++) {
    int8_t v = TWO_BIT[codes[i]];
    if (v < 0) return false;
    Block& b = row[i];
    b.start = (int32_t)i;
    b.length = 1;
    b.fwd = v;
    b.rev = 3 - v;
    b.extra = 0;
    b.gap_dir = 0;
    b.req_l = v < 2;
    b.req_r = v >= 2;
    b.next_l = (v & 1) == 0;
    b.next_r = (v & 1) == 1;
  }
  return true;
}

// One pyramid merge step (HashBlock_ParentRow semantics; field-for-field the
// vectorized index/hashblock.py::merge_row).  Appends to next (cleared) and
// reports the min/max merged block length.
void merge_row_once(const std::vector<Block>& row, std::vector<Block>& next,
                    int32_t* row_max_len_out, int32_t* row_min_len_out) {
  // Branch-free body: the merge decision and the flag algebra depend on
  // sequence content, so their branches are data-random (~50% mispredict)
  // and cost more than computing both sides.  Every pair's merged block is
  // computed unconditionally into a write-always slot whose index advances
  // by the merge decision; all if-chains are ternaries the compiler lowers
  // to cmov.  Field-for-field identical to the branching original (pinned
  // by the native-vs-numpy candidate and walk differential tests).
  const size_t n = row.size();
  next.clear();
  if (n < 2) {
    *row_max_len_out = 0;
    *row_min_len_out = INT32_MAX;
    return;
  }
  next.resize(n - 1);
  size_t w = 0;
  int32_t row_max_len = 0;
  int32_t row_min_len = INT32_MAX;
  for (size_t i = 0; i + 1 < n; i++) {
    const Block& L = row[i];
    const Block& R = row[i + 1];
    const bool do_merge =
        (L.start + L.length >= R.start) & (L.req_r | R.req_l);
    Block& b = next[w];
    b.start = L.start;
    b.length = R.start + R.length - L.start;
    b.fwd = merge_hashes(L.length, L.fwd, R.length, R.fwd);
    b.rev = merge_hashes(R.length, R.rev, L.length, L.rev);

    const bool anchor_exists = L.fwd != R.rev;
    const bool anchor_is_right = L.fwd > R.rev;
    const bool asym = anchor_exists & (b.fwd != b.rev);
    const bool is_reverse = b.fwd < b.rev;
    const bool invert = (is_reverse == anchor_is_right);

    bool a_nl = anchor_is_right ? R.next_l : L.next_l;
    bool a_nr = anchor_is_right ? R.next_r : L.next_r;
    const bool both_a = a_nl & a_nr;
    a_nr = a_nr & !(both_a & anchor_is_right);
    a_nl = a_nl & !(both_a & !anchor_is_right);
    bool o_nl = anchor_is_right ? L.next_l : R.next_l;
    bool o_nr = anchor_is_right ? L.next_r : R.next_r;
    const bool both_o = o_nl & o_nr;
    o_nl = o_nl & !(both_o & !anchor_is_right);
    o_nr = o_nr & !(both_o & anchor_is_right);

    bool req_l = asym ? (a_nl != invert) : true;
    bool req_r = asym ? (a_nr != invert) : true;
    bool next_l = asym ? (o_nl != invert) : true;
    bool next_r = asym ? (o_nr != invert) : true;
    const bool len_diff = L.length != R.length;
    const bool lg = L.length > R.length;
    req_l = len_diff ? lg : req_l;
    req_r = len_diff ? !lg : req_r;
    next_l = len_diff ? !lg : next_l;
    next_r = len_diff ? lg : next_r;
    const bool hash_asym = b.fwd != b.rev;
    const bool pick = b.fwd > b.rev;
    const bool fix_req = hash_asym & req_l & req_r;
    req_l = fix_req ? pick : req_l;
    req_r = fix_req ? !pick : req_r;
    const bool fix_next = hash_asym & next_l & next_r;
    next_l = fix_next ? req_l : next_l;
    next_r = fix_next ? !req_l : next_r;
    b.req_l = req_l; b.req_r = req_r; b.next_l = next_l; b.next_r = next_r;

    b.gap_dir = (req_l != req_r)
                    ? (req_l ? 1 : -1)
                    : (anchor_exists ? (anchor_is_right ? 1 : -1) : 0);

    const int64_t extra_raw = (int64_t)L.length + R.length - b.length;
    b.extra = (int32_t)(extra_raw / 4);  // trunc toward zero, as in Java

    row_max_len = do_merge ? std::max(row_max_len, b.length) : row_max_len;
    row_min_len = do_merge ? std::min(row_min_len, b.length) : row_min_len;
    w += do_merge;
  }
  next.resize(w);
  *row_max_len_out = row_max_len;
  *row_min_len_out = row_min_len;
}

// Collect all interesting gapmer seeds of one read (exact port of
// batch/candidates.py::collect_batch_seeds restricted to a single read).
bool collect_seeds_one_read(const uint8_t* codes, int64_t len,
                            int32_t min_size, int32_t max_size,
                            const uint32_t* pow_b, const uint32_t* inv_pow_b,
                            Scratch& s) {
  s.seeds.clear();
  if (len < 2) return true;

  // gapmer prefix tables (modular prefix sums in uint32)
  s.pref_fwd.resize(len + 1);
  s.pref_comp.resize(len + 1);
  s.pref_fwd[0] = 0;
  s.pref_comp[0] = 0;
  for (int64_t i = 0; i < len; i++) {
    uint8_t c = codes[i];
    s.pref_fwd[i + 1] = s.pref_fwd[i] + (uint32_t)GAP_VAL[c] * pow_b[i];
    s.pref_comp[i + 1] = s.pref_comp[i] + (uint32_t)GAP_VAL_COMP[c] * inv_pow_b[i];
  }

  // base row (HashBlock_BaseRow.java non-ambiguous branch)
  if (!init_base_row(codes, len, s.row)) return false;

  while (s.row.size() >= 2) {
    // ---- merge_row ----
    int32_t row_max_len = 0;
    int32_t row_min_len = INT32_MAX;
    merge_row_once(s.row, s.next, &row_max_len, &row_min_len);
    s.row.swap(s.next);
    if (s.row.empty()) break;

    // skip expansion for rows whose largest block can't reach min_size
    if (max_gapmer_num_bp(row_max_len) < min_size) continue;

    // ---- expand_gapmers + interesting-size filter ----
    size_t emitted_before = s.seeds.size();
    for (const Block& b : s.row) {
      int32_t m = std::max(b.fwd, b.rev);
      int32_t abs_m = wrap32((uint64_t)(m < 0 ? -(int64_t)m : (int64_t)m));
      int32_t rem = abs_m % 3;  // sign follows abs_m (Math.abs(MIN) < 0)
      int64_t target_extra = (int64_t)b.length + rem + b.extra;
      int64_t gap = b.length / 2;
      int64_t ext_len = target_extra - gap;

      int64_t g_start, g_len, g_num_bp;
      int32_t g_fwd, g_rev;
      bool is_self = b.gap_dir == 0;
      if (is_self) {
        g_start = b.start;
        g_len = b.length;
        g_num_bp = b.length;
        g_fwd = b.fwd;
        g_rev = b.rev;
      } else {
        int64_t ext_start, ext_end;
        if (b.gap_dir < 0) {  // extension before the block
          ext_end = (int64_t)b.start - gap;
          ext_start = ext_end - ext_len;
          if (ext_start < 0) continue;
          g_start = ext_start;
        } else {  // extension after the block
          ext_start = (int64_t)b.start + b.length + gap;
          ext_end = ext_start + ext_len;
          if (ext_end > len) continue;
          g_start = b.start;
        }
        int64_t cs = std::min(std::max(ext_start, (int64_t)0), len);
        int64_t ce = std::min(std::max(ext_end, (int64_t)0), len);
        uint32_t ext_hash;
        if (b.gap_dir < 0) {
          // sum_{i in [s,e)} fwd_vals[i] * B^(i-s)  (mod 2^32)
          ext_hash = (s.pref_fwd[ce] - s.pref_fwd[cs]) * inv_pow_b[cs];
        } else {
          // sum_{i in [s,e)} comp_vals[i] * B^(e-1-i)  (mod 2^32)
          int64_t e1 = std::max(ce, (int64_t)1) - 1;
          ext_hash = (s.pref_comp[ce] - s.pref_comp[cs]) * pow_b[e1];
        }
        g_fwd = wrap32((uint64_t)((int64_t)b.fwd + (int32_t)ext_hash));
        g_rev = wrap32((uint64_t)((int64_t)b.rev + (int32_t)ext_hash));
        g_len = b.length + gap + ext_len;
        g_num_bp = b.length + ext_len;
      }

      if (g_num_bp < min_size || g_num_bp > max_size) continue;

      bool primary;
      if (is_self && (b.req_l != b.req_r)) primary = b.req_l;
      else primary = g_fwd >= g_rev;

      Seed sd;
      sd.start = (int32_t)g_start;
      sd.length = (int32_t)g_len;
      sd.num_bp = (int32_t)g_num_bp;
      sd.key = primary ? g_fwd : g_rev;
      sd.primary = primary;
      s.seeds.push_back(sd);
    }
    (void)emitted_before;
    if (row_min_len > max_size) break;
  }
  return true;
}

}  // namespace

// All pyramid row levels of one clean (unambiguous) query, flattened.
// Fields per block (int32): start, length, fwd, rev, extra, gap_dir, req_l,
// req_r, next_l, next_r — the exact ScalarHashBlock field set, produced by
// the same base-row/merge kernels the seed collector uses.  Levels stop when
// a row has < 2 blocks (that last short row IS written) or max_levels is
// reached.  out_counts[level] receives each level's block count; blocks of
// all levels are written consecutively to out_fields ([cap][10]).  Returns
// the number of levels written, -1 on ambiguity (caller falls back to the
// scalar model), -2 when cap is insufficient.
extern "C" int32_t mapper_query_rows(const uint8_t* codes, int64_t len,
                                     int32_t max_levels, int32_t* out_counts,
                                     int32_t* out_fields, int64_t cap) {
  std::vector<Block> row, next;
  if (!init_base_row(codes, len, row)) return -1;
  int64_t written = 0;
  int32_t level = 0;
  auto emit_row = [&](const std::vector<Block>& r) -> bool {
    if (written + (int64_t)r.size() > cap) return false;
    for (const Block& b : r) {
      int32_t* f = out_fields + written * 10;
      f[0] = b.start;
      f[1] = b.length;
      f[2] = b.fwd;
      f[3] = b.rev;
      f[4] = b.extra;
      f[5] = b.gap_dir;
      f[6] = b.req_l;
      f[7] = b.req_r;
      f[8] = b.next_l;
      f[9] = b.next_r;
      written++;
    }
    out_counts[level] = (int32_t)r.size();
    level++;
    return true;
  };
  if (level < max_levels && !emit_row(row)) return -2;
  while (level < max_levels && row.size() >= 2) {
    int32_t mx = 0, mn = INT32_MAX;
    merge_row_once(row, next, &mx, &mn);
    row.swap(next);
    if (!emit_row(row)) return -2;
    if (row.empty()) break;
  }
  return level;
}

// The full interesting-gapmer walk of one clean query
// (align/candidates.py::HashBlockPath.get_next_interesting_block): pyramid
// navigation thresholds (HashBlockPath.java:143-195), gapmer expansion, the
// match-count probes against the merged index, and the recently-seen filter.
// The emitted sequence is a pure function of (query, index counts) — the
// walk takes no feedback from match results — so it is precomputed here in
// one call and consumed lazily by the Python CountingHashBlockPath.
//
// Per-size arrays cover sizes 0..max_set_up; a probe of a larger size is the
// reference's lazy-growth trigger: the walk aborts with -3 and *need_size so
// the caller can grow the database and re-run.
// Output rows ([max_out][9] int32): start, total_len, num_bp, fwd, rev,
// req_l, req_r, gapped_block1_length, gapped_gap_length.
// Returns blocks emitted, -1 ambiguity, -2 output overflow, -3 grow.
extern "C" int64_t mapper_query_walk(
    const uint8_t* codes, int64_t len, int32_t min_interesting,
    int32_t enable_gapmers, int32_t max_set_up, const uint8_t* size_exists,
    const int64_t* size_capacity, const int64_t* size_base,
    const int64_t* size_cap, const int64_t* bin_counts, int32_t* out,
    int64_t max_out, int64_t* need_size) {
  constexpr int64_t I32_MAX = 2147483647;
  // pyramid rows
  std::vector<std::vector<Block>> rows(1);
  if (!init_base_row(codes, len, rows[0])) return -1;
  while (rows.back().size() >= 2) {
    rows.emplace_back();
    int32_t mx = 0, mn = INT32_MAX;
    merge_row_once(rows[rows.size() - 2], rows.back(), &mx, &mn);
  }
  // gapmer prefix tables
  std::vector<uint32_t> pow_b(len + 2), inv_pow_b(len + 2);
  pow_b[0] = 1;
  inv_pow_b[0] = 1;
  for (int64_t i = 1; i <= len + 1; i++) {
    pow_b[i] = pow_b[i - 1] * GAPMER_MULTIPLIER;
    inv_pow_b[i] = inv_pow_b[i - 1] * GAPMER_MULTIPLIER_INV;
  }
  std::vector<uint32_t> pref_fwd(len + 1), pref_comp(len + 1);
  pref_fwd[0] = 0;
  pref_comp[0] = 0;
  for (int64_t i = 0; i < len; i++) {
    uint8_t c = codes[i];
    pref_fwd[i + 1] = pref_fwd[i] + (uint32_t)GAP_VAL[c] * pow_b[i];
    pref_comp[i + 1] = pref_comp[i] + (uint32_t)GAP_VAL_COMP[c] * inv_pow_b[i];
  }

  struct Ext {  // the gapmer ("extended") view of the current block
    bool ok;
    bool is_self;
    int64_t start, total_len, num_bp;
    int32_t fwd, rev;
    bool req_l, req_r;  // the extended OBJECT's flags (defaults for gapmers)
    int64_t b1_len, gap_len;
  };
  auto expand = [&](const Block& b) -> Ext {
    Ext e{};
    if (!enable_gapmers || b.gap_dir == 0) {
      e.ok = true;
      e.is_self = true;
      e.start = b.start;
      e.total_len = b.length;
      e.num_bp = b.length;
      e.fwd = b.fwd;
      e.rev = b.rev;
      e.req_l = b.req_l;
      e.req_r = b.req_r;
      e.b1_len = -1;
      e.gap_len = 0;
      return e;
    }
    int32_t m = std::max(b.fwd, b.rev);
    int32_t abs_m = wrap32((uint64_t)(m < 0 ? -(int64_t)m : (int64_t)m));
    int32_t rem = abs_m % 3;
    int64_t target_extra = (int64_t)b.length + rem + b.extra;
    int64_t gap = b.length / 2;
    int64_t ext_len = target_extra - gap;
    int64_t ext_start, ext_end;
    if (b.gap_dir < 0) {
      ext_end = (int64_t)b.start - gap;
      ext_start = ext_end - ext_len;
      if (ext_start < 0) return e;  // ok=false -> Python returns None
      e.start = ext_start;
      e.b1_len = ext_len;
    } else {
      ext_start = (int64_t)b.start + b.length + gap;
      ext_end = ext_start + ext_len;
      if (ext_end > len) return e;
      e.start = b.start;
      e.b1_len = b.length;
    }
    int64_t cs = std::min(std::max(ext_start, (int64_t)0), len);
    int64_t ce = std::min(std::max(ext_end, (int64_t)0), len);
    uint32_t ext_hash;
    if (b.gap_dir < 0) {
      ext_hash = (pref_fwd[ce] - pref_fwd[cs]) * inv_pow_b[cs];
    } else {
      int64_t e1 = std::max(ce, (int64_t)1) - 1;
      ext_hash = (pref_comp[ce] - pref_comp[cs]) * pow_b[e1];
    }
    e.ok = true;
    e.is_self = false;
    e.fwd = wrap32((uint64_t)((int64_t)b.fwd + (int32_t)ext_hash));
    e.rev = wrap32((uint64_t)((int64_t)b.rev + (int32_t)ext_hash));
    e.total_len = b.length + gap + ext_len;
    e.num_bp = b.length + ext_len;
    e.req_l = false;  // ScalarHashBlock defaults on a fresh gapmer object
    e.req_r = false;
    e.gap_len = gap;
    return e;
  };
  auto ext_primary = [&](const Ext& e) -> bool {
    // is_primary_polarity: req_l != req_r ? req_l : fwd >= rev
    if (e.req_l != e.req_r) return e.req_l;
    return e.fwd >= e.rev;
  };
  auto ext_key = [&](const Ext& e) -> int64_t {
    return ext_primary(e) ? (int64_t)e.fwd : (int64_t)e.rev;
  };
  bool grow = false;
  auto lower_bound = [&](const Ext& e) -> int64_t {
    if (e.num_bp < min_interesting) return I32_MAX;
    if (e.num_bp > max_set_up) {
      grow = true;
      *need_size = e.num_bp;
      return I32_MAX;
    }
    if (!size_exists[e.num_bp]) return I32_MAX;
    int64_t cap = size_capacity[e.num_bp];
    int64_t k = ext_key(e) % cap;
    if (k < 0) k += cap;  // Python % semantics for negative keys
    int64_t c = bin_counts[size_base[e.num_bp] + k];
    return c > size_cap[e.num_bp] ? I32_MAX : c;
  };
  auto allowed_of = [&](const Ext& e) -> int64_t {
    if (e.total_len >= len / 6) {
      // get_max_num_matches_allowed (lazy-growth trigger included)
      if (e.num_bp < min_interesting) return -1;
      if (e.num_bp > max_set_up) {
        grow = true;
        *need_size = e.num_bp;
        return 0;
      }
      if (!size_exists[e.num_bp]) return 0;
      return size_cap[e.num_bp];
    }
    if (e.req_r) return 5;
    return e.num_bp + 1;
  };

  // navigation state (HashBlockPath.java:99-140)
  int level = -1;  // batch_index
  bool have = true;
  Block current{};  // the initial dummy ScalarHashBlock(0, 0)
  current.start = 0;
  current.length = 0;
  bool ext_cached = false;
  Ext ext{};
  auto row_at = [&](int lv) -> const std::vector<Block>* {
    static const std::vector<Block> kEmpty;
    if (lv < 0 || lv >= (int)rows.size()) return &kEmpty;
    return &rows[lv];
  };
  auto get_after = [&](int lv, int64_t pos) -> const Block* {
    const std::vector<Block>& r = *row_at(lv);
    size_t lo = 0, hi = r.size();
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      if (r[mid].start > pos) hi = mid; else lo = mid + 1;
    }
    return lo < r.size() ? &r[lo] : nullptr;
  };
  auto get_exact = [&](int lv, int64_t pos) -> const Block* {
    const Block* b = get_after(lv, pos - 1);
    if (b != nullptr && b->start == pos) return b;
    return nullptr;
  };
  auto move_right = [&]() {
    const Block* b = get_after(level, current.start);
    if (b == nullptr) have = false; else current = *b;
    ext_cached = false;
  };
  auto move_down = [&]() {
    level -= 1;
    const Block* b = get_after(level, current.start);
    if (b == nullptr) have = false; else current = *b;
    ext_cached = false;
  };
  auto move_up_or_right = [&]() {
    const Block* up = get_exact(level + 1, current.start);
    if (up != nullptr) {
      level += 1;
      current = *up;
      ext_cached = false;
    } else {
      move_right();
    }
  };
  auto with_gap = [&]() -> const Ext& {
    if (!ext_cached) {
      ext = expand(current);
      ext_cached = true;
    }
    return ext;
  };

  int32_t prev_fwd = 0, prev_prev_fwd = 0;
  bool has_prev = false, has_prev_prev = false;
  int64_t n_out = 0;
  while (have) {
    // _advance_to_next_position (java:143-195)
    if (enable_gapmers &&
        max_gapmer_num_bp(current.length) < (int64_t)min_interesting) {
      move_up_or_right();
    } else {
      const Ext& e = with_gap();
      if (e.ok) {
        int64_t nm = lower_bound(e);
        if (grow) return -3;
        if (nm < 6) {
          if (level > 0) move_down(); else move_right();
        } else {
          int64_t al = allowed_of(e);
          if (grow) return -3;
          if (nm > al) move_up_or_right(); else move_right();
        }
      } else {
        int64_t typical = (int64_t)current.length * 3 / 2;
        if (typical <= min_interesting && enable_gapmers) {
          move_up_or_right();
        } else {
          if (level > 0) move_down(); else move_right();
        }
      }
    }
    if (!have) break;
    // _get_next_block_with_good_number_of_matches emit check
    const Ext& e = with_gap();
    if (!e.ok) continue;
    int64_t nm = lower_bound(e);
    if (grow) return -3;
    int64_t al = allowed_of(e);
    if (grow) return -3;
    if (nm > al) continue;
    // _recently_seen (updates state even when filtered)
    bool seen = (has_prev && e.fwd == prev_fwd) ||
                (!(has_prev && e.fwd == prev_fwd) && has_prev_prev &&
                 e.fwd == prev_prev_fwd);
    prev_prev_fwd = prev_fwd;
    has_prev_prev = has_prev;
    prev_fwd = e.fwd;
    has_prev = true;
    if (seen) continue;
    if (n_out >= max_out) return -2;
    int32_t* o = out + n_out * 9;
    o[0] = (int32_t)e.start;
    o[1] = (int32_t)e.total_len;
    o[2] = (int32_t)e.num_bp;
    o[3] = e.fwd;
    o[4] = e.rev;
    o[5] = e.req_l;
    o[6] = e.req_r;
    o[7] = (int32_t)e.b1_len;
    o[8] = (int32_t)e.gap_len;
    n_out++;
  }
  return n_out;
}

// Index-build block collection for one (non-ambiguous) reference sequence:
// every gapmer of every pyramid row with num_bp in [min_interesting, hi] and
// num_bp > lo, with both polarity flags (exact port of the row loop in
// index/database.py::_hash_sequence, gapmer mode).  Unlike the query-side
// seed collection this includes the base row and keeps fwd+rev+both flags
// (the database stores dual-polarity entries).  Returns the number of rows
// written, -1 on output overflow, -2 on ambiguity (caller falls back).
extern "C" int64_t mapper_collect_blocks(
    const uint8_t* codes, int64_t len, int32_t min_interesting, int32_t lo,
    int32_t hi, int32_t* out_num_bp, int32_t* out_fwd, int32_t* out_rev,
    uint8_t* out_primary, uint8_t* out_secondary, int64_t* out_start,
    int32_t* out_length, int64_t max_out) {
  if (len <= 0) return 0;
  std::vector<uint32_t> pow_b(len + 2), inv_pow_b(len + 2);
  pow_b[0] = 1;
  inv_pow_b[0] = 1;
  for (int64_t i = 1; i <= len + 1; i++) {
    pow_b[i] = pow_b[i - 1] * GAPMER_MULTIPLIER;
    inv_pow_b[i] = inv_pow_b[i - 1] * GAPMER_MULTIPLIER_INV;
  }
  std::vector<uint32_t> pref_fwd(len + 1), pref_comp(len + 1);
  pref_fwd[0] = 0;
  pref_comp[0] = 0;
  for (int64_t i = 0; i < len; i++) {
    uint8_t c = codes[i];
    if (TWO_BIT[c] < 0) return -2;
    pref_fwd[i + 1] = pref_fwd[i] + (uint32_t)GAP_VAL[c] * pow_b[i];
    pref_comp[i + 1] = pref_comp[i] + (uint32_t)GAP_VAL_COMP[c] * inv_pow_b[i];
  }

  std::vector<Block> row(len), next;
  for (int64_t i = 0; i < len; i++) {
    int8_t v = TWO_BIT[codes[i]];
    Block& b = row[i];
    b.start = (int32_t)i;
    b.length = 1;
    b.fwd = v;
    b.rev = 3 - v;
    b.extra = 0;
    b.gap_dir = 0;
    b.req_l = v < 2;
    b.req_r = v >= 2;
    b.next_l = (v & 1) == 0;
    b.next_r = (v & 1) == 1;
  }

  int64_t w = 0;
  while (true) {
    if (row.empty()) break;
    int32_t row_min_len = INT32_MAX, row_max_len = 0;
    for (const Block& b : row) {
      row_min_len = std::min(row_min_len, b.length);
      row_max_len = std::max(row_max_len, b.length);
    }
    if (row_min_len > hi) break;

    if (max_gapmer_num_bp(row_max_len) >= min_interesting) {
      for (const Block& b : row) {
        int32_t m = std::max(b.fwd, b.rev);
        int32_t abs_m = wrap32((uint64_t)(m < 0 ? -(int64_t)m : (int64_t)m));
        int32_t rem = abs_m % 3;
        int64_t target_extra = (int64_t)b.length + rem + b.extra;
        int64_t gap = b.length / 2;
        int64_t ext_len = target_extra - gap;

        int64_t g_start, g_len, g_num_bp;
        int32_t g_fwd, g_rev;
        bool is_self = b.gap_dir == 0;
        if (is_self) {
          g_start = b.start;
          g_len = b.length;
          g_num_bp = b.length;
          g_fwd = b.fwd;
          g_rev = b.rev;
        } else {
          int64_t ext_start, ext_end;
          if (b.gap_dir < 0) {
            ext_end = (int64_t)b.start - gap;
            ext_start = ext_end - ext_len;
            if (ext_start < 0) continue;
            g_start = ext_start;
          } else {
            ext_start = (int64_t)b.start + b.length + gap;
            ext_end = ext_start + ext_len;
            if (ext_end > len) continue;
            g_start = b.start;
          }
          int64_t cs = std::min(std::max(ext_start, (int64_t)0), len);
          int64_t ce = std::min(std::max(ext_end, (int64_t)0), len);
          uint32_t ext_hash;
          if (b.gap_dir < 0) {
            ext_hash = (pref_fwd[ce] - pref_fwd[cs]) * inv_pow_b[cs];
          } else {
            int64_t e1 = std::max(ce, (int64_t)1) - 1;
            ext_hash = (pref_comp[ce] - pref_comp[cs]) * pow_b[e1];
          }
          g_fwd = wrap32((uint64_t)((int64_t)b.fwd + (int32_t)ext_hash));
          g_rev = wrap32((uint64_t)((int64_t)b.rev + (int32_t)ext_hash));
          g_len = b.length + gap + ext_len;
          g_num_bp = b.length + ext_len;
        }

        if (g_num_bp < min_interesting || g_num_bp <= lo || g_num_bp > hi)
          continue;

        bool primary, secondary;
        if (is_self && (b.req_l != b.req_r)) {
          primary = b.req_l;
          secondary = b.req_r;
        } else {
          primary = g_fwd >= g_rev;
          secondary = g_fwd <= g_rev;
        }
        if (w >= max_out) return -1;
        out_num_bp[w] = (int32_t)g_num_bp;
        out_fwd[w] = g_fwd;
        out_rev[w] = g_rev;
        out_primary[w] = primary ? 1 : 0;
        out_secondary[w] = secondary ? 1 : 0;
        out_start[w] = g_start;
        out_length[w] = (int32_t)g_len;
        w++;
      }
    }

    if (row.size() < 2) break;
    // ---- merge to the next row ----
    next.clear();
    for (size_t i = 0; i + 1 < row.size(); i++) {
      const Block& L = row[i];
      const Block& R = row[i + 1];
      if (!(L.start + L.length >= R.start && (L.req_r || R.req_l))) continue;
      Block b;
      b.start = L.start;
      b.length = R.start + R.length - L.start;
      b.fwd = merge_hashes(L.length, L.fwd, R.length, R.fwd);
      b.rev = merge_hashes(R.length, R.rev, L.length, L.rev);

      bool anchor_exists = L.fwd != R.rev;
      bool anchor_is_right = L.fwd > R.rev;
      bool asym = anchor_exists && (b.fwd != b.rev);
      bool is_reverse = b.fwd < b.rev;
      bool invert = (is_reverse == anchor_is_right);

      bool a_nl = anchor_is_right ? R.next_l : L.next_l;
      bool a_nr = anchor_is_right ? R.next_r : L.next_r;
      if (a_nl && a_nr) {
        if (anchor_is_right) a_nr = false; else a_nl = false;
      }
      bool o_nl = anchor_is_right ? L.next_l : R.next_l;
      bool o_nr = anchor_is_right ? L.next_r : R.next_r;
      if (o_nl && o_nr) {
        if (!anchor_is_right) o_nl = false; else o_nr = false;
      }

      bool req_l = true, req_r = true, next_l = true, next_r = true;
      if (asym) {
        req_l = a_nl != invert;
        req_r = a_nr != invert;
        next_l = o_nl != invert;
        next_r = o_nr != invert;
      }
      if (L.length != R.length) {
        bool lg = L.length > R.length;
        req_l = lg; req_r = !lg; next_l = !lg; next_r = lg;
      }
      if (b.fwd != b.rev) {
        if (req_l && req_r) { req_l = b.fwd > b.rev; req_r = !req_l; }
        if (next_l && next_r) { next_l = req_l; next_r = !req_l; }
      }
      b.req_l = req_l; b.req_r = req_r; b.next_l = next_l; b.next_r = next_r;

      if (req_l != req_r) b.gap_dir = req_l ? 1 : -1;
      else if (anchor_exists) b.gap_dir = anchor_is_right ? 1 : -1;
      else b.gap_dir = 0;

      int64_t extra_raw = (int64_t)L.length + R.length - b.length;
      b.extra = (int32_t)(extra_raw / 4);

      next.push_back(b);
    }
    row.swap(next);
  }
  return w;
}

extern "C" int64_t mapper_generate_candidates(
    // batch
    const uint8_t* codes, const int64_t* read_starts, int64_t num_reads,
    // index config
    int32_t min_size, int32_t max_size,
    // merged index (indexed by block num_bp up to max_size inclusive)
    const int64_t* capacities, const int64_t* caps, const int64_t* bases,
    const int64_t* counts, const int64_t* offsets, const int64_t* values,
    // strand tables over db sequences
    const uint8_t* rev_flags, const int64_t* fwd_index,
    const int64_t* seq_lengths, const int64_t* rc_index,
    const int64_t* seq_starts, int64_t n_seqs,
    // voting parameters
    int64_t span, int64_t bias, int32_t max_matches_per_seed, int32_t k_out,
    // outputs, caller-allocated with num_reads * k_out rows
    int32_t* out_read, uint8_t* out_rev, int32_t* out_seq, int64_t* out_offset,
    int32_t* out_votes) {
  if (num_reads <= 0) return 0;
  int64_t max_len = 0;
  for (int64_t r = 0; r < num_reads; r++)
    max_len = std::max(max_len, read_starts[r + 1] - read_starts[r]);

  // powers of the gapmer base mod 2^32 (shared across reads)
  std::vector<uint32_t> pow_b(max_len + 2), inv_pow_b(max_len + 2);
  pow_b[0] = 1;
  inv_pow_b[0] = 1;
  for (int64_t i = 1; i <= max_len + 1; i++) {
    pow_b[i] = pow_b[i - 1] * GAPMER_MULTIPLIER;
    inv_pow_b[i] = inv_pow_b[i - 1] * GAPMER_MULTIPLIER_INV;
  }

  constexpr int NUM_CHUNKS = 16;  // fixed => deterministic output order
  Out outs[NUM_CHUNKS];
  bool ok[NUM_CHUNKS];
  for (int c = 0; c < NUM_CHUNKS; c++) ok[c] = true;
  int64_t chunk_size = (num_reads + NUM_CHUNKS - 1) / NUM_CHUNKS;

#pragma omp parallel for schedule(dynamic, 1)
  for (int chunk = 0; chunk < NUM_CHUNKS; chunk++) {
    Scratch scratch;
    Out& out = outs[chunk];
    int64_t r_begin = chunk * chunk_size;
    int64_t r_end = std::min(num_reads, r_begin + chunk_size);
    for (int64_t r = r_begin; r < r_end && ok[chunk]; r++) {
      int64_t rs = read_starts[r];
      int64_t read_len = read_starts[r + 1] - rs;
      if (!collect_seeds_one_read(codes + rs, read_len, min_size, max_size,
                                  pow_b.data(), inv_pow_b.data(), scratch)) {
        ok[chunk] = false;
        break;
      }

      // ---- lookup + votes ----
      // the hash-table reads are random accesses into multi-MB arrays; a
      // bin-precompute pass with software prefetch hides most of the misses
      scratch.votes.clear();
      size_t num_seeds = scratch.seeds.size();
      scratch.bins.resize(num_seeds);
      for (size_t si = 0; si < num_seeds; si++) {
        const Seed& sd = scratch.seeds[si];
        int64_t cap = capacities[sd.num_bp];
        int64_t rem = (int64_t)sd.key % cap;
        if (rem < 0) rem += cap;  // numpy floor-mod
        int64_t bin = bases[sd.num_bp] + rem;
        scratch.bins[si] = bin;
        __builtin_prefetch(&counts[bin]);
        __builtin_prefetch(&offsets[bin]);
      }
      // resolve (count, offset) per seed and prefetch every usable bin's
      // whole value run before the consume loop — the random `values` reads
      // are the pass's cache-miss budget, and issuing all prefetches a loop
      // ahead hides them better than the old 8-ahead rolling prefetch
      scratch.cnts.resize(num_seeds);
      scratch.offs.resize(num_seeds);
      for (size_t si = 0; si < num_seeds; si++) {
        const Seed& sd = scratch.seeds[si];
        int64_t bin = scratch.bins[si];
        int64_t cnt = counts[bin];
        int64_t limit = std::min(caps[sd.num_bp], (int64_t)max_matches_per_seed);
        if (cnt <= 0 || cnt > limit) {
          scratch.cnts[si] = 0;
          continue;
        }
        int64_t off = offsets[bin];
        scratch.cnts[si] = cnt;
        scratch.offs[si] = off;
        const int64_t* v2 = &values[off];
        __builtin_prefetch(v2);
        if (cnt > 8) __builtin_prefetch(v2 + 8);
      }
      for (size_t si = 0; si < num_seeds; si++) {
        const Seed& sd = scratch.seeds[si];
        int64_t cnt = scratch.cnts[si];
        if (cnt == 0) continue;
        int64_t off = scratch.offs[si];
        for (int64_t j = 0; j < cnt; j++) {
          int64_t pos = values[off + j];
          // decode (sequence, offset): upper_bound(seq_starts) - 1.
          // Small databases (single contig + RC = 2 sequences) are the
          // common case: a branchless compare beats the binary search.
          int64_t seq;
          if (n_seqs == 2) {
            seq = pos >= seq_starts[1] ? 1 : 0;
          } else {
            int64_t lo = 0, hi = n_seqs;  // seq_starts has n_seqs + 1 entries
            while (lo < hi) {
              int64_t mid = (lo + hi) / 2;
              if (seq_starts[mid + 1] > pos) hi = mid; else lo = mid + 1;
            }
            seq = lo;
          }
          int64_t pos_off = pos - seq_starts[seq];

          int64_t folded_off, folded_seq;
          if (sd.primary) {
            folded_off = pos_off;
            folded_seq = seq;
          } else {
            folded_seq = rc_index[seq];
            folded_off = seq_lengths[folded_seq] - pos_off - sd.length;
          }
          bool mrev = rev_flags[folded_seq] != 0;
          int64_t fwd_idx = fwd_index[folded_seq];
          int64_t contig_len = seq_lengths[fwd_idx];
          int64_t offv;
          if (mrev)
            offv = (contig_len - (folded_off + sd.length)) -
                   (read_len - ((int64_t)sd.start + sd.length));
          else
            offv = folded_off - sd.start;
          int64_t key =
              (((int64_t)(mrev ? 1 : 0)) * n_seqs + fwd_idx) * span + (offv + bias);
          scratch.votes.push_back(key);
        }
      }
      if (scratch.votes.empty()) continue;

      // group by key via a local open-addressed map (votes are heavily
      // concentrated on the true offset, so distinct keys are few; this is
      // O(n) where the previous sort+run-scan was O(n log n))
      scratch.groups.clear();
      size_t cap_pow2 = 64;
      while (cap_pow2 < scratch.votes.size() * 2) cap_pow2 <<= 1;
      scratch.map_keys.assign(cap_pow2, INT64_MIN);
      scratch.map_slot.assign(cap_pow2, 0);
      size_t mask = cap_pow2 - 1;
      for (int64_t v : scratch.votes) {
        size_t h = (size_t)((uint64_t)v * 0x9e3779b97f4a7c15ull >> 40) & mask;
        while (true) {
          if (scratch.map_keys[h] == v) {
            scratch.groups[scratch.map_slot[h]].votes++;
            break;
          }
          if (scratch.map_keys[h] == INT64_MIN) {
            scratch.map_keys[h] = v;
            scratch.map_slot[h] = (int32_t)scratch.groups.size();
            scratch.groups.push_back({v, 1});
            break;
          }
          h = (h + 1) & mask;
        }
      }

      // per-read top-K by votes desc, ties in key-ascending order (identical
      // to the previous sort-runs + stable-sort-by-votes ordering).  Only the
      // first k_out groups in sorted order are ever consulted below (the
      // noise filter advances `emitted` even when it skips), so a partial
      // sort of the top k_out is enough — the full sort was ~18% of the pass.
      const size_t top_k =
          std::min(scratch.groups.size(), (size_t)k_out);
      std::partial_sort(scratch.groups.begin(),
                        scratch.groups.begin() + top_k, scratch.groups.end(),
                        [](const Group& a, const Group& b) {
                          if (a.votes != b.votes) return a.votes > b.votes;
                          return a.key < b.key;
                        });
      int32_t top = scratch.groups[0].votes;
      int32_t emitted = 0;
      for (const Group& g : scratch.groups) {
        if (emitted >= k_out) break;
        // hash-collision noise filter (matches the numpy path)
        if (!(top < 6 || g.votes * 3 >= top)) { emitted++; continue; }
        int64_t offv = g.key % span - bias;  // key >= 0 by construction
        int64_t rest = g.key / span;
        int64_t seq = rest % n_seqs;
        int64_t mrev = rest / n_seqs;
        out.read.push_back((int32_t)r);
        out.rev.push_back((uint8_t)mrev);
        out.seq.push_back((int32_t)seq);
        out.offset.push_back(offv);
        out.votes.push_back(g.votes);
        emitted++;
      }
    }
  }

  for (int c = 0; c < NUM_CHUNKS; c++)
    if (!ok[c]) return -1;  // ambiguity encountered: fall back

  int64_t total = 0;
  for (int c = 0; c < NUM_CHUNKS; c++) total += (int64_t)outs[c].read.size();
  if (total > num_reads * (int64_t)k_out) return -2;  // can't happen
  int64_t w = 0;
  for (int c = 0; c < NUM_CHUNKS; c++) {
    const Out& o = outs[c];
    size_t n = o.read.size();
    if (!n) continue;
    std::memcpy(out_read + w, o.read.data(), n * sizeof(int32_t));
    std::memcpy(out_rev + w, o.rev.data(), n * sizeof(uint8_t));
    std::memcpy(out_seq + w, o.seq.data(), n * sizeof(int32_t));
    std::memcpy(out_offset + w, o.offset.data(), n * sizeof(int64_t));
    std::memcpy(out_votes + w, o.votes.data(), n * sizeof(int32_t));
    w += n;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Fused parallel collect+emit for the index build.
//
// The reference hashes the reference genome in 50 kb jobs, each walking a
// fresh pyramid and keeping only blocks whose START falls in the job range
// (HashBlock_Database.split_hashJobs / hashSequenceThroughSize,
// HashBlock_Buffer.addHashblock): a pyramid block starting at position p is
// fully determined by the sequence content from p rightward (parent blocks
// merge a child with the NEXT child after it), which is what makes job-local
// pyramids exact.  Here each window walks the pyramid over a right-padded
// buffer and tracks a truncation frontier: the leftmost position whose blocks
// could differ from the global pyramid because the buffer ends.  If the
// frontier reaches the window core while interesting block sizes are still
// live, the window retries with a doubled pad (never happens on genomic data
// with the default 4 kb pad).
//
// Output rows are the dual-polarity (size, key, encoded position) inserts of
// index/database.py::_emit (PackedMap.process, java:99-122), grouped by size
// with a counting sort.  PackedIndex.build lexsorts (bin, position), so
// multiset equality per size gives a bit-identical index.

namespace {

inline Block merge_blocks(const Block& L, const Block& R) {
  Block b;
  b.start = L.start;
  b.length = R.start + R.length - L.start;
  b.fwd = merge_hashes(L.length, L.fwd, R.length, R.fwd);
  b.rev = merge_hashes(R.length, R.rev, L.length, L.rev);

  bool anchor_exists = L.fwd != R.rev;
  bool anchor_is_right = L.fwd > R.rev;
  bool asym = anchor_exists && (b.fwd != b.rev);
  bool is_reverse = b.fwd < b.rev;
  bool invert = (is_reverse == anchor_is_right);

  bool a_nl = anchor_is_right ? R.next_l : L.next_l;
  bool a_nr = anchor_is_right ? R.next_r : L.next_r;
  if (a_nl && a_nr) {
    if (anchor_is_right) a_nr = false; else a_nl = false;
  }
  bool o_nl = anchor_is_right ? L.next_l : R.next_l;
  bool o_nr = anchor_is_right ? L.next_r : R.next_r;
  if (o_nl && o_nr) {
    if (!anchor_is_right) o_nl = false; else o_nr = false;
  }

  bool req_l = true, req_r = true, next_l = true, next_r = true;
  if (asym) {
    req_l = a_nl != invert;
    req_r = a_nr != invert;
    next_l = o_nl != invert;
    next_r = o_nr != invert;
  }
  if (L.length != R.length) {
    bool lg = L.length > R.length;
    req_l = lg; req_r = !lg; next_l = !lg; next_r = lg;
  }
  if (b.fwd != b.rev) {
    if (req_l && req_r) { req_l = b.fwd > b.rev; req_r = !req_l; }
    if (next_l && next_r) { next_l = req_l; next_r = !req_l; }
  }
  b.req_l = req_l; b.req_r = req_r; b.next_l = next_l; b.next_r = next_r;

  if (req_l != req_r) b.gap_dir = req_l ? 1 : -1;
  else if (anchor_exists) b.gap_dir = anchor_is_right ? 1 : -1;
  else b.gap_dir = 0;

  int64_t extra_raw = (int64_t)L.length + R.length - b.length;
  b.extra = (int32_t)(extra_raw / 4);  // trunc toward zero, as in Java
  return b;
}

struct EmitRows {
  std::vector<int32_t> sizes;
  std::vector<int32_t> keys;
  std::vector<int64_t> pos;
  void push(int32_t s, int32_t k, int64_t p) {
    sizes.push_back(s);
    keys.push_back(k);
    pos.push_back(p);
  }
};

// Walk one window's pyramid and append its core emissions.  Returns 0 on
// success, 1 when the buffer pad proved too small (caller retries), -2 on
// ambiguity (caller falls back to the numpy path).
// pos_offset places the (possibly sliced) codes range inside the full
// sequence: emitted starts are pos_offset+local, RC positions use full_n.
// keep_lo/keep_hi restrict emission to full-sequence starts in [keep_lo,
// keep_hi) (full range for whole-sequence callers).
int walk_window_emit(const uint8_t* codes, int64_t n, int64_t buf_lo,
                     int64_t buf_hi, int64_t core_lo, int64_t core_hi,
                     int32_t min_interesting, int32_t lo, int32_t hi,
                     int64_t seq_start, int64_t rc_start, int64_t pos_offset,
                     int64_t full_n, int64_t keep_lo, int64_t keep_hi,
                     EmitRows& out) {
  int64_t len = buf_hi - buf_lo;
  if (len <= 0) return 0;
  bool truncated = buf_hi < n;

  std::vector<uint32_t> pow_b(len + 2), inv_pow_b(len + 2);
  pow_b[0] = 1;
  inv_pow_b[0] = 1;
  for (int64_t i = 1; i <= len + 1; i++) {
    pow_b[i] = pow_b[i - 1] * GAPMER_MULTIPLIER;
    inv_pow_b[i] = inv_pow_b[i - 1] * GAPMER_MULTIPLIER_INV;
  }
  std::vector<uint32_t> pref_fwd(len + 1), pref_comp(len + 1);
  pref_fwd[0] = 0;
  pref_comp[0] = 0;
  for (int64_t i = 0; i < len; i++) {
    uint8_t c = codes[buf_lo + i];
    if (TWO_BIT[c] < 0) return -2;
    pref_fwd[i + 1] = pref_fwd[i] + (uint32_t)GAP_VAL[c] * pow_b[i];
    pref_comp[i + 1] = pref_comp[i] + (uint32_t)GAP_VAL_COMP[c] * inv_pow_b[i];
  }

  std::vector<Block> row(len), next;
  for (int64_t i = 0; i < len; i++) {
    int8_t v = TWO_BIT[codes[buf_lo + i]];
    Block& b = row[i];
    b.start = (int32_t)i;
    b.length = 1;
    b.fwd = v;
    b.rev = 3 - v;
    b.extra = 0;
    b.gap_dir = 0;
    b.req_l = v < 2;
    b.req_r = v >= 2;
    b.next_l = (v & 1) == 0;
    b.next_r = (v & 1) == 1;
  }

  // truncation frontier: block starts at/after this local position may
  // disagree with the global pyramid (base row is always exact)
  int64_t frontier = truncated ? len : INT64_MAX;
  int64_t core_lo_local = core_lo - buf_lo;
  int64_t core_hi_local = core_hi - buf_lo;

  while (true) {
    if (row.empty()) break;
    int32_t row_min_len = INT32_MAX, row_max_len = 0;
    for (const Block& b : row) {
      row_min_len = std::min(row_min_len, b.length);
      row_max_len = std::max(row_max_len, b.length);
    }
    if (row_min_len > hi) break;

    if (max_gapmer_num_bp(row_max_len) >= min_interesting) {
      for (const Block& b : row) {
        if (b.start < core_lo_local || b.start >= core_hi_local) continue;
        if ((int64_t)b.start >= frontier) return 1;  // core contaminated

        int32_t m = std::max(b.fwd, b.rev);
        int32_t abs_m = wrap32((uint64_t)(m < 0 ? -(int64_t)m : (int64_t)m));
        int32_t rem = abs_m % 3;
        int64_t target_extra = (int64_t)b.length + rem + b.extra;
        int64_t gap = b.length / 2;
        int64_t ext_len = target_extra - gap;

        int64_t g_start, g_len, g_num_bp;
        int32_t g_fwd, g_rev;
        bool is_self = b.gap_dir == 0;
        if (is_self) {
          g_start = b.start;
          g_len = b.length;
          g_num_bp = b.length;
          g_fwd = b.fwd;
          g_rev = b.rev;
        } else {
          int64_t ext_start, ext_end;
          if (b.gap_dir < 0) {
            ext_end = (int64_t)b.start - gap;
            ext_start = ext_end - ext_len;
            // bounds are the true sequence bounds, not the buffer's
            if (buf_lo + ext_start < 0) continue;
            if (ext_start < 0) return 1;  // pad too small on the left
            g_start = ext_start;
          } else {
            ext_start = (int64_t)b.start + b.length + gap;
            ext_end = ext_start + ext_len;
            if (buf_lo + ext_end > n) continue;
            if (ext_end > len) return 1;  // pad too small on the right
            g_start = b.start;
          }
          int64_t cs = std::min(std::max(ext_start, (int64_t)0), len);
          int64_t ce = std::min(std::max(ext_end, (int64_t)0), len);
          uint32_t ext_hash;
          if (b.gap_dir < 0) {
            ext_hash = (pref_fwd[ce] - pref_fwd[cs]) * inv_pow_b[cs];
          } else {
            int64_t e1 = std::max(ce, (int64_t)1) - 1;
            ext_hash = (pref_comp[ce] - pref_comp[cs]) * pow_b[e1];
          }
          g_fwd = wrap32((uint64_t)((int64_t)b.fwd + (int32_t)ext_hash));
          g_rev = wrap32((uint64_t)((int64_t)b.rev + (int32_t)ext_hash));
          g_len = b.length + gap + ext_len;
          g_num_bp = b.length + ext_len;
        }

        if (g_num_bp < min_interesting || g_num_bp <= lo || g_num_bp > hi)
          continue;

        bool primary, secondary;
        if (is_self && (b.req_l != b.req_r)) {
          primary = b.req_l;
          secondary = b.req_r;
        } else {
          primary = g_fwd >= g_rev;
          secondary = g_fwd <= g_rev;
        }
        int64_t gg_start = pos_offset + buf_lo + g_start;  // full-sequence
        if (gg_start < keep_lo || gg_start >= keep_hi) continue;
        if (primary) out.push((int32_t)g_num_bp, g_fwd, seq_start + gg_start);
        if (secondary)
          out.push((int32_t)g_num_bp, g_rev,
                   rc_start + full_n - (gg_start + g_len));
      }
    }

    if (row.size() < 2) break;
    next.clear();
    int64_t new_frontier = frontier;
    if (truncated) {
      // the last block whose span stays clear of the frontier is the last
      // one whose merge partner is trustworthy; everything from its start
      // onward is suspect at the next level
      new_frontier = 0;
      for (const Block& b : row) {
        if ((int64_t)b.start + b.length <= frontier) {
          new_frontier = b.start;
        } else {
          break;
        }
      }
    }
    for (size_t i = 0; i + 1 < row.size(); i++) {
      const Block& L = row[i];
      const Block& R = row[i + 1];
      if (!(L.start + L.length >= R.start && (L.req_r || R.req_l))) continue;
      next.push_back(merge_blocks(L, R));
    }
    row.swap(next);
    frontier = new_frontier;
    if (truncated && frontier <= core_hi_local && !row.empty()) {
      int32_t live_min = INT32_MAX;
      for (const Block& b : row) live_min = std::min(live_min, b.length);
      if (live_min <= hi) return 1;  // still emitting, core contaminated
      break;
    }
  }
  return 0;
}

}  // namespace

// Parallel fused collect+emit over one non-ambiguous sequence.  Returns the
// total number of rows written (grouped by size: out_size_counts[s] rows of
// size s, in ascending-size order), -1 when max_out is too small, -2 on
// ambiguity.
static int64_t collect_emit_impl(
    const uint8_t* codes, int64_t n, int32_t min_interesting, int32_t lo,
    int32_t hi, int64_t seq_start, int64_t rc_start, int64_t window,
    int64_t pad, int64_t pos_offset, int64_t full_n, int64_t keep_lo,
    int64_t keep_hi, int32_t* out_sizes, int32_t* out_keys, int64_t* out_pos,
    int64_t* out_size_counts, int64_t max_out) {
  if (n <= 0) {
    for (int32_t s = 0; s <= hi; s++) out_size_counts[s] = 0;
    return 0;
  }
  if (window < 4096) window = 4096;
  int64_t num_windows = (n + window - 1) / window;
  std::vector<EmitRows> rows((size_t)num_windows);
  std::vector<int> status((size_t)num_windows, 0);

#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t w = 0; w < num_windows; w++) {
    int64_t core_lo = w * window;
    int64_t core_hi = std::min(n, core_lo + window);
    int64_t this_pad = pad;
    while (true) {
      rows[w].sizes.clear();
      rows[w].keys.clear();
      rows[w].pos.clear();
      int64_t buf_lo = std::max((int64_t)0, core_lo - this_pad);
      int64_t buf_hi = std::min(n, core_hi + this_pad);
      int rc = walk_window_emit(codes, n, buf_lo, buf_hi, core_lo, core_hi,
                                min_interesting, lo, hi, seq_start, rc_start,
                                pos_offset, full_n, keep_lo, keep_hi,
                                rows[w]);
      if (rc == 1 && buf_hi - buf_lo < n) {
        this_pad *= 4;
        continue;
      }
      status[w] = rc == 1 ? 0 : rc;  // rc==1 with full buffer cannot happen
      break;
    }
  }
  for (int64_t w = 0; w < num_windows; w++)
    if (status[w] == -2) return -2;

  // counting-sort assembly: size-major, window order within a size
  std::vector<int64_t> counts((size_t)hi + 1, 0);
  int64_t total = 0;
  for (int64_t w = 0; w < num_windows; w++) {
    total += (int64_t)rows[w].sizes.size();
    for (int32_t s : rows[w].sizes) counts[s]++;
  }
  if (total > max_out) return -1;
  std::vector<int64_t> size_base((size_t)hi + 2, 0);
  for (int32_t s = 0; s <= hi; s++) {
    size_base[s + 1] = size_base[s] + counts[s];
    out_size_counts[s] = counts[s];
  }
  std::vector<int64_t> cursor(size_base.begin(), size_base.end() - 1);
  for (int64_t w = 0; w < num_windows; w++) {
    const EmitRows& r = rows[w];
    for (size_t i = 0; i < r.sizes.size(); i++) {
      int32_t s = r.sizes[i];
      int64_t at = cursor[s]++;
      out_sizes[at] = s;
      out_keys[at] = r.keys[i];
      out_pos[at] = r.pos[i];
    }
  }
  return total;
}

// Parallel fused collect+emit over one non-ambiguous sequence (grouped by
// size; -1 = grow max_out, -2 = ambiguity).
extern "C" int64_t mapper_collect_emit(
    const uint8_t* codes, int64_t n, int32_t min_interesting, int32_t lo,
    int32_t hi, int64_t seq_start, int64_t rc_start, int64_t window,
    int64_t pad, int32_t* out_sizes, int32_t* out_keys, int64_t* out_pos,
    int64_t* out_size_counts, int64_t max_out) {
  return collect_emit_impl(codes, n, min_interesting, lo, hi, seq_start,
                           rc_start, window, pad, 0, n, INT64_MIN, INT64_MAX,
                           out_sizes, out_keys, out_pos, out_size_counts,
                           max_out);
}

// Same over one clean SEGMENT of an ambiguous sequence: codes points at the
// segment slice (standalone pyramid, as the hybrid partition requires),
// pos_offset/full_n place it in the full sequence, and only blocks whose
// full-sequence start lies in [keep_lo, keep_hi) are emitted (the hybrid
// territory rule, HashBlockDatabase._hash_clean_segment).
extern "C" int64_t mapper_collect_emit_range(
    const uint8_t* codes, int64_t seg_len, int64_t pos_offset, int64_t full_n,
    int64_t keep_lo, int64_t keep_hi, int32_t min_interesting, int32_t lo,
    int32_t hi, int64_t seq_start, int64_t rc_start, int64_t window,
    int64_t pad, int32_t* out_sizes, int32_t* out_keys, int64_t* out_pos,
    int64_t* out_size_counts, int64_t max_out) {
  return collect_emit_impl(codes, seg_len, min_interesting, lo, hi, seq_start,
                           rc_start, window, pad, pos_offset, full_n, keep_lo,
                           keep_hi, out_sizes, out_keys, out_pos,
                           out_size_counts, max_out);
}

// ---------------------------------------------------------------------------
// Exact ungapped mismatch counts for candidate rows (the host certificate's
// penalty pass).  For rows where both the read and the reference diagonal are
// pure ACGT, the exact float64 ungapped penalty is (#mismatches) *
// mutation_penalty — an exact integer multiple, equal bit-for-bit to numpy's
// pairwise sum of the per-base penalties whenever mutation_penalty is
// integer-valued (the caller checks that and falls back to the numpy path
// otherwise, as it does for rows flagged not-clean here).

namespace {
// nibble complement (A<->T, C<->G, ambiguity codes bit-reversed)
const uint8_t NIBBLE_COMP[16] = {0, 8, 4, 12, 2, 10, 6, 14,
                                 1, 9, 5, 13, 3, 11, 7, 15};
const bool IS_ACGT[16] = {false, true,  true,  false, true,  false, false,
                          false, true,  false, false, false, false, false,
                          false, false};
}  // namespace

extern "C" void mapper_ungapped_counts(
    const uint8_t* read_codes, const int64_t* read_starts,
    const int32_t* row_read_id, const uint8_t* row_reversed,
    const int64_t* row_diag_start, int64_t k, const uint8_t* ref_concat,
    int32_t* out_counts, uint8_t* out_clean) {
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < k; r++) {
    int64_t rs = read_starts[row_read_id[r]];
    int64_t len = read_starts[row_read_id[r] + 1] - rs;
    const uint8_t* q = read_codes + rs;
    const uint8_t* w = ref_concat + row_diag_start[r];
    int32_t mism = 0;
    bool clean = true;
    if (row_reversed[r]) {
      for (int64_t i = 0; i < len; i++) {
        uint8_t a = NIBBLE_COMP[q[len - 1 - i]];
        uint8_t b = w[i];
        clean &= IS_ACGT[a] & IS_ACGT[b];
        mism += (a != b);
      }
    } else {
      for (int64_t i = 0; i < len; i++) {
        uint8_t a = q[i];
        uint8_t b = w[i];
        clean &= IS_ACGT[a] & IS_ACGT[b];
        mism += (a != b);
      }
    }
    out_counts[r] = mism;
    out_clean[r] = clean ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Scalar conditional pyramid (IUPAC-ambiguity expansion), native port of
// index/scalar.py (itself a faithful model of HashBlock_ParentRow.java /
// MultiHashBlock.java / SequenceCondition.java).  Returns the same entry
// columns as HashBlockDatabase._scalar_entries, in the same (row, slot,
// possibility) order, so the Python scalar path remains the differential
// oracle and outputs stay bit-identical.
// ---------------------------------------------------------------------------

namespace scalarpyr {

constexpr size_t MAX_COMBOS = 64;  // HashBlock_ParentRow.java:10

// Sorted (position -> concrete nibble) constraints (SequenceCondition.java).
struct Cond {
  std::vector<std::pair<int32_t, uint8_t>> kv;
};

// intersect(a, b) -> false on contradiction, else fills out.
static bool cond_intersect(const Cond& a, const Cond& b, Cond& out) {
  if (b.kv.empty()) { out = a; return true; }
  if (a.kv.empty()) { out = b; return true; }
  out.kv.clear();
  out.kv.reserve(a.kv.size() + b.kv.size());
  size_t i = 0, j = 0;
  while (i < a.kv.size() && j < b.kv.size()) {
    int32_t ka = a.kv[i].first, kb = b.kv[j].first;
    if (ka == kb) {
      if (a.kv[i].second != b.kv[j].second) return false;
      out.kv.push_back(a.kv[i]);
      i++; j++;
    } else if (ka < kb) {
      out.kv.push_back(a.kv[i++]);
    } else {
      out.kv.push_back(b.kv[j++]);
    }
  }
  for (; i < a.kv.size(); i++) out.kv.push_back(a.kv[i]);
  for (; j < b.kv.size(); j++) out.kv.push_back(b.kv[j]);
  return true;
}

struct CondBlock {
  bool has_block;
  Block b;
  Cond cond;
};

struct Slot {
  bool multi;
  Block b;                      // valid when !multi (always a real block)
  std::vector<CondBlock> poss;  // valid when multi
};

inline bool should_merge(const Block& L, const Block& R) {
  // HashBlock_ParentRow.shouldMergeBlocks (java:200-208)
  if (L.start + L.length < R.start) return false;
  return L.req_r || R.req_l;
}

// HashBlock_ParentRow.expand (java:137-191) == scalar.py::_expand.
static void expand(const std::vector<Slot>& row, const Block& left_block,
                   const Cond& cond, size_t slot_index,
                   std::vector<CondBlock>& results) {
  if (slot_index + 1 >= row.size()) return;
  const Slot& next = row[slot_index + 1];
  static const Cond ALWAYS{};
  // iterate the next slot's possibilities (a concrete slot behaves as one
  // unconditional possibility)
  size_t np_ = next.multi ? next.poss.size() : 1;
  bool found = false;
  Cond inter;
  for (size_t oi = 0; oi < np_; oi++) {
    const Block* rb;
    const Cond* rc;
    bool r_has;
    if (next.multi) {
      r_has = next.poss[oi].has_block;
      rb = &next.poss[oi].b;
      rc = &next.poss[oi].cond;
    } else {
      r_has = true;
      rb = &next.b;
      rc = &ALWAYS;
    }
    if (!cond_intersect(cond, *rc, inter)) {
      if (found) break;
      continue;
    }
    found = true;
    if (results.size() > MAX_COMBOS) return;
    if (!r_has) {
      expand(row, left_block, inter, slot_index + 1, results);
      continue;
    }
    CondBlock out;
    if (should_merge(left_block, *rb)) {
      out.has_block = true;
      out.b = merge_blocks(left_block, *rb);
    } else {
      out.has_block = false;
    }
    out.cond = inter;
    results.push_back(std::move(out));
  }
}

// scalar.py::scalar_merge_row
static void merge_row(const std::vector<Slot>& row, std::vector<Slot>& out) {
  out.clear();
  if (row.size() < 2) return;
  std::vector<CondBlock> opts;
  for (size_t i = 0; i + 1 < row.size(); i++) {
    const Slot& L = row[i];
    const Slot& R = row[i + 1];
    if (!L.multi && !R.multi) {
      if (should_merge(L.b, R.b)) {
        Slot s;
        s.multi = false;
        s.b = merge_blocks(L.b, R.b);
        out.push_back(std::move(s));
      }
      continue;
    }
    opts.clear();
    if (!L.multi) {
      expand(row, L.b, Cond{}, i, opts);
    } else {
      for (const CondBlock& lo_ : L.poss) {
        if (lo_.has_block) {
          expand(row, lo_.b, lo_.cond, i, opts);
        } else {
          CondBlock o;
          o.has_block = false;
          o.cond = lo_.cond;
          opts.push_back(std::move(o));
        }
      }
    }
    if (!opts.empty() && opts.size() <= MAX_COMBOS) {
      bool any = false;
      for (const CondBlock& o : opts) any |= o.has_block;
      if (any) {
        Slot s;
        s.multi = true;
        s.poss = std::move(opts);
        out.push_back(std::move(s));
        opts = std::vector<CondBlock>();
      }
    }
  }
}

}  // namespace scalarpyr

// Entry columns for one (possibly IUPAC-ambiguous) code window: exactly
// HashBlockDatabase._scalar_entries with window-local starts.  keep_lo/keep_hi
// restrict output to blocks whose window-local start is in [keep_lo, keep_hi).
// Returns the entry count, or -1 when max_out is too small (caller regrows).
extern "C" int64_t mapper_scalar_entries(
    const uint8_t* codes, int64_t len, int32_t min_interesting, int32_t lo,
    int32_t hi, int32_t enable_gapmers, int64_t keep_lo, int64_t keep_hi,
    int32_t* out_num_bp, int32_t* out_fwd, int32_t* out_rev,
    uint8_t* out_primary, uint8_t* out_secondary, int64_t* out_start,
    int32_t* out_length, uint8_t* out_amb, int64_t max_out) {
  using namespace scalarpyr;
  if (len <= 0) return 0;

  // gapmer extension prefix tables; ambiguity codes contribute value 0
  // (HashBlock.charToInt, HashBlock.java:152-169)
  std::vector<uint32_t> pow_b(len + 2), inv_pow_b(len + 2);
  pow_b[0] = 1;
  inv_pow_b[0] = 1;
  for (int64_t i = 1; i <= len + 1; i++) {
    pow_b[i] = pow_b[i - 1] * GAPMER_MULTIPLIER;
    inv_pow_b[i] = inv_pow_b[i - 1] * GAPMER_MULTIPLIER_INV;
  }
  std::vector<uint32_t> pref_fwd(len + 1), pref_comp(len + 1);
  pref_fwd[0] = 0;
  pref_comp[0] = 0;
  for (int64_t i = 0; i < len; i++) {
    uint8_t c = codes[i] & 0xF;
    pref_fwd[i + 1] = pref_fwd[i] + (uint32_t)GAP_VAL[c] * pow_b[i];
    pref_comp[i + 1] = pref_comp[i] + (uint32_t)GAP_VAL_COMP[c] * inv_pow_b[i];
  }

  // base row (HashBlock_BaseRow.java:27-56): ambiguous positions expand into
  // a MultiBlock with one conditional block per possible base, in A,C,G,T
  // (nibble 1,2,4,8) order
  std::vector<Slot> row(len), next;
  for (int64_t i = 0; i < len; i++) {
    uint8_t c = codes[i] & 0xF;
    int8_t v = TWO_BIT[c];
    Slot& s = row[i];
    if (v >= 0) {
      s.multi = false;
      Block& b = s.b;
      b.start = (int32_t)i;
      b.length = 1;
      b.fwd = v;
      b.rev = 3 - v;
      b.extra = 0;
      b.gap_dir = 0;
      b.req_l = v < 2;
      b.req_r = v >= 2;
      b.next_l = (v & 1) == 0;
      b.next_r = (v & 1) == 1;
    } else {
      s.multi = true;
      for (uint8_t bit : {1, 2, 4, 8}) {
        if (!(c & bit)) continue;
        int8_t tb = TWO_BIT[bit];
        CondBlock cb;
        cb.has_block = true;
        Block& b = cb.b;
        b.start = (int32_t)i;
        b.length = 1;
        b.fwd = tb;
        b.rev = 3 - tb;
        b.extra = 0;
        b.gap_dir = 0;
        b.req_l = tb < 2;
        b.req_r = tb >= 2;
        b.next_l = (tb & 1) == 0;
        b.next_r = (tb & 1) == 1;
        cb.cond.kv.push_back({(int32_t)i, bit});
        s.poss.push_back(std::move(cb));
      }
    }
  }

  int64_t w = 0;
  auto emit_block = [&](const Block& b, bool is_conditional) -> bool {
    // gapmer transform (HashBlock.withGapAndExtension, java:67-150)
    int64_t g_start, g_len, g_num_bp;
    int32_t g_fwd, g_rev;
    bool is_self;
    if (!enable_gapmers || b.gap_dir == 0) {
      is_self = true;
      g_start = b.start;
      g_len = b.length;
      g_num_bp = b.length;
      g_fwd = b.fwd;
      g_rev = b.rev;
    } else {
      is_self = false;
      int32_t m = std::max(b.fwd, b.rev);
      int32_t abs_m = wrap32((uint64_t)(m < 0 ? -(int64_t)m : (int64_t)m));
      int32_t rem = abs_m % 3;
      int64_t target_extra = (int64_t)b.length + rem + b.extra;
      int64_t gap = b.length / 2;
      int64_t ext_len = target_extra - gap;
      int64_t ext_start, ext_end;
      if (b.gap_dir < 0) {
        ext_end = (int64_t)b.start - gap;
        ext_start = ext_end - ext_len;
        if (ext_start < 0) return true;
        g_start = ext_start;
      } else {
        ext_start = (int64_t)b.start + b.length + gap;
        ext_end = ext_start + ext_len;
        if (ext_end > len) return true;
        g_start = b.start;
      }
      int64_t cs = std::min(std::max(ext_start, (int64_t)0), len);
      int64_t ce = std::min(std::max(ext_end, (int64_t)0), len);
      uint32_t ext_hash;
      if (b.gap_dir < 0) {
        ext_hash = (pref_fwd[ce] - pref_fwd[cs]) * inv_pow_b[cs];
      } else {
        int64_t e1 = std::max(ce, (int64_t)1) - 1;
        ext_hash = (pref_comp[ce] - pref_comp[cs]) * pow_b[e1];
      }
      g_fwd = wrap32((uint64_t)((int64_t)b.fwd + (int32_t)ext_hash));
      g_rev = wrap32((uint64_t)((int64_t)b.rev + (int32_t)ext_hash));
      g_len = b.length + gap + ext_len;
      g_num_bp = b.length + ext_len;
    }
    if (g_num_bp < min_interesting || g_num_bp <= lo || g_num_bp > hi)
      return true;
    if (g_start < keep_lo || g_start >= keep_hi) return true;
    bool primary, secondary;
    if (is_self && (b.req_l != b.req_r)) {
      primary = b.req_l;
      secondary = b.req_r;
    } else {
      primary = g_fwd >= g_rev;
      secondary = g_fwd <= g_rev;
    }
    if (w >= max_out) return false;
    out_num_bp[w] = (int32_t)g_num_bp;
    out_fwd[w] = g_fwd;
    out_rev[w] = g_rev;
    out_primary[w] = primary ? 1 : 0;
    out_secondary[w] = secondary ? 1 : 0;
    out_start[w] = g_start;
    out_length[w] = (int32_t)g_len;
    out_amb[w] = is_conditional ? 1 : 0;
    w++;
    return true;
  };

  while (!row.empty()) {
    int32_t row_min_len = INT32_MAX;
    for (const Slot& s : row) {
      if (!s.multi) {
        row_min_len = std::min(row_min_len, s.b.length);
      } else {
        for (const CondBlock& o : s.poss)
          if (o.has_block) row_min_len = std::min(row_min_len, o.b.length);
      }
    }
    if (row_min_len > hi) break;  // later rows only have longer blocks

    for (const Slot& s : row) {
      if (!s.multi) {
        if (!emit_block(s.b, false)) return -1;
      } else {
        for (const CondBlock& o : s.poss) {
          if (o.has_block && !emit_block(o.b, true)) return -1;
        }
      }
    }

    if (row.size() < 2) break;
    merge_row(row, next);
    row.swap(next);
  }
  return w;
}

// ---------------------------------------------------------------------------
// Batched hash-collision sampling check (Counting_HashBlockPath.java:95-153;
// candidates.py::_passes_collision_check is the Python oracle): for each
// (walked block, index match) pair, sample +-20 bp around the block and
// reject when mismatches outnumber matches.  One call per query covers every
// match of the prefetched walk.
extern "C" void mapper_collision_batch(
    const uint8_t* q, int64_t qn, const uint8_t* concat,
    const int64_t* ref_global,  // concat index of the match start
    const int64_t* ref_off,     // match offset within its ref sequence
    const int64_t* ref_len,     // ref sequence length
    const int64_t* bstart, const int64_t* blen, const int64_t* bnbp,
    int64_t k, uint8_t* out_ok) {
  for (int64_t i = 0; i < k; i++) {
    const int64_t bs = bstart[i];
    const int64_t right = bs + blen[i] - 1;
    const uint8_t* r = concat + (ref_global[i] - ref_off[i]);
    const int64_t rn = ref_len[i];
    const int64_t rs = ref_off[i];
    int64_t n_match = 0, n_mismatch = 0;
    for (int d = 1; d < 20; d++) {
      for (int t = 0; t < 2; t++) {
        const int64_t qi = t == 0 ? bs - d : right + d;
        if (qi >= 0 && qi < qn) {
          const int64_t ri = qi - bs + rs;
          if (ri >= 0 && ri < rn) {
            if ((q[qi] & r[ri]) == 0)
              n_mismatch++;
            else
              n_match++;
          }
        }
      }
      if (n_match < n_mismatch) break;
      if (n_match >= n_mismatch + bnbp[i]) break;
    }
    out_ok[i] = n_mismatch <= n_match ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// Fused walk prefetch: index lookups + secondary-polarity fold + +-20bp
// collision checks + reverse-strand fold for a whole native-walk sequence in
// one call (candidates._prefetch_matches + _fold_and_filter are the Python
// oracle).  Outputs exactly what CountingHashBlockPath.step replays:
// per-walk-row popularity/raw-count, and collision-filtered
// (fold_seq, fold_off, is_rc) rows grouped by walk index.
// Returns total kept rows, or -2 when cap is insufficient.
extern "C" int64_t mapper_prefetch_fold(
    const int32_t* seq_arr, int64_t nb,  // [nb, 9] native walk rows
    const int64_t* capacities, const int64_t* caps, const int64_t* bases,
    const int64_t* counts, const int64_t* offsets, const int64_t* values,
    const int64_t* seq_starts, int64_t n_seqs, const int64_t* seq_lengths,
    const int64_t* rc_index, const uint8_t* rc_flags,
    const uint8_t* q, int64_t qn, const uint8_t* concat,
    uint8_t* out_popular, int64_t* out_raw_counts, int64_t* out_bounds,
    int64_t* out_fold_idx, int64_t* out_fold_off, uint8_t* out_is_rc,
    int64_t cap) {
  int64_t w = 0;
  out_bounds[0] = 0;
  for (int64_t k = 0; k < nb; k++) {
    const int32_t* row = seq_arr + k * 9;
    const int64_t bs = row[0];
    const int64_t blen = row[1];
    const int64_t nbp = row[2];
    const int32_t fwd = row[3];
    const int32_t rev = row[4];
    const bool req_l = row[5] != 0;
    const bool req_r = row[6] != 0;
    const bool primary = (req_l != req_r) ? req_l : (fwd >= rev);
    const int64_t key = primary ? (int64_t)fwd : (int64_t)rev;
    const int64_t capc = capacities[nbp];
    int64_t rem = key % capc;
    if (rem < 0) rem += capc;  // numpy floor-mod
    const int64_t bin = bases[nbp] + rem;
    const int64_t cnt = counts[bin];
    const bool popular = cnt > caps[nbp];
    out_popular[k] = popular ? 1 : 0;
    const int64_t take = popular ? 0 : cnt;
    out_raw_counts[k] = take;
    const int64_t off0 = offsets[bin];
    for (int64_t j = 0; j < take; j++) {
      int64_t pos = values[off0 + j];
      // decode (sequence, offset)
      int64_t lo = 0, hi = n_seqs;
      while (lo < hi) {
        int64_t mid = (lo + hi) / 2;
        if (seq_starts[mid + 1] > pos) hi = mid; else lo = mid + 1;
      }
      int64_t seq = lo;
      int64_t pos_off = pos - seq_starts[seq];
      if (!primary) {  // secondary-polarity strand fold (match_block)
        const int64_t orig = seq;
        seq = rc_index[orig];
        pos_off = seq_lengths[orig] - pos_off - blen;
      }
      // +-20bp collision sampling (Counting_HashBlockPath.java:95-153)
      const uint8_t* r = concat + seq_starts[seq];
      const int64_t rn = seq_lengths[seq];
      const int64_t right = bs + blen - 1;
      int64_t n_match = 0, n_mismatch = 0;
      for (int d = 1; d < 20; d++) {
        for (int t = 0; t < 2; t++) {
          const int64_t qi = t == 0 ? bs - d : right + d;
          if (qi >= 0 && qi < qn) {
            const int64_t ri = qi - bs + pos_off;
            if (ri >= 0 && ri < rn) {
              if ((q[qi] & r[ri]) == 0)
                n_mismatch++;
              else
                n_match++;
            }
          }
        }
        if (n_match < n_mismatch) break;
        if (n_match >= n_mismatch + nbp) break;
      }
      if (n_mismatch > n_match) continue;
      // reverse-strand fold to forward coordinates (java:154-166)
      const bool is_rc = rc_flags[seq] != 0;
      if (w >= cap) return -2;
      if (is_rc) {
        out_fold_idx[w] = rc_index[seq];
        out_fold_off[w] =
            (seq_lengths[seq] - (pos_off + blen)) - (qn - (bs + blen));
      } else {
        out_fold_idx[w] = seq;
        out_fold_off[w] = pos_off - bs;
      }
      out_is_rc[w] = is_rc ? 1 : 0;
      w++;
    }
    out_bounds[k + 1] = w;
  }
  return w;
}
