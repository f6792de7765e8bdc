// Native pileup accumulation: one call adds every pending alignment of a
// MatchDatabase (mapper_tpu_torch/pileup.py) into its contigs' `middle`,
// `end` and `deletion_start_middle` arrays, in place.
//
// It makes, for every array element, the same float64 additions in the same
// order as the Python passes it replaces, so the arrays come out bit for bit
// the same whatever the weights:
//   1. the fast groups (one full-length ungapped block, no mate overlap),
//      keyed by (forward contig, folded, read length, weight) in the order
//      their key was first seen.  A power-of-two weight takes sparse
//      mismatch corrections here and its depth in step 2; any other weight
//      (or a read that is all end) scatters every base directly.  Within one
//      group every addend an element receives is the same value (+w, or -w
//      at a mismatch's reference row), so the order inside a group is free;
//   2. per contig with power-of-two groups, the depth added onto each
//      position's reference-allele row: one prefix sum of difference
//      arrays, as in the Python passes (exact sums);
//   3. the other alignments' blocks, in visit order (matches, deletions,
//      deletion starts).  Insertions are left to the caller, which keys them
//      by their text.
// Build with -ffp-contract=off: a contracted multiply-add would change the
// end margin's rounding.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kRowDel = 5;
// an alignment's record: code offset, query length, flags, entry, choices,
// and the start on its reference (a lazy row) or its number of blocks
constexpr int kFields = 6;
constexpr int64_t kReversed = 1, kLazy = 8;  // flags; the pair is bits 1-2

struct GroupKey {
  int64_t contig;
  int64_t folded;
  int64_t length;
  uint64_t weight_bits;
  bool operator==(const GroupKey& o) const {
    return contig == o.contig && folded == o.folded && length == o.length &&
           weight_bits == o.weight_bits;
  }
};

struct GroupKeyHash {
  size_t operator()(const GroupKey& k) const {
    uint64_t h = k.weight_bits * 0x9E3779B97F4A7C15ull;
    h ^= static_cast<uint64_t>(k.length) + 0x632BE59BD9B4E019ull + (h << 6) + (h >> 2);
    h ^= (static_cast<uint64_t>(k.contig) << 1 | static_cast<uint64_t>(k.folded)) + (h << 6) + (h >> 2);
    return static_cast<size_t>(h);
  }
};

// numpy's `np.minimum(j, length - 1 - j) < query_end_fraction * length`:
// the first index that is not at a read end, or `length` when all are.  The
// end indices are then exactly j < lo and j >= length - lo.
inline int64_t end_width(int64_t length, double query_end_fraction) {
  const double margin = query_end_fraction * static_cast<double>(length);
  for (int64_t j = 0; j < length; j++) {
    const int64_t dist = j < length - 1 - j ? j : length - 1 - j;
    if (!(static_cast<double>(dist) < margin)) return j;
  }
  return length;
}

// math.frexp(weight)[0] == 0.5: a power of two
inline bool dyadic(double weight) {
  if (!(weight > 0)) return false;
  int exponent;
  return std::frexp(weight, &exponent) == 0.5;
}

}  // namespace

// Returns 0 once the arrays are written; -1 when an index lies outside its
// array (nothing is written then: the caller takes the Python path).
//
// Contigs (forward sequences): `contig_len`, and the addresses of each one's
// middle [6, len], end [6, len], deletion starts [len] (float64) and
// reference rows [len] (int8).  Entries (one per distinct reference
// sequence object): its contig and whether it is the contig's reverse
// complement.  Alignments, in visit order, `kFields` int64 each:
// the offset of its query's codes in `codes`; the query length; flags
// (`kReversed`: read those codes reverse complemented; the pair, bits 1-2:
// 1 and 2 for the first and second component of a two-component choice;
// `kLazy`: one full-length ungapped block, no blocks given); its entry; the
// number of choices it is one of (its weight is 1 / that); the lazy row's
// start on its reference, or the number of its blocks, which follow one
// another in `blocks`, (start_a, start_b, length_a, length_b) each.
// Outputs: each alignment's mate-overlap range (-1, -1 where there is none)
// and the contigs in the order the Python passes would have created their
// pileups (-1 after the last).
extern "C" int64_t mapper_pileup_accumulate(
    int64_t num_contigs, const int64_t* contig_len, const uint64_t* middle_addr,
    const uint64_t* end_addr, const uint64_t* del_addr, const uint64_t* ref_rows_addr,
    int64_t num_entries, const int64_t* entry_contig, const uint8_t* entry_folded,
    const uint8_t* codes, int64_t codes_len,
    const int8_t* code_to_row, const uint8_t* complement, double query_end_fraction,
    int64_t num_alignments, const int64_t* records, int64_t num_blocks,
    const int64_t* blocks, int64_t* out_overlap_lo, int64_t* out_overlap_hi,
    int64_t* out_contig_order) {
  // rows of a code read as is [0] or complemented [1]
  int8_t row_of[2][16];
  for (int c = 0; c < 16; c++) {
    row_of[0][c] = code_to_row[c];
    row_of[1][c] = code_to_row[complement[c] & 15];
  }
  auto rec = [&](int64_t i) { return records + kFields * i; };
  auto lazy = [&](int64_t i) { return (rec(i)[2] & kLazy) != 0; };

  // --- validate every index before any write ------------------------------
  std::vector<int64_t> block0(num_alignments + 1, 0);
  for (int64_t e = 0; e < num_entries; e++) {
    if (entry_contig[e] < 0 || entry_contig[e] >= num_contigs) return -1;
  }
  for (int64_t i = 0; i < num_alignments; i++) {
    const int64_t* r = rec(i);
    const int64_t qlen = r[1], entry = r[3];
    if (entry < 0 || entry >= num_entries || r[4] < 1) return -1;
    if (qlen < 0 || r[0] < 0 || r[0] > codes_len - qlen) return -1;
    const int64_t n = contig_len[entry_contig[entry]];
    if (lazy(i)) {
      if (r[5] < 0 || r[5] > n - qlen) return -1;
      block0[i + 1] = block0[i];
      continue;
    }
    if (r[5] < 0 || r[5] > num_blocks - block0[i]) return -1;
    block0[i + 1] = block0[i] + r[5];
    for (int64_t b = block0[i]; b < block0[i + 1]; b++) {
      const int64_t sa = blocks[4 * b], sb = blocks[4 * b + 1];
      const int64_t la = blocks[4 * b + 2], lb = blocks[4 * b + 3];
      if (la < 0 || lb < 0) return -1;
      if (la == lb && la > 0) {
        if (sa < 0 || sa + la > qlen || sb < 0 || sb + lb > n) return -1;
      } else if (lb > 0) {
        if (sb < 0 || sb + lb > n) return -1;
      }
    }
  }
  if (block0[num_alignments] != num_blocks) return -1;
  // a fast alignment's start on its reference
  auto start_of = [&](int64_t i) { return lazy(i) ? rec(i)[5] : blocks[4 * block0[i] + 1]; };

  // --- mate overlap, and which alignments take the fast groups -------------
  for (int64_t i = 0; i < num_alignments; i++) {
    out_overlap_lo[i] = -1;
    out_overlap_hi[i] = -1;
  }
  for (int64_t i = 0; i + 1 < num_alignments; i++) {
    const int64_t* a = rec(i);
    const int64_t* b = rec(i + 1);
    if (((a[2] >> 1) & 3) != 1 || ((b[2] >> 1) & 3) != 2 || a[3] != b[3]) continue;
    if (block0[i] == block0[i + 1] || block0[i + 1] == block0[i + 2]) continue;
    const int64_t* a0 = blocks + 4 * block0[i];
    const int64_t* a1 = blocks + 4 * (block0[i + 1] - 1);
    const int64_t* b0 = blocks + 4 * block0[i + 1];
    const int64_t* b1 = blocks + 4 * (block0[i + 2] - 1);
    const int64_t lo = a0[1] > b0[1] ? a0[1] : b0[1];
    const int64_t a_end = a1[1] + a1[3], b_end = b1[1] + b1[3];
    const int64_t hi = a_end < b_end ? a_end : b_end;
    if (lo < hi) {
      out_overlap_lo[i] = out_overlap_lo[i + 1] = lo;
      out_overlap_hi[i] = out_overlap_hi[i + 1] = hi;
    }
  }
  std::vector<uint8_t> fast(num_alignments, 0);
  for (int64_t i = 0; i < num_alignments; i++) {
    if (lazy(i)) {
      fast[i] = 1;
    } else if (out_overlap_lo[i] < 0 && block0[i + 1] - block0[i] == 1) {
      const int64_t* b = blocks + 4 * block0[i];
      fast[i] = b[2] == b[3] && b[0] == 0 && b[2] == rec(i)[1];
    }
  }

  // --- fast groups, in the order their key was first seen ------------------
  std::unordered_map<GroupKey, int64_t, GroupKeyHash> group_of;
  std::vector<GroupKey> keys;
  std::vector<int64_t> item_group(num_alignments, -1);
  for (int64_t i = 0; i < num_alignments; i++) {
    if (!fast[i]) continue;
    const int64_t* r = rec(i);
    const double weight = 1.0 / static_cast<double>(r[4]);
    GroupKey key{entry_contig[r[3]], entry_folded[r[3]], r[1], 0};
    std::memcpy(&key.weight_bits, &weight, sizeof(double));
    auto it = group_of.find(key);
    if (it == group_of.end()) {
      it = group_of.emplace(key, static_cast<int64_t>(keys.size())).first;
      keys.push_back(key);
    }
    item_group[i] = it->second;
  }
  const int64_t num_groups = static_cast<int64_t>(keys.size());
  std::vector<int64_t> group_start(num_groups + 1, 0);
  for (int64_t i = 0; i < num_alignments; i++) {
    if (item_group[i] >= 0) group_start[item_group[i] + 1]++;
  }
  for (int64_t g = 0; g < num_groups; g++) group_start[g + 1] += group_start[g];
  std::vector<int64_t> items(group_start[num_groups]);
  {
    std::vector<int64_t> fill(group_start.begin(), group_start.end() - 1);
    for (int64_t i = 0; i < num_alignments; i++) {
      if (item_group[i] >= 0) items[fill[item_group[i]]++] = i;
    }
  }

  // the order the Python passes create pileups in: the other alignments'
  // contigs as they are visited, then the fast groups'
  {
    std::vector<uint8_t> seen(num_contigs, 0);
    int64_t k = 0;
    auto note = [&](int64_t c) {
      if (!seen[c]) {
        seen[c] = 1;
        out_contig_order[k++] = c;
      }
    };
    for (int64_t i = 0; i < num_alignments; i++) {
      if (!fast[i]) note(entry_contig[rec(i)[3]]);
    }
    for (int64_t g = 0; g < num_groups; g++) note(keys[g].contig);
    for (; k < num_contigs; k++) out_contig_order[k] = -1;
  }

  // Contig by contig (groups of other contigs touch other arrays): its
  // groups in first-seen order, then its depth
  std::vector<std::vector<int64_t>> groups_on(num_contigs);
  for (int64_t g = 0; g < num_groups; g++) groups_on[keys[g].contig].push_back(g);
  std::vector<double> diff_mid, diff_end;
  for (int64_t c = 0; c < num_contigs; c++) {
    if (groups_on[c].empty()) continue;
    const int64_t n = contig_len[c];
    double* middle = reinterpret_cast<double*>(middle_addr[c]);
    double* end = reinterpret_cast<double*>(end_addr[c]);
    const int8_t* rref = reinterpret_cast<const int8_t*>(ref_rows_addr[c]);
    bool depth = false;
    for (const int64_t g : groups_on[c]) {
      const GroupKey& key = keys[g];
      const int64_t length = key.length;
      double weight;
      std::memcpy(&weight, &key.weight_bits, sizeof(double));
      const int64_t lo = end_width(length, query_end_fraction);
      const bool folded = key.folded != 0;
      // a power-of-two weight: the reads' depth as +-w at each range's ends
      // of a difference array, prefix-summed below (exact sums), and sparse
      // corrections where the read's row differs from the reference's
      const bool by_depth = dyadic(weight) && 2 * lo < length;
      if (by_depth && !depth) {
        diff_mid.assign(n + 1, 0.0);
        diff_end.assign(n + 1, 0.0);
        depth = true;
      }
      for (int64_t k = group_start[g]; k < group_start[g + 1]; k++) {
        const int64_t i = items[k];
        const bool rev = (rec(i)[2] & kReversed) != 0;
        const int64_t s = start_of(i);
        const uint8_t* q = codes + rec(i)[0];
        const int8_t* rows = row_of[rev != folded];
        if (by_depth) {
          // the read's window on the forward contig: ends [f, f + lo) and
          // [f + length - lo, f + length), middle [f + lo, f + length - lo)
          const int64_t f = folded ? n - s - length : s;
          diff_mid[f + lo] += weight;
          diff_mid[f + length - lo] += -weight;
          if (lo) {
            diff_end[f] += weight;
            diff_end[f + lo] += -weight;
            diff_end[f + length - lo] += weight;
            diff_end[f + length] += -weight;
          }
        }
        for (int64_t j = 0; j < length; j++) {
          const int64_t pos = folded ? n - 1 - s - j : s + j;
          const int64_t row = rows[q[rev ? length - 1 - j : j] & 15];
          const bool in_middle = j >= lo && j < length - lo;
          if (by_depth) {
            const int64_t ref_row = rref[pos];
            if (row == ref_row) continue;
            double* target = in_middle ? middle : end;
            target[row * n + pos] += weight;
            target[ref_row * n + pos] += -weight;
            continue;
          }
          // direct scatter; where the end slices [:lo] and [length-lo:]
          // overlap (a read too short for a middle), a base goes to `end`
          // twice, as in the Python passes
          if (in_middle) middle[row * n + pos] += weight;
          if (j < lo) end[row * n + pos] += weight;
          if (j >= length - lo) end[row * n + pos] += weight;
        }
      }
    }
    if (!depth) continue;
    // one addition a position onto its reference-allele row, as
    // `middle[rref, cols] += depth` makes
    double depth_mid = 0.0, depth_end = 0.0;
    for (int64_t x = 0; x < n; x++) {
      depth_mid += diff_mid[x];
      depth_end += diff_end[x];
      middle[rref[x] * n + x] += depth_mid;
      end[rref[x] * n + x] += depth_end;
    }
  }

  // --- the other alignments' blocks, in visit order ------------------------
  for (int64_t i = 0; i < num_alignments; i++) {
    if (fast[i]) continue;
    const int64_t* r = rec(i);
    const int64_t c = entry_contig[r[3]];
    const bool folded = entry_folded[r[3]] != 0;
    const int64_t n = contig_len[c];
    double* middle = reinterpret_cast<double*>(middle_addr[c]);
    double* end = reinterpret_cast<double*>(end_addr[c]);
    double* del = reinterpret_cast<double*>(del_addr[c]);
    const bool rev = (r[2] & kReversed) != 0;
    const uint8_t* q = codes + r[0];
    const int8_t* rows = row_of[rev != folded];
    const int64_t qlen = r[1];
    const int64_t lo = end_width(qlen, query_end_fraction);
    const double margin = query_end_fraction * static_cast<double>(qlen);
    const double weight = 1.0 / static_cast<double>(r[4]);
    const double half = weight * 0.5;
    // the overlap's half weight: never where there is no overlap (-1, -1)
    const int64_t ov_lo = out_overlap_lo[i], ov_hi = out_overlap_hi[i];
    for (int64_t b = block0[i]; b < block0[i + 1]; b++) {
      const int64_t sa = blocks[4 * b], sb = blocks[4 * b + 1];
      const int64_t la = blocks[4 * b + 2], lb = blocks[4 * b + 3];
      if (la == lb && la > 0) {
        for (int64_t k = 0; k < la; k++) {
          const int64_t x = sa + k, y = sb + k;
          double* target = (x < lo || x >= qlen - lo) ? end : middle;
          const int64_t row = rows[q[rev ? qlen - 1 - x : x] & 15];
          target[row * n + (folded ? n - 1 - y : y)] += (y >= ov_lo && y < ov_hi) ? half : weight;
        }
      } else if (lb > 0) {
        // deletion: weight on each deleted position, its start marked when
        // it lies in the middle of the read
        const int64_t dist = sa < qlen - sa ? sa : qlen - sa;
        const bool is_end = static_cast<double>(dist) < margin;
        double* target = is_end ? end : middle;
        for (int64_t y = sb; y < sb + lb; y++) {
          target[kRowDel * n + (folded ? n - 1 - y : y)] += (y >= ov_lo && y < ov_hi) ? half : weight;
        }
        if (!is_end) del[folded ? n - sb - lb : sb] += (sb >= ov_lo && sb < ov_hi) ? half : weight;
      }
    }
  }
  return 0;
}
