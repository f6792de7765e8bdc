// Native duplication scan: one call groups the interesting hash bins of one
// block length by their edge text, for DuplicationDetector._process_length
// (mapper_tpu_torch/index/duplication.py).
//
// For each bin whose total count lies in [min_copies, max_count], in
// ascending bin order:
//   1. the bin's stored forward positions and their reverse complements
//      (Readable_HashBlock_Database.reverseComplement);
//   2. rows with an ambiguous base in the prefix window [p, p + w) or the
//      suffix window [p + L - w, p + L), w = ceil(L / 4), are dropped;
//   3. the rest sorted by (prefix codes, suffix codes, position), the codes
//      compared as unsigned bytes: the order np.unique gives the vectorized
//      pass's int32 columns of the same codes;
//   4. repeated positions dropped; each run of equal text that keeps at
//      least min_copies positions is one group.
// So the groups come out in the vectorized pass's order: bins ascending,
// text ascending within a bin, positions ascending within a group.  The
// call returns -1, with the outputs unfinished, on an input the vectorized
// pass would index differently (a position outside the codes or its
// sequences, a sequence without a reverse complement, a code past the
// table): the caller then takes that pass, which raises as it always has.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Row {
  const uint8_t* prefix;
  const uint8_t* suffix;
  int64_t position;
};

}  // namespace

extern "C" int64_t mapper_dupscan_group(
    int64_t capacity, const int32_t* counts, const int64_t* offsets, const int64_t* values,
    int64_t max_count, int64_t min_copies, int64_t block_length,
    const uint8_t* codes, int64_t num_codes, const uint8_t* ambiguous,  // 16 entries, 1 = ambiguous
    int64_t num_sequences, const int64_t* starts, const int64_t* lengths, const int64_t* rc_index,
    int64_t* out_sizes, int64_t* out_positions, int64_t* out_totals) {  // totals: rows, groups, positions
  const int64_t width = (block_length + 3) / 4;
  const int64_t suffix_offset = block_length - width;
  const int64_t total = starts[num_sequences];
  std::vector<Row> rows;
  int64_t num_rows = 0, num_groups = 0, num_positions = 0;

  // a row's windows, or false where one holds an ambiguous base; -1 where
  // the position lies outside the codes
  auto clean = [&](int64_t p) -> int {
    if (p < 0 || p + block_length > num_codes) return -1;
    for (const uint8_t* window : {codes + p, codes + p + suffix_offset}) {
      for (int64_t i = 0; i < width; ++i) {
        if (window[i] >= 16) return -1;
        if (ambiguous[window[i]]) return 0;
      }
    }
    return 1;
  };

  for (int64_t bin = 0; bin < capacity; ++bin) {
    if (counts[bin] < min_copies || counts[bin] > max_count) continue;
    const int64_t lo = offsets[bin], hi = offsets[bin + 1];
    if (hi <= lo) continue;
    num_rows += 2 * (hi - lo);
    rows.clear();
    for (int strand = 0; strand < 2; ++strand) {
      for (int64_t k = lo; k < hi; ++k) {
        int64_t p = values[k];
        if (strand == 1) {
          if (p < 0 || p >= total) return -1;
          const int64_t seq = std::upper_bound(starts, starts + num_sequences + 1, p) - starts - 1;
          const int64_t rc = rc_index[seq];
          if (rc < 0) return -1;
          p = starts[rc] + lengths[seq] - (p - starts[seq]) - block_length;
        }
        const int state = clean(p);
        if (state < 0) return -1;
        if (state) rows.push_back({codes + p, codes + p + suffix_offset, p});
      }
    }
    std::sort(rows.begin(), rows.end(), [width](const Row& a, const Row& b) {
      int c = std::memcmp(a.prefix, b.prefix, width);
      if (c == 0) c = std::memcmp(a.suffix, b.suffix, width);
      return c != 0 ? c < 0 : a.position < b.position;
    });
    size_t begin = 0;
    while (begin < rows.size()) {
      size_t end = begin + 1;
      while (end < rows.size() && std::memcmp(rows[end].prefix, rows[begin].prefix, width) == 0 &&
             std::memcmp(rows[end].suffix, rows[begin].suffix, width) == 0) {
        ++end;
      }
      int64_t size = 0;
      for (size_t i = begin; i < end; ++i) {
        if (i == begin || rows[i].position != rows[i - 1].position) {
          out_positions[num_positions + size++] = rows[i].position;
        }
      }
      if (size >= min_copies) {
        out_sizes[num_groups++] = size;
        num_positions += size;
      }
      begin = end;
    }
  }
  out_totals[0] = num_rows;
  out_totals[1] = num_groups;
  out_totals[2] = num_positions;
  return 0;
}
