// Native text-row assembly for the per-position summary writers.
//
// The VCF post-pass emits one row per covered reference position — millions
// of rows whose text is "<contig>\t<1-based position><shared suffix>".  The
// Python writer computes the (few hundred) distinct suffixes once; this
// helper does the per-row itoa + memcpy assembly, which dominates the
// post-pass when done with Python string formatting
// (reference behavior: QuickVariants VcfWriter, Mapper.java:758-777).

#include <cstdint>
#include <cstring>

extern "C" int64_t mapper_format_rows(
    const char* prefix, int64_t prefix_len,     // "<contig name>\t"
    const int64_t* positions,                   // 1-based, print-ready
    const int32_t* suffix_ids, int64_t n,
    const char* suffix_blob,
    const int64_t* suffix_offsets,              // [num_suffixes + 1]
    char* out, int64_t capacity) {
  char* p = out;
  char* end = out + capacity;
  char numbuf[24];
  for (int64_t i = 0; i < n; i++) {
    int64_t pos = positions[i];
    const int64_t off = suffix_offsets[suffix_ids[i]];
    const int64_t sfx_len = suffix_offsets[suffix_ids[i] + 1] - off;
    char* q = numbuf + 24;
    if (pos <= 0) {
      *--q = '0';
    } else {
      while (pos > 0) {
        *--q = static_cast<char>('0' + (pos % 10));
        pos /= 10;
      }
    }
    const int64_t num_len = (numbuf + 24) - q;
    if (p + prefix_len + num_len + sfx_len > end) return -1;
    memcpy(p, prefix, prefix_len);
    p += prefix_len;
    memcpy(p, q, num_len);
    p += num_len;
    memcpy(p, suffix_blob + off, sfx_len);
    p += sfx_len;
  }
  return p - out;
}
