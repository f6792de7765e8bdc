// Native SAM rows: one call writes a batch's rows for SamWriter
// (mapper_tpu_torch/io/sam.py), byte for byte as the JAX package's Python
// rows (mapper_tpu/io/sam.py) do.
//
// The caller flattens the batch into tables:
//   strings   the query and reference names, one blob with offsets;
//   entries   (code offset, length, name id) of each query sequence whose
//             codes a row writes as its SEQ;
//   records   kFields int64 a row, in the order the Python writer emits them:
//               entry, reverse (1: SEQ is the entry's reverse complement),
//               flag, reference name id, start (0-based), mate name id (-1:
//               RNEXT "*" and PNEXT 0), mate start (0-based), blocks (0: one
//               block, the whole query matched), spacing (-1: no cs:f);
//   blocks    (start_a, length_a, length_b) of each row with blocks, in turn;
//   numbers   the distinct penalty texts of the batch (java_float_str's),
//             one blob with offsets; `penalty_ids` a row's AS:f text,
//             `spacing_ids` indexed by a row's spacing field its cs:f text.
// A row reads
//   QNAME FLAG RNAME POS 255 CIGAR RNEXT PNEXT TLEN SEQ * [cs:f:S] AS:f:P
// with POS and PNEXT 1-based and TLEN the entry's length.  The CIGAR is
// SequenceAlignment.cigar(): a leading and a trailing S for unaligned query
// tails (written where not 0), then per block M where length_a ==
// length_b, I where length_a > 0, else D; adjacent M blocks stay apart.
//
// The call checks every index first and returns -1, with nothing written,
// on one out of range or a code past the 16 the tables cover.  Otherwise it
// stores the text's size in *size and writes the text into `out` where it
// fits `capacity` (returns 0; `row_ends`, where not null, then holds the
// offset in `out` of each row's end), else writes nothing (returns 1).

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kFields = 9;

// counts the bytes a row takes
struct Count {
  int64_t n = 0;
  void put(const char*, int64_t k) { n += k; }
  void put(char) { n += 1; }
  void seq(const uint8_t*, int64_t k, bool, const uint8_t*, const uint8_t*) { n += k; }
  void row_end(int64_t) {}
};

// writes them
struct Write {
  char* p;
  const char* start;
  int64_t* ends;
  void put(const char* s, int64_t k) {
    std::memcpy(p, s, k);
    p += k;
  }
  void put(char c) { *p++ = c; }
  void seq(const uint8_t* codes, int64_t k, bool reverse, const uint8_t* decode, const uint8_t* rc_decode) {
    if (reverse) {
      for (int64_t i = k - 1; i >= 0; --i) *p++ = static_cast<char>(rc_decode[codes[i]]);
    } else {
      for (int64_t i = 0; i < k; ++i) *p++ = static_cast<char>(decode[codes[i]]);
    }
  }
  void row_end(int64_t r) {
    if (ends) ends[r] = p - start;
  }
};

// str(v) of a Python int
template <class Sink>
void put_int(Sink& sink, int64_t v) {
  char buf[24];
  char* end = buf + sizeof(buf);
  char* q = end;
  uint64_t u = v < 0 ? 0 - static_cast<uint64_t>(v) : static_cast<uint64_t>(v);
  do {
    *--q = static_cast<char>('0' + u % 10);
    u /= 10;
  } while (u);
  if (v < 0) *--q = '-';
  sink.put(q, end - q);
}

struct Tables {
  const char* strings;
  const int64_t* string_offsets;
  const uint8_t* codes;
  const int64_t* entries;
  const int64_t* records;
  const int64_t* blocks;
  const int64_t* penalty_ids;
  const int64_t* spacing_ids;
  const char* numbers;
  const int64_t* number_offsets;
  uint8_t decode[16];
  uint8_t rc_decode[16];
};

template <class Sink>
void put_string(Sink& sink, const char* blob, const int64_t* offsets, int64_t id) {
  sink.put(blob + offsets[id], offsets[id + 1] - offsets[id]);
}

template <class Sink>
void put_rows(Sink& sink, const Tables& t, int64_t num_rows) {
  const int64_t* block = t.blocks;
  for (int64_t r = 0; r < num_rows; ++r) {
    const int64_t* rec = t.records + kFields * r;
    const int64_t* entry = t.entries + 3 * rec[0];
    const int64_t length = entry[1];
    put_string(sink, t.strings, t.string_offsets, entry[2]);
    sink.put('\t');
    put_int(sink, rec[2]);
    sink.put('\t');
    put_string(sink, t.strings, t.string_offsets, rec[3]);
    sink.put('\t');
    put_int(sink, rec[4] + 1);
    sink.put("\t255\t", 5);
    const int64_t num_blocks = rec[7];
    if (num_blocks == 0) {
      put_int(sink, length);
      sink.put('M');
    } else {
      const int64_t leading = block[0];
      const int64_t* last = block + 3 * (num_blocks - 1);
      const int64_t trailing = length - (last[0] + last[1]);
      if (leading) {
        put_int(sink, leading);
        sink.put('S');
      }
      for (int64_t b = 0; b < num_blocks; ++b, block += 3) {
        const int64_t length_a = block[1], length_b = block[2];
        if (length_a == length_b) {
          put_int(sink, length_a);
          sink.put('M');
        } else if (length_a > 0) {
          put_int(sink, length_a);
          sink.put('I');
        } else {
          put_int(sink, length_b);
          sink.put('D');
        }
      }
      if (trailing) {
        put_int(sink, trailing);
        sink.put('S');
      }
    }
    sink.put('\t');
    if (rec[5] < 0) {
      sink.put("*\t0", 3);
    } else {
      put_string(sink, t.strings, t.string_offsets, rec[5]);
      sink.put('\t');
      put_int(sink, rec[6] + 1);
    }
    sink.put('\t');
    put_int(sink, length);
    sink.put('\t');
    sink.seq(t.codes + entry[0], length, rec[1] != 0, t.decode, t.rc_decode);
    sink.put("\t*\t", 3);
    if (rec[8] >= 0) {
      sink.put("cs:f:", 5);
      put_string(sink, t.numbers, t.number_offsets, t.spacing_ids[rec[8]]);
      sink.put('\t');
    }
    sink.put("AS:f:", 5);
    put_string(sink, t.numbers, t.number_offsets, t.penalty_ids[r]);
    sink.put('\n');
    sink.row_end(r);
  }
}

bool valid_offsets(const int64_t* offsets, int64_t n) {
  if (offsets[0] != 0) return false;
  for (int64_t i = 0; i < n; ++i) {
    if (offsets[i + 1] < offsets[i]) return false;
  }
  return true;
}

}  // namespace

extern "C" int64_t mapper_sam_rows(
    int64_t num_strings, const char* strings, const int64_t* string_offsets,
    int64_t num_codes, const uint8_t* codes, const uint8_t* decode, const uint8_t* complement,  // 16 each
    int64_t num_entries, const int64_t* entries,
    int64_t num_rows, const int64_t* records, int64_t num_blocks, const int64_t* blocks,
    const int64_t* penalty_ids, int64_t num_spacings, const int64_t* spacing_ids,
    int64_t num_numbers, const char* numbers, const int64_t* number_offsets,
    char* out, int64_t capacity, int64_t* size, int64_t* row_ends) {
  if (!valid_offsets(string_offsets, num_strings) || !valid_offsets(number_offsets, num_numbers)) return -1;
  for (int64_t i = 0; i < num_codes; ++i) {
    if (codes[i] >= 16) return -1;
  }
  for (int64_t e = 0; e < num_entries; ++e) {
    const int64_t* entry = entries + 3 * e;
    if (entry[0] < 0 || entry[1] < 0 || entry[0] > num_codes - entry[1]) return -1;
    if (entry[2] < 0 || entry[2] >= num_strings) return -1;
  }
  auto is_number = [num_numbers](int64_t id) { return id >= 0 && id < num_numbers; };
  int64_t blocks_used = 0;
  for (int64_t r = 0; r < num_rows; ++r) {
    const int64_t* rec = records + kFields * r;
    if (rec[0] < 0 || rec[0] >= num_entries) return -1;
    if (rec[3] < 0 || rec[3] >= num_strings || rec[5] < -1 || rec[5] >= num_strings) return -1;
    if (rec[7] < 0 || rec[7] > num_blocks - blocks_used) return -1;
    blocks_used += rec[7];
    if (!is_number(penalty_ids[r])) return -1;
    if (rec[8] < -1 || rec[8] >= num_spacings || (rec[8] >= 0 && !is_number(spacing_ids[rec[8]]))) return -1;
  }

  Tables t{strings, string_offsets, codes, entries, records, blocks, penalty_ids, spacing_ids, numbers,
           number_offsets, {}, {}};
  for (int c = 0; c < 16; ++c) {
    if (complement[c] >= 16) return -1;
    t.decode[c] = decode[c];
    t.rc_decode[c] = decode[complement[c]];
  }
  Count count;
  put_rows(count, t, num_rows);
  *size = count.n;
  if (count.n > capacity) return 1;
  Write write{out, out, row_ends};
  put_rows(write, t, num_rows);
  return 0;
}
