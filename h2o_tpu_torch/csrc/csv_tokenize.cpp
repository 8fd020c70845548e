// CSV tokenizer of the port's parser (h2o_tpu_torch/io/parser.py), on the
// host: the file's bytes -> one fixed-width byte matrix per column, each
// field's content NUL-padded, the first record (a header, if any) included.
//
// Records and fields follow Python's csv reader (the default dialect, not
// strict), whose quoting is pyarrow's:
// - a record ends at '\n', '\r' or "\r\n" outside quotes; empty records
//   (blank lines) are skipped;
// - a field that starts with '"' is quoted: separators and line breaks up
//   to its closing quote are data, and "" inside it is one quote; text
//   after the closing quote is appended as it stands;
// - a quote anywhere else is a literal byte.
//
// Two passes over the bytes, one state machine. The first counts the
// records, checks that each has the first record's field count, and takes
// each column's widest field; the caller then allocates zeroed matrices of
// those widths, and the second pass writes every field's content at its
// (record, column) cell.

#include <cstdint>
#include <cstring>

namespace {

enum State { kRecordStart, kFieldStart, kInField, kInQuoted, kQuoteInQuoted };

// Walks the buffer once, calling on_byte(col, pos_in_field, byte) for each
// content byte, on_field(col, len) at each field's end and on_record(nfields)
// at each non-empty record's end. Returns false as soon as a callback does.
template <class Byte, class Field, class Record>
bool walk(const uint8_t* buf, int64_t n, uint8_t sep, Byte on_byte,
          Field on_field, Record on_record) {
  State st = kRecordStart;
  int32_t col = 0;
  int64_t len = 0;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t c = buf[i];
    switch (st) {
      case kRecordStart:
        if (c == '\n' || c == '\r') break;   // a blank line
        st = kFieldStart;
        [[fallthrough]];
      case kFieldStart:
        if (c == '"') {
          st = kInQuoted;
        } else if (c == sep) {
          if (!on_field(col++, len)) return false;
          len = 0;
        } else if (c == '\n' || c == '\r') {
          if (!on_field(col++, len) || !on_record(col)) return false;
          col = 0, len = 0, st = kRecordStart;
        } else {
          on_byte(col, len++, c);
          st = kInField;
        }
        break;
      case kInField:
        if (c == sep) {
          if (!on_field(col++, len)) return false;
          len = 0, st = kFieldStart;
        } else if (c == '\n' || c == '\r') {
          if (!on_field(col++, len) || !on_record(col)) return false;
          col = 0, len = 0, st = kRecordStart;
        } else {
          on_byte(col, len++, c);
        }
        break;
      case kInQuoted:
        if (c == '"') {
          st = kQuoteInQuoted;
        } else {
          on_byte(col, len++, c);
        }
        break;
      case kQuoteInQuoted:
        if (c == '"') {                       // "" inside a quoted field
          on_byte(col, len++, c);
          st = kInQuoted;
        } else if (c == sep) {
          if (!on_field(col++, len)) return false;
          len = 0, st = kFieldStart;
        } else if (c == '\n' || c == '\r') {
          if (!on_field(col++, len) || !on_record(col)) return false;
          col = 0, len = 0, st = kRecordStart;
        } else {                              // text after a closing quote
          on_byte(col, len++, c);
          st = kInField;
        }
        break;
    }
  }
  if (st != kRecordStart) {
    if (!on_field(col++, len) || !on_record(col)) return false;
  }
  return true;
}

}  // namespace

extern "C" {

// First pass. widths[0..max_cols) starts zeroed. Fills *ncol (the first
// record's field count), *nrec (records) and widths (each column's widest
// field). Returns 0; or 1 when record *nrec (0-based) has *bad_count fields
// instead of *ncol; or 2 when the first record has more than max_cols
// fields (*ncol then says how many: call again with room for them).
int h2o_csv_shape(const uint8_t* buf, int64_t n, uint8_t sep,
                  int32_t max_cols, int32_t* ncol, int64_t* nrec,
                  int64_t* widths, int32_t* bad_count) {
  *ncol = -1;
  *nrec = 0;
  int rc = 0;
  const bool ok = walk(
      buf, n, sep, [](int32_t, int64_t, uint8_t) {},
      [&](int32_t col, int64_t len) {
        if (col < max_cols && len > widths[col]) widths[col] = len;
        return true;
      },
      [&](int32_t nf) {
        if (*ncol < 0) {
          *ncol = nf;
          if (nf > max_cols) {
            rc = 2;
            return false;
          }
        } else if (nf != *ncol) {
          *bad_count = nf;
          rc = 1;
          return false;
        }
        ++*nrec;
        return true;
      });
  if (*ncol < 0) *ncol = 0;
  return ok ? 0 : rc;
}

// Second pass: cols[c] is a zeroed (nrec, widths[c]) row-major byte matrix;
// every field's content goes to its cell. Call only after h2o_csv_shape
// returned 0 for the same bytes.
void h2o_csv_fill(const uint8_t* buf, int64_t n, uint8_t sep,
                  uint8_t* const* cols, const int64_t* widths) {
  int64_t rec = 0;
  walk(
      buf, n, sep,
      [&](int32_t col, int64_t pos, uint8_t c) {
        cols[col][rec * widths[col] + pos] = c;
      },
      [](int32_t, int64_t) { return true; },
      [&](int32_t) {
        ++rec;
        return true;
      });
}

}  // extern "C"
