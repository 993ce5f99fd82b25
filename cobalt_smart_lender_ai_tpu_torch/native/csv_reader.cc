// Columnar CSV reader for the port's table format (io/frames.py), behind a
// plain C interface loaded with ctypes.
//
// The reference's tables are read by pandas' C engine or by the reference's
// own C++ reader; the port's reference reader is io/frames.py's numpy codec.
// This reader gives the codec's RawFrame for the same bytes, in native code:
//
//   * rows end at '\n' outside quotes, where every '"' toggles the quoted
//     state (the codec's scan); the caller turns "\r\n" into "\n" first, as
//     the codec does, so a lone '\r' is data. Every line after the header is
//     a row, a blank one too (one empty field); a final line may lack its
//     '\n'. A row with other than the header's field count is an error.
//   * a field starting with '"' is quoted: "" inside it is one '"', and a
//     quoted field is never missing. An unquoted field is missing when it is
//     empty or one of pandas' default NA tokens.
//   * a column is int64 when every field is [+-]digits (within int64) and
//     none is missing; float64 when every present field is a number as
//     Python's float() reads it (ASCII whitespace around it, '_' between
//     digits, inf/infinity/nan in any case, no hex); a string column
//     otherwise, with a missing mask.
//
// Three steps, the last two spread over threads by row ranges: find the
// row starts (one serial scan with memchr), classify every field of every
// column, then write each column into the caller's buffers (float64 or
// int64 values; a string column as fixed-width bytes, one slot of the
// column's widest field per row, zero-padded, and a missing mask). Numbers
// are parsed with std::from_chars (strtod in the "C" locale where it
// reports a value out of range). No per-cell allocation.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <locale.h>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct Cell {
  const char* ptr;  // the field's text, inside its quotes if quoted
  int64_t len;
  bool quoted;
  bool escaped;     // quoted and holding "" pairs
};

// Calls field(col, cell) for each field of the line [p, end); returns the
// number of fields. An empty line is one empty field.
template <typename Field>
int64_t split_line(const char* p, const char* end, Field&& field) {
  int64_t col = 0;
  while (true) {
    Cell c{p, 0, false, false};
    if (p < end && *p == '"') {
      c.quoted = true;
      const char* s = ++p;
      while (p < end) {
        if (*p != '"') { ++p; continue; }
        if (p + 1 < end && p[1] == '"') { c.escaped = true; p += 2; continue; }
        break;
      }
      c.ptr = s;
      c.len = p - s;
      if (p < end) ++p;                   // the closing quote
      while (p < end && *p != ',') ++p;   // text after it (malformed) is dropped
    } else {
      const void* comma = std::memchr(p, ',', static_cast<size_t>(end - p));
      const char* stop = comma ? static_cast<const char*>(comma) : end;
      c.ptr = p;
      c.len = stop - p;
      p = stop;
    }
    field(col, c);
    ++col;
    if (p >= end) return col;
    ++p;  // the comma
  }
}

int64_t unescaped_len(const Cell& c) {
  if (!c.escaped) return c.len;
  int64_t pairs = 0;
  for (int64_t i = 0; i + 1 < c.len; ++i)
    if (c.ptr[i] == '"') { ++pairs; ++i; }
  return c.len - pairs;
}

void copy_unescaped(const Cell& c, char* out) {
  if (!c.escaped) { std::memcpy(out, c.ptr, static_cast<size_t>(c.len)); return; }
  for (int64_t i = 0; i < c.len; ++i) {
    *out++ = c.ptr[i];
    if (c.ptr[i] == '"') ++i;  // the second quote of a pair
  }
}

// pandas' default NA tokens (the empty field is checked apart).
bool is_na_token(const Cell& c) {
  static const char* kTokens[] = {
      "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
      "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
      "n/a", "nan", "null"};
  for (const char* t : kTokens) {
    const int64_t tl = static_cast<int64_t>(std::strlen(t));
    if (tl == c.len && std::memcmp(c.ptr, t, static_cast<size_t>(tl)) == 0) return true;
  }
  return false;
}

bool missing(const Cell& c) { return !c.quoted && (c.len == 0 || is_na_token(c)); }

bool is_space(char ch) { return ch == ' ' || (ch >= '\t' && ch <= '\r'); }
bool is_digit(char ch) { return ch >= '0' && ch <= '9'; }

bool iequals(const char* a, int64_t n, const char* lit) {
  if (static_cast<int64_t>(std::strlen(lit)) != n) return false;
  for (int64_t i = 0; i < n; ++i) {
    char ch = a[i];
    if (ch >= 'A' && ch <= 'Z') ch = static_cast<char>(ch - 'A' + 'a');
    if (ch != lit[i]) return false;
  }
  return true;
}

// Copies digit ('_'? digit)* from q to w; returns the digits copied.
int64_t digit_run(const char*& q, const char* e, char*& w) {
  int64_t k = 0;
  while (q < e) {
    if (is_digit(*q)) { *w++ = *q++; ++k; }
    else if (*q == '_' && k > 0 && q + 1 < e && is_digit(q[1])) ++q;
    else break;
  }
  return k;
}

double strtod_c(const char* s) {
  static locale_t c_locale = newlocale(LC_NUMERIC_MASK, "C", static_cast<locale_t>(0));
  return strtod_l(s, nullptr, c_locale);
}

// Python's float() of the field's text: true (and *out, when given) for a
// number, false otherwise.
bool py_float(const char* p, int64_t n, double* out) {
  const char* e = p + n;
  while (p < e && is_space(*p)) ++p;
  while (e > p && is_space(e[-1])) --e;
  if (p == e) return false;
  bool neg = false;
  const char* q = p;
  if (*q == '+' || *q == '-') { neg = *q == '-'; ++q; }
  const int64_t rest = e - q;
  if (iequals(q, rest, "inf") || iequals(q, rest, "infinity")) {
    if (out) *out = neg ? -std::numeric_limits<double>::infinity()
                        : std::numeric_limits<double>::infinity();
    return true;
  }
  if (iequals(q, rest, "nan")) {
    if (out) *out = neg ? -std::numeric_limits<double>::quiet_NaN()
                        : std::numeric_limits<double>::quiet_NaN();
    return true;
  }
  char small[128];
  std::string big;
  char* buf = small;
  if (n + 2 > static_cast<int64_t>(sizeof(small))) {
    big.resize(static_cast<size_t>(n + 2));
    buf = big.data();
  }
  char* w = buf;
  if (neg) *w++ = '-';
  int64_t digits = digit_run(q, e, w);
  if (q < e && *q == '.') {
    *w++ = *q++;
    digits += digit_run(q, e, w);
  }
  if (digits == 0) return false;
  if (q < e && (*q == 'e' || *q == 'E')) {
    *w++ = 'e';
    ++q;
    if (q < e && (*q == '+' || *q == '-')) *w++ = *q++;
    if (digit_run(q, e, w) == 0) return false;
  }
  if (q != e) return false;
  if (!out) return true;
  *w = '\0';
  auto res = std::from_chars(buf, w, *out, std::chars_format::general);
  if (res.ec != std::errc() || res.ptr != w) *out = strtod_c(buf);  // out of range
  return true;
}

// [+-]digits within int64: true (and *out, when given).
bool parse_int(const char* p, int64_t n, int64_t* out) {
  const char* e = p + n;
  if (p < e && *p == '+') {
    ++p;
    if (p < e && *p == '-') return false;
  }
  if (p == e || (*p == '-' && (p + 1 == e))) return false;
  int64_t v = 0;
  auto res = std::from_chars(p, e, v);
  if (res.ec != std::errc() || res.ptr != e) return false;
  if (out) *out = v;
  return true;
}

struct ColStats {
  bool numeric = true;   // every present field a float() number
  bool integer = true;   // every present field [+-]digits within int64
  bool any_missing = false;
  bool any_present = false;
  int64_t width = 0;     // widest present field, unescaped
};

template <typename Body>
void parallel_rows(int64_t n_rows, int n_threads, Body&& body) {
  const int64_t per = 16384;
  int64_t t = std::max<int64_t>(1, std::min<int64_t>(n_threads, (n_rows + per - 1) / per));
  if (t == 1) { body(0, 0, n_rows); return; }
  std::vector<std::thread> pool;
  for (int64_t k = 0; k < t; ++k) {
    int64_t r0 = n_rows * k / t, r1 = n_rows * (k + 1) / t;
    pool.emplace_back([&body, k, r0, r1] { body(static_cast<int>(k), r0, r1); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

struct CobaltCsvTable {
  const char* data = nullptr;
  int64_t len = 0;
  int n_threads = 1;
  std::vector<std::string> names;
  std::vector<int> kinds;           // 0 float64, 1 string, 2 int64
  std::vector<int64_t> widths;      // string columns: bytes per slot
  std::vector<int64_t> starts;      // row r is [starts[r], starts[r + 1] - 1)
  int64_t n_rows = 0;
  std::string error;
};

extern "C" {

// Parses the header, finds the rows and classifies the columns; `data` must
// stay alive until cobalt_csv_free. Errors come back through
// cobalt_csv_last_error.
CobaltCsvTable* cobalt_csv_parse(const char* data, int64_t len, int n_threads) {
  auto* t = new CobaltCsvTable();
  t->data = data;
  t->len = len;
  t->n_threads = std::max(1, n_threads);

  // Line starts: just past each '\n' outside quotes.
  std::vector<int64_t> lines{0};
  const char* p = data;
  const char* end = data + len;
  const char* quote = static_cast<const char*>(std::memchr(p, '"', static_cast<size_t>(len)));
  if (!quote) quote = end;
  while (p < end) {
    const void* nl = std::memchr(p, '\n', static_cast<size_t>(quote - p));
    if (nl) {
      p = static_cast<const char*>(nl) + 1;
      lines.push_back(p - data);
      continue;
    }
    if (quote >= end) break;
    const void* close = std::memchr(quote + 1, '"', static_cast<size_t>(end - quote - 1));
    if (!close) break;  // an unclosed quote runs to the end
    p = static_cast<const char*>(close) + 1;
    quote = static_cast<const char*>(std::memchr(p, '"', static_cast<size_t>(end - p)));
    if (!quote) quote = end;
  }
  if (lines.back() < len) lines.push_back(len + 1);  // a last line without '\n'
  if (lines.size() == 1) lines.push_back(len + 1);   // no '\n' at all: the header alone

  // Header.
  split_line(data, data + lines[1] - 1, [&](int64_t, const Cell& c) {
    std::string name(static_cast<size_t>(unescaped_len(c)), '\0');
    copy_unescaped(c, name.data());
    t->names.push_back(std::move(name));
  });
  const int64_t F = static_cast<int64_t>(t->names.size());
  t->starts.assign(lines.begin() + 1, lines.end());
  t->n_rows = static_cast<int64_t>(t->starts.size()) - 1;

  // Classify every field, per thread, then merge.
  std::vector<std::vector<ColStats>> stats(static_cast<size_t>(t->n_threads),
                                           std::vector<ColStats>(static_cast<size_t>(F)));
  std::vector<int64_t> bad_row(static_cast<size_t>(t->n_threads), -1);
  parallel_rows(t->n_rows, t->n_threads, [&](int k, int64_t r0, int64_t r1) {
    auto& st = stats[static_cast<size_t>(k)];
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t n = split_line(data + t->starts[r], data + t->starts[r + 1] - 1,
                                   [&](int64_t j, const Cell& c) {
        if (j >= F) return;
        ColStats& s = st[static_cast<size_t>(j)];
        if (missing(c)) { s.any_missing = true; return; }
        s.any_present = true;
        s.width = std::max(s.width, unescaped_len(c));
        if (!s.numeric) return;
        if (c.escaped || !py_float(c.ptr, c.len, nullptr)) {
          s.numeric = s.integer = false;
        } else if (s.integer && !parse_int(c.ptr, c.len, nullptr)) {
          s.integer = false;
        }
      });
      if (n != F && bad_row[static_cast<size_t>(k)] < 0) bad_row[static_cast<size_t>(k)] = r;
    }
  });
  for (int64_t b : bad_row) {
    if (b >= 0) {
      t->error = "CSV lines with other than " + std::to_string(F) + " fields (row " +
                 std::to_string(b) + ")";
      return t;
    }
  }
  t->kinds.assign(static_cast<size_t>(F), 0);
  t->widths.assign(static_cast<size_t>(F), 0);
  for (int64_t j = 0; j < F; ++j) {
    ColStats m;
    for (const auto& st : stats) {
      const ColStats& s = st[static_cast<size_t>(j)];
      m.numeric = m.numeric && s.numeric;
      m.integer = m.integer && s.integer;
      m.any_missing = m.any_missing || s.any_missing;
      m.any_present = m.any_present || s.any_present;
      m.width = std::max(m.width, s.width);
    }
    if (!m.numeric) t->kinds[j] = 1;
    else if (m.integer && m.any_present && !m.any_missing) t->kinds[j] = 2;
    t->widths[j] = std::max<int64_t>(1, m.width);
  }
  return t;
}

int64_t cobalt_csv_nrows(CobaltCsvTable* t) { return t->n_rows; }
int64_t cobalt_csv_ncols(CobaltCsvTable* t) { return static_cast<int64_t>(t->names.size()); }
const char* cobalt_csv_col_name(CobaltCsvTable* t, int64_t j) { return t->names[j].c_str(); }
int cobalt_csv_col_kind(CobaltCsvTable* t, int64_t j) { return t->kinds[j]; }
int64_t cobalt_csv_col_width(CobaltCsvTable* t, int64_t j) { return t->widths[j]; }
const char* cobalt_csv_last_error(CobaltCsvTable* t) {
  return t->error.empty() ? nullptr : t->error.c_str();
}

// Writes every column: outs[j] is n_rows doubles (kind 0), n_rows int64
// (kind 2) or n_rows x width zeroed bytes (kind 1, with masks[j] n_rows
// bytes, 1 where missing).
void cobalt_csv_fill(CobaltCsvTable* t, void** outs, uint8_t** masks) {
  const int64_t F = static_cast<int64_t>(t->names.size());
  const char* data = t->data;
  parallel_rows(t->n_rows, t->n_threads, [&](int, int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      split_line(data + t->starts[r], data + t->starts[r + 1] - 1,
                 [&](int64_t j, const Cell& c) {
        if (j >= F) return;
        const bool miss = missing(c);
        switch (t->kinds[j]) {
          case 0: {
            double v = std::numeric_limits<double>::quiet_NaN();
            if (!miss) py_float(c.ptr, c.len, &v);
            static_cast<double*>(outs[j])[r] = v;
            break;
          }
          case 2: {
            int64_t v = 0;
            parse_int(c.ptr, c.len, &v);
            static_cast<int64_t*>(outs[j])[r] = v;
            break;
          }
          default:
            masks[j][r] = miss ? 1 : 0;
            if (!miss) copy_unescaped(c, static_cast<char*>(outs[j]) + r * t->widths[j]);
        }
      });
    }
  });
}

void cobalt_csv_free(CobaltCsvTable* t) { delete t; }

}  // extern "C"
