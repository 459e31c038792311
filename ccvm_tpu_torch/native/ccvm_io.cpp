// Host I/O of the ccvm_tpu_torch port, with C linkage for ctypes
// (ccvm_tpu_torch/native/__init__.py builds it with g++ at first use).
//
// Two host paths that the reference runs as Python loops over tokens and
// values (problem_instance.py:180-188, dl_solver.py:252-281):
//   * ccvm_parse_table: the body of a .in file, `rows` lines of at least
//     `cols` delimited floats, into a row-major float64 buffer;
//   * ccvm_format_rows: evolution-sample rows as tab-separated values
//     rounded to 4 decimals, into a character buffer that the caller writes
//     to the file it opened.
//
// The formatter writes each value as the JAX package's C++ writer does
// (ccvm_tpu/native/ccvm_io.cpp:44-60), so the two packages' evolution
// files are equal byte for byte: std::round(v * 1e4) / 1e4 (the double
// product, rounded half away from zero), -0.0 written as 0.0, "%.4f" into
// 64 bytes, trailing zeros trimmed down to one fractional digit.
//
// The tokenizer reads a field as Python's float() does where the two can
// agree: the text between two delimiters (of one character or more), with
// surrounding whitespace allowed, must be one whole number; a short row, a
// missing line or a field that is not a number is an error, never a read
// across the end of its line.  A plain decimal of up to 16 significant
// digits and a power of ten within 1e+-22 (every value of the bundled files)
// takes Clinger's fast path, others glibc's strtod in the "C" locale; both
// round correctly, as Python's float does, so the values are equal bit for
// bit.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>

namespace {

constexpr int kValueChars = 64;  // the JAX writer's buffer: at most 63 characters a value
constexpr int kFieldChars = 512;  // longest field the tokenizer reads

bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\f' || c == '\v';
}

// First occurrence of the delimiter d (dl bytes) in [p, end), else end.
const char* find_delimiter(const char* p, const char* end, const char* d, long dl) {
  if (dl == 1) {
    const void* hit = memchr(p, d[0], end - p);
    return hit != nullptr ? static_cast<const char*>(hit) : end;
  }
  for (; end - p >= dl; ++p)
    if (memcmp(p, d, dl) == 0) return p;
  return end;
}

// Clinger's fast path: a decimal [sign] digits [. digits] [e [sign] digits]
// whose significand m fits in 53 bits and whose power of ten |e| <= 22 is
// exactly m * 10^e or m / 10^-e, one IEEE operation on two exact doubles,
// so correctly rounded: the value strtod (and Python's float) gives, bit for
// bit.  True with *out set when [a, b) is such a number; false otherwise
// (strtod then decides).
bool parse_fast(const char* a, const char* b, double* out) {
  static const double kPow10[] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                                  1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
                                  1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
  const bool negative = *a == '-';
  if (*a == '-' || *a == '+') ++a;
  unsigned long long m = 0;
  int digits = 0, significant = 0, exp10 = 0;
  bool fraction = false;
  for (; a < b; ++a) {
    if (*a >= '0' && *a <= '9') {
      ++digits;
      if (m != 0 || *a != '0') {
        if (++significant > 16) return false;  // m may pass 2^53
        m = 10 * m + (unsigned)(*a - '0');
      }
      if (fraction) --exp10;
    } else if (*a == '.' && !fraction) {
      fraction = true;
    } else {
      break;
    }
  }
  if (digits == 0) return false;
  if (a < b && (*a == 'e' || *a == 'E')) {
    ++a;
    const bool neg_exp = a < b && *a == '-';
    if (a < b && (*a == '-' || *a == '+')) ++a;
    int e = 0, e_digits = 0;
    for (; a < b && *a >= '0' && *a <= '9'; ++a)
      if (++e_digits > 4) return false;
      else e = 10 * e + (*a - '0');
    if (e_digits == 0) return false;
    exp10 += neg_exp ? -e : e;
  }
  if (a != b || m > (1ULL << 53) || exp10 < -22 || exp10 > 22) return false;
  const double v = exp10 < 0 ? (double)m / kPow10[-exp10] : (double)m * kPow10[exp10];
  *out = negative ? -v : v;
  return true;
}

// The number in the field [a, b), whitespace around it allowed; false when
// the field is empty or is not one number as Python's float() reads it
// (strtod's hexadecimal and "nan(...)" forms are refused, as float() does).
bool parse_field(const char* a, const char* b, double* out) {
  static const locale_t c_locale = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  while (a < b && is_space(*a)) ++a;
  while (b > a && is_space(b[-1])) --b;
  const long len = b - a;
  if (len == 0 || len >= kFieldChars) return false;
  if (parse_fast(a, b, out)) return true;
  char buf[kFieldChars];
  for (long i = 0; i < len; ++i) {
    if (a[i] == 'x' || a[i] == 'X' || a[i] == '(') return false;
    buf[i] = a[i];
  }
  buf[len] = '\0';
  char* end = nullptr;
  *out = strtod_l(buf, &end, c_locale);
  return end == buf + len;
}

// `v` rounded to 4 decimals into buf (kValueChars bytes); its length.
int format_rounded(double v, char* buf) {
  double r = std::round(v * 10000.0) / 10000.0;
  if (r == 0.0) r = 0.0;  // -0.0 -> 0.0
  snprintf(buf, kValueChars, "%.4f", r);
  int len = (int)strlen(buf);
  const char* dot = strchr(buf, '.');
  if (dot != nullptr)
    while (buf + len - 1 > dot + 1 && buf[len - 1] == '0') buf[--len] = '\0';
  return len;
}

}  // namespace

extern "C" {

// Parse `rows` lines of `cols` fields from text[0, len), separated by the
// delimiter delim[0, dlen) (lines by '\n'; fields beyond `cols` ignored)
// into out (rows x cols, row-major).  Returns 0; or, with where[0] the row
// and where[1] the field: 1 when the text holds fewer than `rows` lines,
// 2 when a row ends before field where[1] (a blank last field counts as
// none), 3 when a field is not a number; 4 for an empty delimiter.
int ccvm_parse_table(const char* text, long len, const char* delim, long dlen, long rows,
                     long cols, double* out, long* where) {
  if (dlen <= 0) return 4;
  const char* p = text;
  const char* end = text + len;
  for (long r = 0; r < rows; ++r) {
    where[0] = r;
    where[1] = 0;
    if (p >= end) return 1;
    const void* nl = memchr(p, '\n', end - p);
    const char* eol = nl != nullptr ? static_cast<const char*>(nl) : end;
    const char* field = p;
    for (long c = 0; c < cols; ++c) {
      where[1] = c;
      if (field > eol) return 2;  // the line had c fields
      const char* stop = find_delimiter(field, eol, delim, dlen);
      if (!parse_field(field, stop, out + r * cols + c)) {
        // A blank last field is the row's end: a short row.
        const char* a = field;
        while (a < stop && is_space(*a)) ++a;
        return a == stop && stop == eol ? 2 : 3;
      }
      field = stop + dlen;
    }
    p = eol + 1;
  }
  return 0;
}

// Rows x cols values of data as the evolution file's lines: tab-separated
// values rounded to 4 decimals, a tab before each newline when
// trailing_tab is 1 (the DL and Langevin writers), none when 0 (MF's).
// Returns the bytes written to out, or -1 when `cap` bytes may not hold
// them (each row needs at most cols * kValueChars + 1).
long ccvm_format_rows(const double* data, long rows, long cols, int trailing_tab, char* out,
                      long cap) {
  if (cap < rows * (cols * kValueChars + 1)) return -1;
  char* o = out;
  char buf[kValueChars];
  for (long r = 0; r < rows; ++r) {
    for (long c = 0; c < cols; ++c) {
      const int n = format_rounded(data[r * cols + c], buf);
      memcpy(o, buf, n);
      o += n;
      if (c != cols - 1 || trailing_tab) *o++ = '\t';
    }
    *o++ = '\n';
  }
  return o - out;
}

}  // extern "C"
