// Host ingest library of the port: the Netflix-format and MovieLens CSV
// parsers, the counting-sort group-by of the block builders, and the
// presence-table indexer of raw entity ids.
//
// The port's own copy of the JAX package's native ingest library (its
// parsers, cfk_group_by and cfk_index_dense), built by
// cfk_tpu_torch/_build.py with the host C++ compiler and loaded with ctypes
// by cfk_tpu_torch/data/_native.py.  Plain C interface, no PyTorch headers.
// Error convention: the parsers return >= 0 on success and -lineno on a
// malformed input line (the Python parsers' "path:lineno" ValueError), or
// -0x7fffffff on an I/O error.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <strings.h>  // strncasecmp
#include <sys/stat.h>
#include <vector>

namespace {

struct FileBuf {
  char* data = nullptr;
  size_t size = 0;
  ~FileBuf() { std::free(data); }
  bool read(const char* path) {
    struct stat st;
    if (::stat(path, &st) != 0 || !S_ISREG(st.st_mode)) return false;
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    size_t n = static_cast<size_t>(st.st_size);
    data = static_cast<char*>(std::malloc(n + 1));
    if (!data) {
      std::fclose(f);
      return false;
    }
    size = std::fread(data, 1, n, f);
    bool ok = size == n && !std::ferror(f);
    data[size] = '\0';
    std::fclose(f);
    return ok;
  }
};

// Parse a non-negative decimal integer of at most INT64_MAX; advances *p.
// Returns false if no digits were consumed or the value exceeds int64 (the
// Python parsers accept up to INT64_MAX exactly, and so does this one).
inline bool parse_uint(const char*& p, const char* end, long long* out) {
  const char* start = p;
  long long v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    int d = *p - '0';
    if (v > (INT64_MAX - d) / 10) return false;
    v = v * 10 + d;
    ++p;
  }
  if (p == start) return false;
  *out = v;
  return true;
}

// Parse a non-negative decimal float (digits[.digits]) bounded by `end` —
// never reads past the line like strtod would.  Advances *p.
inline bool parse_ufloat(const char*& p, const char* end, double* out) {
  long long ip = 0;
  const char* start = p;
  while (p < end && *p >= '0' && *p <= '9') {
    ip = ip * 10 + (*p - '0');
    ++p;
  }
  bool any = p != start;
  double v = static_cast<double>(ip);
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    const char* fstart = p;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale;
      scale *= 0.1;
      ++p;
    }
    any = any || p != fstart;
  }
  if (!any) return false;
  *out = v;
  return true;
}

}  // namespace

extern "C" {

// Netflix format: "movieId:" header lines, "userId,rating,date" rows.
// Pass movie/user/rating == nullptr (cap 0) to count; otherwise fills up to
// cap entries.  Returns the number of ratings, or -lineno on malformed
// input (including a rating row before any header).
long long cfk_parse_netflix(const char* path, long long* movie, long long* user,
                            float* rating, long long cap) {
  FileBuf buf;
  if (!buf.read(path)) return -0x7fffffffLL;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  long long current_movie = -1;
  long long count = 0;
  long long lineno = 0;
  while (p < end) {
    ++lineno;
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = p;
    const char* qe = line_end;
    while (qe > q && (qe[-1] == '\r' || qe[-1] == ' ' || qe[-1] == '\t')) --qe;
    while (q < qe && (*q == ' ' || *q == '\t')) ++q;
    if (q == qe) {  // blank line
      p = line_end + 1;
      continue;
    }
    long long v;
    const char* r = q;
    // Any line ending in ':' must be "<digits>:" (the Python parser's
    // endswith(':') branch), else it is malformed.
    if (qe[-1] == ':') {
      if (!parse_uint(r, qe, &v) || r + 1 != qe) return -lineno;
      current_movie = v;
    } else if (!parse_uint(r, qe, &v)) {
      return -lineno;
    } else {
      if (current_movie < 0) return -lineno;  // rating row before a header
      if (r >= qe || *r != ',') return -lineno;
      ++r;
      long long rat;
      if (!parse_uint(r, qe, &rat)) return -lineno;
      if (r >= qe || *r != ',') return -lineno;  // the date must be present
      if (count < cap && movie && user && rating) {
        movie[count] = current_movie;
        user[count] = v;
        rating[count] = static_cast<float>(rat);
      }
      ++count;
    }
    p = line_end + 1;
  }
  return count;
}

// MovieLens CSV: optional "userId,..." header, rows userId,movieId,rating,ts.
// Rows rated below min_rating are dropped; same count/fill and -lineno
// conventions as cfk_parse_netflix.
long long cfk_parse_movielens(const char* path, long long* movie,
                              long long* user, float* rating, long long cap,
                              float min_rating) {
  FileBuf buf;
  if (!buf.read(path)) return -0x7fffffffLL;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  long long count = 0;
  long long lineno = 0;
  while (p < end) {
    ++lineno;
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = p;
    const char* qe = line_end;
    while (qe > q && (qe[-1] == '\r' || qe[-1] == ' ')) --qe;
    while (q < qe && *q == ' ') ++q;
    if (q == qe) {
      p = line_end + 1;
      continue;
    }
    if (lineno == 1 && qe - q >= 6 && strncasecmp(q, "userid", 6) == 0) {
      p = line_end + 1;  // header row
      continue;
    }
    long long uid, mid;
    const char* r = q;
    if (!parse_uint(r, qe, &uid) || r >= qe || *r != ',') return -lineno;
    ++r;
    if (!parse_uint(r, qe, &mid) || r >= qe || *r != ',') return -lineno;
    ++r;
    double rat;
    if (!parse_ufloat(r, qe, &rat)) return -lineno;
    // The rating ends the line or is followed by the timestamp separator;
    // trailing garbage ("3.5abc") is malformed, as the Python parser says.
    if (r != qe && *r != ',') return -lineno;
    if (rat >= min_rating) {
      if (count < cap && movie && user && rating) {
        movie[count] = mid;
        user[count] = uid;
        rating[count] = static_cast<float>(rat);
      }
      ++count;
    }
    p = line_end + 1;
  }
  return count;
}

// Stable counting-sort group-by over dense keys, O(n + k): order_out[j] is
// the original index of the j-th entry in (key, original index) order —
// the stable argsort of keys; count_out[k] the entries with key k;
// start_out[k] the exclusive prefix sum of the counts.  Returns 0, or -1 if
// a key lies outside [0, num_keys).
int cfk_group_by(const int64_t* keys, long long nnz, long long num_keys,
                 int64_t* order_out, int32_t* count_out, int64_t* start_out) {
  std::memset(count_out, 0, sizeof(int32_t) * num_keys);
  for (long long i = 0; i < nnz; ++i) {
    int64_t k = keys[i];
    if (k < 0 || k >= num_keys) return -1;
    ++count_out[k];
  }
  int64_t acc = 0;
  for (long long k = 0; k < num_keys; ++k) {
    start_out[k] = acc;
    acc += count_out[k];
  }
  std::vector<int64_t> cursor(start_out, start_out + num_keys);
  for (long long i = 0; i < nnz; ++i) {
    order_out[cursor[keys[i]]++] = i;  // ascending i within a key: stable
  }
  return 0;
}

// Dense-index raw entity ids by rank among the distinct values present:
// unique_out gets the sorted distinct ids, dense_out[i] the rank of raw[i].
// O(n + max_raw) through a presence table, so raw ids must lie in
// [0, max_raw] (the caller checks the range and takes the sort path
// otherwise).  Returns the number of distinct ids, or -1 on an id outside
// that range.
long long cfk_index_dense(const int64_t* raw, long long nnz, int64_t max_raw,
                          int64_t* unique_out, int32_t* dense_out) {
  std::vector<int32_t> rank(static_cast<size_t>(max_raw) + 1, -1);
  for (long long i = 0; i < nnz; ++i) {
    int64_t v = raw[i];
    if (v < 0 || v > max_raw) return -1;
    rank[v] = 1;
  }
  long long n_unique = 0;
  for (int64_t v = 0; v <= max_raw; ++v) {
    if (rank[v] >= 0) {
      rank[v] = static_cast<int32_t>(n_unique);
      if (unique_out) unique_out[n_unique] = v;
      ++n_unique;
    }
  }
  if (dense_out) {
    for (long long i = 0; i < nnz; ++i) dense_out[i] = rank[raw[i]];
  }
  return n_unique;
}

// Bump when parser semantics or signatures change: a library reporting
// another version is rebuilt by cfk_tpu_torch/data/_native.py, never used.
int cfk_native_abi_version() { return 1; }

}  // extern "C"
