// Fast UEA/UCR .ts parser (native component of the data layer).
//
// The reference's data ingestion is sktime's Python .arff/.ts reader
// (SURVEY.md §3.5) — fine at GunPoint scale, minutes at InsectWingbeat
// scale (tens of thousands of series × dozens of channels). This is the
// library's native-runtime counterpart: a single-pass C++ parser
// (mmap-free, one read; strtod over the raw buffer; forward-fill of
// missing values done in-place) exposed through a tiny C API consumed via
// ctypes in gpsig/data/_native.py. Python's parser remains as the
// fallback and the correctness oracle (tests/test_data_utils.py).
//
// Protocol (all functions extern "C"):
//   h   = fastts_parse(path)          -> opaque handle, NULL on failure
//         (failure includes the timestamp "(t, v)" .ts dialect — the
//          caller falls back to Python)
//   n   = fastts_num_series(h); d = fastts_num_dims(h)
//   fastts_get_lengths(h, int32[n])   -> per-series length L_i
//   m   = fastts_labels_size(h); fastts_get_labels(h, char[m])
//         ('\n'-joined label strings, no trailing separator)
//   fastts_get_values(h, i, double[L_i * d])  -> series i, time-major
//   fastts_free(h)

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Handle {
  int d = 0;
  std::vector<int> lengths;                 // per series
  std::vector<std::vector<double>> values;  // per series, time-major L*d
  std::string labels;                       // '\n'-joined
};

// Parse one dimension's comma-separated values; '?' or empty -> NaN.
// Returns false on a structural surprise (e.g. timestamp tuples).
bool parse_dim(const char* s, const char* end, std::vector<double>* out) {
  const char* p = s;
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p < end && *p == '(') return false;  // timestamped dialect
    if (p >= end || *p == ',') {
      out->push_back(NAN);
      if (p < end) ++p;
      continue;
    }
    if (*p == '?') {
      out->push_back(NAN);
      ++p;
    } else {
      double v;
      if (*p == '+') ++p;  // from_chars rejects a leading '+'
      auto [q, ec] = std::from_chars(p, end, v);
      if (ec != std::errc() || q == p) return false;
      out->push_back(v);
      p = q;
    }
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p < end) {
      if (*p != ',') return false;
      ++p;
      if (p >= end) out->push_back(NAN);  // trailing comma -> empty value
    }
  }
  return true;
}

// Forward-fill NaNs along time for one column; backfill leading NaNs.
void ffill(std::vector<double>* col) {
  int n = static_cast<int>(col->size());
  int first = -1;
  for (int i = 0; i < n; ++i) {
    if (!std::isnan((*col)[i])) {
      first = i;
      break;
    }
  }
  if (first < 0) {
    for (int i = 0; i < n; ++i) (*col)[i] = 0.0;
    return;
  }
  for (int i = 0; i < first; ++i) (*col)[i] = (*col)[first];
  double last = (*col)[first];
  for (int i = first + 1; i < n; ++i) {
    if (std::isnan((*col)[i]))
      (*col)[i] = last;
    else
      last = (*col)[i];
  }
}

}  // namespace

extern "C" {

void* fastts_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(static_cast<size_t>(size));
  if (size > 0 && fread(&buf[0], 1, static_cast<size_t>(size), f) !=
                      static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  Handle* h = new Handle();
  bool in_data = false;
  const char* p = buf.data();
  const char* bend = p + buf.size();
  std::vector<std::vector<double>> dims;  // scratch per line

  while (p < bend) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(bend - p)));
    const char* lend = nl ? nl : bend;
    // strip \r and surrounding spaces
    const char* ls = p;
    while (ls < lend && isspace(static_cast<unsigned char>(*ls))) ++ls;
    const char* le = lend;
    while (le > ls && isspace(static_cast<unsigned char>(le[-1]))) --le;
    p = nl ? nl + 1 : bend;
    if (ls >= le || *ls == '#') continue;
    if (!in_data) {
      if (*ls == '@' && le - ls >= 5 && strncasecmp(ls, "@data", 5) == 0)
        in_data = true;
      continue;
    }
    // data line: dim1:dim2:...:label
    const char* last_colon = nullptr;
    for (const char* q = le; q > ls; --q) {
      if (q[-1] == ':') {
        last_colon = q - 1;
        break;
      }
    }
    if (!last_colon) {
      delete h;
      return nullptr;
    }
    h->labels.append(last_colon + 1, le);
    h->labels.push_back('\n');

    dims.clear();
    const char* seg = ls;
    while (seg <= last_colon) {
      const char* segend = static_cast<const char*>(
          memchr(seg, ':', static_cast<size_t>(last_colon - seg)));
      if (!segend || segend > last_colon) segend = last_colon;
      dims.emplace_back();
      if (!parse_dim(seg, segend, &dims.back())) {
        delete h;
        return nullptr;
      }
      seg = segend + 1;
    }
    int d = static_cast<int>(dims.size());
    if (h->d == 0)
      h->d = d;
    else if (h->d != d) {
      delete h;
      return nullptr;
    }
    int L = 0;
    for (auto& v : dims) L = std::max(L, static_cast<int>(v.size()));
    for (auto& v : dims) {
      v.resize(static_cast<size_t>(L), NAN);
      ffill(&v);
    }
    std::vector<double> series(static_cast<size_t>(L) * d);
    for (int t = 0; t < L; ++t)
      for (int j = 0; j < d; ++j)
        series[static_cast<size_t>(t) * d + j] = dims[j][t];
    h->lengths.push_back(L);
    h->values.push_back(std::move(series));
  }
  if (!h->labels.empty()) h->labels.pop_back();  // trailing '\n'
  if (h->lengths.empty()) {
    delete h;
    return nullptr;
  }
  return h;
}

int fastts_num_series(void* vh) {
  return static_cast<int>(static_cast<Handle*>(vh)->lengths.size());
}

int fastts_num_dims(void* vh) { return static_cast<Handle*>(vh)->d; }

long long fastts_labels_size(void* vh) {
  return static_cast<long long>(static_cast<Handle*>(vh)->labels.size());
}

void fastts_get_labels(void* vh, char* out) {
  Handle* h = static_cast<Handle*>(vh);
  memcpy(out, h->labels.data(), h->labels.size());
}

void fastts_get_lengths(void* vh, int* out) {
  Handle* h = static_cast<Handle*>(vh);
  memcpy(out, h->lengths.data(), h->lengths.size() * sizeof(int));
}

void fastts_get_values(void* vh, int i, double* out) {
  Handle* h = static_cast<Handle*>(vh);
  const std::vector<double>& v = h->values[static_cast<size_t>(i)];
  memcpy(out, v.data(), v.size() * sizeof(double));
}

void fastts_free(void* vh) { delete static_cast<Handle*>(vh); }

}  // extern "C"
