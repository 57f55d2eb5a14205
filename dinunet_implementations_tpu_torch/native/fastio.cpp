// Native batch reader for FreeSurfer aseg-stats TSV files: the port's copy
// of the JAX package's native/fastio.cpp, built with g++ on first use
// (native/__init__.py) and loaded through ctypes by data/native_io.py.
//
// The reference re-reads every TSV per item per epoch through torch's
// DataLoader workers (comps/fs/__init__.py:33-39); the port reads each file
// once into a dense matrix (data/freesurfer.py as_arrays), and this threaded
// C++ parser fills the [n_files, n_feats] batch in one call.
//
// Semantics are bit-identical to data/freesurfer.py::read_aseg_stats:
//   - skip the first (header) line;
//   - per remaining nonempty line, parse the text after the first '\t'
//     (std::from_chars: the same correctly rounded double as Python's
//     float(), and independent of the locale);
//   - max-normalize in double precision, then cast to float32.
// Any malformed or non-finite value fails the batch, and the caller falls
// back to the Python reader.
//
// C ABI only. Thread-safe, no Python involvement during parsing,
// deterministic output placement.

#include <charconv>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Parse one file into out[0..n_feats). Returns empty string on success,
// else a human-readable reason (the Python wrapper falls back on any error).
std::string parse_one(const char* path, long n_feats, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return std::string("cannot open ") + path;
  std::string content;
  {
    char buf[1 << 16];
    size_t got;
    while ((got = std::fread(buf, 1, sizeof buf, f)) > 0) content.append(buf, got);
    std::fclose(f);
  }
  std::vector<double> vals;
  vals.reserve(n_feats);
  size_t pos = 0, end = content.size();
  bool header = true;
  while (pos < end) {
    size_t nl = content.find('\n', pos);
    if (nl == std::string::npos) nl = end;
    size_t line_end = nl;
    while (line_end > pos && (content[line_end - 1] == '\r' ||
                              content[line_end - 1] == ' ' ||
                              content[line_end - 1] == '\t'))
      --line_end;  // strip(): trailing CR / whitespace
    size_t lbeg = pos;  // strip(): leading whitespace too — a leading-tab
    while (lbeg < line_end && (content[lbeg] == ' ' || content[lbeg] == '\t' ||
                               content[lbeg] == '\r'))
      ++lbeg;  // line like "\t1.5" must fail "no value column" as in Python
    if (header) {
      header = false;
    } else if (line_end > lbeg) {
      size_t tab = content.find('\t', lbeg);
      if (tab == std::string::npos || tab >= line_end)
        return std::string("no value column in ") + path;
      // value token = between the first tab and the next tab / line end.
      // std::from_chars, NOT strtod: strtod honors LC_NUMERIC, so a
      // decimal-comma locale would silently truncate "123.45" to 123
      // without tripping the error path — from_chars is locale-free and
      // matches Python float() (which is what read_aseg_stats uses).
      size_t vbeg = tab + 1;
      size_t vend = content.find('\t', vbeg);
      if (vend == std::string::npos || vend > line_end) vend = line_end;
      while (vbeg < vend && (content[vbeg] == ' ' || content[vbeg] == '\t'))
        ++vbeg;  // float() tolerates surrounding whitespace
      const char* s = content.c_str() + vbeg;
      const char* se = content.c_str() + vend;
      if (s < se && *s == '+') ++s;  // from_chars rejects the leading '+'
      double v = 0.0;
      auto res = std::from_chars(s, se, v);
      // the FULL token must parse (trailing spaces aside): "1.5abc" or a
      // leading-tab line must error like Python's float(), not truncate
      const char* rest = res.ptr;
      while (rest < se && (*rest == ' ')) ++rest;
      if (res.ec != std::errc() || res.ptr == s || rest != se)
        return std::string("bad number in ") + path;
      // NaN/inf would make the max-normalize below diverge from numpy's
      // NaN-propagating np.max: error out so the wrapper falls back to the
      // bit-identical Python reader for the batch
      if (!std::isfinite(v))
        return std::string("non-finite value in ") + path;
      vals.push_back(v);
    }
    pos = nl + 1;
  }
  if ((long)vals.size() != n_feats) {
    return std::string(path) + ": expected " + std::to_string(n_feats) +
           " features, got " + std::to_string(vals.size());
  }
  double mx = vals[0];
  for (double v : vals)
    if (v > mx) mx = v;
  for (long i = 0; i < n_feats; ++i) out[i] = (float)(vals[i] / mx);
  return std::string();
}

}  // namespace

extern "C" {

// Fill out[n_files, n_feats] from the given paths. Returns 0 on success;
// on failure returns 1 with the first error message copied into errbuf.
int fastio_read_aseg_batch(const char** paths, long n_files, long n_feats,
                           float* out, char* errbuf, long errlen) {
  unsigned hw = std::thread::hardware_concurrency();
  long n_threads = (long)(hw ? hw : 2);
  if (n_threads > n_files) n_threads = n_files;
  if (n_threads < 1) n_threads = 1;
  std::vector<std::string> errors((size_t)n_threads);
  std::vector<std::thread> workers;
  workers.reserve((size_t)n_threads);
  for (long t = 0; t < n_threads; ++t) {
    workers.emplace_back([=, &errors]() {
      for (long i = t; i < n_files; i += n_threads) {
        std::string err = parse_one(paths[i], n_feats, out + i * n_feats);
        if (!err.empty() && errors[(size_t)t].empty()) errors[(size_t)t] = err;
      }
    });
  }
  for (auto& w : workers) w.join();
  for (auto& e : errors) {
    if (!e.empty()) {
      std::snprintf(errbuf, (size_t)errlen, "%s", e.c_str());
      return 1;
    }
  }
  return 0;
}

}  // extern "C"
