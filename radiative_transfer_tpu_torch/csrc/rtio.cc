// rtio: native runtime I/O for radiative_transfer_tpu_torch.
//
// The port's own copy of native/rtio.cc (the JAX package's), with the
// same C ABI (rtio_abi_version() == 1). It implements the host-side data
// path in C++ as the reference does (reference: src/param.cpp:5-66
// key=value deck parsing, src/ParameterHandler.cpp:136-198 whitespace
// table reads, src/main.cc:37-57 CSV dumps), exposed through a flat C ABI
// consumed from Python via ctypes (radiative_transfer_tpu_torch/native.py).
//
// This is host C++, not a kernel: native.py builds it at first use with
// the C++ compiler on PATH into _build/<hash>/librtio.so.
// ops/_cuda_build.py compiles only csrc/*.cu and hashes only *.cu and
// *.cuh, so this file leaves the kernel library's hash and build as they
// are.
//
// Grammar notes (must match the Python paths of config/config.py and
// utils/io.py bit-for-bit):
//  * a line is a comment iff its FIRST character is '#';
//  * the first '=' splits key from value; the value is the untrimmed
//    remainder of the line;
//  * a duplicated key keeps its FIRST occurrence (std::map::insert);
//  * tables are bare whitespace-separated streams of doubles, reading
//    stops at the first unparsable token (stream >> double semantics);
//  * CSV numbers are printed with "%.17g" (shortest round-trippable is
//    not used — matches the Python writers' FMT).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr char kFieldSep = '\x1f';  // between key and value
constexpr char kRecordSep = '\x1e'; // between records

char* dup_string(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  if (out != nullptr) std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

}  // namespace

extern "C" {

// Parse a .prm deck. Returns a malloc'd buffer of
// key \x1f value \x1e ... records (first-occurrence-wins, file order),
// or nullptr if the file cannot be opened. Free with rtio_free.
char* rtio_parse_deck(const char* path) {
  std::FILE* fh = std::fopen(path, "rb");
  if (fh == nullptr) return nullptr;

  std::map<std::string, std::string> seen;
  std::vector<std::pair<std::string, std::string>> ordered;

  std::string line;
  int c;
  bool eof = false;
  while (!eof) {
    line.clear();
    for (;;) {
      c = std::fgetc(fh);
      if (c == EOF) { eof = true; break; }
      if (c == '\n') break;
      if (c == '\r') {
        // Universal newlines like the Python loader: a lone '\r' ends
        // the line; a following '\n' is part of the same terminator.
        const int nxt = std::fgetc(fh);
        if (nxt != '\n' && nxt != EOF) std::ungetc(nxt, fh);
        if (nxt == EOF) eof = true;
        break;
      }
      line.push_back(static_cast<char>(c));
    }
    if (eof && line.empty()) break;
    // (CRLF already consumed above; nothing to strip.)
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (!line.empty() && line[0] == '#') continue;
    const std::size_t idx = line.find('=');
    if (idx == std::string::npos) continue;
    std::string key = line.substr(0, idx);
    std::string value = line.substr(idx + 1);
    if (seen.emplace(key, value).second) {
      ordered.emplace_back(std::move(key), std::move(value));
    }
  }
  std::fclose(fh);

  std::string buf;
  for (const auto& kv : ordered) {
    buf += kv.first;
    buf += kFieldSep;
    buf += kv.second;
    buf += kRecordSep;
  }
  return dup_string(buf);
}

// Read a whitespace-separated stream of doubles; stops at the first token
// strtod cannot fully consume. Returns a malloc'd array and sets *n;
// nullptr if the file cannot be opened. Free with rtio_free.
double* rtio_read_table(const char* path, int64_t* n) {
  *n = 0;
  std::FILE* fh = std::fopen(path, "rb");
  if (fh == nullptr) return nullptr;

  std::vector<double> values;
  std::string tok;
  int c;
  bool eof = false;
  while (!eof) {
    tok.clear();
    while ((c = std::fgetc(fh)) != EOF && std::isspace(c)) {}
    if (c == EOF) break;
    do {
      tok.push_back(static_cast<char>(c));
    } while ((c = std::fgetc(fh)) != EOF && !std::isspace(c));
    if (c == EOF) eof = true;
    // strtod accepts C99 hex floats ("0x1C"), which neither the
    // reference's stream >> double nor the Python path's float()
    // accept — reject them so all three backends stop identically.
    if (tok.find('x') != std::string::npos ||
        tok.find('X') != std::string::npos)
      break;
    char* end = nullptr;
    const double v = std::strtod(tok.c_str(), &end);
    if (end != tok.c_str() + tok.size()) break;  // stream >> double stops
    values.push_back(v);
  }
  std::fclose(fh);

  double* out = static_cast<double*>(std::malloc(values.size() * sizeof(double)));
  if (out != nullptr && !values.empty())
    std::memcpy(out, values.data(), values.size() * sizeof(double));
  *n = static_cast<int64_t>(values.size());
  return out;
}

namespace {

// Buffered "%.17g" writer: one fwrite per ~1 MiB instead of per value.
class BulkWriter {
 public:
  explicit BulkWriter(std::FILE* fh) : fh_(fh) { buf_.reserve(kFlushAt + 64); }
  ~BulkWriter() { flush(); }

  void value(double v) {
    char tmp[40];
    const int len = std::snprintf(tmp, sizeof(tmp), "%.17g", v);
    buf_.append(tmp, static_cast<std::size_t>(len));
    maybe_flush();
  }
  void raw(char ch) {
    buf_.push_back(ch);
    maybe_flush();
  }
  void flush() {
    if (!buf_.empty()) {
      std::fwrite(buf_.data(), 1, buf_.size(), fh_);
      buf_.clear();
    }
  }

 private:
  static constexpr std::size_t kFlushAt = 1 << 20;
  void maybe_flush() {
    if (buf_.size() >= kFlushAt) flush();
  }
  std::FILE* fh_;
  std::string buf_;
};

}  // namespace

// Write a (rows, cols) row-major matrix as whitespace-separated rows
// (Eigen MatrixXd operator<< layout). Returns 0 on success.
int rtio_write_matrix(const char* path, const double* data, int64_t rows,
                      int64_t cols) {
  std::FILE* fh = std::fopen(path, "wb");
  if (fh == nullptr) return 1;
  {
    BulkWriter w(fh);
    for (int64_t r = 0; r < rows; ++r) {
      for (int64_t c = 0; c < cols; ++c) {
        if (c > 0) w.raw(' ');
        w.value(data[r * cols + c]);
      }
      w.raw('\n');
    }
  }
  return std::fclose(fh) == 0 ? 0 : 1;
}

// Write a vector one value per line (Eigen VectorXd operator<< layout).
int rtio_write_vector(const char* path, const double* data, int64_t n) {
  std::FILE* fh = std::fopen(path, "wb");
  if (fh == nullptr) return 1;
  {
    BulkWriter w(fh);
    for (int64_t i = 0; i < n; ++i) {
      w.value(data[i]);
      w.raw('\n');
    }
  }
  return std::fclose(fh) == 0 ? 0 : 1;
}

// Write a C-order (M, G, N) psi tensor as M rows whose columns interleave
// groups fastest — column index n*G + g (the reference's column-major
// Eigen Tensor print consumed by its plot scripts as psi_arr_m[g::num_G]).
int rtio_write_psi(const char* path, const double* data, int64_t M,
                   int64_t G, int64_t N) {
  std::FILE* fh = std::fopen(path, "wb");
  if (fh == nullptr) return 1;
  {
    BulkWriter w(fh);
    for (int64_t m = 0; m < M; ++m) {
      const double* pm = data + m * G * N;
      for (int64_t n = 0; n < N; ++n) {
        for (int64_t g = 0; g < G; ++g) {
          if (n != 0 || g != 0) w.raw(' ');
          w.value(pm[g * N + n]);
        }
      }
      w.raw('\n');
    }
  }
  return std::fclose(fh) == 0 ? 0 : 1;
}

void rtio_free(void* p) { std::free(p); }

int rtio_abi_version() { return 1; }

}  // extern "C"
