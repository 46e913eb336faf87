// The port's copy of native/carmen_parser.cpp (the JAX package's CARMEN
// parser): the same records, the same C interface, the same results on
// well-formed logs.  It reads with C stdio and parses numbers with
// strtol / strtof / strtod instead of iostreams: a toolchain that links
// libstdc++ statically into the shared library (as the compiler on the
// CUDA card's machine does) gives the library its own copy of the
// iostream and locale state beside the host process's, and a stream then
// crashes the process.
//
// Supported records (classic CARMEN logs: intel.clf, fr079.clf, ...):
//   FLASER n r1..rn x y theta odom_x odom_y odom_theta ts host lts
//   ROBOTLASER1 type start fov res maxr acc remission n r1..rn ...
//               laser_x laser_y laser_th rob_x rob_y rob_th ... ts
//   ODOM x y theta tv rv accel ts host lts
//
// C ABI: two-pass (count, fill) so the caller allocates numpy buffers.

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

struct Scan {
  std::vector<float> ranges;
  float odom[3];
  double time;
};

struct ParsedLog {
  std::vector<Scan> scans;
  int max_beams = 0;
};

// A cursor over one line, read as `std::istringstream >> x` reads it:
// leading whitespace skipped, the longest prefix of the value taken, and
// a read that finds no value fails (and so do the reads after it).
class Cursor {
 public:
  explicit Cursor(const char *s) : p_(s) {}

  bool word(std::string *out) {
    if (!skip()) return false;
    const char *b = p_;
    while (*p_ && !std::isspace(static_cast<unsigned char>(*p_))) ++p_;
    out->assign(b, p_);
    return true;
  }

  bool integer(int *out) {
    if (!skip()) return false;
    char *end = nullptr;
    long v = std::strtol(p_, &end, 10);
    if (end == p_) return fail();
    p_ = end;
    *out = static_cast<int>(v);
    return true;
  }

  bool real(float *out) {
    std::string num;
    if (!number(&num)) return false;
    *out = std::strtof(num.c_str(), nullptr);
    return true;
  }

  bool real(double *out) {
    std::string num;
    if (!number(&num)) return false;
    *out = std::strtod(num.c_str(), nullptr);
    return true;
  }

 private:
  bool skip() {
    if (failed_) return false;
    while (*p_ && std::isspace(static_cast<unsigned char>(*p_))) ++p_;
    return *p_ != '\0' || fail();
  }

  bool fail() {
    failed_ = true;
    return false;
  }

  // [+-]? (digits [. digits?] | . digits) ([eE] [+-]? digits)?
  bool number(std::string *out) {
    if (!skip()) return false;
    const char *b = p_, *q = p_;
    auto digits = [&q]() {
      const char *s = q;
      while (std::isdigit(static_cast<unsigned char>(*q))) ++q;
      return q > s;
    };
    if (*q == '+' || *q == '-') ++q;
    bool mant = digits();
    if (*q == '.') {
      ++q;
      mant = digits() || mant;
    }
    if (!mant) return fail();
    if (*q == 'e' || *q == 'E') {
      const char *e = q++;
      if (*q == '+' || *q == '-') ++q;
      if (!digits()) q = e;
    }
    out->assign(b, q);
    p_ = q;
    return true;
  }

  const char *p_;
  bool failed_ = false;
};

bool parse_flaser(Cursor &c, Scan *out) {
  int n;
  if (!c.integer(&n) || n <= 0 || n > 100000) return false;
  out->ranges.resize(n);
  for (int i = 0; i < n; ++i) {
    if (!c.real(&out->ranges[i])) return false;
  }
  float x, y, th;
  if (!(c.real(&x) && c.real(&y) && c.real(&th)))
    return false;  // laser pose (unused)
  if (!(c.real(&out->odom[0]) && c.real(&out->odom[1]) &&
        c.real(&out->odom[2])))
    return false;
  if (!c.real(&out->time)) out->time = 0.0;
  return true;
}

bool parse_robotlaser1(Cursor &c, Scan *out) {
  int type;
  double start, fov, res, maxr, acc;
  int remission;
  if (!(c.integer(&type) && c.real(&start) && c.real(&fov) &&
        c.real(&res) && c.real(&maxr) && c.real(&acc) &&
        c.integer(&remission)))
    return false;
  int n;
  if (!c.integer(&n) || n <= 0 || n > 100000) return false;
  out->ranges.resize(n);
  for (int i = 0; i < n; ++i)
    if (!c.real(&out->ranges[i])) return false;
  int nrem;
  if (!c.integer(&nrem)) return false;
  double tmp;
  for (int i = 0; i < nrem; ++i)
    if (!c.real(&tmp)) return false;
  double lx, ly, lth, rx, ry, rth;
  if (!(c.real(&lx) && c.real(&ly) && c.real(&lth) && c.real(&rx) &&
        c.real(&ry) && c.real(&rth)))
    return false;
  out->odom[0] = static_cast<float>(rx);
  out->odom[1] = static_cast<float>(ry);
  out->odom[2] = static_cast<float>(rth);
  // skip 5 motion fields, then timestamp
  for (int i = 0; i < 5 && c.real(&tmp); ++i) {
  }
  if (!c.real(&out->time)) out->time = 0.0;
  return true;
}

ParsedLog *parse_file(const char *path) {
  FILE *f = std::fopen(path, "r");
  if (!f) return nullptr;
  auto *log = new ParsedLog();
  char *line = nullptr;
  size_t cap = 0;
  while (getline(&line, &cap, f) != -1) {
    if (line[0] == '\0' || line[0] == '\n' || line[0] == '#') continue;
    Cursor c(line);
    std::string tag;
    if (!c.word(&tag)) continue;
    Scan s{};
    bool ok = false;
    if (tag == "FLASER") {
      ok = parse_flaser(c, &s);
    } else if (tag == "ROBOTLASER1") {
      ok = parse_robotlaser1(c, &s);
    }
    if (ok) {
      if (static_cast<int>(s.ranges.size()) > log->max_beams)
        log->max_beams = static_cast<int>(s.ranges.size());
      log->scans.push_back(std::move(s));
    }
  }
  std::free(line);
  std::fclose(f);
  return log;
}

}  // namespace

extern "C" {

// Returns an opaque handle (or nullptr); fills n_scans / max_beams.
void *clf_open(const char *path, int *n_scans, int *max_beams) {
  ParsedLog *log = parse_file(path);
  if (!log) return nullptr;
  *n_scans = static_cast<int>(log->scans.size());
  *max_beams = log->max_beams;
  return log;
}

// Fill caller-allocated buffers:
//   ranges:  n_scans * max_beams floats (padded with max_range_pad)
//   beam_counts: n_scans ints
//   odom:    n_scans * 3 floats (absolute odometry pose)
//   times:   n_scans doubles
void clf_fill(void *handle, float *ranges, int *beam_counts, float *odom,
              double *times, float max_range_pad) {
  auto *log = static_cast<ParsedLog *>(handle);
  const int mb = log->max_beams;
  for (size_t k = 0; k < log->scans.size(); ++k) {
    const Scan &s = log->scans[k];
    const int n = static_cast<int>(s.ranges.size());
    beam_counts[k] = n;
    for (int i = 0; i < mb; ++i)
      ranges[k * mb + i] = (i < n) ? s.ranges[i] : max_range_pad;
    std::memcpy(odom + k * 3, s.odom, 3 * sizeof(float));
    times[k] = s.time;
  }
}

void clf_close(void *handle) {
  delete static_cast<ParsedLog *>(handle);
}

}  // extern "C"
