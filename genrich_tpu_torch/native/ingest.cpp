// genrich-tpu native ingest library.
//
// Host-side byte-level pipeline: SAM/BAM parsing, queryname grouping,
// pair assembly, AS-based multimapper selection, PCR-duplicate
// removal, and fragment-interval generation.  Produces per-chromosome
// event arrays (start, end, count) consumed by the device engine.
//
// Behavior mirrors the reference Genrich's ingest layers (components
// 4-12 in SURVEY.md §2; Genrich.c:2490-5181) including float32 score
// arithmetic, uint32 coordinate wraparound in ATAC windows, the
// 128-alignment cap, and stable descending-quality duplicate
// evaluation order.  Written fresh in C++ (std containers, RAII);
// exposed as a C API for ctypes.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>
#include <algorithm>
#include <type_traits>
#include <sys/mman.h>
#include <zlib.h>
#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif
#include <sys/stat.h>

namespace {

constexpr int MAX_ALNS = 128;
constexpr size_t MAX_LINE = 65520;
constexpr float NOSCORE = -3.4028234663852886e38f;

// ---- error reporting ------------------------------------------------

struct IngestError {
  int code;            // reference error-table index
  std::string msg;     // prefix
};

thread_local IngestError g_err{-1, ""};

[[noreturn]] void fail(const std::string& msg, int code) {
  g_err = {code, msg};
  throw g_err;
}

// reference error codes used here (errors.py order)
enum {
  ERRFILE = 0, ERROPEN = 1, ERRMEM = 4, ERRINT = 5, ERRFLOAT = 6,
  ERRMISM = 14,
  ERRINFO = 15, ERRSAM = 16, ERRCHROM = 17, ERRHEAD = 18, ERRBAM = 19,
  ERRCHRLEN = 22, ERRPOS = 24, ERRSORT = 25, ERRTYPE = 26, ERRAUX = 27,
  ERRLINEAR = 29, ERRINDEX = 30, ERRISSUE = 33, ERRGZIP = 42,
  ERRCIGAR = 44,
};

// ---- hugepage-backed growable arrays --------------------------------
//
// The dedup stores and event buffers reach several GB at production
// scale, and the dedup loops random-access them in quality order.
// With 4 KB pages that access pattern is page-walk-bound (the PTE
// working set itself falls out of cache), and glibc's heap gets no
// hugepages while the host THP mode is "madvise".  HVec replaces
// std::vector for those arrays:
//   - mmap-backed with MADV_HUGEPAGE (Linux >= 6.7 aligns large
//     anonymous mappings to 2 MB boundaries, so the advice takes);
//   - grown with mremap, which moves page tables instead of copying
//     bytes: growth is cheap and never holds old+new copies at once,
//     unlike vector doubling (which transiently doubles RSS for the
//     largest array);
//   - released eagerly (munmap) the moment a phase no longer needs
//     the data, returning the pages to the OS immediately.
// Trivially-copyable element types only.
template <typename T>
struct HVec {
  static_assert(std::is_trivially_copyable<T>::value,
                "HVec holds POD only");
  T* ptr = nullptr;
  size_t len = 0, cap = 0;
  size_t bytes = 0;                    // mapped length (mremap needs it)

  HVec() = default;
  HVec(const HVec&) = delete;
  HVec& operator=(const HVec&) = delete;
  HVec(HVec&& o) noexcept { swap(o); }
  HVec& operator=(HVec&& o) noexcept {
    if (this != &o) { release(); swap(o); }
    return *this;
  }
  ~HVec() { release(); }
  void swap(HVec& o) noexcept {
    std::swap(ptr, o.ptr); std::swap(len, o.len);
    std::swap(cap, o.cap); std::swap(bytes, o.bytes);
  }

  size_t size() const { return len; }
  bool empty() const { return len == 0; }
  T* data() { return ptr; }
  const T* data() const { return ptr; }
  T* begin() { return ptr; }
  T* end() { return ptr + len; }
  const T* begin() const { return ptr; }
  const T* end() const { return ptr + len; }
  T& operator[](size_t i) { return ptr[i]; }
  const T& operator[](size_t i) const { return ptr[i]; }
  T& back() { return ptr[len - 1]; }

  void clear() { len = 0; }
  void release() {
    if (ptr) munmap(ptr, bytes);
    ptr = nullptr; len = cap = bytes = 0;
  }
  void reserve(size_t want) {
    size_t wb = want * sizeof(T);
    if (wb <= bytes) { cap = bytes / sizeof(T); return; }
    size_t nb = bytes ? bytes : (size_t)(4u << 20);
    while (nb < wb) nb <<= 1;
    void* np = ptr
        ? mremap(ptr, bytes, nb, MREMAP_MAYMOVE)
        : mmap(nullptr, nb, PROT_READ | PROT_WRITE,
               MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (np == MAP_FAILED) fail("memory map", ERRMEM);
    ptr = (T*)np;
    madvise(np, nb, MADV_HUGEPAGE);
    bytes = nb;
    cap = nb / sizeof(T);
  }
  void push_back(const T& v) {
    if (len == cap) reserve(len + 1);
    ptr[len++] = v;
  }
  void append(const T* src, size_t n) {
    if (len + n > cap) reserve(len + n);
    memcpy(ptr + len, src, n * sizeof(T));
    len += n;
  }
  void resize(size_t n) {              // contents of new tail undefined
    if (n > cap) reserve(n);
    len = n;
  }
};

// ---- data model -----------------------------------------------------

struct Chrom {
  std::string name;
  uint32_t len = 0;
  bool skip = false;
  bool save = false;
  std::vector<uint32_t> bed;   // merged exclusion bounds [s,e,...]
  int index = 0;
};

struct Aln {
  uint32_t pos0 = 0, pos1 = 0;
  float score = NOSCORE;
  bool primary = false, paired = false, full_ = false, first = false,
       strand = false;
  int chrom = -1;              // index into chroms
};

struct Counters {
  uint64_t count = 0, unmapped = 0, paired = 0, single_ = 0,
           orphan = 0, paired_pr = 0, single_pr = 0, supp = 0,
           skipped = 0, low_mapq = 0, sec_pair = 0, sec_single = 0,
           count_pr = 0, dups_pr = 0, count_dc = 0, dups_dc = 0,
           count_sn = 0, dups_sn = 0, err_count = 0;
  double total_len = 0.0;
};

struct Options {
  bool single_opt = false, extend_opt = false, avg_ext_opt = false,
       atac_opt = false, atac_adj = true, dups_opt = false,
       sort_opt = true, verbose = false;
  int32_t extend = 0, atac_len5 = 0, atac_len3 = 0, min_mapq = 0;
  float as_diff = 0.0f;
};

struct EventBuf {
  HVec<int64_t> start, end;
  HVec<int32_t> count;
};

struct ReadStore {
  // Flat dedup store: one Meta per buffered read (file order), all
  // alignment records in one shared arena, names NUL-terminated in
  // one byte arena.  Replaces a vector<struct{string,2x vector<Aln>}>
  // whose per-read heap allocations dominated -r parse time.
  struct Meta {
    uint32_t aln_off = 0, aln2_off = 0;
    uint16_t aln_cnt = 0, aln2_cnt = 0;
    uint16_t qual = 0;
    bool first = false;
    float score = NOSCORE, score_r2 = NOSCORE;
    uint32_t name_off = 0;
  };
  HVec<Meta> meta;
  HVec<Aln> alns;
  HVec<char> names;
  // summed-quality histogram, maintained at append time so dedup's
  // counting sort never needs a dedicated sweep over meta
  std::vector<uint32_t> qhist = std::vector<uint32_t>(1 << 16, 0);
  size_t size() const { return meta.size(); }
  void clear() {
    meta.clear(); alns.clear(); names.clear();
    std::fill(qhist.begin(), qhist.end(), 0);
  }
  void release() {
    meta.release(); alns.release(); names.release();
    std::fill(qhist.begin(), qhist.end(), 0);
  }
  const char* name(const Meta& m) const {
    return names.data() + m.name_off;
  }
  uint32_t add_name(const std::string& q) {
    uint32_t off = (uint32_t)names.size();
    names.append(q.c_str(), q.size() + 1);
    return off;
  }
};

// Lazy read-name handle for the interval-generation call chain: the
// name is only ever printed on warning / -b / -R / error paths, so
// the hot path must not pay the random name-arena load (the dedup
// loops visit reads in quality order, far from file order) nor a
// std::string copy per read.
struct NameRef {
  const char* p = nullptr;             // direct c-string, or
  const ReadStore* st = nullptr;       // lazy (arena, offset)
  uint32_t off = 0;

  // explicit: a NameRef borrows storage (a c-string, or the names
  // arena while it is not appended to) and must not outlive the call
  // expression that created it -- no implicit conversions that could
  // silently bind a temporary.
  explicit NameRef(const char* s) : p(s) {}
  explicit NameRef(const std::string& s) : p(s.c_str()) {}
  NameRef(const ReadStore& store, uint32_t name_off)
      : st(&store), off(name_off) {}
  const char* c_str() const {
    return p ? p : st->names.data() + off;
  }
  std::string str() const { return std::string(c_str()); }
};

struct XBedEntry { std::string name; uint32_t p0, p1; };

struct Context {
  std::vector<Chrom> chroms;
  std::unordered_map<std::string, int> by_name;
  std::vector<std::string> xchr;
  std::vector<XBedEntry> xbed;
  std::vector<EventBuf> events;      // per chrom, current file
  Counters ctr;
  Options opt;
  bool ctrl = false;
  int sample = 0;
  gzFile bed_out = nullptr;          // optional -b log
  FILE* bed_out_f = nullptr;
  gzFile dups_out = nullptr;         // optional -R log
  FILE* dups_out_f = nullptr;
  // per-template state
  std::vector<Aln> alns;
  uint16_t qual_r1 = 0, qual_r2 = 0;
  std::string read_name;
  // avg-ext deferral
  struct Unpair { std::string q; Aln a; uint8_t n; };
  std::vector<Unpair> unpair;
  // dedup stores
  ReadStore reads_pr, reads_dc, reads_sn;
  std::string err_msg;               // last error text for the C API
  int err_code = -1;
  // parallel-parse shard mode: warnings and -b rows are buffered in
  // file order instead of written, and replayed at merge time so the
  // observable output is byte-identical to a sequential parse
  bool shard_mode = false;
  bool shard_bed = false;            // parent has a -b log open
  struct WarnEntry { bool capped; std::string text; };
  std::vector<WarnEntry> warn_buf;   // capped entries: first MAX_ALNS
  std::string bed_buf;               // buffered -b rows
  // totalLen terms, (frag_len, count): the sequential accumulation is
  // `total_len += (double)frag_len / count` in file order, which is
  // NOT associative across shard partial sums; shards record the
  // terms and the merge replays the divisions+adds in file order so
  // the double is bit-identical to a sequential parse
  std::vector<std::pair<uint64_t, uint8_t>> len_terms;
  // phase wall times from the last gi_parse (filled when
  // GENRICH_NATIVE_PROF is set; surfaced through gi_prof so bench
  // artifacts can carry the native phase split)
  double prof_records_s = 0.0, prof_dedup_s = 0.0;
};

// Warning printf: sequential contexts write straight to stderr;
// shards buffer (capped == counts against the global err_count cap).
void warnf(Context* c, bool capped, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  if (!c->shard_mode) {
    vfprintf(stderr, fmt, ap);
    va_end(ap);
    return;
  }
  // buffered shard warnings must match the sequential path's
  // unbounded vfprintf byte-for-byte: size the buffer exactly
  // (warning text can carry a qname plus a chromosome name of any
  // length), never truncate
  va_list ap2;
  va_copy(ap2, ap);
  int need = vsnprintf(nullptr, 0, fmt, ap);
  std::string text;
  if (need > 0) {
    text.resize((size_t)need);
    vsnprintf(&text[0], (size_t)need + 1, fmt, ap2);
  }
  c->warn_buf.push_back({capped, std::move(text)});
  va_end(ap2);
  va_end(ap);
}

void outf(Context* c, gzFile gz, FILE* f, const char* fmt, ...) {
  char buf[4096];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  if (gz) gzputs(gz, buf);
  else if (f) fputs(buf, f);
}

// -b row: shards buffer (replayed in file order at merge, so the gz
// byte stream is identical to a sequential run); otherwise direct
void bed_rowf(Context* c, const char* fmt, ...) {
  char buf[4096];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  if (c->shard_mode) c->bed_buf += buf;
  else if (c->bed_out) gzputs(c->bed_out, buf);
  else if (c->bed_out_f) fputs(buf, c->bed_out_f);
}

// ---- exclusion regions ---------------------------------------------

std::vector<uint32_t> build_xbed(Context* c, const std::string& name,
                                 uint32_t len) {
  // insertion sort by start (new equal-start goes first), clamp, merge
  std::vector<uint32_t> bed;
  for (auto& b : c->xbed) {
    if (b.name != name) continue;
    if (b.p0 >= len) {
      if (c->opt.verbose)
        fprintf(stderr, "Warning! BED interval (%s, %u - %u) ignored\n"
                "  - located off end of reference %s (length %u)\n",
                b.name.c_str(), b.p0, b.p1, name.c_str(), len);
      continue;
    }
    size_t j = 0;
    while (j < bed.size() && !(b.p0 <= bed[j])) j += 2;
    bed.insert(bed.begin() + j, {b.p0, b.p1});
  }
  size_t i = 0;
  while (i < bed.size()) {
    if (bed[i + 1] > len) {
      if (c->opt.verbose)
        fprintf(stderr, "Warning! BED interval (%s, %u - %u) extends "
                "past end of ref.\n  - edited to (%s, %u - %u)\n",
                name.c_str(), bed[i], bed[i + 1], name.c_str(), bed[i],
                len);
      bed[i + 1] = len;
    }
    if (i && bed[i] <= bed[i - 1]) {
      if (bed[i + 1] > bed[i - 1]) bed[i - 1] = bed[i + 1];
      bed.erase(bed.begin() + i, bed.begin() + i + 2);
    } else {
      i += 2;
    }
  }
  return bed;
}

int save_chrom(Context* c, const std::string& name, uint32_t len) {
  auto it = c->by_name.find(name);
  if (it != c->by_name.end()) {
    Chrom& ch = c->chroms[it->second];
    if (ch.len != len) fail(name, ERRCHRLEN);
    if (!c->ctrl) ch.save = true;
    return it->second;
  }
  Chrom ch;
  ch.name = name;
  ch.len = len;
  ch.skip = std::find(c->xchr.begin(), c->xchr.end(), name)
            != c->xchr.end();
  ch.save = !c->ctrl;
  if (!ch.skip) ch.bed = build_xbed(c, name, len);
  ch.index = (int)c->chroms.size();
  c->by_name.emplace(name, ch.index);
  c->chroms.push_back(std::move(ch));
  c->events.emplace_back();
  return (int)c->chroms.size() - 1;
}

// ---- interval generation (saveInterval etc.) ------------------------

uint32_t save_interval(Context* c, int ci, int64_t start, int64_t end,
                       const NameRef& qname, uint8_t count) {
  Chrom& ch = c->chroms[ci];
  if (start < 0) {
    if (c->opt.verbose) {
      if (c->ctr.err_count < (uint64_t)MAX_ALNS)
        warnf(c, true, "Warning! Read %s prevented from extending "
              "below 0 on %s\n", qname.c_str(), ch.name.c_str());
      c->ctr.err_count++;
    }
    start = 0;
  }
  if (start >= (int64_t)ch.len)
    fail("Read " + qname.str() + ", ref. " + ch.name, ERRPOS);
  if (end > (int64_t)ch.len) {
    if (c->opt.verbose) {
      if (c->ctr.err_count < (uint64_t)MAX_ALNS)
        warnf(c, true, "Warning! Read %s prevented from extending "
              "past %u on %s\n", qname.c_str(), ch.len,
              ch.name.c_str());
      c->ctr.err_count++;
    }
    end = ch.len;
  }
  EventBuf& ev = c->events[ci];
  ev.start.push_back(start);
  ev.end.push_back(end);
  ev.count.push_back(count);
  if (c->bed_out || c->bed_out_f || (c->shard_mode && c->shard_bed))
    bed_rowf(c, "%s\t%ld\t%ld\t%s_%d_%c_%d\n",
             ch.name.c_str(), (long)start, (long)end, qname.c_str(),
             (int)count, c->ctrl ? 'C' : 'E', c->sample);
  return (uint32_t)(end - start);
}

uint32_t save_frag_atac(Context* c, int ci, uint32_t start,
                        uint32_t end, const NameRef& q,
                        uint8_t count) {
  if (c->opt.atac_adj) {
    start = start + 5u;
    end = end - 5u;
  }
  uint32_t len5 = (uint32_t)c->opt.atac_len5;
  uint32_t len3 = (uint32_t)c->opt.atac_len3;
  if (start + len3 >= (uint32_t)(int32_t)(end - len3))
    return save_interval(c, ci, (int32_t)(start - len5),
                         (int64_t)(uint32_t)(end + len5), q, count);
  return save_interval(c, ci, (int32_t)(start - len5),
                       (int64_t)(uint32_t)(start + len3), q, count)
       + save_interval(c, ci, (int32_t)(end - len3),
                       (int64_t)(uint32_t)(end + len5), q, count);
}

uint32_t save_fragment(Context* c, const NameRef& q, const Aln& a,
                       uint8_t count) {
  uint32_t start = a.pos0, end = a.pos1;
  if (start > end) std::swap(start, end);
  if (c->opt.atac_opt)
    return save_frag_atac(c, a.chrom, start, end, q, count);
  return save_interval(c, a.chrom, start, end, q, count);
}

uint32_t save_unpair(Context* c, const NameRef& q, const Aln& a0,
                     uint8_t count, bool extend_opt, int32_t extend) {
  Aln a = a0;
  if (extend_opt) {
    if (a.strand)
      return save_interval(c, a.chrom, a.pos0,
                           (int64_t)(uint32_t)(a.pos0 + extend), q,
                           count);
    return save_interval(c, a.chrom,
                         (int32_t)(a.pos1 - (uint32_t)extend),
                         a.pos1, q, count);
  }
  if (c->opt.atac_opt) {
    uint32_t len5 = (uint32_t)c->opt.atac_len5;
    uint32_t len3 = (uint32_t)c->opt.atac_len3;
    if (a.strand) {
      if (c->opt.atac_adj) a.pos0 += 5u;
      return save_interval(c, a.chrom, (int32_t)(a.pos0 - len5),
                           (int64_t)(uint32_t)(a.pos0 + len3), q,
                           count);
    }
    if (c->opt.atac_adj) a.pos1 -= 5u;
    return save_interval(c, a.chrom, (int32_t)(a.pos1 - len3),
                         (int64_t)(uint32_t)(a.pos1 + len5), q, count);
  }
  return save_interval(c, a.chrom, a.pos0, a.pos1, q, count);
}

// ---- multimapper selection -----------------------------------------

template <typename Valid>
void subsample(Context* c, const Aln* alns, size_t n_alns,
               Valid valid, uint8_t* count, float* score) {
  // insertion sort descending; stable for equal scores
  std::vector<float> arr;
  arr.reserve(*count);
  for (size_t k = 0; k < n_alns; k++) {
    const Aln& a = alns[k];
    if (valid(a)) {
      auto it = arr.begin();
      while (it != arr.end() && !(a.score > *it)) ++it;
      arr.insert(it, a.score);
    }
  }
  *count = *count > 10 ? 10 : (uint8_t)(*count - 1);
  *score = arr[*count - 1];
}

int process_pair(Context* c, const NameRef& q, const Aln* alns,
                 size_t n_alns, float score) {
  if (score != NOSCORE) score = score - c->opt.as_diff;
  auto valid = [&](const Aln& a) {
    return a.paired && a.full_ && a.score >= score
        && c->chroms[a.chrom].save && !c->chroms[a.chrom].skip;
  };
  uint8_t count = 0;
  for (size_t k = 0; k < n_alns; k++) if (valid(alns[k])) count++;
  if (!count) return 0;
  if (count > 10 || count == 7 || count == 9)
    subsample(c, alns, n_alns, valid, &count, &score);
  auto valid2 = [&](const Aln& a) {
    return a.paired && a.full_ && a.score >= score
        && c->chroms[a.chrom].save && !c->chroms[a.chrom].skip;
  };
  uint64_t frag_len = 0;
  uint8_t saved = 0;
  for (size_t k = 0; k < n_alns; k++) {
    const Aln& a = alns[k];
    if (valid2(a)) {
      frag_len += save_fragment(c, q, a, count);
      if (++saved == count) break;
    }
  }
  if (saved != count)
    fail("Saved " + std::to_string(saved) + " alignments for read "
         + q.str() + "; should have been " + std::to_string(count),
         ERRISSUE);
  if (c->shard_mode)
    c->len_terms.emplace_back(frag_len, count);
  else
    c->ctr.total_len += (double)frag_len / count;
  return 1;
}

int process_single(Context* c, const NameRef& q, const Aln* alns,
                   size_t n_alns, bool extend_opt, int32_t extend,
                   bool avg_ext, float score, bool first) {
  if (score != NOSCORE) score = score - c->opt.as_diff;
  auto valid = [&](const Aln& a) {
    return !a.paired && a.first == first && a.score >= score
        && c->chroms[a.chrom].save && !c->chroms[a.chrom].skip;
  };
  uint8_t count = 0;
  for (size_t k = 0; k < n_alns; k++) if (valid(alns[k])) count++;
  if (!count) return 0;
  if (count > 10 || count == 7 || count == 9)
    subsample(c, alns, n_alns, valid, &count, &score);
  auto valid2 = [&](const Aln& a) {
    return !a.paired && a.first == first && a.score >= score
        && c->chroms[a.chrom].save && !c->chroms[a.chrom].skip;
  };
  uint8_t saved = 0;
  for (size_t k = 0; k < n_alns; k++) {
    const Aln& a = alns[k];
    if (valid2(a)) {
      if (avg_ext)
        c->unpair.push_back({q.str(), a, count});
      else
        save_unpair(c, q, a, count, extend_opt, extend);
      if (++saved == count) break;
    }
  }
  if (saved != count)
    fail("Saved " + std::to_string(saved) + " alignments for read "
         + q.str() + "; should have been " + std::to_string(count),
         ERRISSUE);
  return 1;
}

// ---- dedup stores ---------------------------------------------------

uint32_t copy_alns(Context* c, float score, bool first,
                   HVec<Aln>* arena) {
  if (score != NOSCORE) score = score - c->opt.as_diff;
  uint32_t n = 0;
  for (const Aln& a : c->alns)
    if (!a.paired && a.first == first && a.score >= score) {
      arena->push_back(a);
      n++;
    }
  return n;
}

void save_alns(Context* c, const std::string& q, bool pair,
               bool single_r1, bool single_r2, float score_pr,
               float score_r1, float score_r2) {
  if (pair) {
    ReadStore& st = c->reads_pr;
    ReadStore::Meta m;
    m.name_off = st.add_name(q);
    m.qual = (uint16_t)std::min<uint32_t>(
        (uint32_t)c->qual_r1 + c->qual_r2, UINT16_MAX);
    m.score = score_pr;
    m.aln_off = (uint32_t)st.alns.size();
    float score = score_pr;
    if (score != NOSCORE) score = score - c->opt.as_diff;
    for (const Aln& a : c->alns)
      if (a.paired && a.full_ && a.score >= score) {
        Aln b = a;
        if (b.pos0 > b.pos1) std::swap(b.pos0, b.pos1);
        st.alns.push_back(b);
        m.aln_cnt++;
      }
    st.qhist[m.qual]++;
    st.meta.push_back(m);
  } else if (c->opt.single_opt) {
    if (single_r1 && single_r2) {
      ReadStore& st = c->reads_dc;
      ReadStore::Meta m;
      m.name_off = st.add_name(q);
      m.first = true;
      m.score = score_r1;
      m.score_r2 = score_r2;
      m.qual = (uint16_t)std::min<uint32_t>(
          (uint32_t)c->qual_r1 + c->qual_r2, UINT16_MAX);
      m.aln_off = (uint32_t)st.alns.size();
      m.aln_cnt = (uint16_t)copy_alns(c, score_r1, true, &st.alns);
      m.aln2_off = (uint32_t)st.alns.size();
      m.aln2_cnt = (uint16_t)copy_alns(c, score_r2, false, &st.alns);
      st.qhist[m.qual]++;
      st.meta.push_back(m);
    } else if (single_r1 || single_r2) {
      ReadStore& st = c->reads_sn;
      ReadStore::Meta m;
      m.name_off = st.add_name(q);
      m.first = single_r1;
      m.score = single_r1 ? score_r1 : score_r2;
      m.qual = single_r1 ? c->qual_r1 : c->qual_r2;
      m.aln_off = (uint32_t)st.alns.size();
      m.aln_cnt = (uint16_t)copy_alns(c, m.score, single_r1,
                                      &st.alns);
      st.qhist[m.qual]++;
      st.meta.push_back(m);
    }
  }
}

// ---- per-template processing (processAlns) --------------------------

void process_alns(Context* c) {
  float score_pr = NOSCORE, score_r1 = NOSCORE, score_r2 = NOSCORE;
  bool pair = false, s1 = false, s2 = false;
  for (const Aln& a : c->alns) {
    if (a.paired) {
      if (a.full_) {
        if (!pair || score_pr < a.score) score_pr = a.score;
        pair = true;
      } else {
        c->ctr.orphan++;
      }
    } else if (c->opt.single_opt && !pair) {
      if (a.first && score_r1 <= a.score) { score_r1 = a.score; s1 = true; }
      else if (!a.first && score_r2 <= a.score) { score_r2 = a.score; s2 = true; }
    }
  }
  if (c->opt.dups_opt) {
    save_alns(c, c->read_name, pair, s1, s2, score_pr, score_r1,
              score_r2);
    return;
  }
  if (pair) {
    c->ctr.paired_pr += process_pair(c, NameRef(c->read_name), c->alns.data(),
                                     c->alns.size(), score_pr);
  } else if (c->opt.single_opt) {
    if (s1)
      c->ctr.single_pr += process_single(
          c, NameRef(c->read_name), c->alns.data(), c->alns.size(),
          c->opt.extend_opt, c->opt.extend, c->opt.avg_ext_opt,
          score_r1, true);
    if (s2)
      c->ctr.single_pr += process_single(
          c, NameRef(c->read_name), c->alns.data(), c->alns.size(),
          c->opt.extend_opt, c->opt.extend, c->opt.avg_ext_opt,
          score_r2, false);
  }
}

// ---- alignment assembly (parseAlign) --------------------------------

uint16_t sum_qual(const uint8_t* qual, int len, int offset) {
  if (len > 0 && qual[0] == 0xFF) return 0;
  int sum = 0;
  for (int i = 0; i < len; i++) sum += (int)qual[i] - offset;
  return sum > 0xFFFF ? 0xFFFF : (uint16_t)sum;
}

bool parse_align(Context* c, uint16_t flag, int ci, uint32_t pos,
                 int32_t length, uint32_t pnext, float score,
                 const uint8_t* qual, int qual_len, int qual_off,
                 bool qual_star) {
  if (flag & 0x1) {
    if ((flag & 0xC0) == 0xC0) fail("", ERRLINEAR);
    if (!(flag & 0xC0)) fail("", ERRINDEX);
  }
  if (c->opt.dups_opt) {
    if (flag & 0x40) {
      if (!c->qual_r1 && !qual_star)
        c->qual_r1 = sum_qual(qual, qual_len, qual_off);
    } else {
      if (!c->qual_r2 && !qual_star)
        c->qual_r2 = sum_qual(qual, qual_len, qual_off);
    }
  }
  Chrom& ch = c->chroms[ci];
  if ((flag & 0x3) == 0x3) {
    if (ch.skip || !ch.save) c->ctr.skipped++;
    else {
      c->ctr.paired++;
      if (flag & 0x100) c->ctr.sec_pair++;
    }
    for (Aln& a : c->alns) {
      if (a.paired && !a.full_ && a.chrom == ci
          && ((flag & 0x40) ? (!a.first && a.pos0 == pos)
                            : (a.first && a.pos1 == pos))
          && ((flag & 0x100) ? !a.primary : a.primary)) {
        if (flag & 0x40)
          a.pos0 = (flag & 0x10) ? pos + length : pos;
        else
          a.pos1 = (flag & 0x10) ? pos + length : pos;
        if (score == NOSCORE) a.score = NOSCORE;
        else if (a.score != NOSCORE) a.score = a.score + score;
        a.full_ = true;
        return true;
      }
    }
    if ((int)c->alns.size() == MAX_ALNS) return false;
    Aln a;
    a.chrom = ci;
    a.score = score;
    a.primary = !(flag & 0x100);
    a.full_ = false;
    a.paired = true;
    if (flag & 0x40) {
      a.pos0 = (flag & 0x10) ? pos + length : pos;
      a.pos1 = pnext;
      a.first = true;
    } else {
      a.pos0 = pnext;
      a.pos1 = (flag & 0x10) ? pos + length : pos;
      a.first = false;
    }
    c->alns.push_back(a);
    return true;
  }
  if (ch.skip || !ch.save) c->ctr.skipped++;
  else {
    c->ctr.single_++;
    if (flag & 0x100) c->ctr.sec_single++;
  }
  if (c->opt.single_opt) {
    if ((int)c->alns.size() == MAX_ALNS) return false;
    Aln a;
    a.chrom = ci;
    a.score = score;
    a.primary = !(flag & 0x100);
    a.paired = false;
    a.strand = !(flag & 0x10);
    a.first = (flag & 0x40) != 0;
    a.pos0 = pos;
    a.pos1 = pos + length;
    c->alns.push_back(a);
  }
  return true;
}

void flush_group(Context* c) {
  if (!c->read_name.empty()) process_alns(c);
  c->alns.clear();
  c->qual_r1 = c->qual_r2 = 0;
}

// ---- dedup evaluation (findDups) ------------------------------------

// Open-addressing hash map: 128-bit key -> uint32 value, linear
// probing, insert-if-absent (matching the reference's checkAndAdd
// "first occurrence wins", Genrich.c:3457-3522).  ~5x faster than
// node-based unordered_map with tuple keys on the -r hot path.
struct OAMap {
  // One slot = one struct (24 B): a probe touches 1-2 cache lines
  // instead of the 3 a parallel-array layout costs, and a single
  // prefetch covers the whole probe.  The dedup loop is memory-bound
  // (random probes over a table far larger than L2), so slot layout
  // and prefetch distance, not hashing, set its speed.
  struct Slot {
    uint64_t k0, k1;
    uint32_t val;                      // UINT32_MAX = empty
  };
  // Hugepage-backed buffer: at production scale the table spans
  // hundreds of MB, so random probes through 4 KB pages are
  // TLB-miss-bound; MADV_HUGEPAGE collapses it to a few hundred
  // 2 MB pages (host THP is in madvise mode).
  Slot* slot = nullptr;
  size_t cap = 0, mask = 0, used = 0;

  OAMap() = default;
  OAMap(const OAMap&) = delete;
  OAMap& operator=(const OAMap&) = delete;
  OAMap& operator=(OAMap&& o) {
    if (this != &o) {
      if (slot) free(slot);
      slot = o.slot; cap = o.cap; mask = o.mask; used = o.used;
      o.slot = nullptr; o.cap = 0; o.mask = 0; o.used = 0;
    }
    return *this;
  }
  ~OAMap() { if (slot) free(slot); }

  static uint64_t mix(uint64_t a, uint64_t b) {
    uint64_t x = a ^ (b * 0x9E3779B97F4A7C15ull);
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27; x *= 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  }
  void init(size_t expect) {
    size_t n = 64;
    while (n < 2 * expect + 16) n <<= 1;
    if (slot) free(slot);
    size_t raw = n * sizeof(Slot);
    const size_t align = 2u << 20;
    if (raw >= 2 * align) {            // hugepages only when it pays
      size_t bytes = (raw + align - 1) & ~(align - 1);
      slot = (Slot*)aligned_alloc(align, bytes);
      if (slot) madvise(slot, bytes, MADV_HUGEPAGE);
    }
    if (!slot) slot = (Slot*)malloc(raw);
    if (!slot) fail("dedup table", ERRMEM);
    // 0xFF fill: val == UINT32_MAX everywhere (k0/k1 are never read
    // for an empty slot), one streaming pass instead of per-slot
    memset(slot, 0xFF, raw);
    cap = n; mask = n - 1; used = 0;
  }
  void grow() {
    OAMap bigger;
    bigger.init(cap);                  // doubles (init uses 2x)
    for (size_t i = 0; i < cap; i++)
      if (slot[i].val != UINT32_MAX)
        bigger.put(slot[i].k0, slot[i].k1, slot[i].val);
    *this = std::move(bigger);
  }
  void prefetch(uint64_t a, uint64_t b) const {
    if (slot)
      __builtin_prefetch(&slot[mix(a, b) & mask]);
  }
  uint32_t find(uint64_t a, uint64_t b) const {
    if (!slot) return UINT32_MAX;
    size_t i = mix(a, b) & mask;
    for (;;) {
      const Slot& s = slot[i];
      if (s.val == UINT32_MAX) return UINT32_MAX;
      if (s.k0 == a && s.k1 == b) return s.val;
      i = (i + 1) & mask;
    }
  }
  void put(uint64_t a, uint64_t b, uint32_t v) {  // keep-first
    if (2 * used >= mask) grow();
    size_t i = mix(a, b) & mask;
    for (;;) {
      Slot& s = slot[i];
      if (s.val == UINT32_MAX) {
        s.k0 = a; s.k1 = b; s.val = v; used++;
        return;
      }
      if (s.k0 == a && s.k1 == b) return;
      i = (i + 1) & mask;
    }
  }
};

// 64-bit-key variant used per chromosome for the proper-pair table:
// the pair key (5'pos0, 5'pos1) packs exactly into one u64 once the
// chromosome picks the table.  Slots are packed to 12 B (x86
// unaligned u64 loads are cheap): at the published 146M-record scale
// the three tables total ~2.4 GB instead of 3.2, and the probe loop
// is bandwidth/latency-bound on exactly these bytes.
struct OAMap64 {
#pragma pack(push, 1)
  struct Slot {
    uint64_t k;
    uint32_t val;                      // UINT32_MAX = empty
  };
#pragma pack(pop)
  static_assert(sizeof(Slot) == 12, "packed 12 B slot");
  Slot* slot = nullptr;
  size_t cap = 0, mask = 0, used = 0;

  OAMap64() = default;
  OAMap64(const OAMap64&) = delete;
  OAMap64& operator=(const OAMap64&) = delete;
  OAMap64(OAMap64&& o) { *this = std::move(o); }
  OAMap64& operator=(OAMap64&& o) {
    if (this != &o) {
      if (slot) free(slot);
      slot = o.slot; cap = o.cap; mask = o.mask; used = o.used;
      o.slot = nullptr; o.cap = 0; o.mask = 0; o.used = 0;
    }
    return *this;
  }
  ~OAMap64() { if (slot) free(slot); }

  static uint64_t mix(uint64_t a) {
    uint64_t x = a * 0x9E3779B97F4A7C15ull;
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27; x *= 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  }
  void init(size_t expect) {
    size_t n = 64;
    while (n < 2 * expect + 16) n <<= 1;
    if (slot) free(slot);
    size_t raw = n * sizeof(Slot);
    const size_t align = 2u << 20;
    if (raw >= 2 * align) {            // hugepages only when it pays
      size_t bytes = (raw + align - 1) & ~(align - 1);
      slot = (Slot*)aligned_alloc(align, bytes);
      if (slot) madvise(slot, bytes, MADV_HUGEPAGE);
    }
    if (!slot) slot = (Slot*)malloc(raw);
    if (!slot) fail("dedup table", ERRMEM);
    memset(slot, 0xFF, raw);
    cap = n; mask = n - 1; used = 0;
  }
  void grow() {
    OAMap64 bigger;
    bigger.init(cap);
    for (size_t i = 0; i < cap; i++)
      if (slot[i].val != UINT32_MAX)
        bigger.put(slot[i].k, slot[i].val);
    *this = std::move(bigger);
  }
  void prefetch(uint64_t k) const {
    if (slot)
      __builtin_prefetch(&slot[mix(k) & mask]);
  }
  uint32_t find(uint64_t k) const {
    if (!slot) return UINT32_MAX;
    size_t i = mix(k) & mask;
    for (;;) {
      const Slot& s = slot[i];
      if (s.val == UINT32_MAX) return UINT32_MAX;
      if (s.k == k) return s.val;
      i = (i + 1) & mask;
    }
  }
  void put(uint64_t k, uint32_t v) {   // keep-first
    if (2 * used >= mask) grow();
    size_t i = mix(k) & mask;
    for (;;) {
      Slot& s = slot[i];
      if (s.val == UINT32_MAX) {
        s.k = k; s.val = v; used++;
        return;
      }
      if (s.k == k) return;
      i = (i + 1) & mask;
    }
  }
  // One probe chain for the single-key read path: returns the
  // existing value for k (a duplicate), or UINT32_MAX after
  // inserting (k, v) at the chain's terminal empty slot — find()
  // followed by put() walks the same chain twice for every non-dup.
  uint32_t find_or_put(uint64_t k, uint32_t v) {
    if (2 * used >= mask) grow();
    size_t i = mix(k) & mask;
    for (;;) {
      Slot& s = slot[i];
      if (s.val == UINT32_MAX) {
        s.k = k; s.val = v; used++;
        return UINT32_MAX;
      }
      if (s.k == k) return s.val;
      i = (i + 1) & mask;
    }
  }
};

std::vector<uint32_t> sort_order(const ReadStore& reads) {
  // descending by summed quality, ties in file order — identical
  // order to the reference's stable johnSort (Genrich.c:3274-3354).
  // The key is only 16 bits, so one stable counting-sort pass beats
  // a comparison sort of (qual << 32 | index) u64s ~10x.
  const size_t n = reads.size();
  std::vector<uint32_t> cnt(1 << 16, 0);
  for (size_t q = 0; q < cnt.size(); q++)
    cnt[0xFFFFu - q] = reads.qhist[q];
  uint32_t run = 0;
  for (size_t q = 0; q < cnt.size(); q++) {
    uint32_t c = cnt[q];
    cnt[q] = run;
    run += c;
  }
  std::vector<uint32_t> order(n);
  for (size_t i = 0; i < n; i++)
    order[cnt[0xFFFFu - reads.meta[i].qual]++] = (uint32_t)i;
  return order;
}

void find_dups(Context* c) {
  const bool fd_prof = getenv("GENRICH_NATIVE_PROF") != nullptr;
  double t_pair_s = 0.0;
  auto fd_t0 = std::chrono::steady_clock::now();
  bool dups_verb = c->dups_out || c->dups_out_f;
  bool seed_singles = c->opt.single_opt && c->reads_sn.size() != 0;
  // singleton table: (chrom, pos, strand) -> first occurrence, value
  // tagged with the store it came from (pr/dc/sn) for -R naming
  OAMap64 table_sn;
  constexpr uint32_t TAG_PR = 0u << 30, TAG_DC = 1u << 30,
                     TAG_SN = 2u << 30, TAG_MASK = 3u << 30;
  if (seed_singles)
    table_sn.init(2 * c->reads_pr.alns.size()
                  + c->reads_dc.alns.size() + c->reads_sn.alns.size());
  auto sn_key = [](int ch, uint32_t pos, bool strand) {
    return ((uint64_t)(uint32_t)ch << 33)
         | ((uint64_t)(strand ? 1 : 0) << 32) | pos;
  };
  auto sn_name = [&](uint32_t v) -> const char* {
    const ReadStore& st = (v & TAG_MASK) == TAG_PR ? c->reads_pr
                        : (v & TAG_MASK) == TAG_DC ? c->reads_dc
                                                   : c->reads_sn;
    return st.name(st.meta[v & ~TAG_MASK]);
  };

  double t_scatter_s = 0.0;
  const size_t n_pr_total = c->reads_pr.size();
  {  // properly paired: one 64-bit-key table per chromosome
    std::vector<OAMap64> tables(c->chroms.size());
    {
      std::vector<uint32_t> cnt(c->chroms.size(), 0);
      for (const Aln& a : c->reads_pr.alns) cnt[(uint32_t)a.chrom]++;
      for (size_t ci = 0; ci < tables.size(); ci++)
        if (cnt[ci]) tables[ci].init(cnt[ci]);
    }
    auto pr_key = [](const Aln& a) {
      return ((uint64_t)a.pos0 << 32) | a.pos1;
    };
    const size_t n_pr = c->reads_pr.size();

    // Stage 1 (scatter): permute each read's probe-relevant fields
    // into descending-quality order in ONE file-order sweep.  The
    // counting-sort slot for a read is known from the quality
    // histogram (maintained at append time), so the sweep reads
    // meta+alns SEQUENTIALLY and scatters 24-byte work records.
    // Earlier rounds instead walked meta/alns through a quality-order
    // permutation inside the probe loop itself; at production scale
    // those three dependent random streams (meta -> aln block -> hash
    // slot) were page-walk-bound — per-read cost grew 4x from 24M to
    // 97M records as the stores outgrew the TLB's reach.  After the
    // scatter, the probe loop's only random stream is the hash table.
    // Processing order (and thus the keep-first dup semantics,
    // Genrich.c:3457-3522) is unchanged: slots are assigned in file
    // order within each quality value, identical to the reference's
    // stable johnSort.
    struct PrWork {
      uint64_t key;              // 1 aln: (pos0<<32)|pos1; else the
                                 // read's offset into multi_arena
      uint32_t idx;              // meta index (file order)
      uint32_t name_off;
      float score;
      int16_t chrom;             // first aln's chromosome
      uint16_t cnt;              // alignments in this read's block
    };
    static_assert(sizeof(PrWork) == 24, "PrWork packs to 24 B");
    HVec<PrWork> work;
    HVec<Aln> multi_arena;       // multi-aln blocks, quality order
    bool small_chroms = c->chroms.size() <= 32767;
    if (small_chroms && n_pr) {
      auto s0 = std::chrono::steady_clock::now();
      work.resize(n_pr);
      std::vector<uint32_t> slot(1 << 16);
      {
        uint32_t run = 0;
        for (size_t q = (1 << 16); q-- > 0;) {
          slot[q] = run;
          run += c->reads_pr.qhist[q];
        }
      }
      const ReadStore::Meta* meta = c->reads_pr.meta.data();
      const Aln* arena = c->reads_pr.alns.data();
      for (size_t i = 0; i < n_pr; i++) {
        const ReadStore::Meta& m = meta[i];
        uint32_t s = slot[m.qual]++;
        PrWork w;
        if (m.aln_cnt == 1) {
          const Aln& a = arena[m.aln_off];
          w.key = pr_key(a);
          w.chrom = (int16_t)a.chrom;
        } else {
          // rare multi-aln (or empty) read: its block moves to the
          // side arena so the main stores can be released below
          w.key = (uint64_t)multi_arena.size();
          w.chrom = 0;
          multi_arena.append(arena + m.aln_off, m.aln_cnt);
        }
        w.idx = (uint32_t)i;
        w.name_off = m.name_off;
        w.score = m.score;
        w.cnt = m.aln_cnt;
        work[s] = w;
      }
      if (!c->opt.single_opt) {
        // probe needs only work[], multi_arena, the tables, and the
        // name arena (-R / warnings); at ~146M records meta+alns are
        // ~3.8 GB of dead weight through the probe phase.  (With -y
        // the singleton table's TAG_PR values still index pr meta,
        // so the stores stay until find_dups returns.)
        c->reads_pr.meta.release();
        c->reads_pr.alns.release();
      }
      if (fd_prof)
        t_scatter_s = std::chrono::duration<double>(
            std::chrono::steady_clock::now() - s0).count();
    }

    // Stage 2 (probe): sequential walk of the quality-ordered work
    // array; the hash-slot prefetch runs ahead on the single
    // remaining random stream.  Multi-alignment reads (rare) fall
    // back to their arena block.
    // GENRICH_NATIVE_PROF=2 additionally times every process_pair
    // call; at =1 the per-call clock reads (2 per read) would inflate
    // the probe phase they are meant to decompose
    const bool fd_deep = fd_prof && [] {
      const char* e = getenv("GENRICH_NATIVE_PROF");
      return e && e[0] == '2';
    }();
    auto run_pair = [&](const PrWork& w, const Aln* alns) {
      if (fd_deep) {
        auto p0 = std::chrono::steady_clock::now();
        c->ctr.paired_pr += process_pair(
            c, NameRef(c->reads_pr, w.name_off), alns, w.cnt, w.score);
        t_pair_s += std::chrono::duration<double>(
            std::chrono::steady_clock::now() - p0).count();
      } else {
        c->ctr.paired_pr += process_pair(
            c, NameRef(c->reads_pr, w.name_off), alns, w.cnt, w.score);
      }
    };
    // pr table values are NAME-ARENA offsets, not meta indices: the
    // only consumer of a match is the -R log line, and the name
    // arena outlives the (released) meta/aln stores
    const char* nm = c->reads_pr.names.data();
    auto probe_read = [&](const PrWork& w) {
      c->ctr.count_pr++;
      if (w.cnt == 1) {          // 1-aln fast path: no arena read,
        Aln first;               // one probe chain for find+insert
        first.pos0 = (uint32_t)(w.key >> 32);
        first.pos1 = (uint32_t)w.key;
        first.score = w.score;
        first.paired = first.full_ = true;
        first.chrom = w.chrom;
        uint32_t v = tables[w.chrom].find_or_put(w.key, w.name_off);
        if (v != UINT32_MAX) {
          c->ctr.dups_pr++;
          if (dups_verb)
            outf(c, c->dups_out, c->dups_out_f,
                 "%s\t%s:%u-%u\t%s\tpaired\n", nm + w.name_off,
                 c->chroms[first.chrom].name.c_str(), first.pos0,
                 first.pos1, nm + v);
          return;
        }
        if (seed_singles) {
          table_sn.put(sn_key(w.chrom, first.pos0, true),
                       w.idx | TAG_PR);
          table_sn.put(sn_key(w.chrom, first.pos1, false),
                       w.idx | TAG_PR);
        }
        run_pair(w, &first);
        return;
      }
      const Aln* alns =
          w.cnt ? multi_arena.data() + (size_t)w.key : nullptr;
      const Aln* hit = nullptr;
      uint32_t match = UINT32_MAX;
      for (uint16_t k = 0; k < w.cnt; k++) {
        const Aln& a = alns[k];
        uint32_t v = tables[a.chrom].find(pr_key(a));
        if (v != UINT32_MAX) { hit = &a; match = v; break; }
      }
      if (hit) {
        c->ctr.dups_pr++;
        if (dups_verb)
          outf(c, c->dups_out, c->dups_out_f,
               "%s\t%s:%u-%u\t%s\tpaired\n", nm + w.name_off,
               c->chroms[hit->chrom].name.c_str(), hit->pos0,
               hit->pos1, nm + match);
        return;
      }
      for (uint16_t k = 0; k < w.cnt; k++) {
        const Aln& a = alns[k];
        tables[a.chrom].put(pr_key(a), w.name_off);
        if (seed_singles) {
          table_sn.put(sn_key(a.chrom, a.pos0, true), w.idx | TAG_PR);
          table_sn.put(sn_key(a.chrom, a.pos1, false), w.idx | TAG_PR);
        }
      }
      run_pair(w, alns);
    };

    if (small_chroms) {
      for (size_t s = 0; s < n_pr; s++) {
        if (s + 16 < n_pr) {
          const PrWork& f = work[s + 16];
          tables[f.chrom].prefetch(f.key);
        }
        probe_read(work[s]);
      }
    } else {
      // >32767 chromosomes (scaffold-heavy assemblies): PrWork's
      // int16 chrom can't represent the first aln; take the
      // permutation path instead of scattering.
      std::vector<uint32_t> order = sort_order(c->reads_pr);
      for (size_t idx = 0; idx < n_pr; idx++) {
        const uint32_t i = order[idx];
        const ReadStore::Meta& m = c->reads_pr.meta[i];
        const Aln* alns = c->reads_pr.alns.data() + m.aln_off;
        const Aln* hit = nullptr;
        uint32_t match = UINT32_MAX;
        for (uint16_t k = 0; k < m.aln_cnt; k++) {
          const Aln& a = alns[k];
          uint32_t v = tables[a.chrom].find(pr_key(a));
          if (v != UINT32_MAX) { hit = &a; match = v; break; }
        }
        c->ctr.count_pr++;
        if (hit) {
          c->ctr.dups_pr++;
          if (dups_verb)
            outf(c, c->dups_out, c->dups_out_f,
                 "%s\t%s:%u-%u\t%s\tpaired\n", c->reads_pr.name(m),
                 c->chroms[hit->chrom].name.c_str(), hit->pos0,
                 hit->pos1, c->reads_pr.names.data() + match);
          continue;
        }
        for (uint16_t k = 0; k < m.aln_cnt; k++) {
          const Aln& a = alns[k];
          tables[a.chrom].put(pr_key(a), m.name_off);
          if (seed_singles) {
            table_sn.put(sn_key(a.chrom, a.pos0, true), i | TAG_PR);
            table_sn.put(sn_key(a.chrom, a.pos1, false), i | TAG_PR);
          }
        }
        c->ctr.paired_pr += process_pair(
            c, NameRef(c->reads_pr, m.name_off), alns,
            m.aln_cnt, m.score);
      }
    }
  }
  if (fd_prof)
    fprintf(stderr, "[native] find_dups(pr): %.3fs of which "
            "scatter: %.3fs process_pair: %.3fs (%zu reads)\n",
            std::chrono::duration<double>(
                std::chrono::steady_clock::now() - fd_t0).count(),
            t_scatter_s, t_pair_s, n_pr_total);

  if (!c->opt.single_opt) return;

  bool extend_opt = c->opt.extend_opt;
  int32_t extend = c->opt.extend;
  if (c->opt.avg_ext_opt) {
    if (!c->ctr.paired_pr) {
      if (c->opt.verbose)
        fprintf(stderr, "Warning! No paired alignments to calculate "
                "avg frag length --\n  Printing unpaired alignments "
                "\"as is\"\n");
      extend = 0;
    } else {
      extend = (int32_t)(c->ctr.total_len / c->ctr.paired_pr + 0.5);
    }
    extend_opt = extend != 0;
  }

  {  // discordant
    OAMap table;
    table.init(c->reads_dc.alns.size());
    auto dc_key = [](const Aln& a, uint32_t pos) {
      return ((uint64_t)(uint32_t)a.chrom << 33)
           | ((uint64_t)(a.strand ? 1 : 0) << 32) | pos;
    };
    std::vector<uint32_t> order = sort_order(c->reads_dc);
    const size_t n_dc = order.size();
    for (size_t idx = 0; idx < n_dc; idx++) {
      if (idx + 16 < n_dc)
        __builtin_prefetch(&c->reads_dc.meta[order[idx + 16]]);
      if (idx + 8 < n_dc) {
        const ReadStore::Meta& fm = c->reads_dc.meta[order[idx + 8]];
        __builtin_prefetch(c->reads_dc.alns.data() + fm.aln_off);
        __builtin_prefetch(c->reads_dc.alns.data() + fm.aln2_off);
      }
      const uint32_t i = order[idx];
      const ReadStore::Meta& m = c->reads_dc.meta[i];
      const Aln* al1 = c->reads_dc.alns.data() + m.aln_off;
      const Aln* al2 = c->reads_dc.alns.data() + m.aln2_off;
      bool dup = false;
      for (uint16_t k = 0; k < m.aln_cnt && !dup; k++) {
        const Aln& a = al1[k];
        uint32_t pos = a.strand ? a.pos0 : a.pos1;
        for (uint16_t j = 0; j < m.aln2_cnt; j++) {
          const Aln& b = al2[j];
          uint32_t pos1 = b.strand ? b.pos0 : b.pos1;
          uint32_t v1 = table.find(dc_key(a, pos), dc_key(b, pos1));
          if (v1 != UINT32_MAX) {
            dup = true;
            if (dups_verb)
              outf(c, c->dups_out, c->dups_out_f,
                   "%s\t%s:%u,%c;%s:%u,%c\t%s\tdiscordant\n",
                   c->reads_dc.name(m),
                   c->chroms[a.chrom].name.c_str(),
                   pos, a.strand ? '+' : '-',
                   c->chroms[b.chrom].name.c_str(), pos1,
                   b.strand ? '+' : '-',
                   c->reads_dc.name(c->reads_dc.meta[v1]));
            break;
          }
          uint32_t v2 = table.find(dc_key(b, pos1), dc_key(a, pos));
          if (v2 != UINT32_MAX) {
            dup = true;
            if (dups_verb)
              outf(c, c->dups_out, c->dups_out_f,
                   "%s\t%s:%u,%c;%s:%u,%c\t%s\tdiscordant\n",
                   c->reads_dc.name(m),
                   c->chroms[b.chrom].name.c_str(),
                   pos1, b.strand ? '+' : '-',
                   c->chroms[a.chrom].name.c_str(), pos,
                   a.strand ? '+' : '-',
                   c->reads_dc.name(c->reads_dc.meta[v2]));
            break;
          }
        }
      }
      c->ctr.count_dc++;
      if (dup) { c->ctr.dups_dc++; continue; }
      for (uint16_t k = 0; k < m.aln_cnt; k++) {
        const Aln& a = al1[k];
        uint32_t pos = a.strand ? a.pos0 : a.pos1;
        for (uint16_t j = 0; j < m.aln2_cnt; j++) {
          const Aln& b = al2[j];
          uint32_t pos1 = b.strand ? b.pos0 : b.pos1;
          table.put(dc_key(a, pos), dc_key(b, pos1), i);
          if (seed_singles) {
            if (j == 0)
              table_sn.put(sn_key(a.chrom, pos, a.strand),
                           i | TAG_DC);
            if (k == 0)
              table_sn.put(sn_key(b.chrom, pos1, b.strand),
                           i | TAG_DC);
          }
        }
      }
      c->ctr.single_pr += process_single(
          c, NameRef(c->reads_dc, m.name_off), al1, m.aln_cnt,
          extend_opt, extend, false, m.score, true);
      c->ctr.single_pr += process_single(
          c, NameRef(c->reads_dc, m.name_off), al2, m.aln2_cnt,
          extend_opt, extend, false, m.score_r2, false);
    }
  }

  {  // singletons
    std::vector<uint32_t> order = sort_order(c->reads_sn);
    const size_t n_sn = order.size();
    for (size_t idx = 0; idx < n_sn; idx++) {
      if (idx + 16 < n_sn)
        __builtin_prefetch(&c->reads_sn.meta[order[idx + 16]]);
      if (idx + 8 < n_sn)
        __builtin_prefetch(c->reads_sn.alns.data()
                           + c->reads_sn.meta[order[idx + 8]].aln_off);
      if (idx + 4 < n_sn) {
        const ReadStore::Meta& fm = c->reads_sn.meta[order[idx + 4]];
        if (fm.aln_cnt) {
          const Aln& fa = c->reads_sn.alns[fm.aln_off];
          table_sn.prefetch(sn_key(fa.chrom,
                                   fa.strand ? fa.pos0 : fa.pos1,
                                   fa.strand));
        }
      }
      const uint32_t i = order[idx];
      const ReadStore::Meta& m = c->reads_sn.meta[i];
      const Aln* alns = c->reads_sn.alns.data() + m.aln_off;
      bool dup = false;
      for (uint16_t k = 0; k < m.aln_cnt; k++) {
        const Aln& a = alns[k];
        uint32_t pos = a.strand ? a.pos0 : a.pos1;
        uint32_t v = table_sn.find(sn_key(a.chrom, pos, a.strand));
        if (v != UINT32_MAX) {
          dup = true;
          if (dups_verb)
            outf(c, c->dups_out, c->dups_out_f, "%s\t%s:%u,%c\t%s\t"
                 "single\n", c->reads_sn.name(m),
                 c->chroms[a.chrom].name.c_str(), pos,
                 a.strand ? '+' : '-', sn_name(v));
          break;
        }
      }
      c->ctr.count_sn++;
      if (dup) { c->ctr.dups_sn++; continue; }
      for (uint16_t k = 0; k < m.aln_cnt; k++) {
        const Aln& a = alns[k];
        uint32_t pos = a.strand ? a.pos0 : a.pos1;
        table_sn.put(sn_key(a.chrom, pos, a.strand), i | TAG_SN);
      }
      c->ctr.single_pr += process_single(
          c, NameRef(c->reads_sn, m.name_off), alns, m.aln_cnt,
          extend_opt, extend, false, m.score, m.first);
    }
  }
}

void process_avg_ext(Context* c) {
  int32_t avg = 0;
  if (!c->ctr.paired_pr) {
    if (c->opt.verbose)
      fprintf(stderr, "Warning! No paired alignments to calculate avg "
              "frag length --\n  Printing unpaired alignments \"as "
              "is\"\n");
  } else {
    avg = (int32_t)(c->ctr.total_len / c->ctr.paired_pr + 0.5);
  }
  for (auto& u : c->unpair) {
    if (!avg)
      save_interval(c, u.a.chrom, u.a.pos0, u.a.pos1, NameRef(u.q), u.n);
    else if (u.a.strand)
      save_interval(c, u.a.chrom, u.a.pos0,
                    (int64_t)(uint32_t)(u.a.pos0 + avg), NameRef(u.q), u.n);
    else
      save_interval(c, u.a.chrom, (int32_t)(u.a.pos1 - (uint32_t)avg),
                    u.a.pos1, NameRef(u.q), u.n);
  }
  c->unpair.clear();
}

// ---- SAM parsing ----------------------------------------------------

float get_float(const char* s) {
  char* endp;
  float v = strtof(s, &endp);
  if (endp == s || *endp != '\0') fail(s, ERRFLOAT);
  return v;
}

long get_long(const char* s) {
  char* endp;
  long v = strtol(s, &endp, 10);
  if (endp == s || *endp != '\0') fail(s, ERRINT);
  return v;
}

// CIGAR walk: consume <digits><op> tokens left to right, summing the
// query-sequence length (M/=/X/I/S) and the query-vs-reference span
// correction into *offset (I/S consume query only, D reference only;
// N/H/P consume neither).  Validation follows the reference's
// parseCigar (Genrich.c:4408-4445) with one deliberate tightening:
// a token with no leading digits raises an integer error with an
// empty payload, where the reference's getInt accepts the empty
// digit run as 0 (it never checks endptr) and so tolerates a bare
// opcode on a degenerate CIGAR.  As in the reference, an
// unrecognized opcode names itself quoted in the message and a
// trailing digit run with no opcode is silently ignored.  The
// string is read in place, never modified.
int parse_cigar(const char* cigar, int* offset) {
  int length = 0;
  const char* p = cigar;
  while (*p) {
    const char* d = p;
    while (*d >= '0' && *d <= '9') d++;
    char op = *d;
    if (op == '\0') break;              // digits with no opcode
    if (d == p) fail("", ERRINT);       // opcode with no digits
    int n = (int)strtol(p, nullptr, 10);  // stops at the opcode
    switch (op) {
      case 'M': case '=': case 'X':
        length += n;
        break;
      case 'I': case 'S':
        length += n;
        *offset -= n;
        break;
      case 'D':
        *offset += n;
        break;
      case 'N': case 'H': case 'P':
        break;
      default: {
        char msg[4] = {'\'', op, '\'', 0};
        fail(msg, ERRCIGAR);
      }
    }
    p = d + 1;
  }
  return length;
}

// Reference-genome span of one record: the sequence length (from SEQ,
// or implied by the CIGAR when SEQ is "*"/empty) plus the CIGAR's
// insertion/deletion correction.  When both SEQ and a CIGAR are
// present their lengths must agree (reference: calcDist,
// Genrich.c:4451-4463); with neither, the record carries no usable
// span and is an error.
int calc_dist(const std::string& q, const char* seq,
              const char* cigar) {
  int length = strcmp(seq, "*") ? (int)strlen(seq) : 0;
  int offset = 0;
  bool have_cigar = strcmp(cigar, "*") != 0;
  if (!have_cigar) {
    if (!length) fail(q, ERRINFO);
    return length;
  }
  int implied = parse_cigar(cigar, &offset);
  if (length && length != implied) fail(q, ERRMISM);
  return (length ? length : implied) + offset;
}

float sam_score(char* extra) {
  if (!extra) return NOSCORE;
  char* save1;
  for (char* field = strtok_r(extra, "\t", &save1); field;
       field = strtok_r(nullptr, "\t", &save1)) {
    char* save2;
    char* tag = strtok_r(field, ":", &save2);
    if (tag && !strcmp(tag, "AS")) {
      char* t1 = strtok_r(nullptr, ":", &save2);
      if (!t1) return NOSCORE;
      char* t2 = strtok_r(nullptr, ":", &save2);
      if (!t2) return NOSCORE;
      return get_float(t2);
    }
  }
  return NOSCORE;
}

// ---- multithreaded BGZF decompression --------------------------------
//
// BAM files (and bgzip'd SAM/logs) are BGZF: a series of independent
// <=64 KB gzip members, each carrying its compressed size in a 'BC'
// extra subfield (SAM spec §4.1).  The reference decompresses them
// serially inside gzread; here a worker pool inflates blocks ahead of
// the parse thread, overlapping decompression with record parsing and
// scaling with cores.  Byte stream delivered is identical to gzread's.

int bgzf_threads() {
  // Inflate workers; GENRICH_THREADS=n gives n-1 workers (one slot
  // notionally for the parse loop), 0/1 disables MT.  Default: one
  // worker per core, capped at 8 — the parse thread spends most of
  // its time blocked on the ring, so leaving it a dedicated core
  // halves throughput on small machines (measured 2-core: 8.7s ->
  // 4.8s framing a 9.7M-record BAM with 2 workers vs 1).
  const char* e = getenv("GENRICH_THREADS");
  if (e && *e) {
    int v = atoi(e);
    return v > 1 ? (v > 32 ? 32 : v) - 1 : 0;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw >= 2 ? (int)(hw < 8 ? hw : 8) : 0;
}

int parse_threads() {
  // Record-parse worker threads (GENRICH_INGEST_THREADS=n; 0/1 =
  // sequential).  Default: cores-2 on >=4-core machines (leaving the
  // walker thread and the BGZF inflate workers a core), capped at
  // 16; sequential below that — measured on a 2-core box the
  // walker/worker split's extra stream copy loses to the plain loop
  // once libdeflate makes inflate cheap.
  const char* e = getenv("GENRICH_INGEST_THREADS");
  if (e && *e) {
    int v = atoi(e);
    return v < 0 ? 0 : (v > 32 ? 32 : v);
  }
  unsigned hw = std::thread::hardware_concurrency();
  if (hw < 4) return 0;
  unsigned w = hw - 2;
  return (int)(w < 16 ? w : 16);
}

struct BgzfMT {
  FILE* f;
  struct Slot {
    std::vector<uint8_t> comp, out;
    size_t comp_len = 0, out_len = 0;
    uint32_t isize = 0, crc = 0;
    int state = 0;             // 0 free, 1 compressed, 2 inflated
    bool bad = false;
  };
  std::vector<Slot> ring;
  std::deque<uint64_t> work;   // block seqs ready to inflate
  uint64_t prod = 0, cons = 0; // produced / consumed block seqs
  size_t cons_off = 0;         // bytes already taken from slot `cons`
  bool eof_in = false, shutdown_ = false, corrupt = false;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::vector<std::thread> workers;

  BgzfMT(FILE* fh, int nthreads)
      // deep ring (a few MB): the consumer alternates between
      // parse-heavy bursts (workers fill the ring, then idle) and
      // drain bursts; 12 slots of headroom per worker keeps the
      // inflate pool busy across a whole parse burst
      : f(fh), ring((size_t)(12 * nthreads + 40)) {
    for (int i = 0; i < nthreads; i++)
      workers.emplace_back([this] { worker(); });
  }
  ~BgzfMT() {
    { std::lock_guard<std::mutex> lk(mu); shutdown_ = true; }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    fclose(f);
  }

  // Read the next BGZF block into ring[prod % n] (caller guarantees
  // that slot is free; only the consumer thread touches f).  false at
  // EOF; a malformed stream sets `corrupt` and reads as EOF, matching
  // the gzread error behavior of the serial path.
  bool produce_one() {
    Slot& s = ring[prod % ring.size()];
    uint8_t hdr[12];
    size_t n = fread(hdr, 1, 12, f);
    if (n == 0) { eof_in = true; return false; }
    if (n < 12 || hdr[0] != 0x1f || hdr[1] != 0x8b || hdr[2] != 8 ||
        !(hdr[3] & 4)) { corrupt = eof_in = true; return false; }
    unsigned xlen = hdr[10] | ((unsigned)hdr[11] << 8);
    uint8_t extra[65536];
    if (fread(extra, 1, xlen, f) != xlen) {
      corrupt = eof_in = true;
      return false;
    }
    long bsize = -1;
    for (size_t i = 0; i + 4 <= xlen;) {
      unsigned slen = extra[i + 2] | ((unsigned)extra[i + 3] << 8);
      if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2 &&
          i + 6 <= xlen) {
        bsize = extra[i + 4] | ((long)extra[i + 5] << 8);
        break;
      }
      i += 4 + slen;
    }
    long comp_len = bsize + 1 - 12 - (long)xlen - 8;
    if (bsize < 0 || comp_len < 0) {
      corrupt = eof_in = true;
      return false;
    }
    s.comp.resize((size_t)comp_len);
    uint8_t tr[8];
    if (fread(s.comp.data(), 1, (size_t)comp_len, f) !=
            (size_t)comp_len ||
        fread(tr, 1, 8, f) != 8) {
      corrupt = eof_in = true;
      return false;
    }
    s.comp_len = (size_t)comp_len;
    s.crc = tr[0] | ((uint32_t)tr[1] << 8) | ((uint32_t)tr[2] << 16) |
            ((uint32_t)tr[3] << 24);
    s.isize = tr[4] | ((uint32_t)tr[5] << 8) | ((uint32_t)tr[6] << 16) |
              ((uint32_t)tr[7] << 24);
    if (s.isize > (1u << 16)) { corrupt = eof_in = true; return false; }
    {
      std::lock_guard<std::mutex> lk(mu);
      s.state = 1;
      work.push_back(prod);
    }
    prod++;
    cv_work.notify_one();
    return true;
  }

  // one-block raw-deflate inflate + CRC check; libdeflate when
  // available (~2x zlib on BGZF-sized blocks), zlib otherwise
  void worker() {
#ifdef USE_LIBDEFLATE
    struct libdeflate_decompressor* dec =
        libdeflate_alloc_decompressor();
#else
    z_stream z{};
    inflateInit2(&z, -15);
#endif
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_work.wait(lk, [&] { return shutdown_ || !work.empty(); });
      if (work.empty()) break;   // shutdown
      uint64_t seq = work.front();
      work.pop_front();
      Slot& s = ring[seq % ring.size()];
      lk.unlock();
      s.out.resize(s.isize);
#ifdef USE_LIBDEFLATE
      size_t actual = 0;
      auto r = libdeflate_deflate_decompress(
          dec, s.comp.data(), s.comp_len, s.out.data(), s.isize,
          &actual);
      s.out_len = s.isize;
      s.bad = !(r == LIBDEFLATE_SUCCESS && actual == s.isize &&
                libdeflate_crc32(0, s.out.data(), s.isize) == s.crc);
#else
      inflateReset(&z);
      z.next_in = s.comp.data();
      z.avail_in = (uInt)s.comp_len;
      z.next_out = s.out.data();
      z.avail_out = (uInt)s.isize;
      int r = inflate(&z, Z_FINISH);
      s.out_len = s.isize;
      s.bad = !(r == Z_STREAM_END && z.avail_out == 0 &&
                crc32(crc32(0, nullptr, 0), s.out.data(),
                      (uInt)s.isize) == s.crc);
#endif
      lk.lock();
      s.state = 2;
      cv_done.notify_all();
    }
    lk.unlock();
#ifdef USE_LIBDEFLATE
    libdeflate_free_decompressor(dec);
#else
    inflateEnd(&z);
#endif
  }

  // gzread-alike: blocks until `cap` bytes or EOF/corruption.
  int read(void* dst, unsigned cap) {
    uint8_t* d = (uint8_t*)dst;
    unsigned got = 0;
    while (got < cap && !corrupt) {
      while (!eof_in && prod - cons < ring.size())
        if (!produce_one()) break;
      if (cons == prod) break;   // true EOF
      Slot& s = ring[cons % ring.size()];
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [&] { return s.state == 2; });
      }
      if (s.bad) { corrupt = true; break; }
      size_t k = s.out_len - cons_off;
      if (k > cap - got) k = cap - got;
      memcpy(d + got, s.out.data() + cons_off, k);
      got += (unsigned)k;
      cons_off += k;
      if (cons_off == s.out_len) {   // slot drained (incl. 0-byte EOF
        s.state = 0;                 // marker blocks): recycle
        cons_off = 0;
        cons++;
      }
    }
    return (int)got;
  }
};

// Open path for BGZF-MT reading if it is a regular file whose first
// gzip member carries the BGZF 'BC' subfield; nullptr otherwise.
BgzfMT* bgzf_open(const char* path, int nthreads) {
  struct stat st;
  if (nthreads < 1 || stat(path, &st) != 0 || !S_ISREG(st.st_mode))
    return nullptr;
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t hdr[12];
  bool use = false;
  if (fread(hdr, 1, 12, f) == 12 && hdr[0] == 0x1f && hdr[1] == 0x8b &&
      hdr[2] == 8 && (hdr[3] & 4)) {
    unsigned xlen = hdr[10] | ((unsigned)hdr[11] << 8);
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, f) == xlen)
      for (size_t i = 0; i + 4 <= xlen;) {
        unsigned slen = extra[i + 2] | ((unsigned)extra[i + 3] << 8);
        if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2) {
          use = true;
          break;
        }
        i += 4 + slen;
      }
  }
  if (use && fseek(f, 0, SEEK_SET) == 0) return new BgzfMT(f, nthreads);
  fclose(f);
  return nullptr;
}

struct Reader {
  // Buffered reader over zlib (transparent for plain files).  gzgets
  // scans per character and gzread-per-field costs a zlib call per 4
  // bytes; block reads + memchr run the SAM hot loop ~3x faster.
  // BGZF inputs (BAM, bgzip'd SAM) bypass zlib for the multithreaded
  // block pipeline above.
  gzFile gz = nullptr;
  std::unique_ptr<BgzfMT> bgzf;
  std::vector<char> buf;
  size_t head = 0, tail = 0;
  bool ateof = false;
  explicit Reader(const char* path) : buf(1 << 20) {
    bgzf.reset(bgzf_open(path, bgzf_threads()));
    if (!bgzf) {
      gz = gzopen(path, "rb");
      if (gz) gzbuffer(gz, 1 << 17);
    }
  }
  ~Reader() { if (gz) gzclose(gz); }
  bool valid() const { return gz || bgzf; }

  bool fill() {
    if (ateof) return false;
    if (head) {
      memmove(buf.data(), buf.data() + head, tail - head);
      tail -= head;
      head = 0;
    }
    if (tail == buf.size()) buf.resize(buf.size() * 2);
    int n = bgzf ? bgzf->read(buf.data() + tail,
                              (unsigned)(buf.size() - tail))
                 : gzread(gz, buf.data() + tail,
                          (unsigned)(buf.size() - tail));
    if (n <= 0) { ateof = true; return false; }
    tail += (size_t)n;
    return true;
  }

  // copy up to n leading bytes without consuming them
  size_t peek(void* dst, size_t n) {
    while (tail - head < n && fill()) {}
    size_t k = tail - head < n ? tail - head : n;
    memcpy(dst, buf.data() + head, k);
    return k;
  }

  // next line, NUL-terminated in place ('\n' stripped); nullptr at
  // EOF; length in last_len.  Unlike the reference's fgets (getLine,
  // Genrich.c:139-144), lines longer than 64 KB are returned whole
  // (PARITY.md item 3).
  size_t last_len = 0;
  char* line() {
    for (;;) {
      char* p = buf.data() + head;
      char* nl = (char*)memchr(p, '\n', tail - head);
      if (nl) {
        *nl = '\0';
        last_len = (size_t)(nl - p);
        head = (size_t)(nl - buf.data()) + 1;
        return p;
      }
      if (!fill()) {
        if (head == tail) return nullptr;
        if (tail == buf.size()) buf.resize(buf.size() + 1);
        buf[tail] = '\0';
        char* q = buf.data() + head;
        last_len = tail - head;
        head = tail;
        return q;
      }
    }
  }

  bool read(void* dst, size_t n) {   // exact-length binary read
    uint8_t* d = (uint8_t*)dst;
    while (n) {
      size_t have = tail - head;
      if (have) {
        size_t k = have < n ? have : n;
        memcpy(d, buf.data() + head, k);
        head += k;
        d += k;
        n -= k;
        continue;
      }
      if (!fill()) return false;
    }
    return true;
  }

  // zero-copy exact-length read: pointer into the internal buffer,
  // valid until the next Reader call.  nullptr on EOF/short.
  const uint8_t* take(size_t n) {
    while (tail - head < n) {
      if (n > buf.size()) buf.resize(2 * n);
      if (!fill()) return nullptr;
    }
    const uint8_t* p = (const uint8_t*)buf.data() + head;
    head += n;
    return p;
  }
};

struct NameMap {
  // open-addressing chrom-name lookup over borrowed c-strings: the
  // per-record std::string construction + unordered_map::find of the
  // naive version malloc'd on every SAM record
  struct Slot { const char* key = nullptr; int val = -1; };
  std::vector<Slot> slots;
  void build(const std::vector<Chrom>& chroms) {
    size_t cap = 16;
    while (cap < chroms.size() * 2) cap <<= 1;
    slots.assign(cap, {});
    for (auto& ch : chroms) {
      size_t m = cap - 1, i = hashs(ch.name.c_str()) & m;
      while (slots[i].key) i = (i + 1) & m;
      slots[i] = {ch.name.c_str(), ch.index};
    }
  }
  static uint64_t hashs(const char* s) {
    uint64_t h = 1469598103934665603ull;
    for (; *s; s++) { h ^= (uint8_t)*s; h *= 1099511628211ull; }
    return h;
  }
  int find(const char* k) const {
    size_t m = slots.size() - 1, i = hashs(k) & m;
    while (slots[i].key) {
      if (!strcmp(slots[i].key, k)) return slots[i].val;
      i = (i + 1) & m;
    }
    return -1;
  }
};

// ---- parallel record parsing ----------------------------------------
//
// SAM/BAM semantics are order-dependent only at queryname-group
// granularity (group assembly, multimapper selection, dedup
// buffering, file-order tie-breaks).  The caller thread therefore
// only *frames* records and detects group boundaries — replicating
// exactly the unmapped/supp/MAPQ pre-filters and the truncated-name
// comparison the record parser itself applies — and cuts the stream
// into multi-MB spans that always end on a group boundary.  Worker
// threads parse spans into shard Contexts (events, counters, dedup
// stores, buffered warnings/-b rows); the caller merges completed
// shards strictly in span order, so every observable output —
// counters, event order, dedup stores and their file-order
// tie-breaks, warning text and its MAX_ALNS cap, -b bytes, even the
// non-associative totalLen double — is bit-identical to a
// sequential parse.  The reference is single-threaded
// (/root/reference/Genrich.c:4869-4943 readSAM/readBAM); this
// parallel decomposition is TPU-framework-native design, not a port.

size_t span_bytes() {                    // span target size
  // GENRICH_INGEST_SPAN overrides (tests use tiny spans to force
  // group-boundary cuts and multi-span merging on small files)
  static const size_t v = [] {
    const char* e = getenv("GENRICH_INGEST_SPAN");
    if (e && *e) {
      long n = atol(e);
      if (n > 0) return (size_t)n;
    }
    return (size_t)(4 << 20);
  }();
  return v;
}

std::unique_ptr<Context> make_shard(const Context* c) {
  auto s = std::unique_ptr<Context>(new Context());
  s->chroms = c->chroms;
  s->opt = c->opt;
  s->ctrl = c->ctrl;
  s->sample = c->sample;
  s->events.resize(c->chroms.size());
  s->shard_mode = true;
  s->shard_bed = (c->bed_out || c->bed_out_f);
  return s;
}

void add_counters(Counters* a, const Counters& b) {
  a->count += b.count; a->unmapped += b.unmapped;
  a->paired += b.paired; a->single_ += b.single_;
  a->orphan += b.orphan; a->paired_pr += b.paired_pr;
  a->single_pr += b.single_pr; a->supp += b.supp;
  a->skipped += b.skipped; a->low_mapq += b.low_mapq;
  a->sec_pair += b.sec_pair; a->sec_single += b.sec_single;
  a->count_pr += b.count_pr; a->dups_pr += b.dups_pr;
  a->count_dc += b.count_dc; a->dups_dc += b.dups_dc;
  a->count_sn += b.count_sn; a->dups_sn += b.dups_sn;
}

void merge_store(ReadStore* dst, const ReadStore& src) {
  uint32_t aln_base = (uint32_t)dst->alns.size();
  uint32_t name_base = (uint32_t)dst->names.size();
  dst->alns.append(src.alns.data(), src.alns.size());
  dst->names.append(src.names.data(), src.names.size());
  size_t m0 = dst->meta.size();
  dst->meta.append(src.meta.data(), src.meta.size());
  for (size_t i = m0; i < dst->meta.size(); i++) {
    dst->meta[i].aln_off += aln_base;
    dst->meta[i].aln2_off += aln_base;
    dst->meta[i].name_off += name_base;
  }
  for (size_t q = 0; q < src.qhist.size(); q++)
    dst->qhist[q] += src.qhist[q];
}

void merge_shard(Context* c, Context* s) {
  // warnings exactly as a sequential run would have printed them:
  // uncapped always, capped while the GLOBAL err_count is under the
  // cap (the shard buffered its first MAX_ALNS capped texts, a
  // superset of what can still print)
  uint64_t base = c->ctr.err_count, seen = 0;
  for (auto& w : s->warn_buf) {
    if (!w.capped) { fputs(w.text.c_str(), stderr); continue; }
    if (base + seen < (uint64_t)MAX_ALNS)
      fputs(w.text.c_str(), stderr);
    seen++;
  }
  c->ctr.err_count += s->ctr.err_count;
  add_counters(&c->ctr, s->ctr);
  for (auto& t : s->len_terms)   // file-order replay: bit-exact
    c->ctr.total_len += (double)t.first / t.second;
  for (size_t ci = 0; ci < s->events.size(); ci++) {
    EventBuf& d = c->events[ci];
    EventBuf& e = s->events[ci];
    d.start.append(e.start.data(), e.start.size());
    d.end.append(e.end.data(), e.end.size());
    d.count.append(e.count.data(), e.count.size());
  }
  for (auto& u : s->unpair) c->unpair.push_back(std::move(u));
  merge_store(&c->reads_pr, s->reads_pr);
  merge_store(&c->reads_dc, s->reads_dc);
  merge_store(&c->reads_sn, s->reads_sn);
  if (!s->bed_buf.empty()) {
    if (c->bed_out) gzwrite(c->bed_out, s->bed_buf.data(),
                            (unsigned)s->bed_buf.size());
    else if (c->bed_out_f) fwrite(s->bed_buf.data(), 1,
                                  s->bed_buf.size(), c->bed_out_f);
  }
}

// Work pool: the caller produces spans (next_span) and merges results
// in span order; workers run parse_span on shard contexts.  The first
// erroring span (in span order) wins, exactly like a sequential stop.
template <typename NextSpan, typename ParseSpan>
void run_parse_pool(Context* c, int n_workers, NextSpan&& next_span,
                    ParseSpan&& parse_span) {
  struct Item { uint64_t idx; std::string bytes; };
  std::mutex mu;
  std::condition_variable cv_work, cv_res;
  std::deque<Item> queue;
  bool done = false;
  std::vector<std::unique_ptr<Context>> results;
  const size_t max_q = (size_t)n_workers * 2;

  auto worker = [&]() {
    for (;;) {
      Item it;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return done || !queue.empty(); });
        if (queue.empty()) return;
        it = std::move(queue.front());
        queue.pop_front();
        cv_work.notify_all();    // wake a blocked producer
      }
      auto s = make_shard(c);
      try {
        parse_span(s.get(), it.bytes);
        flush_group(s.get());
      } catch (const IngestError& e) {
        s->err_code = e.code;
        s->err_msg = e.msg;
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        if (results.size() <= it.idx) results.resize(it.idx + 1);
        results[it.idx] = std::move(s);
        cv_res.notify_all();
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 0; i < n_workers; i++) threads.emplace_back(worker);

  uint64_t next_idx = 0, merged = 0;
  int err_code = -1;
  std::string err_msg;
  auto drain_ready = [&](bool wait_all) {
    // merge completed shards in span order (caller thread)
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      if (merged == next_idx && !wait_all) return;
      if (merged == next_idx) return;
      if (results.size() <= merged || !results[merged]) {
        if (!wait_all) return;
        cv_res.wait(lk, [&] {
          return results.size() > merged && bool(results[merged]);
        });
      }
      auto s = std::move(results[merged]);
      merged++;
      lk.unlock();
      if (err_code < 0) {
        if (s->err_code >= 0) {
          err_code = s->err_code;
          err_msg = s->err_msg;
        } else {
          merge_shard(c, s.get());
        }
      }
      s.reset();
      lk.lock();
    }
  };

  try {
    std::string bytes;
    while (err_code < 0 && next_span(&bytes)) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return queue.size() < max_q; });
        queue.push_back({next_idx++, std::move(bytes)});
        cv_work.notify_one();
      }
      bytes.clear();
      drain_ready(false);
    }
  } catch (...) {
    // producer failed (I/O/framing error).  Let the workers finish
    // the already-queued spans, then surface the EARLIEST span's
    // record error when one exists — a sequential parse would have
    // hit it before the producer's later truncation — so the
    // reported error never depends on worker timing; with no span
    // error, rethrow the producer's exception.
    {
      std::unique_lock<std::mutex> lk(mu);
      done = true;
      cv_work.notify_all();
    }
    for (auto& t : threads) t.join();
    if (err_code < 0) {
      for (uint64_t i = merged; i < next_idx; i++) {
        if (i < results.size() && results[i]
            && results[i]->err_code >= 0) {
          err_code = results[i]->err_code;
          err_msg = results[i]->err_msg;
          break;
        }
      }
    }
    if (err_code >= 0) throw IngestError{err_code, err_msg};
    throw;
  }
  {
    std::unique_lock<std::mutex> lk(mu);
    done = true;
    cv_work.notify_all();
  }
  drain_ready(true);
  for (auto& t : threads) t.join();
  if (err_code >= 0) throw IngestError{err_code, err_msg};
}

void check_sam_header(Context* c, char* line) {
  char* save;
  char* tag = strtok_r(line, "\t\n", &save);
  if (!tag) return;
  if (!strcmp(tag, "@HD")) {
    const char* order = nullptr;
    for (char* f = strtok_r(nullptr, "\t\n", &save); f;
         f = strtok_r(nullptr, "\t\n", &save))
      if (!strncmp(f, "SO:", 3)) order = f + 3;
    if (c->opt.sort_opt && (!order || strcmp(order, "queryname")))
      fail("", ERRSORT);
  } else if (!strcmp(tag, "@SQ")) {
    const char* name = nullptr;
    const char* len = nullptr;
    for (char* f = strtok_r(nullptr, "\t\n", &save); f;
         f = strtok_r(nullptr, "\t\n", &save)) {
      if (!strncmp(f, "SN:", 3)) name = f + 3;
      else if (!strncmp(f, "LN:", 3)) len = f + 3;
    }
    if (name && len) save_chrom(c, name, (uint32_t)atoll(len));
  }
}

// one SAM record line (NUL-terminatable, '\n' stripped, length len);
// shared by the sequential reader and the parallel span workers
void parse_sam_line(Context* c, char* line, size_t len,
                    const NameMap& cmap) {
  if (line[0] == '@')
    // the reference's payload is the fgets line incl. '\n'
    fail(std::string(line) + "\n", ERRHEAD);
  // tokenize 11 fields + extra (single-delimiter memchr scan, ~3x
  // faster than strtok_r's per-call delimiter-set walk; delimiter
  // runs are skipped exactly like strtok)
  char* f[11];
  char* p = line;
  char* lend = line + len;
  bool f0_last = false;   // f[0] ran to end of line (the
                          // reference's strtok token keeps '\n')
  for (int i = 0; i < 11; i++) {
    while (p < lend && *p == '\t') p++;
    if (p >= lend)
      fail(i == 0 ? std::string("\n")
           : (i == 1 && f0_last ? std::string(f[0]) + "\n"
                                : std::string(f[0])), ERRSAM);
    f[i] = p;
    char* t = (char*)memchr(p, '\t', (size_t)(lend - p));
    if (t) { *t = '\0'; p = t + 1; }
    else { p = lend; if (i == 0) f0_last = true; }
  }
  char* extra = p < lend ? p : nullptr;
  const char* qn = f[0];
  uint16_t flag = (uint16_t)get_long(f[1]);
  const char* rname = f[2];
  uint32_t pos = (uint32_t)(get_long(f[3]) - 1);
  uint8_t mapq = (uint8_t)get_long(f[4]);
  char* cigar = f[5];
  uint32_t pnext = (uint32_t)(get_long(f[7]) - 1);
  const char* seq = f[9];
  char* qual = f[10];
  size_t ql = strlen(qual);

  if (flag & 0x4) { c->ctr.unmapped++; return; }
  if ((qn[0] == '*' && !qn[1]) || (rname[0] == '*' && !rname[1]))
    fail(qn, ERRSAM);
  if (flag & 0xE00) { c->ctr.supp++; return; }
  int ci = cmap.find(rname);
  if (ci < 0) fail(rname, ERRCHROM);
  if (mapq < c->opt.min_mapq) { c->ctr.low_mapq++; return; }

  if (c->read_name.empty()
      || strcmp(qn, c->read_name.c_str()) != 0) {
    flush_group(c);
    c->read_name.assign(qn, strnlen(qn, MAX_ALNS));
  }
  int length = calc_dist(c->read_name, seq, cigar);
  float score = sam_score(extra);
  bool star = qual[0] == '*' && !qual[1];
  if (!parse_align(c, flag, ci, pos, length, pnext, score,
                   (const uint8_t*)qual, (int)ql, 33, star)
      && c->opt.verbose)
    warnf(c, false, "Warning! Read %s has more than %d alignments\n",
          c->read_name.c_str(), MAX_ALNS);
}

uint64_t read_sam_seq(Context* c, Reader& rd, char* first_line,
                      size_t first_len, const NameMap& cmap) {
  // sequential tail: first record line already read by the caller
  uint64_t count = 0;
  c->read_name.clear();
  char* line = first_line;
  size_t len = first_len;
  while (line != nullptr) {
    count++;
    parse_sam_line(c, line, len, cmap);
    line = rd.line();
    len = rd.last_len;
  }
  flush_group(c);
  c->read_name.clear();
  return count;
}

// Caller-thread walker for SAM: frames lines, replicates the
// pre-filters + group comparison of parse_sam_line to cut spans on
// group boundaries, and feeds run_parse_pool.
uint64_t read_sam_parallel(Context* c, Reader& rd, char* first_line,
                           size_t first_len, const NameMap& cmap,
                           int n_workers) {
  uint64_t count = 0;
  std::string prev;               // group name (MAX_ALNS-truncated)
  char* line = first_line;
  size_t len = first_len;
  bool line_ready = true;

  auto next_span = [&](std::string* out) -> bool {
    if (!line_ready) return false;
    out->clear();
    while (line_ready) {
      // classification: the same unmapped/supp/MAPQ filters and
      // truncated-name strcmp parse_sam_line applies; malformed
      // lines classify as irrelevant (the worker will fail there)
      bool relevant = false;
      const char* qn = nullptr;
      size_t qlen = 0;
      {
        const char* p = line;
        const char* lend = line + len;
        const char* f[5];
        size_t flen[5];
        int got = 0;
        for (int i = 0; i < 5; i++) {
          while (p < lend && *p == '\t') p++;
          if (p >= lend) break;
          f[i] = p;
          const char* t = (const char*)memchr(p, '\t',
                                              (size_t)(lend - p));
          flen[i] = t ? (size_t)(t - p) : (size_t)(lend - p);
          p = t ? t + 1 : lend;
          got++;
        }
        if (got == 5 && line[0] != '@') {
          // FLAG/MAPQ with exactly the worker's integer semantics
          // (get_long: strtol over the whole field, same uint16/uint8
          // truncation), so the walker's relevant/irrelevant verdict
          // can never diverge from parse_sam_line on a line the
          // worker accepts; a field get_long would reject classifies
          // as irrelevant — the worker's own fail() surfaces it
          char* endp;
          long lf = strtol(f[1], &endp, 10);
          bool ok = endp != f[1]
                    && (endp == f[1] + flen[1] || *endp == '\0');
          long lm = 0;
          if (ok) {
            lm = strtol(f[4], &endp, 10);
            ok = endp != f[4]
                 && (endp == f[4] + flen[4] || *endp == '\0');
          }
          if (ok) {
            uint16_t flag = (uint16_t)lf;
            uint8_t mapq = (uint8_t)lm;
            relevant = !(flag & 0x4) && !(flag & 0xE00)
                       && mapq >= c->opt.min_mapq;
          }
          qn = f[0];
          qlen = flen[0];
        }
      }
      if (relevant) {
        bool new_group = prev.empty() || qlen != prev.size()
                         || memcmp(qn, prev.data(), qlen) != 0;
        if (new_group) {
          if (out->size() >= span_bytes())
            return true;       // current line starts the next span
          prev.assign(qn, qlen < (size_t)MAX_ALNS ? qlen
                                                  : (size_t)MAX_ALNS);
        }
      }
      out->append(line, len);
      out->push_back('\n');
      count++;
      line = rd.line();
      if (!line) {
        line_ready = false;
        return !out->empty();
      }
      len = rd.last_len;
    }
    return !out->empty();
  };

  auto parse_span = [&](Context* s, std::string& bytes) {
    char* p = &bytes[0];
    char* end = p + bytes.size();
    while (p < end) {
      char* nl = (char*)memchr(p, '\n', (size_t)(end - p));
      size_t ll = (size_t)(nl - p);
      *nl = '\0';
      parse_sam_line(s, p, ll, cmap);
      p = nl + 1;
    }
  };

  run_parse_pool(c, n_workers, next_span, parse_span);
  c->read_name.clear();
  return count;
}

uint64_t read_sam(Context* c, Reader& rd) {
  char* line;
  NameMap cmap;              // built once the header is complete
  c->read_name.clear();
  while ((line = rd.line()) != nullptr) {
    if (line[0] == '@') {
      check_sam_header(c, line);
      continue;
    }
    break;                   // first record line
  }
  if (line == nullptr) return 0;
  cmap.build(c->chroms);
  int n_workers = parse_threads();
  if (n_workers >= 2)
    return read_sam_parallel(c, rd, line, rd.last_len, cmap,
                             n_workers);
  return read_sam_seq(c, rd, line, rd.last_len, cmap);
}

// ---- BAM parsing ----------------------------------------------------

int32_t read_i32(Reader& rd, bool end_required, bool* eof) {
  unsigned char b[4];
  if (!rd.read(b, 4)) {
    if (end_required) fail("", ERRBAM);
    *eof = true;
    return 0;
  }
  return (int32_t)(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24));
}

float bam_score(const uint8_t* extra, int len) {
  int i = 0;
  while (i < len - 4) {
    char t0 = (char)extra[i], t1 = (char)extra[i + 1];
    char val = (char)extra[i + 2];
    i += 3;
    if (t0 == 'A' && t1 == 'S') {
      switch (val) {
        case 'c': return (float)(int8_t)extra[i];
        case 'C': return (float)extra[i];
        case 's': return (float)(int16_t)(extra[i] | (extra[i+1] << 8));
        case 'S': return (float)(uint16_t)(extra[i] | (extra[i+1] << 8));
        case 'i': return (float)(int32_t)(extra[i] | (extra[i+1] << 8)
                      | (extra[i+2] << 16) | (extra[i+3] << 24));
        case 'I': return (float)(uint32_t)(extra[i] | (extra[i+1] << 8)
                      | (extra[i+2] << 16) | ((uint32_t)extra[i+3] << 24));
        default: {
          char msg[4] = {'\'', val, '\'', 0};
          fail(msg, ERRTYPE);
        }
      }
    }
    switch (val) {
      case 'A': case 'c': case 'C': i += 1; break;
      case 's': case 'S': i += 2; break;
      case 'i': case 'I': case 'f': i += 4; break;
      case 'Z': while (i < len && extra[i]) i++; i++; break;
      case 'H': while (i < len && extra[i]) i += 2; i++; break;
      case 'B': {
        char sub = (char)extra[i];
        int size;
        switch (sub) {
          case 'c': case 'C': size = 1; break;
          case 's': case 'S': size = 2; break;
          case 'i': case 'I': case 'f': size = 4; break;
          default: {
            char msg[4] = {'\'', sub, '\'', 0};
            fail(msg, ERRTYPE);
          }
        }
        int32_t cnt = (int32_t)(extra[i+1] | (extra[i+2] << 8)
                     | (extra[i+3] << 16) | (extra[i+4] << 24));
        i += 1 + 4 + size * cnt;
        break;
      }
      default: {
        char msg[4] = {'\'', val, '\'', 0};
        fail(msg, ERRTYPE);
      }
    }
    if (i > len) fail("", ERRAUX);
  }
  return NOSCORE;
}

// GENRICH_ABLATE=frame|fields cuts the record loop short for perf
// attribution (frame: BGZF+framing only; fields: +field decode and
// filters, no group processing).  Output is wrong under ablation —
// measurement only.
int ablate_mode() {
  static int mode = [] {
    const char* e = getenv("GENRICH_ABLATE");
    if (!e || !*e) return 0;
    if (!strcmp(e, "frame")) return 1;
    if (!strcmp(e, "fields")) return 2;
    return 0;
  }();
  return mode;
}

// one BAM alignment record (shared by the sequential reader and the
// parallel span workers); b points at the block body of block_size
// bytes, idx maps BAM ref ids -> registry chrom indices
void parse_bam_record(Context* c, const uint8_t* b,
                      int32_t block_size,
                      const std::vector<int>& idx) {
  int n_ref = (int)idx.size();
  auto rd32 = [&](int off) {
    return (int32_t)(b[off] | (b[off+1] << 8) | (b[off+2] << 16)
                     | ((uint32_t)b[off+3] << 24));
  };
  int32_t ref_id = rd32(0);
  int32_t pos = rd32(4);
  uint32_t bin_mq_nl = (uint32_t)rd32(8);
  int l_read_name = bin_mq_nl & 0xFF;
  uint8_t mapq = (bin_mq_nl >> 8) & 0xFF;
  uint32_t flag_nc = (uint32_t)rd32(12);
  int n_cigar = flag_nc & 0xFFFF;
  uint16_t flag = (flag_nc >> 16) & 0xFFFF;
  int32_t l_seq = rd32(16);
  int32_t next_pos = rd32(24);
  int off = 32;
  const char* rn = (const char*)b + off;
  size_t rl = strnlen(rn, l_read_name);
  off += l_read_name;
  const uint8_t* cigar = b + off;
  off += n_cigar * 4;
  off += (l_seq + 1) / 2;
  const uint8_t* qual = b + off;
  off += l_seq;
  if (off > block_size) fail("", ERRBAM);
  const uint8_t* extra = b + off;
  int extra_len = block_size - off;

  if (flag & 0x4) { c->ctr.unmapped++; return; }
  if ((rl == 1 && rn[0] == '*') || ref_id < 0 || ref_id >= n_ref
      || idx[ref_id] < 0 || idx[ref_id] >= (int)c->chroms.size()
      || pos < 0)
    fail(std::string(rn, rl), ERRSAM);
  if (flag & 0xE00) { c->ctr.supp++; return; }
  if (mapq < c->opt.min_mapq) { c->ctr.low_mapq++; return; }

  // full name vs the MAX_ALNS-truncated stored one, like the
  // reference's strcmp against its char[MAX_ALNS] buffer
  if (ablate_mode() == 2) {      // fields decoded; skip processing
    float s_ = bam_score(extra, extra_len);
    (void)s_;
    return;
  }
  if (c->read_name.size() != rl
      || memcmp(rn, c->read_name.data(), rl) != 0) {
    flush_group(c);
    c->read_name.assign(rn, rl < (size_t)MAX_ALNS
                        ? rl : (size_t)MAX_ALNS);
  }
  // calcDistBAM
  int length = l_seq;
  for (int k = 0; k < n_cigar; k++) {
    uint32_t cg = cigar[4*k] | (cigar[4*k+1] << 8)
                | (cigar[4*k+2] << 16)
                | ((uint32_t)cigar[4*k+3] << 24);
    uint32_t op = cg & 0xF, opl = cg >> 4;
    if (op == 1 || op == 4) length -= opl;
    else if (op == 2) length += opl;
  }
  float score = bam_score(extra, extra_len);
  bool star = l_seq >= 1 && qual[0] == '*'
              && (l_seq < 2 || qual[1] == 0);
  if (!parse_align(c, flag, idx[ref_id], (uint32_t)pos, length,
                   (uint32_t)next_pos, score, qual, l_seq, 0, star)
      && c->opt.verbose)
    warnf(c, false, "Warning! Read %s has more than %d alignments\n",
          c->read_name.c_str(), MAX_ALNS);
}

// Caller-thread walker for BAM: frames size-prefixed records,
// replicates parse_bam_record's pre-filters + truncated-name
// comparison for group detection, cuts spans on group boundaries.
uint64_t read_bam_parallel(Context* c, Reader& rd,
                           const std::vector<int>& idx,
                           int n_workers) {
  uint64_t count = 0;
  std::string prev;
  std::string carry;      // consumed record belonging to the next span
  bool at_eof = false;

  auto next_span = [&](std::string* out) -> bool {
    if (at_eof && carry.empty()) return false;
    out->clear();
    if (!carry.empty()) {
      out->swap(carry);
      carry.clear();
    }
    for (;;) {
      bool eof = false;
      int32_t bs = read_i32(rd, false, &eof);
      if (eof) { at_eof = true; return !out->empty(); }
      if (bs < (int32_t)(6 * 4 + 2 * 4)) fail("", ERRBAM);
      const uint8_t* b = rd.take((size_t)bs);
      if (!b) fail("", ERRBAM);
      count++;
      uint32_t bin_mq_nl = (uint32_t)(b[8] | (b[9] << 8)
                 | (b[10] << 16) | ((uint32_t)b[11] << 24));
      int l_read_name = bin_mq_nl & 0xFF;
      uint8_t mapq = (bin_mq_nl >> 8) & 0xFF;
      uint16_t flag = (uint16_t)(b[14] | (b[15] << 8));
      bool relevant = !(flag & 0x4) && !(flag & 0xE00)
                      && mapq >= c->opt.min_mapq;
      bool cut = false;
      if (relevant) {
        const char* rn = (const char*)b + 32;
        size_t rl = strnlen(rn, l_read_name);
        if (prev.size() != rl || memcmp(rn, prev.data(), rl) != 0) {
          prev.assign(rn, rl < (size_t)MAX_ALNS ? rl
                                                : (size_t)MAX_ALNS);
          cut = out->size() >= span_bytes();
        }
      }
      std::string* dst = cut ? &carry : out;
      uint32_t bs_le = (uint32_t)bs;
      dst->append((const char*)&bs_le, 4);
      dst->append((const char*)b, (size_t)bs);
      if (cut) return true;
    }
  };

  auto parse_span = [&](Context* s, std::string& bytes) {
    const uint8_t* p = (const uint8_t*)bytes.data();
    const uint8_t* end = p + bytes.size();
    while (p < end) {
      uint32_t bs;
      memcpy(&bs, p, 4);
      p += 4;
      parse_bam_record(s, p, (int32_t)bs, idx);
      p += bs;
    }
  };

  run_parse_pool(c, n_workers, next_span, parse_span);
  c->read_name.clear();
  return count;
}

uint64_t read_bam(Context* c, Reader& rd) {
  bool eof = false;
  int32_t l_text = read_i32(rd, true, &eof);
  std::vector<char> text(l_text + 1);
  if (l_text > 0 && !rd.read(text.data(), l_text))
    fail("", ERRBAM);
  text[l_text] = '\0';
  // first line: @HD, SO check
  char* nl = strchr(text.data(), '\n');
  if (nl) *nl = '\0';
  {
    char* save;
    char* tag = strtok_r(text.data(), "\t", &save);
    if (!tag || strcmp(tag, "@HD")) fail("", ERRBAM);
    const char* order = nullptr;
    for (char* f = strtok_r(nullptr, "\t", &save); f;
         f = strtok_r(nullptr, "\t", &save))
      if (!strncmp(f, "SO:", 3)) order = f + 3;
    if (c->opt.sort_opt && (!order || strcmp(order, "queryname")))
      fail("", ERRSORT);
  }
  int32_t n_ref = read_i32(rd, true, &eof);
  std::vector<int> idx(n_ref);
  for (int i = 0; i < n_ref; i++) {
    int32_t l_name = read_i32(rd, true, &eof);
    if (l_name < 1 || (size_t)l_name > MAX_LINE) fail("", ERRBAM);
    std::vector<char> nb(l_name);
    if (!rd.read(nb.data(), l_name)) fail("", ERRBAM);
    if (nb[l_name - 1] != '\0') fail("", ERRBAM);
    uint32_t l_ref = (uint32_t)read_i32(rd, true, &eof);
    idx[i] = save_chrom(c, nb.data(), l_ref);
  }

  int n_workers = parse_threads();
  uint64_t count;
  if (n_workers >= 1)
    count = read_bam_parallel(c, rd, idx, n_workers);
  else {
    count = 0;
    c->read_name.clear();
    for (;;) {
      eof = false;
      int32_t block_size = read_i32(rd, false, &eof);
      if (eof) break;
      if (block_size < (int32_t)(6 * 4 + 2 * 4)) fail("", ERRBAM);
      // parse in place from the reader buffer (no per-record copy);
      // nothing below retains pointers past this iteration
      const uint8_t* b = rd.take((size_t)block_size);
      if (!b) fail("", ERRBAM);
      count++;
      if (ablate_mode() == 1) continue;       // frame-only probe
      parse_bam_record(c, b, block_size, idx);
    }
    flush_group(c);
    c->read_name.clear();
  }
  return count;
}

}  // namespace

// ---- C API ----------------------------------------------------------

extern "C" {

void* gi_create() { return new Context(); }

void gi_destroy(void* h) { delete (Context*)h; }

const char* gi_error_msg(void* h) {
  return ((Context*)h)->err_msg.c_str();
}
int gi_error_code(void* h) { return ((Context*)h)->err_code; }

void gi_add_xchr(void* h, const char* name) {
  ((Context*)h)->xchr.push_back(name);
}

void gi_add_xbed(void* h, const char* name, uint32_t p0, uint32_t p1) {
  ((Context*)h)->xbed.push_back({name, p0, p1});
}

void gi_set_options(void* h, int single_opt, int extend_opt,
                    int32_t extend, int avg_ext_opt, int atac_opt,
                    int atac_adj, int32_t atac_len5, int32_t atac_len3,
                    int32_t min_mapq, float as_diff, int dups_opt,
                    int sort_opt, int verbose) {
  Options& o = ((Context*)h)->opt;
  o.single_opt = single_opt;
  o.extend_opt = extend_opt;
  o.extend = extend;
  o.avg_ext_opt = avg_ext_opt;
  o.atac_opt = atac_opt;
  o.atac_adj = atac_adj;
  o.atac_len5 = atac_len5;
  o.atac_len3 = atac_len3;
  o.min_mapq = min_mapq;
  o.as_diff = as_diff;
  o.dups_opt = dups_opt;
  o.sort_opt = sort_opt;
  o.verbose = verbose;
}

void gi_reset_save(void* h) {
  for (auto& ch : ((Context*)h)->chroms) ch.save = false;
}

// returns record count, or -1 on error (query gi_error_*)
int64_t gi_parse(void* h, const char* path, int is_bam_hint, int ctrl,
                 int sample, const char* bed_path, int bed_gz,
                 const char* dups_path, int dups_gz) {
  Context* c = (Context*)h;
  c->ctrl = ctrl;
  c->sample = sample;
  c->ctr = Counters();
  for (auto& ev : c->events) { ev.start.clear(); ev.end.clear();
                               ev.count.clear(); }
  c->unpair.clear();
  c->reads_pr.clear();
  c->reads_dc.clear();
  c->reads_sn.clear();
  c->alns.clear();
  c->qual_r1 = c->qual_r2 = 0;

  c->bed_out = nullptr; c->bed_out_f = nullptr;
  c->dups_out = nullptr; c->dups_out_f = nullptr;
  if (bed_path && bed_path[0]) {
    if (bed_gz) c->bed_out = gzopen(bed_path, "ab");
    else c->bed_out_f = fopen(bed_path, "a");
  }
  if (dups_path && dups_path[0]) {
    if (dups_gz) c->dups_out = gzopen(dups_path, "ab");
    else c->dups_out_f = fopen(dups_path, "a");
  }

  int64_t count = -1;
  try {
    Reader rd(path);
    if (!rd.valid()) fail(path, ERROPEN);
    // peek magic (both the zlib and BGZF-MT paths decompress
    // transparently); consume it only for BAM, whose reader starts
    // at l_text
    unsigned char magic[4];
    size_t n = rd.peek(magic, 4);
    bool bam = (n == 4 && !memcmp(magic, "BAM\1", 4));
    if (bam) rd.read(magic, 4);
    const bool prof = getenv("GENRICH_NATIVE_PROF") != nullptr;
    auto t0 = std::chrono::steady_clock::now();
    count = bam ? (int64_t)read_bam(c, rd) : (int64_t)read_sam(c, rd);
    c->ctr.count = (uint64_t)count;
    auto t1 = std::chrono::steady_clock::now();
    if (c->opt.dups_opt) {
      find_dups(c);
      // the stores exist only for dedup; release them now so the
      // numeric phase doesn't carry GBs of dead read metadata
      c->reads_pr.release();
      c->reads_dc.release();
      c->reads_sn.release();
    } else if (c->opt.avg_ext_opt) {
      process_avg_ext(c);
    }
    auto t2 = std::chrono::steady_clock::now();
    if (prof) {
      fprintf(stderr, "[native] records: %.3fs  post(find_dups): %.3fs\n",
              std::chrono::duration<double>(t1 - t0).count(),
              std::chrono::duration<double>(t2 - t1).count());
      c->prof_records_s = std::chrono::duration<double>(t1 - t0).count();
      c->prof_dedup_s = std::chrono::duration<double>(t2 - t1).count();
    }
  } catch (const IngestError& e) {
    c->err_code = e.code;
    c->err_msg = e.msg;
    count = -1;
  }
  if (c->bed_out) gzclose(c->bed_out);
  if (c->bed_out_f) fclose(c->bed_out_f);
  if (c->dups_out) gzclose(c->dups_out);
  if (c->dups_out_f) fclose(c->dups_out_f);
  c->bed_out = nullptr; c->bed_out_f = nullptr;
  c->dups_out = nullptr; c->dups_out_f = nullptr;
  return count;
}

int gi_chrom_count(void* h) {
  return (int)((Context*)h)->chroms.size();
}
const char* gi_chrom_name(void* h, int i) {
  return ((Context*)h)->chroms[i].name.c_str();
}
uint32_t gi_chrom_len(void* h, int i) {
  return ((Context*)h)->chroms[i].len;
}
int gi_chrom_skip(void* h, int i) {
  return ((Context*)h)->chroms[i].skip;
}
int gi_chrom_save(void* h, int i) {
  return ((Context*)h)->chroms[i].save;
}
int gi_chrom_bed_len(void* h, int i) {
  return (int)((Context*)h)->chroms[i].bed.size();
}
void gi_chrom_bed(void* h, int i, uint32_t* out) {
  auto& bed = ((Context*)h)->chroms[i].bed;
  memcpy(out, bed.data(), bed.size() * sizeof(uint32_t));
}

int64_t gi_event_count(void* h, int ci) {
  return (int64_t)((Context*)h)->events[ci].start.size();
}
void gi_events(void* h, int ci, int64_t* start, int64_t* end,
               int32_t* count) {
  EventBuf& ev = ((Context*)h)->events[ci];
  memcpy(start, ev.start.data(), ev.start.size() * sizeof(int64_t));
  memcpy(end, ev.end.data(), ev.end.size() * sizeof(int64_t));
  memcpy(count, ev.count.data(), ev.count.size() * sizeof(int32_t));
}

void gi_counters(void* h, uint64_t* u, double* total_len) {
  Counters& c = ((Context*)h)->ctr;
  uint64_t vals[] = {c.count, c.unmapped, c.paired, c.single_,
                     c.orphan, c.paired_pr, c.single_pr, c.supp,
                     c.skipped, c.low_mapq, c.sec_pair, c.sec_single,
                     c.count_pr, c.dups_pr, c.count_dc, c.dups_dc,
                     c.count_sn, c.dups_sn, c.err_count};
  memcpy(u, vals, sizeof vals);
  *total_len = c.total_len;
}

}  // extern "C"

// ---- numeric helpers (exact-order reductions for the engine) --------

extern "C" {

// double += (float)term sequential accumulation (C operation order)
double gi_exact_sum_f32(const float* terms, int64_t n) {
  double total = 0.0;
  for (int64_t i = 0; i < n; i++) total += terms[i];
  return total;
}

// elementwise libm log10f (this glibc's log10f is not correctly
// rounded; parity requires the real function)
void gi_log10f(const float* in, float* out, int64_t n) {
  for (int64_t i = 0; i < n; i++) out[i] = log10f(in[i]);
}

}  // extern "C"

// ---- breakpoint construction (engine pileup hot path) ---------------
//
// Converts one chromosome's events into sorted unique positions with
// cumulative per-class sums (the numpy engine's _nonzero_entries,
// engine/pileup.py) — identical integer math, native speed.

namespace {
struct BpState {
  std::vector<int64_t> pos;
  std::vector<float> val;
};
thread_local BpState g_bp;

// raw per-class contributions by count code (see engine/pileup.py)
const int8_t ADD_TBL[11][4] = {
  {0,0,0,0},{1,0,0,0},{0,4,0,0},{0,0,2,0},{0,2,0,0},{0,0,0,2},
  {0,0,1,0},{0,0,0,0},{0,1,0,0},{0,0,0,0},{0,0,0,1}};
const int8_t SUB_TBL[11][4] = {
  {0,0,0,0},{-1,0,0,0},{-1,4,0,0},{-1,4,1,0},{-1,6,0,0},{-1,4,0,3},
  {-1,4,2,0},{0,0,0,0},{-1,7,0,0},{0,0,0,0},{-1,4,0,4}};
}  // namespace

extern "C" {

// compute breakpoints for chrom ci; returns the number of
// canonical-nonzero entries (fetch with gi_breakpoints_fetch)
static int64_t bp_compute(const int64_t* starts,
                          const int64_t* ends, const int32_t* counts,
                          size_t n);

int64_t gi_breakpoints(void* h, int ci) {
  Context* c = (Context*)h;
  EventBuf& ev = c->events[ci];
  return bp_compute(ev.start.data(), ev.end.data(), ev.count.data(),
                    ev.start.size());
}

int64_t gi_breakpoints_arrays(const int64_t* starts,
                              const int64_t* ends,
                              const int32_t* counts, int64_t n) {
  return bp_compute(starts, ends, counts, (size_t)n);
}

static int64_t bp_compute(const int64_t* starts, const int64_t* ends,
                          const int32_t* counts, size_t n) {
  // events as packed u64 keys (pos << 5 | sub << 4 | count): ties in
  // position sum commutatively, so an unstable order is fine and an
  // LSD radix sort runs ~5x faster than std::sort on 16-byte structs
  std::vector<uint64_t> pts;
  pts.reserve(2 * n);
  uint64_t max_key = 0;
  for (size_t i = 0; i < n; i++) {
    uint64_t c = (uint64_t)(uint32_t)counts[i] & 0xF;
    uint64_t a = ((uint64_t)starts[i] << 5) | c;
    uint64_t b = ((uint64_t)ends[i] << 5) | 0x10 | c;
    pts.push_back(a);
    pts.push_back(b);
    if (b > max_key) max_key = b;
  }
  {
    std::vector<uint64_t> tmp(pts.size());
    int bits = 1;
    while ((max_key >> bits) && bits < 64) bits++;
    for (int shift = 0; shift < bits; shift += 8) {
      size_t cnt[257] = {0};
      for (uint64_t x : pts) cnt[((x >> shift) & 0xFF) + 1]++;
      for (int i = 0; i < 256; i++) cnt[i + 1] += cnt[i];
      for (uint64_t x : pts) tmp[cnt[(x >> shift) & 0xFF]++] = x;
      pts.swap(tmp);
    }
  }

  BpState& bp = g_bp;
  bp.pos.clear(); bp.val.clear();
  int64_t t0 = 0, t1 = 0, t2 = 0, t3 = 0;   // running cumulative sums
  size_t i = 0;
  // C++ % keeps sign; emulate python floor semantics for negatives
  auto fmod4 = [](int64_t v, int64_t m) {
    int64_t r = v % m; return r < 0 ? r + m : r; };
  auto fdiv = [](int64_t v, int64_t m) {
    return (v >= 0) ? v / m : -(( -v + m - 1) / m); };
  while (i < pts.size()) {
    int64_t p = (int64_t)(pts[i] >> 5);
    int64_t d0 = 0, d1 = 0, d2 = 0, d3 = 0;
    for (; i < pts.size() && (int64_t)(pts[i] >> 5) == p; i++) {
      const int8_t* t = (pts[i] & 0x10) ? SUB_TBL[pts[i] & 0xF]
                                        : ADD_TBL[pts[i] & 0xF];
      d0 += t[0]; d1 += t[1]; d2 += t[2]; d3 += t[3];
    }
    t0 += d0; t1 += d1; t2 += d2; t3 += d3;
    // canonical-nonzero test on the per-position delta
    int64_t halves = fdiv(d1, 4) + fdiv(d2, 3) + fdiv(d3, 5);
    int64_t e = fmod4(d1, 4), s = fmod4(d2, 3), tt = fmod4(d3, 5);
    bool nz = e != 0 || s != 0 || tt != 0 || fmod4(halves, 2) != 0
              || (d0 + fdiv(halves, 2)) != 0;
    if (nz) {
      bp.pos.push_back(p);
      // getVal (Genrich.c:1902-1907) on the cumulative sums: same
      // float32 op order as engine.pileup.canon_value_f32
      // (class cumsums t1..t3 are nonnegative by construction)
      int64_t ch = t1 / 4 + t2 / 3 + t3 / 5;
      float v = (float)(int32_t)(t0 + ch / 2);
      v = v + (float)(int32_t)(t1 % 4 + 4 * (ch % 2)) / 8.0f;
      v = v + (float)(int32_t)(t2 % 3) / 6.0f;
      v = v + (float)(int32_t)(t3 % 5) / 10.0f;
      bp.val.push_back(v);
    }
  }
  return (int64_t)bp.pos.size();
}

void gi_breakpoints_fetch(void* h, int64_t* pos, float* val) {
  (void)h;
  BpState& bp = g_bp;
  size_t n = bp.pos.size();
  memcpy(pos, bp.pos.data(), n * sizeof(int64_t));
  memcpy(val, bp.val.data(), n * sizeof(float));
}

}  // extern "C"

// ---- exact-order peak calling (engine/peaks.py hot loop) -------------
//
// Streaming replication of callPeaks/updatePeak/checkPeak
// (Genrich.c:977-1069): sequential float32 AUC accumulation, summit
// tie-breaking (p/q from the first max-stat interval, position from
// the first longest one), SKIP hard breaks, gap joining.  The numpy
// engine's per-interval Python loop costs ~4 us/interval; this runs
// the same arithmetic at native speed.

extern "C" {

int64_t gi_call_peaks(const float* stat, const float* pval,
                      const float* qval,          // null -> -1 column
                      const int64_t* ends, int64_t n,
                      float min_pq, float min_auc,
                      int64_t min_len, int64_t max_gap,
                      int64_t* o_start, int64_t* o_end, float* o_auc,
                      float* o_spv, float* o_sqv, int64_t* o_spos,
                      int64_t cap) {
  int64_t count = 0;
  bool have = false;
  int64_t peak_start = 0, peak_end = 0;
  float auc = 0.0f;
  float summit_val = -1.0f, summit_pv = -1.0f, summit_qv = -1.0f;
  uint32_t summit_pos = 0;
  int64_t summit_len = 0;

  int64_t start = 0;
  for (int64_t m = 0; m <= n; m++) {
    bool flush;
    if (m == n) {
      flush = true;
    } else {
      int64_t end = ends[m];
      float pq = stat[m];
      flush = false;
      if (pq > min_pq) {
        if (have && start - peak_end > max_gap) {
          // too far: finalize the open peak first
          if (auc >= min_auc && peak_end - peak_start >= min_len) {
            if (count < cap) {
              o_start[count] = peak_start; o_end[count] = peak_end;
              o_auc[count] = auc; o_spv[count] = summit_pv;
              o_sqv[count] = summit_qv;
              o_spos[count] = (int64_t)summit_pos;
            }
            count++;
          }
          have = false;
        }
        if (!have) {
          have = true;
          peak_start = start;
          auc = 0.0f;
          summit_val = -1.0f; summit_pv = -1.0f; summit_qv = -1.0f;
          summit_pos = 0; summit_len = 0;
        }
        peak_end = end;
        int64_t length = end - start;
        float lf = (float)(uint32_t)length;
        float diff = pq - min_pq;
        float prod = lf * diff;
        auc = auc + prod;
        if (pq > summit_val) {
          summit_val = pq;
          summit_pv = pval[m];
          summit_qv = qval ? qval[m] : -1.0f;
          summit_pos = (uint32_t)(uint64_t)(end + start) / 2
                       - (uint32_t)peak_start;
          summit_len = length;
        } else if (pq == summit_val && length > summit_len) {
          summit_pos = (uint32_t)(uint64_t)(end + start) / 2
                       - (uint32_t)peak_start;
          summit_len = length;
        }
      } else if (pq == -1.0f) {
        flush = true;               // SKIP hard-breaks peaks
      }
      start = end;
    }
    if (flush && have) {
      if (auc >= min_auc && peak_end - peak_start >= min_len) {
        if (count < cap) {
          o_start[count] = peak_start; o_end[count] = peak_end;
          o_auc[count] = auc; o_spv[count] = summit_pv;
          o_sqv[count] = summit_qv; o_spos[count] = (int64_t)summit_pos;
        }
        count++;
      }
      have = false;
    }
  }
  return count;
}

}  // extern "C"

// ---- peaks-only re-analysis from a -f log (-P fast path) -------------
//
// Streaming replication of callPeaksLog (Genrich.c:1277-1488) for the
// common resume case: no post-hoc -e/-E exclusions.  Any anomaly
// (short row, empty field, parse failure) returns -1 and the Python
// state machine (genrich_tpu/logreader.py) re-runs the file from
// scratch so error output stays byte-identical.

namespace {
struct LogPeaks {
  std::vector<std::string> names;     // one per chromosome section
  std::vector<int32_t> sec;
  std::vector<int64_t> start, end, spos;
  std::vector<float> auc, spv, sqv;
  int64_t genome_len = 0, peak_bp = 0;
};
thread_local LogPeaks g_lp;
}  // namespace

extern "C" {

int64_t gi_call_peaks_log(const char* path, int32_t idx_p,
                          int32_t idx_q, int use_q, float min_pq,
                          float min_auc, int64_t min_len,
                          int64_t max_gap, int genome_opt) {
  LogPeaks& lp = g_lp;
  lp = LogPeaks();
  Reader rd(path);
  if (!rd.valid()) return -1;
  if (!rd.line()) return -1;          // header (validated in Python)

  int32_t idx_max = use_q && idx_q > idx_p ? idx_q : idx_p;

  // peak state (mirrors logreader._PeakState)
  int64_t peak_start = -1, peak_end = -1;
  float auc = 0.0f, summit_val = -1.0f;
  float summit_pv = -1.0f, summit_qv = -1.0f;
  int64_t summit_len = 0;
  uint32_t summit_pos = 0;
  int32_t cur_sec = -1;

  auto check = [&](int32_t s) {
    if (peak_start != -1 && auc >= min_auc
        && peak_end - peak_start >= min_len) {
      lp.sec.push_back(s);
      lp.start.push_back(peak_start);
      lp.end.push_back(peak_end);
      lp.auc.push_back(auc);
      lp.spv.push_back(summit_pv);
      lp.sqv.push_back(summit_qv);
      lp.spos.push_back((int64_t)summit_pos);
      lp.peak_bp += peak_end - peak_start;
    }
  };
  auto reset = [&]() {
    peak_start = -1;
    summit_val = -1.0f; summit_pv = -1.0f; summit_qv = -1.0f;
    summit_len = 0; summit_pos = 0; auc = 0.0f;
  };

  std::string prev;
  char* line;
  while ((line = rd.line()) != nullptr) {
    // split on tabs, keeping empty fields (any empty field bails)
    char* f[64];
    int nf = 0;
    char* p = line;
    char* lend = line + rd.last_len;
    while (nf < 64) {
      f[nf++] = p;
      char* t = (char*)memchr(p, '\t', (size_t)(lend - p));
      if (!t) break;
      *t = '\0';
      p = t + 1;
    }
    if (nf == 64) return -1;        // oversized row: Python path
    if (nf <= idx_max || nf < 3) return -1;
    if (!f[0][0] || !f[1][0] || !f[2][0]) return -1;

    char* endp;
    long long sv = strtoll(f[1], &endp, 10);
    if (endp == f[1] || *endp) return -1;
    long long ev = strtoll(f[2], &endp, 10);
    if (endp == f[2] || *endp) return -1;
    uint32_t start = (uint32_t)sv;
    uint32_t end = (uint32_t)ev;

    if (prev.empty() || strcmp(f[0], prev.c_str()) != 0) {
      check(cur_sec);
      reset();
      lp.names.emplace_back(f[0]);
      cur_sec = (int32_t)lp.names.size() - 1;
      prev = f[0];
    }

    const char* stat = f[use_q ? idx_q : idx_p];
    if (!strcmp(stat, "NA")) {
      check(cur_sec);
      reset();
      continue;
    }
    float pqval = strtof(stat, &endp);
    if (endp == stat || *endp) return -1;

    if (genome_opt) lp.genome_len += (int64_t)end - (int64_t)start;
    if (pqval > min_pq) {
      // updatePeak (Genrich.c:943-970) in float32
      uint32_t length = end - start;
      float lf = (float)length;
      float diff = pqval - min_pq;
      float prod = lf * diff;
      auc = auc + prod;
      if (peak_start == -1) peak_start = (int64_t)start;
      peak_end = (int64_t)end;
      float pv, qv;
      if (use_q) {
        pv = strtof(f[idx_p], &endp);
        if (endp == f[idx_p] || *endp) return -1;
        qv = pqval;
      } else {
        pv = pqval;
        qv = -1.0f;
      }
      if (pqval > summit_val) {
        summit_val = pqval;
        summit_pv = pv;
        summit_qv = qv;
        summit_pos = (start + end) / 2 - (uint32_t)peak_start;
        summit_len = (int64_t)length;
      } else if (pqval == summit_val && (int64_t)length > summit_len) {
        summit_pos = (start + end) / 2 - (uint32_t)peak_start;
        summit_len = (int64_t)length;
      }
    } else if ((int64_t)end - peak_end > max_gap) {
      check(cur_sec);
      reset();
    }
  }
  check(cur_sec);
  return (int64_t)lp.sec.size();
}

int32_t gi_log_section_count() {
  return (int32_t)g_lp.names.size();
}

const char* gi_log_section_name(int32_t i) {
  return g_lp.names[(size_t)i].c_str();
}

void gi_log_peaks_fetch(int32_t* sec, int64_t* start, int64_t* end,
                        float* auc, float* spv, float* sqv,
                        int64_t* spos, int64_t* genome_len,
                        int64_t* peak_bp) {
  LogPeaks& lp = g_lp;
  size_t n = lp.sec.size();
  memcpy(sec, lp.sec.data(), n * sizeof(int32_t));
  memcpy(start, lp.start.data(), n * sizeof(int64_t));
  memcpy(end, lp.end.data(), n * sizeof(int64_t));
  memcpy(auc, lp.auc.data(), n * sizeof(float));
  memcpy(spv, lp.spv.data(), n * sizeof(float));
  memcpy(sqv, lp.sqv.data(), n * sizeof(float));
  memcpy(spos, lp.spos.data(), n * sizeof(int64_t));
  *genome_len = lp.genome_len;
  *peak_bp = lp.peak_bp;
}

}  // extern "C"

// ---- bulk log-row writers (-f / -k, printInterval/printPile) ---------
//
// The Python writers format one row at a time (~2 us/row); these
// append whole per-chromosome blocks with fprintf/gzprintf, using the
// exact reference formats (Genrich.c:770-803, 1697-1715).  Appending
// to gzip paths adds a new member per block; decompressed content is
// identical to the reference's single-member stream.

extern "C" {

int64_t gi_append_text(const char* path, int gz, const char* data,
                       int64_t len) {
  if (gz) {
    gzFile f = gzopen(path, "ab");
    if (!f) return -1;
    int64_t done = 0;
    while (done < len) {
      int chunk = (int)((len - done) > (1 << 28) ? (1 << 28)
                                                 : (len - done));
      if (gzwrite(f, data + done, (unsigned)chunk) != chunk) {
        gzclose(f);
        return -1;
      }
      done += chunk;
    }
    gzclose(f);
  } else {
    FILE* f = fopen(path, "ab");
    if (!f) return -1;
    if (len && fwrite(data, 1, (size_t)len, f) != (size_t)len) {
      fclose(f);
      return -1;
    }
    fclose(f);
  }
  return 0;
}

static void row_common(char* buf, int* off, const char* name,
                       int64_t start, int64_t end) {
  *off = sprintf(buf, "%s\t%d\t%d\t", name,
                 (int32_t)(uint32_t)start, (int32_t)(uint32_t)end);
}

int64_t gi_write_log_rows(const char* path, int gz, const char* name,
                          const int64_t* starts, const int64_t* ends,
                          const float* expt, const float* ctrl,
                          const float* pval, const float* qval,
                          const uint8_t* sig, int64_t n) {
  gzFile zf = nullptr;
  FILE* f = nullptr;
  if (gz) { zf = gzopen(path, "ab"); if (!zf) return -1; }
  else { f = fopen(path, "ab"); if (!f) return -1; }
  char buf[4096];
  for (int64_t m = 0; m < n; m++) {
    int off;
    row_common(buf, &off, name, starts[m], ends[m]);
    if (ctrl[m] == -1.0f) {
      off += sprintf(buf + off, "%f\t%f\tNA", (double)expt[m], 0.0);
      if (qval) off += sprintf(buf + off, "\tNA");
    } else {
      off += sprintf(buf + off, "%f\t%f\t%f", (double)expt[m],
                     (double)ctrl[m], (double)pval[m]);
      if (qval) off += sprintf(buf + off, "\t%f", (double)qval[m]);
      if (sig && sig[m]) off += sprintf(buf + off, "\t*");
    }
    buf[off++] = '\n';
    if (gz) { if (gzwrite(zf, buf, (unsigned)off) != off) break; }
    else fwrite(buf, 1, (size_t)off, f);
  }
  if (zf) gzclose(zf);
  if (f) fclose(f);
  return 0;
}

int64_t gi_write_pile_rows(const char* path, int gz, const char* name,
                           const int64_t* starts, const int64_t* ends,
                           const float* expt, const float* ctrl,
                           const float* pval, int64_t n) {
  gzFile zf = nullptr;
  FILE* f = nullptr;
  if (gz) { zf = gzopen(path, "ab"); if (!zf) return -1; }
  else { f = fopen(path, "ab"); if (!f) return -1; }
  char buf[4096];
  for (int64_t m = 0; m < n; m++) {
    int off;
    row_common(buf, &off, name, starts[m], ends[m]);
    if (ctrl[m] == -1.0f)
      off += sprintf(buf + off, "%f\t%f\tNA", (double)expt[m], 0.0);
    else
      off += sprintf(buf + off, "%f\t%f\t%f", (double)expt[m],
                     (double)ctrl[m], (double)pval[m]);
    buf[off++] = '\n';
    if (gz) { if (gzwrite(zf, buf, (unsigned)off) != off) break; }
    else fwrite(buf, 1, (size_t)off, f);
  }
  if (zf) gzclose(zf);
  if (f) fclose(f);
  return 0;
}

// Fused distinct-pair index + BH length accumulation for the exact
// engine's p-value stage (savePval + hashPval, Genrich.c:1720-1794,
// 300-327).  Inputs: per-interval packed (expt, ctrl) u64 keys in RLE
// row order, the sorted distinct table uk (numpy unique of the same
// keys), and the interval end coordinates.  Outputs: idx[i] with
// uk[idx[i]] == keys[i], and bp[j] = total interval length mapped to
// distinct pair j (double; genome bp < 2^53 so the sum is exact).
// Replaces numpy's searchsorted(uk, key) — a log2(d)-level binary
// search per row whose lower levels miss cache — plus a diff/astype/
// bincount chain, with one hash probe per row.  Returns 0, or -1 if a
// key is missing from uk (caller falls back to numpy).
int gi_pair_index_tab(const uint64_t* keys, int64_t n,
                      const uint64_t* uk, int64_t d,
                      const int64_t* ends, uint32_t* idx_out,
                      double* bp_out) {
  size_t cap = 64;
  while (cap < 2 * (size_t)d + 16) cap <<= 1;
  const size_t mask = cap - 1;
  struct Slot { uint64_t k; uint32_t v; };
  std::vector<Slot> tab(cap, Slot{0, UINT32_MAX});
  auto mix = [](uint64_t x) {
    x *= 0x9E3779B97F4A7C15ull;
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27; x *= 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  };
  for (int64_t j = 0; j < d; j++) {
    size_t i = mix(uk[j]) & mask;
    while (tab[i].v != UINT32_MAX) i = (i + 1) & mask;
    tab[i] = Slot{uk[j], (uint32_t)j};
  }
  for (int64_t j = 0; j < d; j++) bp_out[j] = 0.0;
  int64_t prev = 0;
  for (int64_t r = 0; r < n; r++) {
    const uint64_t k = keys[r];
    if (r + 8 < n) __builtin_prefetch(&tab[mix(keys[r + 8]) & mask]);
    size_t i = mix(k) & mask;
    for (;;) {
      if (tab[i].k == k && tab[i].v != UINT32_MAX) break;
      if (tab[i].v == UINT32_MAX) return -1;
      i = (i + 1) & mask;
    }
    const uint32_t j = tab[i].v;
    idx_out[r] = j;
    bp_out[j] += (double)(ends[r] - prev);
    prev = ends[r];
  }
  return 0;
}

}  // extern "C"
