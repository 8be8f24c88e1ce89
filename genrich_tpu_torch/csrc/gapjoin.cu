// gap_join: the gap-join of callPeaks.  Which interval rows are
// significant, which of them open a new peak, and each candidate peak's
// first row and last significant row, compacted at the end of K slots.
//
// Replaces the gap-join of genrich_tpu/ops/peaks_jax.py::call_peaks
// (:54-89: four cummax and two cumsum passes over the rows) and its
// top_k compaction of the candidates (:107-111); in the port, the plain
// version ops/peaks.py::peak_candidates_plain.  Semantics (callPeaks,
// Genrich.c:977-1069), per row i in genomic order:
//   live' = live && ends - starts > 0 (int32, wrapping);
//   sig   = live' && stat > min_pq (float32); skp = live' && stat == SKIP;
//   a sig row joins the peak before it iff the largest end e among the
//   sig rows before it is >= 0, its start minus e (int32) is at most
//   max_gap, and no skp row lies after the last sig row before it, up to
//   and including row i; otherwise it opens a new peak.
// Peak p's candidate is (its first row, its last sig row).  The K slots
// hold the last min(n, K) peaks in genomic order at their end, empty
// slots (first 0, last -1, not existing) before them; n counts every
// peak, so a caller sees when the cap dropped some.
//
// Bound: device-memory bandwidth.  13 bytes in per row (starts, ends,
// stat, live) and 2 out (sig, skp), 17 bytes per slot and 8 for the
// count (testing.gap_join_bytes); a few integer compares per row.
//
// Design.  One kernel per call, a single pass with decoupled look-back
// whose carry is the state of the join (State) under an associative
// combine.  A segment's state is what its rows say without knowing what
// precedes them: the first sig row's start and whether a skp row
// precedes that row inside the segment; the largest end and the row of
// its last sig row, and whether a skp row follows that row; and how many
// of its sig rows after the first open a peak.  Whether the segment's
// first sig row opens one depends on what precedes it, and combine
// decides that.  The first design (csrc/reference/gapjoin_first.cu) was
// a memset, a scan kernel of 1,024-row tiles and a finish kernel per
// call; its time went mostly to latency, not bytes (PERF.md, Step 0: the
// scan kernel alone took 15 us on 330 tiles, and each tile's chain of
// dependent steps took microseconds).  What each choice does:
// - Persistent blocks.  The grid is as many 256-thread blocks as fit on
//   the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//   at most one per tile; each block takes tile after tile from an
//   atomic counter, in order, so a tile waits only on tiles that running
//   blocks hold.  Tiles of 4,096 rows (16 a thread) make a main-path
//   call ~270 tiles, not ~1,090.
// - A ring of two tiles in shared memory fed by TMA bulk copies.
//   Thread 0 issues cp.async.bulk copies of the next tile's four columns
//   (52 KB) into the free stage, completed by its mbarrier, so the loads
//   overlap the current tile's scan, look-back and walk.  The ragged
//   last tile (rows not a multiple of the tile) takes plain loads.
// - Rows judged side by side.  Each thread reads its rows' chunks of 4
//   in a rotated order (the 8 threads of a 16-byte read hit 8 bank
//   groups, where the plain order made a 16-way conflict), keeps sig and
//   skp as bit masks, and judges only its sig rows again: inside a
//   thread a sig row's join depends only on the sig rows before it there
//   and the skp rows since the last of them, so the thread's state and
//   the rows that open peaks come from masks, and only the thread's
//   first sig row waits for the prefix.
// - A block-wide look-back.  Each window, thread j reads tile win - j:
//   256 predecessors at a time, where a warp reads 32; a block scan
//   whose warp totals are scanned with shuffles.
// - A packed State of 4 ints, one 16-byte load or store.  HAS (the
//   segment has a sig row) is 1 + its last sig row > 0, and the two skip
//   bits ride in bit 31 of that row and of the peak count: a row is
//   below m < 2^31 - 1, so 1 + row < 2^31, and a segment's count is
//   below its sig rows, so below 2^31 too.
// - No memset and no finish launch.  The counters and the tiles' flags
//   live in a scratch the wrapper caches per device and stream, zeroed
//   once.  Every block writes its share of the K slots as empty; the
//   last block to finish (an atomic done counter, after a __threadfence
//   over its writes) reads the total, the last tile's inclusive prefix,
//   writes the min(n, K) slots that hold peaks, and zeroes the counters
//   and the flags it used for the next call on the stream, also when
//   that call is a replay of a CUDA graph.
// - sig and skp leave as one 16-byte store each per thread; a row that
//   opens peak p writes first_s[p] = the row and prev_s[p] = the last
//   sig row before it, which is the last row of peak p - 1.
//
// Premise: the sig rows' ends do not decrease (rows in genomic order;
// dead and zero-length rows are never sig).  A segment's state judges
// each later sig row's join by the ends of the segment's own sig rows,
// which equals the plain version's running maximum only then.
#include <cuda_runtime.h>
#include <stdint.h>

// The port builds the defaults; gapjoin_probe.py's sweep builds others
// (-DGJ_THREADS, -DGJ_ITEMS, -DGJ_STAGES, -DGJ_MIN_BLOCKS).
#ifndef GJ_ITEMS
#define GJ_ITEMS 16
#endif
#ifndef GJ_STAGES
#define GJ_STAGES 2
#endif
#ifndef GJ_THREADS
#define GJ_THREADS 256
#endif

namespace {

constexpr int THREADS = GJ_THREADS;
constexpr int ITEMS = GJ_ITEMS;           // consecutive rows per thread
constexpr int TILE = THREADS * ITEMS;     // rows per tile
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = GJ_STAGES;  // the ring: 2, the current tile and
                                   // the next; 1, the current only
constexpr int STAGE_BYTES = 13 * TILE;    // starts, ends, stat, live
constexpr int SMEM = STAGES * STAGE_BYTES;
constexpr int FIT = 232448 / (SMEM + 2048);  // blocks that fit an SM
#ifdef GJ_MIN_BLOCKS
constexpr int MIN_BLOCKS = GJ_MIN_BLOCKS;
#else
constexpr int MIN_BLOCKS = FIT < 1 ? 1 : (FIT > 2048 / THREADS ? 2048 / THREADS
                                                               : FIT);
#endif
constexpr int SLOTS = 16;                 // K slots per thread per pass
constexpr int SLEEP_NS = 64;              // between two polls of a flag
constexpr int HEAD = 4;   // scratch ints: tile counter, done counter, pad
constexpr int REC = 12;   // ints per tile: flag, pad x3, aggregate, inclusive
constexpr int FLAG_AGG = 1;               // the tile's aggregate is out
constexpr int FLAG_INC = 2;               // its inclusive prefix is out
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr unsigned TOP = 0x80000000u;
constexpr unsigned LOW = 0x7fffffffu;
constexpr float SKIP = -1.0f;
static_assert(ITEMS == 8 || ITEMS == 16 || ITEMS == 32, "rows per thread");
static_assert(STAGES == 1 || STAGES == 2, "ring stages");
static_assert(SMEM <= 232448, "the ring must fit in shared memory");

struct State {
  int f_start;   // start of the first sig row (0 if none)
  int l_end;     // largest end of a sig row, -1 if none
  unsigned row;  // bits 0-30: 1 + its last sig row (0: none, no HAS);
                 // bit 31: a skp row at or before its first sig row
  unsigned npk;  // bits 0-30: sig rows after the first that open a peak;
                 // bit 31: a skp row after its last sig row (any, if none)
};

struct Rows {
  const int* starts;
  const int* ends;
  const float* stat;
  const uint8_t* live;
  int64_t m;
  float min_pq;
  int max_gap;  // Genrich's -g, an int32
};

struct Out {
  uint8_t* sig;
  uint8_t* skp;
  int* first_s;
  int* prev_s;
  int64_t k;
  int64_t* first;
  int64_t* last;
  uint8_t* exists;
  int64_t* count;
};

__device__ __forceinline__ State identity() { return State{0, -1, 0u, 0u}; }

// GJ_TRACE builds (gapjoin_probe.py trace) stamp %globaltimer at each
// phase of each block and tile into g_trace: [0, 2) the last block's
// slots, then 8 int64 per block (TRACE_BLOCKS of them), then 10 per tile.
constexpr int TRACE_BLOCKS = 1024;
#ifdef GJ_TRACE
__device__ int64_t* g_trace;
__device__ __forceinline__ int64_t now() {
  uint64_t v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return (int64_t)v;
}
#define STAMP(slot) \
  do {                                       \
    if (threadIdx.x == 0) g_trace[slot] = now(); \
  } while (0)
#define MARK(slot, v)                        \
  do {                                       \
    if (threadIdx.x == 0) g_trace[slot] = (v); \
  } while (0)
#else
#define STAMP(slot) \
  do {              \
  } while (0)
#define MARK(slot, v) \
  do {                \
  } while (0)
#endif
#define BREC(b) (16 + 8 * (int64_t)(b))
#define TREC(tile) (16 + 8 * (int64_t)TRACE_BLOCKS + 10 * (int64_t)(tile))

__device__ __forceinline__ bool has(const State& s) {
  return (s.row & LOW) != 0u;
}

// a - b in int32, wrapping as the plain version's int32 tensors do
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// whether a sig row at ``start`` joins the peak of the rows in ``a``
__device__ __forceinline__ bool joins(const State& a, int start,
                                      bool skip_before, int gap) {
  return a.l_end >= 0 && sub32(start, a.l_end) <= gap
         && !(a.npk & TOP) && !skip_before;
}

// the state of segment a followed by segment b
__device__ __forceinline__ State combine(const State& a, const State& b,
                                         int gap) {
  const bool ah = has(a), bh = has(b);
  State r;
  r.f_start = ah ? a.f_start : b.f_start;  // 0 in a state without HAS
  const unsigned f_skip = ah ? (a.row & TOP)
                             : (bh ? ((a.npk | b.row) & TOP) : 0u);
  r.row = ((bh ? b.row : a.row) & LOW) | f_skip;
  const unsigned opens =
      (ah && bh && !joins(a, b.f_start, b.row & TOP, gap)) ? 1u : 0u;
  r.npk = (((a.npk & LOW) + (b.npk & LOW) + opens) & LOW)
          | (bh ? (b.npk & TOP) : ((a.npk | b.npk) & TOP));
  r.l_end = max(a.l_end, b.l_end);
  return r;
}

__device__ __forceinline__ State shfl_up(const State& s, int off) {
  return State{__shfl_up_sync(FULL_MASK, s.f_start, off),
               __shfl_up_sync(FULL_MASK, s.l_end, off),
               __shfl_up_sync(FULL_MASK, s.row, off),
               __shfl_up_sync(FULL_MASK, s.npk, off)};
}

__device__ __forceinline__ State shfl_down(const State& s, int off) {
  return State{__shfl_down_sync(FULL_MASK, s.f_start, off),
               __shfl_down_sync(FULL_MASK, s.l_end, off),
               __shfl_down_sync(FULL_MASK, s.row, off),
               __shfl_down_sync(FULL_MASK, s.npk, off)};
}

__device__ __forceinline__ State shfl_idx(const State& s, int src) {
  return State{__shfl_sync(FULL_MASK, s.f_start, src),
               __shfl_sync(FULL_MASK, s.l_end, src),
               __shfl_sync(FULL_MASK, s.row, src),
               __shfl_sync(FULL_MASK, s.npk, src)};
}

// rows 0..k of a thread's mask (k < 32)
__device__ __forceinline__ unsigned upto(int k) { return (2u << k) - 1u; }

__device__ __forceinline__ void put(int* p, const State& s) {
  *reinterpret_cast<int4*>(p) =
      make_int4(s.f_start, s.l_end, (int)s.row, (int)s.npk);
}

// a published state, read past L1 (the scratch outlives a launch)
__device__ __forceinline__ State get(const int* p) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(p));
  return State{v.x, v.y, (unsigned)v.z, (unsigned)v.w};
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// a tile's flag, once it is out: relaxed polls, SLEEP_NS apart (the
// caller fences before it reads the state the flag announces)
__device__ __forceinline__ int wait_flag(const int* p) {
  int f = ld_relaxed(p);
  while (f == 0) {
    __nanosleep(SLEEP_NS);
    f = ld_relaxed(p);
  }
  return f;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool bar_try(uint64_t* bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return ok != 0u;
}

// Thread 0: copy tile ``tile``'s four columns into a stage of the ring;
// the stage's mbarrier completes when all its bytes have landed.
__device__ __forceinline__ void issue(unsigned char* stage, uint64_t* bar,
                                      const Rows& r, int64_t tile) {
  const int64_t base = tile * TILE;
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(b),
               "r"(STAGE_BYTES)
               : "memory");
  const void* src[4] = {r.starts + base, r.ends + base, r.stat + base,
                        r.live + base};
  const uint32_t off[4] = {0u, 4u * TILE, 8u * TILE, 12u * TILE};
  const uint32_t len[4] = {4u * TILE, 4u * TILE, 4u * TILE, 1u * TILE};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];" ::"r"(smem_addr(stage + off[c])),
        "l"(src[c]), "r"(len[c]), "r"(b)
        : "memory");
}

// sig bits k..k+3 as four bytes of 0/1
__device__ __forceinline__ uint32_t spread4(unsigned bits) {
  return (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14)
         | ((bits & 8u) << 21);
}

__device__ __forceinline__ void store_bits(uint8_t* dst, unsigned bits) {
  uint32_t w[ITEMS / 4];
#pragma unroll
  for (int q = 0; q < ITEMS / 4; ++q) w[q] = spread4(bits >> (4 * q));
  if constexpr (ITEMS == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int q = 0; q < ITEMS / 16; ++q)
      reinterpret_cast<uint4*>(dst)[q] =
          make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
  }
}

// The exclusive prefix of tile ``tile`` (> 0), in thread 0: each
// window, thread j reads tile win - j, and the block combines in tile
// order the aggregates down to the nearest inclusive prefix (each warp
// by a tree of shuffles, then the warps, oldest first).  Called by every
// thread; returns identity() elsewhere.
__device__ State look_back(int64_t tile, const int* rec, int gap,
                           State* s_red, int* s_near) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  State excl = identity();
  for (int64_t win = tile - 1;; win -= THREADS) {
    const int64_t b = win - t;
    int f = FLAG_INC;  // before tile 0: identity (tile 0 is INC)
    if (b >= 0) f = wait_flag(rec + b * REC);
    const unsigned incs = __ballot_sync(FULL_MASK, f == FLAG_INC);
    if (lane == 0) s_near[warp] = incs ? warp * 32 + __ffs(incs) - 1 : THREADS;
    __syncthreads();
    int nearest = THREADS;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) nearest = min(nearest, s_near[w]);
    State v = identity();
    if (b >= 0 && t <= nearest) {
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
      v = get(rec + b * REC + (f == FLAG_INC ? 8 : 4));
    }
    // lane 0 gets lanes 31..0 combined in that order (tile order)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const State o = shfl_down(v, off);
      if (lane + off < 32) v = combine(o, v, gap);
    }
    if (lane == 0) s_red[warp] = v;
    __syncthreads();
    if (t == 0) {
      State all = identity();
#pragma unroll
      for (int w = WARPS - 1; w >= 0; --w) all = combine(all, s_red[w], gap);
      excl = combine(all, excl, gap);
    }
    if (nearest < THREADS) return excl;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gap_join_kernel(Rows r, int* __restrict__ scratch, int64_t ntiles, Out o) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t s_bar[STAGES];
  __shared__ int64_t s_tile[STAGES];
  __shared__ State s_warp[WARPS];
  __shared__ State s_red[WARPS];
  __shared__ int s_near[WARPS];
  __shared__ State s_prefix;
  __shared__ int s_last;
  int* const ticket = scratch;
  int* const done = scratch + 1;
  int* const rec = scratch + HEAD;  // tile b: rec + b * REC
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int gap = r.max_gap;
  const int64_t full = r.m / TILE;  // tiles the bulk copies load whole
  bool more = true;  // thread 0: the counter may still hold tiles

  // thread 0: the next tile from the counter, ntiles once there is none
  auto take = [&]() -> int64_t {
    if (!more) return ntiles;
    const int64_t tile = atomicAdd(ticket, 1);
    if (tile < ntiles) return tile;
    more = false;
    return ntiles;
  };
  // thread 0: tile ``tile`` into stage ``s`` of the ring; the ragged
  // last tile (and none) load nothing here
  auto load = [&](int s, int64_t tile) {
    s_tile[s] = tile;
    if (tile < full) {
      // order the block's earlier generic accesses to the stage before
      // the bulk copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(ring + s * STAGE_BYTES, &s_bar[s], r, tile);
    }
  };

  // thread 0: the tile of iteration i + 1 (the counter's answer
  // ``got``, taken in iteration i) into its stage: with two stages after
  // iteration i's block scan (iteration i - 1 freed that stage), with one
  // at the end of iteration i
  auto next_into = [&](int i, int got) {
    int64_t next = ntiles;
    if (got >= 0 && got < ntiles) next = got;
    else more = false;
    load((i + 1) % STAGES, next);
  };

  STAMP(BREC(blockIdx.x) + 0);
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) bar_init(&s_bar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load(0, take());
  }
  __syncthreads();
  STAMP(BREC(blockIdx.x) + 1);

  unsigned phase = 0;  // bit s: parity of stage s's next completion
  for (int i = 0;; ++i) {
    const int s = i % STAGES;
    const int64_t tile = s_tile[s];
    if (tile >= ntiles) break;
    int* const st = reinterpret_cast<int*>(ring + s * STAGE_BYTES);
    int* const en = st + TILE;
    float* const sv = reinterpret_cast<float*>(en + TILE);
    uint8_t* const lv = reinterpret_cast<uint8_t*>(sv + TILE);
    const int64_t base = tile * TILE;
    if (tile >= full) {  // the ragged last tile; rows past m are dead
      for (int j = t; j < TILE; j += THREADS) {
        const int64_t row = base + j;
        const bool in = row < r.m;
        st[j] = in ? r.starts[row] : 0;
        en[j] = in ? r.ends[row] : 0;
        sv[j] = in ? r.stat[row] : 0.0f;
        lv[j] = in ? r.live[row] : 0;
      }
      __syncthreads();
    } else {
      while (!bar_try(&s_bar[s], (phase >> s) & 1u)) {
      }
      phase ^= 1u << s;
    }
    STAMP(TREC(tile) + 8);
    // Thread 0 asks the counter for the tile of iteration i + 1 now (in
    // iteration 0, after the first tile landed, so that a block that
    // starts early does not take the tiles of blocks that start a little
    // later) and loads it later (next_into).
    int ticket_got = -1;
    if (t == 0 && more) ticket_got = atomicAdd(ticket, 1);
    STAMP(TREC(tile) + 1);
    MARK(TREC(tile) + 0, blockIdx.x);
    MARK(TREC(tile) + 7, i);

    // this thread's rows: their flags from 16-byte reads of the stage,
    // each thread taking its chunks of 4 rows in a rotated order so that
    // the 8 threads a read serves at once hit 8 different bank groups
    const int r0 = t * ITEMS;
    unsigned sig = 0, skp = 0;  // bit k: row r0 + k is sig / skp
    {
      constexpr int CHUNKS = ITEMS / 4;
      constexpr int SPREAD = CHUNKS == 2 ? 2 : (CHUNKS == 4 ? 1 : 0);
      uint32_t lw[CHUNKS];  // the live bytes
      if constexpr (CHUNKS == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(lv + r0);
        lw[0] = v.x;
        lw[1] = v.y;
      } else {
#pragma unroll
        for (int c = 0; c < CHUNKS / 4; ++c) {
          const uint4 v = reinterpret_cast<const uint4*>(lv + r0)[c];
          lw[4 * c] = v.x;
          lw[4 * c + 1] = v.y;
          lw[4 * c + 2] = v.z;
          lw[4 * c + 3] = v.w;
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        const int q = (j + (lane >> SPREAD)) & (CHUNKS - 1);
        const int4 a = *reinterpret_cast<const int4*>(st + r0 + 4 * q);
        const int4 b = *reinterpret_cast<const int4*>(en + r0 + 4 * q);
        const float4 c = *reinterpret_cast<const float4*>(sv + r0 + 4 * q);
        uint32_t l = 0;
#pragma unroll
        for (int w = 0; w < CHUNKS; ++w) l = w == q ? lw[w] : l;
        const int as[4] = {a.x, a.y, a.z, a.w};
        const int bs[4] = {b.x, b.y, b.z, b.w};
        const float cs[4] = {c.x, c.y, c.z, c.w};
        unsigned g4 = 0, x4 = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = ((l >> (8 * e)) & 0xffu) && sub32(bs[e], as[e]) > 0;
          g4 |= (unsigned)(live && cs[e] > r.min_pq) << e;
          x4 |= (unsigned)(live && cs[e] == SKIP) << e;
        }
        sig |= g4 << (4 * q);
        skp |= x4 << (4 * q);
      }
    }
    // Which of its sig rows after the first open a peak: inside a thread
    // a sig row's join depends only on the sig rows before it there (the
    // largest of their ends) and the skp rows since the last of them, so
    // only the sig rows are read again, one by one.
    unsigned opens = 0;  // bit k: sig row r0 + k, not the first, opens one
    int l_end = -1;      // the largest end of the sig rows so far
    for (unsigned w = sig; w; w &= w - 1u) {
      const int k = __ffs(w) - 1;
      const unsigned below = sig & (upto(k) >> 1);
      if (below) {
        const int p = 31 - __clz(below);  // the sig row before it
        const bool join = l_end >= 0 && sub32(st[r0 + k], l_end) <= gap
                          && (skp & upto(k) & ~upto(p)) == 0u;
        opens |= (join ? 0u : 1u) << k;
      }
      l_end = max(l_end, en[r0 + k]);
    }
    State mine = State{0, -1, 0u, skp ? TOP : 0u};
    if (sig) {
      const int f = __ffs(sig) - 1, l = 31 - __clz(sig);
      mine.f_start = st[r0 + f];
      mine.l_end = l_end;
      mine.row = (unsigned)(base + r0 + l + 1)
                 | ((skp & upto(f)) ? TOP : 0u);
      mine.npk = (unsigned)__popc(opens)
                 | ((l + 1 < ITEMS && (skp >> (l + 1))) ? TOP : 0u);
    }

    STAMP(TREC(tile) + 2);
    // block scan of the threads' states: inclusive in each warp, then
    // each warp scans the warps' totals with shuffles
    State incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const State up = shfl_up(incl, off);
      if (lane >= off) incl = combine(up, incl, gap);
    }
    State excl_w = shfl_up(incl, 1);
    if (lane == 0) excl_w = identity();
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    State ws = lane < WARPS ? s_warp[lane] : identity();
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const State up = shfl_up(ws, off);
      if (lane >= off) ws = combine(up, ws, gap);
    }
    const State total = shfl_idx(ws, WARPS - 1);
    State before = shfl_idx(ws, warp > 0 ? warp - 1 : 0);
    if (warp == 0) before = identity();
    const State in_tile = combine(before, excl_w, gap);

    int* const my = rec + tile * REC;
    STAMP(TREC(tile) + 3);
    if (t == 0) {
      if (tile == 0) {
        s_prefix = identity();
        put(my + 8, total);
        st_release(my, FLAG_INC);
      } else {
        put(my + 4, total);
        st_release(my, FLAG_AGG);
      }
      if (STAGES == 2) next_into(i, ticket_got);
    }
    STAMP(TREC(tile) + 4);
    if (tile > 0) {
      const State ex = look_back(tile, rec, gap, s_red, s_near);
      if (t == 0) {
        s_prefix = ex;
        put(my + 8, combine(ex, total, gap));
        st_release(my, FLAG_INC);
      }
    }
    STAMP(TREC(tile) + 5);
    __syncthreads();

    // sig and skp leave only now: a thread's stores still in flight
    // would hold up its st.release of the tile's states and its fences
    // in the look-back
    if (tile < full) {
      store_bits(o.sig + base + r0, sig);
      store_bits(o.skp + base + r0, skp);
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (base + r0 + k < r.m) {
          o.sig[base + r0 + k] = (sig >> k) & 1u;
          o.skp[base + r0 + k] = (skp >> k) & 1u;
        }
      }
    }

    // this thread's peaks from its exact prefix: its first sig row opens
    // one unless it joins the rows before the thread, then each row of
    // ``opens``; a peak's first_s is its first row, and the peak before
    // it gets prev_s, its last sig row
    if (sig) {
      const State cur = combine(s_prefix, in_tile, gap);
      int count = has(cur) ? 1 + (int)(cur.npk & LOW) : 0;
      const int f = __ffs(sig) - 1;
      const bool join = cur.l_end >= 0 && sub32(st[r0 + f], cur.l_end) <= gap
                        && !(cur.npk & TOP) && (skp & upto(f)) == 0u;
      if (!join) {
        o.first_s[count] = (int)(base + r0 + f);
        if (count > 0) o.prev_s[count] = (int)(cur.row & LOW) - 1;
        ++count;
      }
      for (unsigned w = opens; w; w &= w - 1u) {
        const int k = __ffs(w) - 1;
        o.first_s[count] = (int)(base + r0 + k);
        o.prev_s[count] = (int)(base + r0 + 31 - __clz(sig & (upto(k) >> 1)));
        ++count;
      }
    }
    __syncthreads();  // the stage, s_warp and s_prefix are free again
    if (STAGES == 1) {
      if (t == 0) next_into(i, ticket_got);
      __syncthreads();
    }
    STAMP(TREC(tile) + 6);
  }
  STAMP(BREC(blockIdx.x) + 2);

  // Every block first writes its share of the K slots as empty (first
  // 0, last -1, not existing).  The last block to finish (every walk,
  // so every first_s and prev_s, is out) then writes the slots that
  // hold peaks: slot j holds peak j + n - K where that is not negative,
  // the last min(n, K) slots.  No slot's peak is known before the count,
  // nor readable before every block walked its tiles.
  {
    const int64_t share = (o.k + gridDim.x - 1) / gridDim.x;
    const int64_t j_end = min(o.k, share * (blockIdx.x + 1));
    for (int64_t j = share * blockIdx.x + t; j < j_end; j += THREADS) {
      o.first[j] = 0;
      o.last[j] = -1;
      o.exists[j] = 0;
    }
  }
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(done, 1) == (int)gridDim.x - 1;
  }
  STAMP(BREC(blockIdx.x) + 3);
  __syncthreads();
  if (!s_last) return;
  STAMP(0);
  __threadfence();
  const State tot = get(rec + (ntiles - 1) * REC + 8);
  const int64_t n = has(tot) ? 1 + (int64_t)(tot.npk & LOW) : 0;
  const int64_t last_row = (int64_t)(tot.row & LOW) - 1;
  if (t == 0) *o.count = n;
  // SLOTS slots per thread at a time: all their loads, then the stores
  const int64_t j0 = o.k > n ? o.k - n : 0;  // the first slot with a peak
  for (int64_t c = j0; c < o.k; c += (int64_t)SLOTS * THREADS) {
    int64_t fv[SLOTS], lv[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int64_t j = c + (int64_t)u * THREADS + t;
      const int64_t p = j + n - o.k;
      fv[u] = 0;
      lv[u] = -1;
      if (j < o.k) {
        fv[u] = __ldcg(o.first_s + p);
        lv[u] = p == n - 1 ? last_row : (int64_t)__ldcg(o.prev_s + p + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int64_t j = c + (int64_t)u * THREADS + t;
      if (j < o.k) {
        o.first[j] = fv[u];
        o.last[j] = lv[u];
        o.exists[j] = 1;
      }
    }
  }
  // leave the scratch as the next call on this stream needs it
  for (int64_t j = t; j < ntiles; j += THREADS) rec[j * REC] = 0;
  if (t == 0) {
    *ticket = 0;
    *done = 0;
  }
  STAMP(1);
}

int64_t tiles_of(int64_t m) { return (m + TILE - 1) / TILE; }

// Blocks that fit on the current device at once (its SMs times the
// blocks per SM), read once per device.
int resident_blocks(int* out) {
  static int cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    err = cudaFuncSetAttribute(gap_join_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gap_join_kernel, THREADS, SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidConfiguration;
    cache[dev] = per_sm * sms;
  }
  *out = cache[dev];
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// int32 words of the scratch that the counters and the tiles' flags and
// states take for m rows; it must be zeroed before its first call, and
// every call leaves it zeroed.
int64_t gap_join_state_ints(int64_t m) { return HEAD + REC * tiles_of(m); }

#ifdef GJ_TRACE
// Where a GJ_TRACE build stamps its phases: int64 [16 + 8 * 1024 + 10 *
// tiles], the grid at most 1,024 blocks.
int gap_join_set_trace(void* trace) {
  return (int)cudaMemcpyToSymbol(g_trace, &trace, sizeof(trace));
}
#endif

// The grid of a call on m rows on the current device (0 on an error).
int64_t gap_join_grid(int64_t m) {
  int blocks = 0;
  if (resident_blocks(&blocks) != (int)cudaSuccess) return 0;
  return tiles_of(m) < blocks ? tiles_of(m) : blocks;
}

// Rows (length m, 0 < m < 2^31) in genomic order: starts, ends int32,
// stat f32, live uint8 (all 16-byte aligned).  Outputs: sig, skp uint8
// [m] (16-byte aligned); first, last int64 [k], exists uint8 [k]; count
// int64 [1].  state: int32 [gap_join_state_ints(m)] as the last call on
// this stream left it (zeroed the first time), and used by no other
// stream meanwhile; pairs: int32 [2 m], any contents.  One launch;
// returns its CUDA error.
int gap_join_launch(const int* starts, const int* ends, const float* stat,
                    const uint8_t* live, int64_t m, float min_pq,
                    long long max_gap, int64_t k, uint8_t* sig,
                    uint8_t* skp, int64_t* first, int64_t* last,
                    uint8_t* exists, int64_t* count, int* state, int* pairs,
                    void* stream) {
  if (m <= 0 || m > 0x7fffffff || k < 0 || max_gap < -0x7fffffffLL - 1
      || max_gap > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = resident_blocks(&blocks);
  if (err != (int)cudaSuccess) return err;
  const int64_t ntiles = tiles_of(m);
  const int64_t grid = ntiles < blocks ? ntiles : blocks;
  const Rows r = {starts, ends, stat, live, m, min_pq, (int)max_gap};
  const Out o = {sig, skp, pairs, pairs + m, k, first, last, exists, count};
  gap_join_kernel<<<(unsigned)grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      r, state, ntiles, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
