// gap_join_first: the first design of kernel K5 (gapjoin.cu), kept as a
// reference that the card tests and chip_smoke.py hold the current
// design to, bit for bit, on every output, and time beside it.  It is
// built into a library of its own (kernels.reference_library()) that
// the port never loads.  Its kernels and entry points carry a _first
// suffix; their bodies are the first design's.
//
// One 128-thread block per 1,024-row tile, tiles taken from an atomic
// counter: 16-byte loads of each thread's 8 rows, a fold of their
// join states, a block scan, a single-pass decoupled look-back over the
// tiles' published states (5 ints each), then a walk of each thread's
// rows that writes sig/skp and each new peak's first row and previous
// peak's last row.  Each call is three device operations: a memset of
// the counter and flags, the scan kernel, and a finish kernel that
// places the K slots once the count is known.
// gap_join_first_part runs one of the three alone, so that a call's
// time can be split among them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ITEMS = 8;                  // consecutive rows per thread
constexpr int TILE = THREADS * ITEMS;     // rows per block
constexpr int WARPS = THREADS / 32;
constexpr int WORDS = 5;                  // ints of a published State
constexpr int FLAG_AGG = 1;               // the tile's aggregate is out
constexpr int FLAG_INC = 2;               // its inclusive prefix is out
constexpr int FINISH_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float SKIP = -1.0f;

// State::bits
constexpr int HAS = 1;     // the segment has a sig row
constexpr int F_SKIP = 2;  // a skp row at or before its first sig row
constexpr int T_SKIP = 4;  // a skp row after its last sig row (any, if none)

struct State {
  int bits;
  int f_start;  // start of the first sig row (0 without HAS)
  int l_end;    // largest end of a sig row, -1 if none
  int l_idx;    // row of the last sig row, -1 if none
  int npk;      // sig rows after the first that open a peak
};

struct Rows {
  const int* starts;
  const int* ends;
  const float* stat;
  const uint8_t* live;
  int64_t m;
  float min_pq;
  long long max_gap;
};

__device__ __forceinline__ State identity() { return State{0, 0, -1, -1, 0}; }

// a - b in int32, wrapping as the plain version's int32 tensors do
__device__ __forceinline__ int sub32(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// whether a sig row at ``start`` joins the peak of the rows in ``a``
__device__ __forceinline__ bool joins(const State& a, int start,
                                      bool skip_before, long long gap) {
  return a.l_end >= 0 && (long long)sub32(start, a.l_end) <= gap
         && !(a.bits & T_SKIP) && !skip_before;
}

// the state of segment a followed by segment b
__device__ __forceinline__ State combine(const State& a, const State& b,
                                         long long gap) {
  const bool ah = a.bits & HAS, bh = b.bits & HAS;
  State r;
  int bits = (ah || bh) ? HAS : 0;
  r.f_start = 0;
  if (ah) {
    r.f_start = a.f_start;
    bits |= a.bits & F_SKIP;
  } else if (bh) {
    r.f_start = b.f_start;
    if ((a.bits & T_SKIP) || (b.bits & F_SKIP)) bits |= F_SKIP;
  }
  if (bh)
    bits |= b.bits & T_SKIP;
  else
    bits |= (a.bits | b.bits) & T_SKIP;
  r.bits = bits;
  r.l_end = max(a.l_end, b.l_end);
  r.l_idx = bh ? b.l_idx : a.l_idx;
  r.npk = a.npk + b.npk
          + ((ah && bh && !joins(a, b.f_start, b.bits & F_SKIP, gap)) ? 1
                                                                      : 0);
  return r;
}

__device__ __forceinline__ State row_state(bool sig, bool skp, int start,
                                           int end, int row) {
  if (sig) return State{HAS | (skp ? F_SKIP : 0), start, end, row, 0};
  return State{skp ? T_SKIP : 0, 0, -1, -1, 0};
}

__device__ __forceinline__ State shfl_up(const State& s, int off) {
  return State{__shfl_up_sync(FULL_MASK, s.bits, off),
               __shfl_up_sync(FULL_MASK, s.f_start, off),
               __shfl_up_sync(FULL_MASK, s.l_end, off),
               __shfl_up_sync(FULL_MASK, s.l_idx, off),
               __shfl_up_sync(FULL_MASK, s.npk, off)};
}

__device__ __forceinline__ State shfl_down(const State& s, int off) {
  return State{__shfl_down_sync(FULL_MASK, s.bits, off),
               __shfl_down_sync(FULL_MASK, s.f_start, off),
               __shfl_down_sync(FULL_MASK, s.l_end, off),
               __shfl_down_sync(FULL_MASK, s.l_idx, off),
               __shfl_down_sync(FULL_MASK, s.npk, off)};
}

__device__ __forceinline__ State shfl_idx(const State& s, int lane) {
  return State{__shfl_sync(FULL_MASK, s.bits, lane),
               __shfl_sync(FULL_MASK, s.f_start, lane),
               __shfl_sync(FULL_MASK, s.l_end, lane),
               __shfl_sync(FULL_MASK, s.l_idx, lane),
               __shfl_sync(FULL_MASK, s.npk, lane)};
}

__device__ __forceinline__ void put(int* p, const State& s) {
  p[0] = s.bits;
  p[1] = s.f_start;
  p[2] = s.l_end;
  p[3] = s.l_idx;
  p[4] = s.npk;
}

__device__ __forceinline__ State get(const int* p) {
  return State{p[0], p[1], p[2], p[3], p[4]};
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// int32 scratch: [0] tile counter, [1, 1 + ntiles) flags, the tiles'
// aggregates and inclusive prefixes (WORDS each), then first_s [m] and
// prev_s [m]
__host__ __device__ __forceinline__ int64_t state_ints(int64_t ntiles) {
  return 1 + ntiles * (1 + 2 * (int64_t)WORDS);
}

// The exclusive prefix of tile ``tile`` (> 0), by warp 0: look back over
// the predecessors 32 at a time (lane l reads tile win - l), combining
// aggregates in tile order down to the nearest inclusive prefix.
__device__ __forceinline__ State look_back(int64_t tile, const int* flags,
                                           const int* agg, const int* inc,
                                           long long gap) {
  const int lane = threadIdx.x & 31;
  State excl = identity();
  for (int64_t win = tile - 1;; win -= 32) {
    const int64_t b = win - lane;
    int f = FLAG_INC;  // before tile 0: never read (tile 0 is INC)
    if (b >= 0) {
      do {
        f = ld_acquire(flags + b);
      } while (f == 0);
    }
    const unsigned incs = __ballot_sync(FULL_MASK, f == FLAG_INC);
    const int nearest = incs ? __ffs(incs) - 1 : 32;
    State v = identity();
    if (b >= 0 && lane <= nearest)
      v = get((f == FLAG_INC ? inc : agg) + b * WORDS);
    // lane 0 gets lanes 31..0 combined in that order (tile order)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const State o = shfl_down(v, off);
      if (lane + off < 32) v = combine(o, v, gap);
    }
    excl = combine(shfl_idx(v, 0), excl, gap);
    if (incs) return excl;
  }
}

__global__ void __launch_bounds__(THREADS)
gap_join_first_kernel(Rows r, int* __restrict__ scratch, int64_t ntiles,
                uint8_t* __restrict__ sig_out, uint8_t* __restrict__ skp_out,
                int* __restrict__ first_s, int* __restrict__ prev_s) {
  __shared__ State s_warp[WARPS];
  __shared__ State s_prefix;
  __shared__ int64_t s_tile;
  int* const flags = scratch + 1;
  int* const agg = flags + ntiles;
  int* const inc = agg + ntiles * WORDS;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long gap = r.max_gap;

  if (t == 0) s_tile = atomicAdd(scratch, 1);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t r0 = tile * TILE + (int64_t)t * ITEMS;

  // this thread's consecutive rows: 16-byte loads of the columns and
  // one 8-byte load of the live flags; rows past m are dead
  int st[ITEMS], en[ITEMS];
  float sv[ITEMS];
  unsigned lv = 0;  // bit k: row r0 + k is live
  if (r0 + ITEMS <= r.m) {
    const int4* ps = reinterpret_cast<const int4*>(r.starts + r0);
    const int4* pe = reinterpret_cast<const int4*>(r.ends + r0);
    const float4* pv = reinterpret_cast<const float4*>(r.stat + r0);
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const int4 a = ps[q], b = pe[q];
      const float4 c = pv[q];
      st[4 * q + 0] = a.x; st[4 * q + 1] = a.y;
      st[4 * q + 2] = a.z; st[4 * q + 3] = a.w;
      en[4 * q + 0] = b.x; en[4 * q + 1] = b.y;
      en[4 * q + 2] = b.z; en[4 * q + 3] = b.w;
      sv[4 * q + 0] = c.x; sv[4 * q + 1] = c.y;
      sv[4 * q + 2] = c.z; sv[4 * q + 3] = c.w;
    }
    const uint2 l = *reinterpret_cast<const uint2*>(r.live + r0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((l.x >> (8 * k)) & 0xffu) lv |= 1u << k;
      if ((l.y >> (8 * k)) & 0xffu) lv |= 1u << (4 + k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t i = r0 + k;
      st[k] = en[k] = 0;
      sv[k] = 0.0f;
      if (i < r.m) {
        st[k] = r.starts[i];
        en[k] = r.ends[i];
        sv[k] = r.stat[i];
        if (r.live[i]) lv |= 1u << k;
      }
    }
  }

  unsigned sig = 0, skp = 0;  // bit k: row r0 + k is sig / skp
  State mine = identity();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool live = ((lv >> k) & 1u) && sub32(en[k], st[k]) > 0;
    const bool g = live && sv[k] > r.min_pq;
    const bool s = live && sv[k] == SKIP;
    sig |= (unsigned)g << k;
    skp |= (unsigned)s << k;
    mine = combine(mine, row_state(g, s, st[k], en[k], (int)(r0 + k)), gap);
  }

  // block scan of the threads' states: inclusive in each warp, then the
  // warps' totals in order
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
  State before = identity(), total = identity();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before = combine(before, s_warp[w], gap);
    total = combine(total, s_warp[w], gap);
  }
  const State in_tile = combine(before, excl_w, gap);

  if (t == 0) {
    if (tile == 0) {
      s_prefix = identity();
      put(inc, total);
      st_release(flags, FLAG_INC);
    } else {
      put(agg + tile * WORDS, total);
      st_release(flags + tile, FLAG_AGG);
    }
  }
  if (tile > 0 && warp == 0) {
    const State ex = look_back(tile, flags, agg, inc, gap);
    if (t == 0) {
      s_prefix = ex;
      put(inc + tile * WORDS, combine(ex, total, gap));
      st_release(flags + tile, FLAG_INC);
    }
  }
  __syncthreads();

  // walk the rows from this thread's exact prefix
  const State cur = combine(s_prefix, in_tile, gap);
  int count = (cur.bits & HAS) ? 1 + cur.npk : 0;
  int l_end = cur.l_end, l_idx = cur.l_idx;
  bool tskip = cur.bits & T_SKIP;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const bool g = (sig >> k) & 1u, s = (skp >> k) & 1u;
    if (g) {
      const bool join = l_end >= 0
                        && (long long)sub32(st[k], l_end) <= gap
                        && !tskip && !s;
      const int row = (int)(r0 + k);
      if (!join) {
        first_s[count] = row;
        if (count > 0) prev_s[count] = l_idx;
        ++count;
      }
      l_end = max(l_end, en[k]);
      l_idx = row;
      tskip = false;
    } else if (s) {
      tskip = true;
    }
  }

  if (r0 + ITEMS <= r.m) {
    uint2 a = {0u, 0u}, b = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a.x |= ((sig >> k) & 1u) << (8 * k);
      a.y |= ((sig >> (4 + k)) & 1u) << (8 * k);
      b.x |= ((skp >> k) & 1u) << (8 * k);
      b.y |= ((skp >> (4 + k)) & 1u) << (8 * k);
    }
    *reinterpret_cast<uint2*>(sig_out + r0) = a;
    *reinterpret_cast<uint2*>(skp_out + r0) = b;
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (r0 + k < r.m) {
        sig_out[r0 + k] = (sig >> k) & 1u;
        skp_out[r0 + k] = (skp >> k) & 1u;
      }
    }
  }
}

// The K slots from the total (the last tile's inclusive prefix): slot j
// holds peak j + n - K, or nothing where that is negative.
__global__ void __launch_bounds__(FINISH_THREADS)
gap_join_first_finish_kernel(const int* __restrict__ scratch, int64_t ntiles,
                       const int* __restrict__ first_s,
                       const int* __restrict__ prev_s, int64_t k,
                       int64_t* __restrict__ first, int64_t* __restrict__ last,
                       uint8_t* __restrict__ exists,
                       int64_t* __restrict__ count) {
  const int* total = scratch + 1 + ntiles * (1 + WORDS)
                     + (ntiles - 1) * WORDS;
  const int64_t n = (total[0] & HAS) ? 1 + (int64_t)total[4] : 0;
  const int64_t j0 = (int64_t)blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (j0 == 0) *count = n;
  for (int64_t j = j0; j < k; j += (int64_t)gridDim.x * FINISH_THREADS) {
    const int64_t p = j + n - k;
    if (p < 0) {
      first[j] = 0;
      last[j] = -1;
      exists[j] = 0;
    } else {
      first[j] = first_s[p];
      last[j] = p == n - 1 ? (int64_t)total[3] : (int64_t)prev_s[p + 1];
      exists[j] = 1;
    }
  }
}

}  // namespace

extern "C" {

// int32 words of scratch the wrapper allocates for m rows.
int64_t gap_join_first_scratch(int64_t m) {
  return state_ints((m + TILE - 1) / TILE) + 2 * m;
}

// Rows (length m, 0 < m < 2^31) in genomic order: starts, ends int32,
// stat f32 (all 16-byte aligned), live uint8 (8-byte aligned).  Outputs:
// sig, skp uint8 [m] (8-byte aligned); first, last int64 [k], exists
// uint8 [k]; count int64 [1].  scratch: int32 [gap_join_first_scratch(m)],
// its counter and flags zeroed here.  Returns the first CUDA error of
// the memset and the two launches.
// One part of a call alone (0: the memset, 1: the scan kernel, 2: the
// finish kernel; -1: all three, the call itself), on a scratch whose
// counter and flags part 0 zeroed.
int gap_join_first_part(int part, const int* starts, const int* ends, const float* stat,
                    const uint8_t* live, int64_t m, float min_pq,
                    long long max_gap, int64_t k, uint8_t* sig,
                    uint8_t* skp, int64_t* first, int64_t* last,
                    uint8_t* exists, int64_t* count, int* scratch,
                    void* stream) {
  if (m <= 0 || m > 0x7fffffff || k < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t ntiles = (m + TILE - 1) / TILE;
  cudaError_t err = cudaSuccess;
  if (part < 0 || part == 0) {
    err = cudaMemsetAsync(scratch, 0, (size_t)(1 + ntiles) * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  int* const first_s = scratch + state_ints(ntiles);
  int* const prev_s = first_s + m;
  const Rows r = {starts, ends, stat, live, m, min_pq, max_gap};
  if (part < 0 || part == 1) {
    gap_join_first_kernel<<<(unsigned)ntiles, THREADS, 0, s>>>(
        r, scratch, ntiles, sig, skp, first_s, prev_s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (part >= 0 && part != 2) return (int)cudaSuccess;
  int64_t blocks = (k + FINISH_THREADS - 1) / FINISH_THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 1024) blocks = 1024;
  gap_join_first_finish_kernel<<<(unsigned)blocks, FINISH_THREADS, 0, s>>>(
      scratch, ntiles, first_s, prev_s, k, first, last, exists, count);
  return (int)cudaGetLastError();
}


int gap_join_first_launch(const int* starts, const int* ends,
                          const float* stat, const uint8_t* live, int64_t m,
                          float min_pq, long long max_gap, int64_t k,
                          uint8_t* sig, uint8_t* skp, int64_t* first,
                          int64_t* last, uint8_t* exists, int64_t* count,
                          int* scratch, void* stream) {
  return gap_join_first_part(-1, starts, ends, stat, live, m, min_pq,
                             max_gap, k, sig, skp, first, last, exists,
                             count, scratch, stream);
}

}  // extern "C"
