"""Helpers shared by the port's tests, ``chip_smoke.py`` and the bench.

``peak_rows`` makes a synthetic chromosome of coverage rows holding
peaks, and ``peak_row_columns`` the same rows as ``peak_reduce``'s
int32/float32 columns; ``gap_join_rows`` makes rows for the gap-join
and ``gap_join_blocked`` transcribes kernel K5's design in numpy;
``auc_rowwise`` is the exact engine's AUC on the host (a float32 sum in
row order); ``recording`` keeps the arguments of a wrapper's calls;
``blacklist_regions`` draws ``-E`` regions and ``write_bed`` writes
them; ``check_log`` holds a port's ``-f``/``-k``
log to the exact engine's, and ``check_summits`` its narrowPeak column
10 (summit offset).  numpy only, except
the ``*_first_design`` helpers, which launch the first designs of
kernels K1-K5 (``csrc/reference/``) on the card so that the current
ones can be held to them, ``median_ms`` (device time by CUDA events),
``recording`` and the operation counters.  ``mapped_files`` lists the
files under a directory that this process has mapped.

``calc_pval_opcount``, ``tile_stats_opcount``, ``coverage_scan_opcount``
and ``fisher_combine_opcount`` tally, on a call's own inputs, the
branch each row or lane of kernels K1 (lambda mode), K2 and K3 takes and
the trip count of each series, and turn the tally into float
operations: each operation written in the CUDA source counts once, each
libm call or IEEE division ``LIBM_OPS[name]``.  ``bound`` turns bytes
and operations into the least time the card could take, and
``call_work`` counts a recorded call's bytes and operations.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np

F32 = np.float32


def mapped_files(root):
    """The files under ``root`` that this process has mapped, as
    ``/proc/self/maps`` names them (sorted, each once)."""
    root = os.path.join(os.path.realpath(root), "")
    with open("/proc/self/maps") as f:
        fields = (ln.split(None, 5) for ln in f)
        return sorted({p[5].rstrip("\n") for p in fields
                       if len(p) == 6 and p[5].startswith(root)})


@contextmanager
def recording(targets):
    """While the block runs, each (module, name) of ``targets`` is
    wrapped to keep host copies of the arguments of its calls; yields
    {name: [args, ...]}."""
    import torch
    calls = {name: [] for _, name in targets}
    real = {name: getattr(mod, name) for mod, name in targets}

    def wrap(name):
        def record(*args):
            calls[name].append([a.cpu() if torch.is_tensor(a) else a
                                for a in args])
            return real[name](*args)
        return record
    for mod, name in targets:
        setattr(mod, name, wrap(name))
    try:
        yield calls
    finally:
        for mod, name in targets:
            setattr(mod, name, real[name])


def peak_rows(rng, m, n_regions, region_rows=(3, 40), min_pq=2.0,
              skip_frac=0.002):
    """A contiguous chromosome of m rows holding about n_regions peaks.

    Rows are 1-60 bp; background stat lies below ``min_pq``; inside a
    region of ``region_rows`` rows (a [lo, hi) range), stat lies above
    it, on a 0.25 grid in every other region (so summit ties occur) and
    off it in the rest (so AUC rounds), with 10% sub-threshold gap
    rows; then a ``skip_frac`` share of all rows become SKIP (-1).
    Returns (ends int64, stat, pval, qval f32); row i spans
    ends[i-1]..ends[i], from 0.
    """
    lens = rng.randint(1, 61, m)
    ends = np.cumsum(lens).astype(np.int64)
    stat = rng.uniform(0.0, min_pq, m).astype(F32)
    starts = np.sort(rng.choice(max(m - region_rows[1], 1), n_regions,
                                replace=False))
    for i, s in enumerate(starts):
        n = rng.randint(*region_rows)
        hi = min_pq + 0.25 * rng.randint(1, 120, n)
        if i % 2:                     # off the grid: AUC rounds
            hi = hi + rng.uniform(0, 0.25, n)
        gap = rng.rand(n) < 0.1
        stat[s:s + n] = np.where(gap, stat[s:s + n], hi).astype(F32)
    stat[rng.rand(m) < skip_frac] = -1.0
    pval = (stat + rng.uniform(0, 1, m)).astype(F32)
    qval = (stat * 0.5).astype(F32)
    return ends, stat, pval, qval


def peak_row_columns(rng, m, n_regions, **kw):
    """``peak_rows`` as the columns ``peak_reduce`` takes: (starts,
    ends int32, stat, pval, qval float32), numpy."""
    ends, stat, pval, qval = peak_rows(rng, m, n_regions, **kw)
    starts = np.concatenate([[0], ends[:-1]])
    return (starts.astype(np.int32), ends.astype(np.int32), stat, pval,
            qval)


def peak_reduce_first_design(starts, ends, stat, pval, qval, sig, first,
                             last, min_pq):
    """Kernel K4's first design (one warp per peak) on CUDA tensors,
    with ``peak_reduce``'s arguments and outputs.  Not
    counted in ``kernels.LAUNCHES``."""
    import torch

    from . import kernels
    k = first.shape[0]
    dev = starts.device
    args = [t.contiguous() for t in (starts, ends, stat, pval, qval)]
    args += [sig.contiguous().view(torch.uint8), first.contiguous(),
             last.contiguous()]
    with torch.cuda.device(dev):
        lib = kernels.reference_library()
        f32 = [torch.empty(k, dtype=torch.float32, device=dev)
               for _ in range(4)]
        i32 = [torch.empty(k, dtype=torch.int32, device=dev)
               for _ in range(2)]
        rc = lib.peak_reduce_warp_launch(
            *(kernels.ptr(t) for t in args), k, float(F32(min_pq)),
            *(kernels.ptr(t) for t in f32 + i32),
            kernels.stream_of(starts))
        kernels.check(rc, "peak_reduce_warp")
    return tuple(f32 + i32)


def coverage_scan_first_design(packed, groups, carry, lam=None):
    """Kernel K1's first design (reduce-then-scan in three launches) on
    CUDA tensors, with ``coverage_scan``'s arguments and outputs.  Not
    counted in ``kernels.LAUNCHES``."""
    import torch

    from . import kernels
    packed = packed.contiguous()
    carry = carry.to(torch.int32).contiguous()
    m = packed.shape[0]
    dev = packed.device
    with torch.cuda.device(dev):
        lib = kernels.reference_library()
        nblocks = -(-m // lib.coverage_scan_three_pass_tile())
        vals = torch.empty((groups, m), dtype=torch.float32, device=dev)
        pval = torch.empty(m if lam is not None else 0,
                           dtype=torch.float32, device=dev)
        scratch = torch.empty((2, max(nblocks, 1), 4 * groups),
                              dtype=torch.int32, device=dev)
        rc = lib.coverage_scan_three_pass_launch(
            kernels.ptr(packed), m, groups, kernels.ptr(carry),
            float(F32(0.0 if lam is None else lam)), int(lam is not None),
            kernels.ptr(vals), kernels.ptr(pval), kernels.ptr(scratch[0]),
            kernels.ptr(scratch[1]), kernels.stream_of(packed))
        kernels.check(rc, "coverage_scan_three_pass")
    return vals, (pval if lam is not None else None)


def tile_stats_first_design(expt_val, ctrl_raw, excluded, factor, lam):
    """Kernel K2's first design (one row per thread) on CUDA tensors,
    with ``tile_stats``'s arguments and output.  Not counted in
    ``kernels.LAUNCHES``."""
    import torch

    from . import kernels
    args = [expt_val.contiguous(), ctrl_raw.contiguous(),
            excluded.contiguous().view(torch.uint8)]
    m = expt_val.shape[0]
    with torch.cuda.device(expt_val.device):
        lib = kernels.reference_library()
        pval = torch.empty(m, dtype=torch.float32, device=expt_val.device)
        rc = lib.tile_stats_first_launch(
            *(kernels.ptr(t) for t in args), float(F32(factor)),
            float(F32(lam)), kernels.ptr(pval), m,
            kernels.stream_of(expt_val))
        kernels.check(rc, "tile_stats_first")
    return pval


def fisher_combine_first_design(pvals):
    """Kernel K3's first design (one lane per thread) on a CUDA f32 [R, N]
    tensor, with ``fisher_combine``'s output.  Not counted in
    ``kernels.LAUNCHES``."""
    import torch

    from . import kernels
    pvals = pvals.contiguous()
    r, n = pvals.shape
    with torch.cuda.device(pvals.device):
        lib = kernels.reference_library()
        out = torch.empty(n, dtype=torch.float32, device=pvals.device)
        rc = lib.fisher_combine_first_launch(kernels.ptr(pvals), r, n,
                                             kernels.ptr(out),
                                             kernels.stream_of(pvals))
        kernels.check(rc, "fisher_combine_first")
    return out


def gap_join_first_design(starts, ends, stat, live, min_pq, max_gap,
                           k_peaks, part=-1, bufs=None):
    """Kernel K5's first design (a memset, the scan kernel and a finish
    kernel per call) on CUDA tensors, with ``peak_candidates``'
    arguments and outputs (a ``PeakRows``), allocated as its wrapper
    allocated them.  ``part`` 0, 1 or 2 launches only the memset, the
    scan or the finish (-1: all three), on the outputs and scratch of
    ``bufs``, which a call returns beside its ``PeakRows`` when ``part``
    is not -1.  Not counted in ``kernels.LAUNCHES``."""
    import torch

    from . import kernels
    from .ops.peaks import PeakRows
    m = starts.shape[0]
    k = min(k_peaks, m)
    dev = starts.device
    args = [kernels.aligned(t.contiguous(), 16) for t in (starts, ends, stat)]
    args.append(kernels.aligned(live.contiguous().view(torch.uint8), 16))
    with torch.cuda.device(dev):
        lib = kernels.reference_library()
        if bufs is None:
            bufs = (torch.empty(m, dtype=torch.uint8, device=dev),
                    torch.empty(m, dtype=torch.uint8, device=dev),
                    torch.empty((2, k), dtype=torch.int64, device=dev),
                    torch.empty(k, dtype=torch.uint8, device=dev),
                    torch.empty((), dtype=torch.int64, device=dev),
                    torch.empty(lib.gap_join_first_scratch(m),
                                dtype=torch.int32, device=dev))
        sig, skp, cand, exists, n, scratch = bufs
        rc = lib.gap_join_first_part(
            part, *(t.data_ptr() for t in args), m, float(F32(min_pq)),
            int(max_gap), k, sig.data_ptr(), skp.data_ptr(),
            cand[0].data_ptr(), cand[1].data_ptr(), exists.data_ptr(),
            n.data_ptr(), scratch.data_ptr(), kernels.stream_of(starts))
        kernels.check(rc, "gap_join_first")
    rows = PeakRows(sig.view(torch.bool), skp.view(torch.bool), cand[0],
                    cand[1], exists.view(torch.bool), n)
    return rows if part == -1 else (rows, bufs)


def median_ms(fn, n=20, busy=True, spin_cycles=2_000_000):
    """Median milliseconds of ``fn`` between two CUDA events, after 3
    calls to warm up.  With ``busy`` the card first spins
    ``spin_cycles`` (about a millisecond), so the host has queued all of
    ``fn``'s work before the first event runs: the time is the
    device's alone.  Without it, the time of the call, the host's
    launch work included where the device waits on it."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if busy:
            torch.cuda._sleep(spin_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def auc_rowwise(starts, ends, stat, sig, first, last, min_pq):
    """Each candidate's AUC as updatePeak adds it (Genrich.c:948-964,
    ``genrich_tpu/engine/peaks.py:107-131``): float32 (len * (stat -
    min_pq)) over the significant rows first..last, summed in float32
    in row order.  Rows: numpy [M]; candidates: first/last [K], last <
    first for one with no rows (AUC 0).  Returns f32 [K].
    """
    contrib = np.where(sig, (ends - starts).astype(F32)
                       * (stat - F32(min_pq)), F32(0.0)).astype(F32)
    out = np.zeros(len(first), F32)
    for j, (lo, hi) in enumerate(zip(first, last)):
        if hi >= lo:
            # add.accumulate is a sequential sum (no pairwise blocking)
            out[j] = np.cumsum(contrib[lo:hi + 1], dtype=F32)[-1]
    return out


# --- kernel K5's design (csrc/gapjoin.cu), transcribed ---------------------

GJ_TOP, GJ_LOW = 1 << 31, (1 << 31) - 1
GJ_IDENTITY = (0, -1, 0, 0)   # gapjoin.cu's packed State: (f_start, l_end,
                              # 1 + last sig row | skip before the first,
                              # peaks after the first | skip after the last)
GJ_THREADS = 256              # gapjoin.cu's threads per block
GJ_WARP = 32


def _sub32(a, b):
    """a - b in int32, wrapping."""
    return (int(a) - int(b) + (1 << 31)) % (1 << 32) - (1 << 31)


def _gj_has(a):
    return a[2] & GJ_LOW != 0


def _gj_joins(a, start, skip_before, gap):
    return (a[1] >= 0 and _sub32(start, a[1]) <= gap
            and not a[3] & GJ_TOP and not skip_before)


def gj_combine(a, b, gap):
    """gapjoin.cu's ``combine``: the state of segment a, then b."""
    ah, bh = _gj_has(a), _gj_has(b)
    f_skip = a[2] & GJ_TOP if ah else ((a[3] | b[2]) & GJ_TOP if bh else 0)
    opens = ah and bh and not _gj_joins(a, b[0], b[2] & GJ_TOP, gap)
    npk = ((a[3] & GJ_LOW) + (b[3] & GJ_LOW) + int(opens)) & GJ_LOW
    return (a[0] if ah else b[0], max(a[1], b[1]),
            ((b[2] if bh else a[2]) & GJ_LOW) | f_skip,
            npk | ((b[3] if bh else a[3] | b[3]) & GJ_TOP))


def _gj_upto(k):
    """Rows 0..k of a thread's mask."""
    return (2 << k) - 1


def _gj_thread(sig, skp, starts, ends, lo, n_rows, gap):
    """gapjoin.cu's pass 1 for one thread's rows lo .. lo + n_rows - 1:
    its sig and skp masks, ``opens`` (bit k: sig row lo + k, not the
    thread's first, opens a peak, judged by the largest end of the sig
    rows before it in the thread and the skp rows since the last of
    them) and the thread's packed State."""
    g = sum(int(sig[lo + k]) << k for k in range(n_rows))
    x = sum(int(skp[lo + k]) << k for k in range(n_rows))
    opens, l_end = 0, -1
    for k in range(n_rows):
        below = g & (_gj_upto(k) >> 1)
        if g >> k & 1 and below:
            p = below.bit_length() - 1
            join = (l_end >= 0 and _sub32(starts[lo + k], l_end) <= gap
                    and x & _gj_upto(k) & ~_gj_upto(p) == 0)
            opens |= (0 if join else 1) << k
        if g >> k & 1:
            l_end = max(l_end, int(ends[lo + k]))
    if not g:
        return g, x, opens, (0, -1, 0, GJ_TOP if x else 0)
    f, last = (g & -g).bit_length() - 1, g.bit_length() - 1
    return g, x, opens, (
        int(starts[lo + f]), l_end,
        (lo + last + 1) | (GJ_TOP if x & _gj_upto(f) else 0),
        bin(opens).count("1") | (GJ_TOP if x >> (last + 1) else 0))


def _gj_window(states, gap):
    """``look_back``'s reduction of one window: thread j holds states[j]
    (tile win - j); each warp's lane 0 ends with lanes 31..0 combined in
    that order by a tree of shuffles, then the warps are combined oldest
    first."""
    all_ = GJ_IDENTITY
    warps = [list(states[w:w + GJ_WARP])
             for w in range(0, len(states), GJ_WARP)]
    for v in reversed(warps):
        v += [GJ_IDENTITY] * (GJ_WARP - len(v))
        off = 1
        while off < GJ_WARP:
            v = [gj_combine(v[lane + off], v[lane], gap)
                 if lane + off < GJ_WARP else v[lane]
                 for lane in range(GJ_WARP)]
            off <<= 1
        all_ = gj_combine(all_, v[0], gap)
    return all_


def gap_join_blocked(starts, ends, stat, live, min_pq, max_gap, k_peaks,
                     tile, blocks=264, seed=0):
    """Kernel K5 (``csrc/gapjoin.cu``) in numpy, with ``tile`` rows per
    tile (min(tile, 256) threads of tile / threads rows each) and
    ``blocks`` persistent blocks (at most one per tile), each with a
    ring of two tiles.  Each block is a generator that yields where the
    kernel's blocks may interleave, and a scheduler seeded by ``seed``
    steps them in a random order each round; a round in which every
    block waits is a deadlock and raises.  A block takes its first tile
    from the counter, and for each tile, once its data landed, the next
    one; for each tile each thread judges its rows (``_gj_thread``), the
    block scans the threads' states, publishes the tile's aggregate
    (tile 0: its inclusive prefix), looks back over windows of
    ``threads`` predecessors that all have a flag (``_gj_window``) down
    to the nearest inclusive prefix, publishes its own, and each thread
    writes first_s and prev_s for the peaks its rows open from its exact
    prefix.  Each block writes its share of the K slots as empty before
    it counts itself done; the last block done (every walk is out)
    writes the slots that hold peaks, from the last tile's inclusive
    prefix, and zeroes the counters and flags.  Returns (sig, skp,
    first [K], last [K], exists [K], n) as
    ``ops/peaks.peak_candidates``."""
    m = len(starts)
    gap = int(max_gap)
    threads = min(tile, GJ_THREADS)
    items = tile // threads
    assert threads * items == tile
    thr = F32(min_pq)
    lens = np.array([_sub32(e, s) for s, e in zip(starts, ends)])
    lv = np.asarray(live, bool) & (lens > 0)
    sig = lv & (np.asarray(stat, F32) > thr)
    skp = lv & (np.asarray(stat, F32) == F32(-1.0))
    ntiles = -(-m // tile)
    grid = min(ntiles, blocks)
    mem = {"ticket": 0, "done": 0}
    flag = [0] * ntiles
    agg = [None] * ntiles
    inc = [None] * ntiles
    first_s = np.zeros(m, np.int64)
    prev_s = np.zeros(m, np.int64)
    k = min(k_peaks, m)
    first = np.full(k, 7, np.int64)      # as torch.empty leaves them
    last = np.full(k, 7, np.int64)
    exists = np.ones(k, bool)
    count = []

    def look_back(t):
        excl, win = GJ_IDENTITY, t - 1
        while True:
            lanes = [win - j for j in range(threads)]
            while any(flag[b] == 0 for b in lanes if b >= 0):
                yield True
            fl = [flag[b] if b >= 0 else 2 for b in lanes]
            nearest = fl.index(2) if 2 in fl else threads
            excl = gj_combine(_gj_window(
                [(inc[b] if fl[j] == 2 else agg[b])
                 if b >= 0 and j <= nearest else GJ_IDENTITY
                 for j, b in enumerate(lanes)], gap), excl, gap)
            if nearest < threads:
                return excl
            win -= threads

    def walk(cur, lo, g, x, opens):
        count = 1 + (cur[3] & GJ_LOW) if _gj_has(cur) else 0
        f = (g & -g).bit_length() - 1
        if not (cur[1] >= 0 and _sub32(starts[lo + f], cur[1]) <= gap
                and not cur[3] & GJ_TOP and x & _gj_upto(f) == 0):
            first_s[count] = lo + f
            if count > 0:
                prev_s[count] = (cur[2] & GJ_LOW) - 1
            count += 1
        for kk in range(items):
            if opens >> kk & 1:
                first_s[count] = lo + kk
                prev_s[count] = lo + (g & (_gj_upto(kk) >> 1)).bit_length() - 1
                count += 1

    def block(b):
        more = True
        ring = [ntiles, ntiles]

        def take():
            nonlocal more
            if not more:
                return ntiles
            t = mem["ticket"]
            mem["ticket"] += 1
            if t < ntiles:
                return t
            more = False
            return ntiles
        ring[0] = take()
        yield False
        i = 0
        while ring[i % 2] < ntiles:
            t = ring[i % 2]
            ring[(i + 1) % 2] = take()      # the data of tile t landed
            yield False
            base = t * tile
            per = [_gj_thread(sig, skp, starts, ends, base + j * items,
                              max(0, min(items, m - base - j * items)), gap)
                   for j in range(threads)]
            excl_t, total = [], GJ_IDENTITY
            for *_, a in per:
                excl_t.append(total)
                total = gj_combine(total, a, gap)
            if t == 0:
                prefix = GJ_IDENTITY
                inc[t], flag[t] = total, 2
            else:
                agg[t], flag[t] = total, 1
                yield False
                prefix = yield from look_back(t)
                inc[t], flag[t] = gj_combine(prefix, total, gap), 2
            yield False
            for j, (g, x, opens, _) in enumerate(per):
                if g:
                    walk(gj_combine(prefix, excl_t[j], gap),
                         base + j * items, g, x, opens)
            i += 1
        share = -(-k // grid)                # its share of slots, empty
        for j in range(share * b, min(k, share * (b + 1))):
            first[j], last[j], exists[j] = 0, -1, False
        mem["done"] += 1
        if mem["done"] < grid:
            return
        tot = inc[ntiles - 1]               # the last block done
        n = 1 + (tot[3] & GJ_LOW) if _gj_has(tot) else 0
        count.append(n)
        for j in range(max(0, k - n), k):
            p = j + n - k
            first[j], exists[j] = first_s[p], True
            last[j] = (tot[2] & GJ_LOW) - 1 if p == n - 1 else prev_s[p + 1]
        flag[:] = [0] * ntiles
        mem.update(ticket=0, done=0)

    rng = np.random.RandomState(seed)
    gens = [block(b) for b in range(grid)]
    live_blocks = list(range(grid))
    while live_blocks:
        moved = False
        for b in rng.permutation(live_blocks):
            try:
                moved |= not next(gens[b])
            except StopIteration:
                live_blocks.remove(b)
                moved = True
        if not moved:
            raise RuntimeError("gap_join_blocked: every block waits")
    return sig, skp, first, last, exists, count[0]


def gap_join_rows(rng, m, max_gap, n_regions, skip_frac=0.02,
                  dead_frac=0.05, dead_tail=0):
    """Rows in genomic order for the gap-join: (starts, ends int32, stat
    f32, live bool), numpy.  Rows are 0-40 bp (zero-length ones
    included); between two rows a hole of 0, max_gap - 1, max_gap,
    max_gap + 1 or up to 3 max_gap bp; ``n_regions`` runs of 1-30 rows
    above 2.0 over a background below it, stat exactly 2.0 on some rows
    (not significant); a ``skip_frac`` share SKIP, a ``dead_frac``
    share not live, and the last ``dead_tail`` rows dead padding of
    length 0 at the last end, as the sharded engine's [t, M] rows."""
    lens = rng.randint(0, 41, m)
    holes = rng.choice([0, 0, 0, max_gap - 1, max_gap, max_gap + 1, -1], m)
    holes = np.where(holes < 0, rng.randint(0, 3 * max_gap + 1, m), holes)
    holes[0] = rng.randint(0, 50)
    starts = np.cumsum(holes + np.concatenate([[0], lens[:-1]]))
    ends = starts + lens
    stat = rng.uniform(0.0, 2.0, m).astype(F32)
    for s in rng.choice(m, n_regions, replace=False):
        n = rng.randint(1, 31)
        stat[s:s + n] = rng.uniform(2.0, 9.0, len(stat[s:s + n]))
    stat[rng.rand(m) < 0.01] = F32(2.0)
    stat[rng.rand(m) < skip_frac] = F32(-1.0)
    live = rng.rand(m) >= dead_frac
    if dead_tail:
        starts[-dead_tail:] = ends[-dead_tail - 1]
        ends[-dead_tail:] = ends[-dead_tail - 1]
        live[-dead_tail:] = False
    return (starts.astype(np.int32), ends.astype(np.int32), stat, live)


def blacklist_regions(rng, chroms, n_regions, region_len, tile_len,
                      cut=()):
    """``-E`` regions ((name, start, end) in BED coordinates) drawn from
    ``rng`` (a ``numpy.random.RandomState``) on ``chroms``, (name,
    length) pairs: ``n_regions`` of ``region_len`` = (lo, hi) bp at
    random places of all of them, every tenth followed by one that
    overlaps it and every tenth after the fifth by one adjacent to it
    (the BED loader merges both); one across each tile boundary (each
    multiple of ``tile_len``) of every chromosome; one ending at the
    first chromosome's end; and one from each (name, position) of
    ``cut`` on, so that a peak there is cut.  In the order drawn, not
    sorted (the loader sorts)."""
    lo, hi = region_len
    length = dict(chroms)
    names = [name for name, _ in chroms]
    out = []

    def add(name, start, n):
        start = max(int(start), 0)
        out.append((name, start, min(start + int(n), length[name])))
    for i in range(n_regions):
        name = names[rng.randint(len(names))]
        n = rng.randint(lo, hi + 1)
        add(name, rng.randint(0, max(length[name] - n, 1)), n)
        _, s, e = out[-1]
        if i % 10 == 0:
            add(name, (s + e) // 2, rng.randint(lo, hi + 1))
        elif i % 10 == 5:
            add(name, e, rng.randint(lo, hi + 1))
    for name, size in chroms:
        for b in range(tile_len, size, tile_len):
            n = rng.randint(lo, hi + 1)
            add(name, b - rng.randint(1, n), n)
    name, size = chroms[0]
    n = rng.randint(lo, hi + 1)
    add(name, size - n, n)
    for name, pos in cut:
        add(name, pos, rng.randint(lo, hi + 1))
    return out


def write_bed(path, regions):
    """(name, start, end) regions as a BED file at ``path``."""
    with open(path, "w") as f:
        f.writelines(f"{n}\t{s}\t{e}\n" for n, s, e in regions)
    return path


def _log_rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f
                if not ln.startswith("#") and not ln.startswith("chr\t")]


def check_log(exact_log, port_log, cols=(3, 4, 5)):
    """``test_engine_jax_cli.py:145-170``'s rule: every port row ends at
    a boundary of the exact log, with ``cols`` within 1e-3 relative
    (NA where the exact log has NA), and the covered bp agree.  Raises
    AssertionError; returns a summary."""
    fe, ff = _log_rows(exact_log), _log_rows(port_log)
    fe_map = {(r[0], r[2]): r for r in fe}
    missing = [r for r in ff if (r[0], r[2]) not in fe_map]
    if not ff or missing:
        raise AssertionError(f"{port_log}: {len(missing)} of {len(ff)} "
                             f"rows have no boundary in the exact log: "
                             f"{missing[:3]}")
    worst = 0.0
    for r in ff:
        e = fe_map[(r[0], r[2])]
        for col in cols:
            if e[col] == "NA" or r[col] == "NA":
                if e[col] != r[col]:
                    raise AssertionError(f"NA differs: {e} {r}")
                continue
            x, y = float(e[col]), float(r[col])
            d = abs(x - y) / max(1.0, abs(x))
            worst = max(worst, d)
            if d > 1e-3:
                raise AssertionError(f"log values differ: {e} {r}")

    def span(rs):
        return sum(int(r[2]) - int(r[1]) for r in rs)
    if span(fe) != span(ff):
        raise AssertionError(f"covered bp differ: {span(fe)} {span(ff)}")
    return {"rows_exact": len(fe), "rows_port": len(ff),
            "worst_rel_diff": worst, "bp": span(ff)}


def _log_stats(path):
    """{chrom: (starts, ends, stat)} of an -f log; the stat is the
    column that calls peaks: -log(q) when the log has it, else the
    (combined) -log(p); NA rows are NaN."""
    with open(path) as f:
        header = next(ln for ln in f if ln.startswith("chr\t"))
    names = header.rstrip("\n").split("\t")
    col = names.index("-log(q)") if "-log(q)" in names \
        else max(i for i, n in enumerate(names) if n.startswith("-log(p)"))
    by_chrom = {}
    for r in _log_rows(path):
        by_chrom.setdefault(r[0], []).append(
            (int(r[1]), int(r[2]), np.nan if r[col] == "NA"
             else float(r[col])))
    return {c: tuple(np.array(x) for x in zip(*rows))
            for c, rows in by_chrom.items()}


def check_summits(exact_lines, port_lines, exact_log, tol):
    """narrowPeak column 10 (summit offset) of the port's rows against
    the exact engine's, on the rows whose columns 1-3 agree.  Equal, or
    a near tie: the exact engine's ``-f`` log puts the two summits in
    intervals whose stats lie within ``tol`` relative (the tolerance the
    caller grants columns 8-9), so float32 statistics may pick either.
    Raises AssertionError; returns (rows compared, near ties)."""
    exact = {tuple(ln.split("\t")[:3]): ln.split("\t")
             for ln in exact_lines}
    stats = None
    n = ties = 0
    for ln in port_lines:
        got = ln.split("\t")
        want = exact.get(tuple(got[:3]))
        if want is None:
            continue
        n += 1
        if got[9] == want[9]:
            continue
        stats = stats or _log_stats(exact_log)
        starts, ends, stat = stats[got[0]]
        at = [stat[np.searchsorted(ends, int(got[1]) + int(r[9]),
                                   side="right")] for r in (want, got)]
        if not abs(at[0] - at[1]) <= tol * max(1.0, abs(at[0])):
            raise AssertionError(f"summit differs and is no near tie "
                                 f"(stats {at}): {want} {got}")
        ties += 1
    return n, ties


# --- operation counts and bounds ------------------------------------------

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
FP64_OPS_PER_S = 34e12      # H100 SXM float64, outside the tensor cores

# (float32, float64) operations per call, an FMA counted twice: the SASS
# of probe kernels built with the port's nvcc flags, from entry to first
# EXIT, less a copy kernel's (``python -m genrich_tpu_torch.sass_cost``
# with CUDA 12.8's nvcc and cuobjdump for sm_90a).
LIBM_OPS = {
    "logf": (32, 0), "log10f": (33, 0), "expf": (11, 0), "log1pf": (31, 0),
    "sqrtf": (7, 0), "fdiv": (12, 0),
    "log": (3, 47), "log1p": (9, 86), "expm1": (9, 36), "exp": (4, 32),
    "lgamma": (10, 97), "ddiv": (4, 16)}


def scan_bytes(m, groups, lam):
    """K1: packed int32 in, groups x f32 coverage (+ f32 p) out."""
    return 4 * m * (1 + groups + (lam is not None))


def stats_bytes(m):
    """K2: ev, cr f32 and the excluded mask in, -log10 p f32 out."""
    return 13 * m


def peak_reduce_bytes(first, last):
    """K4's bytes on these candidates: 13 per row of an existing peak
    (starts, ends, stat, sig; the summit's p and q are two rows more),
    16 per candidate in and 24 out."""
    rows = int((last - first + 1).clamp_min(0).sum())
    return 13 * rows + 40 * first.shape[0]


def gap_join_bytes(m, k):
    """The gap-join's bytes on m rows and k slots: starts, ends, stat
    and live in (13 per row), sig and skp out (2 per row), first, last
    and exists out (17 per slot), and the count.  Its operations (a few
    integer compares per row) bind far below its bytes."""
    return 15 * m + 17 * k + 8


def call_work(name, args):
    """The bytes and operations of one call of kernel wrapper ``name``
    (K1, K2, K5 or K4 by its key of ``kernels.LAUNCHES``) on its
    arguments ``args``, as ``recording`` keeps them: {"bytes",
    "fp32_ops", "fp64_ops"}.  K1 in lambda mode counts its p-value
    branches on the coverage its plain version gives."""
    from .ops import scan
    fp32 = fp64 = 0       # K5 and K4: bytes only, as chip_smoke.py counts
    if name == "coverage_scan":
        packed, groups, carry, lam = (list(args) + [None])[:4]
        m = packed.shape[0]
        cov = None if lam is None else scan.coverage_scan_plain(
            packed, groups, carry)[0][0]
        nbytes = scan_bytes(m, groups, lam)
        fp32 = coverage_scan_opcount(m, groups, cov, lam)["fp32_ops"]
    elif name == "tile_stats":
        nbytes = stats_bytes(args[0].shape[0])
        fp32 = tile_stats_opcount(*args)["fp32_ops"]
    elif name == "gap_join":
        m = args[0].shape[0]
        nbytes = gap_join_bytes(m, min(args[6], m))
    elif name == "peak_reduce":
        nbytes = peak_reduce_bytes(args[6], args[7])
    else:
        raise ValueError(f"no byte count for kernel {name}")
    return {"bytes": int(nbytes), "fp32_ops": int(fp32),
            "fp64_ops": int(fp64)}


def bound(nbytes, fp32_ops=0, fp64_ops=0):
    """The least time the card could take for work that moves ``nbytes``
    and runs these operations: the larger of the bytes over the memory
    rate and the operations over their unit's peak rate (the float32
    and float64 units run side by side).  Returns (ms, "bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(fp32_ops / FP32_OPS_PER_S, fp64_ops / FP64_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class _Ops:
    """float32 and float64 operations, summed over pieces of code."""

    def __init__(self):
        self.fp32 = 0
        self.fp64 = 0

    def add(self, n, fp32=0, fp64=0, **libm):
        """``n`` times: ``fp32``/``fp64`` written operations and the
        libm calls ``name=calls``."""
        n = int(n)
        self.fp32 += n * fp32
        self.fp64 += n * fp64
        for name, calls in libm.items():
            a, b = LIBM_OPS[name]
            self.fp32 += n * calls * a
            self.fp64 += n * calls * b


# calc_pval (csrc/pval.cuh), float32 operations written in each piece:
#   early returns: ctrl == -1 (1); ctrl == 0 and expt == 0 (3 in all)
#   control's log-normal parameters: fmaxf, 10 *, mu2, sd2, ctrl > 7 (5)
#     + log10f; ctrl > 7: sd2 + mu2 (1) + 2 sqrtf, 2 fdiv, logf, log1pf;
#     else logf(mu) - LOGSQRT (1) + logf
#   x: fmaxf, - meanlog (2) + logf, fdiv;  p: neg, fminf (2) + fdiv
#   pnorm_upper_log: fabsf, y <= a (2), then
#     A: xsq, xnum, 3 x 4 recurrence, y > eps/2, x * (.. + ..), (.. + ..)
#        (19) + fdiv; tiny |x|: x * c instead (17); logf(0.5 - t) (1) + logf
#     B: y <= sqrt32, xnum, 7 x 4, 2 adds, x <= 0 (33) + fdiv + do_del
#     C: 2 compares, x * x, fmaxf, xnum, 4 x 4, 3, 2, x <= 0 (27)
#        + 3 fdiv + do_del;  |x| = inf: 2 compares (2)
#   do_del: y * 16, truncf, / 16, d (6), then ret: neg, mul, sub, / 2,
#     * temp, neg (6) + expf + log1pf; else neg, mul, sub, / 2, + (5) + logf
def calc_pval_opcount(expt, ctrl, lam=None):
    """Tally of ``calc_pval`` over rows: float32 tensors ``expt`` and
    ``ctrl`` (SKIP -1 for an excluded row).  Rows whose ctrl equals
    ``lam`` share one evaluation of the control's log-normal parameters
    (it depends on lambda alone).  Returns {"rows", "branches",
    "fp32_ops"}."""
    import torch
    f = torch.float32
    expt, ctrl = expt.to(f), ctrl.to(f)
    skip = ctrl == -1.0
    czero = ~skip & (ctrl == 0.0)
    ezero = ~skip & ~czero & (expt == 0.0)
    main = ~(skip | czero | ezero)
    at_lam = main & (ctrl == float(F32(lam))) if lam is not None \
        else torch.zeros_like(main)
    own = main & ~at_lam
    mu = torch.clamp_min(ctrl, float(F32(1e-30)))
    sd = 10.0 * torch.log10(mu)
    mu2, sd2 = mu * mu, sd * sd
    big = ctrl > 7.0
    meanlog = torch.where(big, torch.log(mu2 / torch.sqrt(sd2 + mu2)),
                          torch.log(mu) - float(F32(0.445999019652555)))
    sdlog = torch.where(big, torch.sqrt(torch.log1p(sd2 / mu2)),
                        torch.full_like(mu, float(F32(0.944456478248262))))
    x = (torch.log(torch.clamp_min(expt, float(F32(1e-30)))) - meanlog) \
        / sdlog
    y = torch.abs(x)
    a = main & (y <= float(F32(0.67448975)))
    tiny = a & ~(y > float(np.finfo(F32).eps) * 0.5)
    b = main & ~a & (y <= float(F32(5.656854249492381)))
    c = main & ~a & ~b & (y < float(np.finfo(F32).max))
    ret = (b | c) & (x <= 0.0)
    br = {"skip": skip, "ctrl_zero": czero, "expt_zero": ezero,
          "main": main, "at_lambda": at_lam, "own_big": own & big,
          "own_small": own & ~big, "A": a & ~tiny, "A_tiny": tiny, "B": b,
          "C": c, "inf": main & ~a & ~b & ~c, "do_del_ret": ret,
          "do_del_log": (b | c) & ~ret}
    n = {k: int(v.sum()) for k, v in br.items()}
    ops = _Ops()
    ops.add(n["skip"], 1)
    ops.add(n["ctrl_zero"] + n["expt_zero"] + n["main"], 3)
    lam_big = lam is not None and float(F32(lam)) > 7.0
    for k, once in (("own_big", 0), ("own_small", 0), ("at_lambda", 1)):
        rows = (1 if n[k] else 0) if once else n[k]
        is_big = lam_big if once else k == "own_big"
        ops.add(rows, 5, log10f=1)
        if is_big:
            ops.add(rows, 1, sqrtf=2, fdiv=2, logf=1, log1pf=1)
        else:
            ops.add(rows, 1, logf=1)
    ops.add(n["main"], 2 + 2 + 2, logf=1, fdiv=2)    # x, p, pnorm entry
    ops.add(n["A"], 19 + 1, fdiv=1, logf=1)
    ops.add(n["A_tiny"], 17 + 1, logf=1)
    ops.add(n["B"], 33, fdiv=1)
    ops.add(n["C"], 27, fdiv=3)
    ops.add(n["inf"], 2)
    ops.add(n["do_del_ret"], 6 + 6, expf=1, log1pf=1)
    ops.add(n["do_del_log"], 6 + 5, logf=1)
    return {"rows": int(expt.numel()), "branches": n, "fp32_ops": ops.fp32}


# integral values with an entry in K2's tables (csrc/stats.cu TABLE)
STATS_TABLE = 8192


def _in_table(v):
    """Rows whose value ``v`` (float32) has a table entry."""
    import torch
    return (v >= 1.0) & (v < STATS_TABLE) & (torch.trunc(v) == v)


def tile_stats_opcount(expt, ctrl_raw, excluded, factor, lam):
    """Tally of kernel K2 (csrc/stats.cu) on its arguments: per live
    row factor * ctrl_raw and fmaxf with lambda (2), then calc_pval.
    The operations are calc_pval's, row by row; the branches add
    ``table_p`` and ``table_params``, the rows whose p-value (a signal
    against lambda) or log-normal parameters (a control of its own) K2
    reads from its tables instead."""
    import torch
    factor, lam = float(F32(factor)), float(F32(lam))
    cr = ctrl_raw.to(torch.float32)
    ctrl = torch.clamp_min(factor * cr, lam)
    ctrl = torch.where(excluded, torch.full_like(ctrl, -1.0), ctrl)
    ev = torch.where(excluded, torch.zeros_like(ctrl),
                     expt.to(torch.float32))
    res = calc_pval_opcount(ev, ctrl, lam)
    res["fp32_ops"] += 2 * int((~excluded).sum())
    main = (ctrl != -1.0) & (ctrl != 0.0) & (ev != 0.0)
    at_lam = main & (ctrl == lam)
    res["branches"].update(
        table_p=int((at_lam & _in_table(ev)).sum()),
        table_params=int((main & ~at_lam & _in_table(cr)).sum()))
    return res


def coverage_scan_opcount(m, groups, coverage=None, lam=None):
    """Tally of kernel K1 (csrc/scan.cu): canon_value's int-to-float
    conversions, * 0.125 and three adds (6 per group and row) and, in
    lambda mode, calc_pval of the coverage against lambda."""
    import torch
    res = {"rows": int(m), "fp32_ops": 6 * groups * int(m)}
    if lam is not None:
        c = calc_pval_opcount(coverage, torch.full_like(coverage, float(
            F32(lam))), lam)
        res.update(branches=c["branches"],
                   fp32_ops=res["fp32_ops"] + c["fp32_ops"])
    return res


_M_LOG10E = 0.434294481903251827651128918916605082
_M_LN2 = 0.693147180559945309417232121458176568


def _stirlerr_ops(ops, n):
    """stirlerr(n) of fisher.cu: nn and the compares, then a table entry
    (n <= 15) or 3-5 divisions and 2-4 subtractions."""
    if n > 80:
        ops.add(1, fp64=1 + 1 + 2, ddiv=3)
    elif n > 35:
        ops.add(1, fp64=1 + 2 + 3, ddiv=4)
    elif n > 15:
        ops.add(1, fp64=1 + 3 + 4, ddiv=5)
    else:
        ops.add(1, fp64=1 + 3 + 1)


# fisher.cu, operations written in each piece (float64 unless noted):
#   per replicate: v != SKIP (1 float32); per live value: cvt, + (2)
#   live >= 2: total == 0 (1); one live value or a zero total: cvt (1)
#   combined lanes: 2 * total, x / 2, alph (cvt, *, / 2), neg, > FLT_MAX,
#     cvt, x < 1 (9) + 2 ddiv
#   pgamma_smallx: per term n + 1, neg, *, alph + n, +, 2 fabs, *, > (9)
#     + 2 ddiv; then alph * log - lgamma (2) + log, log1p(..) + (1)
#     + log1p, log1_exp
#   log1_exp: > -ln2, neg (2) + expm1 + log, or + exp + log1p
#   dpois: alph - 1, 2 pi x, * -0.5, 2 subtractions (5) + log; bd0:
#     |x - np| < 0.1 (x + np) (5); near: v, s, |s| < DBL_MIN (6) + ddiv,
#     ej, v2 (3), per term * v2, cvt, +, == (4) + ddiv; far: (3) + ddiv
#     + log;  x <= alph - 1 (2)
#   pd_upper_series: ddiv; per term a + 1, *, +, *, > (5) + ddiv; log;
#     then + d (1), log1_exp
#   pd_lower_series: alph - 1, y >= 1 (2); per term *, +, - 1, >= 1, *,
#     > (6) + ddiv; log1p; then + d (1)
#   once per live count: lgamma(alph + 1) (1 + lgamma), stirlerr(alph-1)
def fisher_combine_opcount(pv):
    """Tally of kernel K3 (csrc/fisher.cu) on f32 [R, N] replicate rows:
    lanes per path, each series' trip counts (from the plain version's
    masked loops, ``ops.chisq.pgamma(..., trips=)``) and float32 and
    float64 operations.  What depends only on a lane's live count
    (``lgamma(live + 1)``, ``stirlerr(live - 1)``) counts once per live
    count.  Returns {"lanes", "paths", "trips", "fp32_ops",
    "fp64_ops"}."""
    import torch

    from .ops import chisq
    r = pv.shape[0]
    live = pv != -1.0
    n_live = live.sum(dim=0)
    total = torch.zeros(pv.shape[1], dtype=torch.float64, device=pv.device)
    for k in range(r):
        total = total + torch.where(live[k], pv[k].double(),
                                    torch.zeros_like(total))
    comp = (n_live >= 2) & (total != 0.0)
    trivial = ((n_live == 1) | ((n_live >= 2) & (total == 0.0)))
    xg = (2.0 * total[comp] / _M_LOG10E) / 2.0
    alph = n_live[comp].to(torch.float64)
    trips = {}
    res = chisq.pgamma(xg, alph, trips=trips)
    small = xg < 1
    upper = ~small & (xg <= alph - 1)
    lower = ~small & ~upper
    a, npx = alph - 1, xg
    near = ~small & (torch.abs(a - npx) < 0.1 * (a + npx))
    v = torch.where(near, (a - npx) / (a + npx), torch.zeros_like(a))
    tiny = near & (torch.abs((a - npx) * v) < torch.finfo(torch.float64).tiny)
    expm1_br = res < -_M_LN2          # log1_exp's log(-expm1) branch
    t_small = trips["pgamma_smallx"][small]
    t_up = trips["pd_upper_series"][upper]
    t_lo = trips["pd_lower_series"][lower]
    t_bd0 = trips["bd0"][near & ~tiny]
    ops = _Ops()
    ops.add(pv.shape[1] * r, fp32=1)
    ops.add(int(live.sum()), fp64=2)
    ops.add(int((n_live >= 2).sum()), fp64=1)
    ops.add(int(trivial.sum()), fp64=1)
    ops.add(int(comp.sum()), fp64=9, ddiv=2)
    ops.add(int(t_small.sum()), fp64=9, ddiv=2)
    ops.add(int(small.sum()), fp64=2 + 1, log=1, log1p=1)
    for br in (small, upper):
        ops.add(int((br & expm1_br).sum()), fp64=2, expm1=1, log=1)
        ops.add(int((br & ~expm1_br).sum()), fp64=2, exp=1, log1p=1)
    ops.add(int((~small).sum()), fp64=5 + 5 + 2, log=1)
    ops.add(int(near.sum()), fp64=6, ddiv=1)
    ops.add(int((near & ~tiny).sum()), fp64=3)
    ops.add(int(t_bd0.sum()), fp64=4, ddiv=1)
    ops.add(int((~small & ~near).sum()), fp64=3, ddiv=1, log=1)
    ops.add(int(upper.sum()), fp64=1, ddiv=1, log=1)
    ops.add(int(t_up.sum()), fp64=5, ddiv=1)
    ops.add(int(lower.sum()), fp64=2 + 1, log1p=1)
    ops.add(int(t_lo.sum()), fp64=6, ddiv=1)
    for k in torch.unique(alph[small]).tolist():
        ops.add(1, fp64=1, lgamma=1)
    for k in torch.unique(alph[~small]).tolist():
        _stirlerr_ops(ops, k - 1)

    def stats(t):
        return {"lanes": int(t.numel()), "sum": int(t.sum()),
                "max": int(t.max()) if t.numel() else 0}
    return {"lanes": int(pv.shape[1]),
            "paths": {"skip": int((n_live == 0).sum()),
                      "trivial": int(trivial.sum()),
                      "small_x": int(small.sum()),
                      "upper": int(upper.sum()), "lower": int(lower.sum()),
                      "bd0_series": int((near & ~tiny).sum()),
                      "log1_exp_expm1": int((expm1_br & (small | upper))
                                            .sum())},
            "trips": {"pgamma_smallx": stats(t_small),
                      "pd_upper_series": stats(t_up),
                      "pd_lower_series": stats(t_lo), "bd0": stats(t_bd0)},
            "fp32_ops": ops.fp32, "fp64_ops": ops.fp64}
