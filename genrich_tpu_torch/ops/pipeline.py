"""Per-tile coverage, p-values and peaks (twin of ops/pipeline_jax.py).

``tile_coverage`` merges expt, ctrl and exclusion breakpoints into one
sort of 8-channel packed class deltas and scans them with kernel K1
(``ops/scan.py``, two 10-bit groups); ``tile_stats`` turns coverage
into -log10 p with kernel K2 (``csrc/stats.cu``) on the card, or with
its plain PyTorch version on the CPU.  The single-tile helpers
(``analyze_tile_core``, ``analyze_tile``, ``analyze_tile_ctrl``) chain
them into peak calling; ``analyze_tile_core`` scans in K1's lambda mode,
the Pallas kernel's own function.  ``tile_class_totals`` gives the
inter-tile carries of the sharded engine (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from .peaks import TilePeaks, call_peaks
from .pileup import (PACKED_ADD, PACKED_SUB, PACKED_ZERO, device_table,
                     event_deltas, unpack_deltas)
from .pvalue import calc_pval
from .scan import coverage_scan


class TileResult(NamedTuple):
    peaks: TilePeaks
    frag_len: torch.Tensor     # f32 scalar: weighted fragment length
    n_intervals: torch.Tensor  # int32 scalar: live intervals


def build_event_points(start, end, count):
    """Events -> (pos, deltas) point lists (2E points, deltas [2E, 4])."""
    add, sub = event_deltas(count)
    return torch.cat([start, end]), torch.cat([add, sub], dim=0)


# the packed payload of an add / a sub row per count code with its
# deltas in group 0 or 1 of the 8-channel rows, the other group's zero
_GROUP_ADD = tuple((PACKED_ADD << (10 * g)) | (PACKED_ZERO << (10 * (1 - g)))
                   for g in (0, 1))
_GROUP_SUB = tuple((PACKED_SUB << (10 * g)) | (PACKED_ZERO << (10 * (1 - g)))
                   for g in (0, 1))


def _packed_points(start, end, count, group: int):
    """Events -> (pos, packed) with the class deltas in ``group``.

    The packed payload equals ``pack_deltas`` of the 8-channel rows
    ``tile_coverage`` builds (the other group holds zero deltas), read
    from a per-count-code table instead of packing each row.
    """
    dev = start.device
    idx = count.long()
    return (torch.cat([start, end]),
            torch.cat([device_table(_GROUP_ADD[group], dev)[idx],
                       device_table(_GROUP_SUB[group], dev)[idx]]))


def _excluded(starts, excl):
    """True for intervals whose start lies inside a -E exclusion.

    excl: int32 [K, 2] sorted (start, end) pairs, padded with
    (tile_len, tile_len).  The JAX twin's ``side="right"`` parity test.
    """
    idx = torch.searchsorted(excl.reshape(-1).contiguous(), starts,
                             right=True)
    return (idx % 2) == 1


def tile_coverage(es, ee, ec, cs, ce, cc, excl, tile_len, carry_e,
                  carry_c, limit=None, levels: bool = False):
    """Events -> per-interval expt/ctrl coverage for one tile.

    es/ee: int32 [E] starts/ends, ec: count codes [E] (any integer
    dtype, padding rows have code 0); likewise cs/ce/cc for control.
    Returns (starts, ends, expt_val, ctrl_raw, excluded, live,
    frag_len, ctrl_frag) like the JAX twin; ctrl_raw is the unscaled
    control coverage, and the two fragment sums are float64 scalars
    (``frag_sum``; the JAX twin's are float32).  ``limit`` (default
    tile_len) clips the analysed span.  Rows that share a position come out of the (unstable) sort
    in any order; consumers mask rows of length 0.  With ``levels``
    a ninth array follows: ``expt_level``, 120 times the treatment's
    exact pileup value at each row as int64 (``expt_levels``), which
    ``compact.pileup_runs`` compares where float32 values may round
    two pileup values to one.
    """
    if limit is None:
        limit = tile_len
    dev = es.device
    e_pos, e_pk = _packed_points(es, ee, ec, 0)
    c_pos, c_pk = _packed_points(cs, ce, cc, 1)
    x_pos = excl.reshape(-1).to(torch.int32)
    zero8 = PACKED_ZERO | (PACKED_ZERO << 10)
    pos = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     e_pos.to(torch.int32), c_pos.to(torch.int32), x_pos])
    packed = torch.cat([
        torch.full((1,), zero8, dtype=torch.int32, device=dev),
        e_pk, c_pk,
        torch.full((x_pos.shape[0],), zero8, dtype=torch.int32,
                   device=dev)])
    pos, order = torch.sort(pos)
    packed = packed[order]
    vals, _ = coverage_scan(packed, 2,
                            torch.cat([carry_e, carry_c]).to(torch.int32))
    expt_val, ctrl_raw = vals[0], vals[1]

    starts = pos
    ends = torch.cat([pos[1:], torch.full((1,), int(tile_len),
                                          dtype=pos.dtype, device=dev)])
    ends = torch.clamp_max(ends, int(limit))
    excluded = _excluded(starts, excl)
    live = starts < int(limit)
    lens = torch.clamp_min(ends - starts, 0).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    frag_len = frag_sum(torch.where(excluded, zero, lens * expt_val))
    ctrl_frag = frag_sum(torch.where(excluded, zero, lens * ctrl_raw))
    out = (starts, ends, expt_val, ctrl_raw, excluded, live, frag_len,
           ctrl_frag)
    if levels:
        out += (expt_levels(packed, carry_e),)
    return out


FRAG_CHUNK = 1 << 12    # terms per partial of ``frag_sum``


def frag_sum(terms):
    """float64 sum of float32 terms in an order fixed by their count.

    The terms go in chunks of FRAG_CHUNK, each summed by one thread
    (``sum(dim=1)`` splits its work over the chunks, never inside one),
    then the partials are added in order (``cumsum``).  A plain
    ``.sum()`` splits its work by ``torch.get_num_threads()``, and a
    float32 sum of ~10^5 terms then changes in the last bit with the
    thread count.  The exact engine adds the same float32 terms
    ``f32(len) * val`` one by one in float64
    (``engine/pileup.py::exact_sum_f64``); where every term is an
    integer (ATAC pileups of whole weights) both sums are exact and
    equal.  Returns a float64 scalar tensor.
    """
    pad = (-terms.shape[0]) % FRAG_CHUNK
    chunks = torch.cat([terms, terms.new_zeros(pad)]).view(-1, FRAG_CHUNK)
    return torch.cumsum(chunks.sum(dim=1, dtype=torch.float64), 0)[-1]


# 120 x (cov + e8/8 + s6/6 + t10/10): the class sums' rational value as
# an integer (getVal's value, Genrich.c:1902-1907, before rounding)
LEVEL_WEIGHTS = np.array([120, 15, 20, 12], np.int64)


def expt_levels(packed, carry):
    """Exact treatment pileup per row of sorted packed deltas: int64
    [M], 120 times the value of the inclusive class sums plus ``carry``
    (int32 [4]).  Two rows have the same value iff their levels are
    equal; the exact engine breaks an interval exactly there
    (``engine/pileup.py::_entry_nonzero``), where float32 rounds two
    values to one once coverage passes about 2^21."""
    w = device_table(LEVEL_WEIGHTS, packed.device)
    step = (unpack_deltas(packed, 1).to(torch.int64) * w).sum(dim=1)
    return torch.cumsum(step, dim=0) + (carry.to(torch.int64) * w).sum()


def tile_stats_plain(expt_val, ctrl_raw, excluded, factor, lam):
    """Plain PyTorch version of kernel K2 (pipeline_jax.tile_stats)."""
    factor = float(np.float32(factor))
    lam = float(np.float32(lam))
    ctrl_val = torch.clamp_min(factor * ctrl_raw, lam)
    ctrl_eff = torch.where(excluded, torch.full_like(ctrl_val, -1.0),
                           ctrl_val)
    return calc_pval(torch.where(excluded, torch.zeros_like(expt_val),
                                 expt_val), ctrl_eff)


def _tile_stats_cuda(expt_val, ctrl_raw, excluded, factor, lam):
    """Launch csrc/stats.cu on the card.

    Replaces the elementwise XLA program of pipeline_jax.tile_stats
    (:164-173).  Bound by device-memory bandwidth (9 B in, 4 B out per
    row) where the arithmetic is read from tables: a first launch
    evaluates, for each integral coverage value below the table's size,
    the p-value of that signal against lambda and the log-normal
    parameters of that raw control; the second walks the rows and runs
    the p-value math (csrc/pval.cuh) only for values beyond the tables
    (see the source's header).  The math evaluates only the branch each
    row takes, where the plain version evaluates every branch and
    selects.
    """
    expt_val = expt_val.contiguous()
    ctrl_raw = ctrl_raw.contiguous()
    ex = excluded.contiguous().view(torch.uint8)
    m = expt_val.shape[0]
    with torch.cuda.device(expt_val.device):
        lib = kernels.library()
        pval = torch.empty(m, dtype=torch.float32, device=expt_val.device)
        tables = torch.empty(lib.tile_stats_scratch_bytes(),
                             dtype=torch.uint8, device=expt_val.device)
        rc = lib.tile_stats_launch(
            kernels.ptr(expt_val), kernels.ptr(ctrl_raw), kernels.ptr(ex),
            float(np.float32(factor)), float(np.float32(lam)),
            kernels.ptr(pval), m, kernels.ptr(tables),
            kernels.stream_of(expt_val))
        kernels.check(rc, "tile_stats")
    kernels.count("tile_stats", expt_val.device)
    return pval


def tile_stats(expt_val, ctrl_raw, excluded, factor, lam):
    """-log10 p per interval from coverage + global factor/lambda.

    Ctrl coverage is max(factor * ctrl_raw, lambda); excluded intervals
    carry SKIP (savePileupCtrl/savePval, Genrich.c:2052-2161,
    1720-1794), in float32.  Kernel K2 on CUDA tensors, the plain
    version on CPU tensors.
    """
    for t, dt in ((expt_val, torch.float32), (ctrl_raw, torch.float32),
                  (excluded, torch.bool)):
        if t.dtype != dt or t.dim() != 1 or t.shape != expt_val.shape:
            raise TypeError("tile_stats takes f32 [M], f32 [M], bool [M]")
        if t.device != expt_val.device:
            raise ValueError("tile_stats inputs must share a device")
    if expt_val.device.type == "cuda":
        return _tile_stats_cuda(expt_val, ctrl_raw, excluded, factor, lam)
    if expt_val.device.type != "cpu":
        raise ValueError(f"unsupported device {expt_val.device}")
    return tile_stats_plain(expt_val, ctrl_raw, excluded, factor, lam)


def tile_class_totals(start, end, count):
    """Sum of all class deltas of a tile's events (int32 [..., 4]).

    The inter-tile carry of the sharded engine is the exclusive prefix
    of these totals over the tiles in genomic order.  Leading dims are
    batch dims: [t, E] events give [t, 4].
    """
    add, sub = event_deltas(count)
    return (add + sub).sum(dim=-2, dtype=torch.int32)


def analyze_tile_core(start, end, count, tile_len, carry, lam, min_pq,
                      min_auc, min_len: int, max_gap: int) -> TileResult:
    """Tile analysis with an inter-tile carry: events -> peaks.

    start/end/count: [E] events, padding rows count 0 at tile_len.
    carry: int32 [4] class sums entering the tile.  lam: background
    rate (no control); min_pq: the -log10 threshold.  A virtual point
    at 0 makes the leading interval carry the incoming coverage.  The
    scan is K1's lambda mode (``coverage_pval_fused``'s function):
    coverage and -log10 p against lam in one pass.
    """
    dev = start.device
    idx = count.long()
    pos = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     start.to(torch.int32), end.to(torch.int32)])
    packed = torch.cat([
        torch.full((1,), PACKED_ZERO, dtype=torch.int32, device=dev),
        device_table(PACKED_ADD, dev)[idx],
        device_table(PACKED_SUB, dev)[idx]])
    pos, order = torch.sort(pos)
    vals, pval = coverage_scan(packed[order], 1, carry.to(torch.int32),
                               float(np.float32(lam)))
    vals = vals[0]
    starts = pos
    ends = torch.cat([pos[1:], torch.full((1,), int(tile_len),
                                          dtype=pos.dtype, device=dev)])
    frag_len = ((ends - starts).to(torch.float32) * vals).sum()
    live = starts < int(tile_len)
    peaks = call_peaks(starts, ends, pval, pval, torch.full_like(pval, -1.0),
                       live, float(np.float32(min_pq)),
                       float(np.float32(min_auc)), min_len, max_gap)
    return TileResult(peaks, frag_len, live.sum(dtype=torch.int32))


def analyze_tile(start, end, count, tile_len, lam, min_pq, min_auc,
                 min_len: int, max_gap: int) -> TileResult:
    """Single-tile analysis (no carry): events -> peaks."""
    zero = torch.zeros(4, dtype=torch.int32, device=start.device)
    return analyze_tile_core(start, end, count, tile_len, zero, lam, min_pq,
                             min_auc, min_len, max_gap)


def analyze_tile_ctrl(es, ee, ec, cs, ce, cc, excl, tile_len, carry_e,
                      carry_c, lam, factor, min_pq, min_auc, min_len: int,
                      max_gap: int):
    """Full-feature single-tile analysis: expt + ctrl + exclusions.

    Through K1 (``tile_coverage``), K2 (``tile_stats``) and K4
    (``call_peaks``).  Returns (TileResult, ctrl_frag, pval, starts,
    ends, live), as the JAX twin.
    """
    (starts, ends, expt_val, ctrl_raw, excluded, live, frag_len,
     ctrl_frag) = tile_coverage(es, ee, ec, cs, ce, cc, excl, tile_len,
                                carry_e, carry_c)
    pval = tile_stats(expt_val, ctrl_raw, excluded, factor, lam)
    peaks = call_peaks(starts, ends, pval, pval, torch.full_like(pval, -1.0),
                       live, float(np.float32(min_pq)),
                       float(np.float32(min_auc)), min_len, max_gap)
    return (TileResult(peaks, frag_len.to(torch.float32),
                       live.sum(dtype=torch.int32)),
            ctrl_frag.to(torch.float32), pval, starts, ends, live)


def random_events(generator: torch.Generator, n_events: int, tile_len: int,
                  n_hotspots: int = 8, frac_hot: float = 0.7):
    """Synthetic clustered fragment events for benches and dry runs.

    A share ``frac_hot`` of the events start within 1,500 bp after one
    of ``n_hotspots`` random positions, the rest anywhere in the tile;
    fragments are 80-399 bp, clipped to the tile, never empty.  Drawn
    from ``generator`` on its device: (start, end, count) int32 [n].
    """
    g = generator
    dev = g.device

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)

    hot = randint(0, max(1, tile_len - 2000), n_hotspots)
    which = randint(0, n_hotspots, n_events)
    is_hot = torch.rand(n_events, generator=g, device=dev) < frac_hot
    base = torch.where(is_hot, hot[which] + randint(0, 1500, n_events),
                       randint(0, max(1, tile_len - 500), n_events))
    frag = randint(80, 400, n_events)
    start = base.clamp(0, tile_len - 1).to(torch.int32)
    end = (base + frag).clamp(1, tile_len).to(torch.int32)
    end = torch.maximum(end, start + 1)
    return start, end, torch.ones(n_events, dtype=torch.int32, device=dev)
