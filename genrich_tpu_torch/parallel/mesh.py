"""Sharding of the genome-tile pipeline (twin of parallel/mesh.py).

The genome is cut into fixed-length tiles; a shard holds a contiguous
block of them, a ``[t, ...]`` batch on its card.  Where the JAX package
runs each step as a ``shard_map`` over a 1-D device mesh, the port runs
it over each shard's tiles, one tile after the other (``vmap`` written
out), and the three global couplings of the JAX module become
collectives over a group of shards, local operations without one:

  - weighted fragment length -> lambda: every shard gets every tile's
    sum (a shard-ordered gather, the JAX module's
    ``replicated_concat``), so each runs the same float64 host sum;
  - inter-tile pileup carry: per-tile class-delta totals are gathered
    and prefix-summed, the scan carry for fragments that span tile
    boundaries;
  - the distinct (p, bp) tables for the exact BH, and the per-tile peak
    arrays when ``replicated``, ride the same gather; peaks straddling
    tile boundaries merge on the host (``merge_tile_peaks``).

A group is a ``torch.distributed`` process group (one shard a process,
on its card: ``all_gather``) or a ``CardGroup``, the cards of this
process, one shard each, the JAX module's mesh over ``jax.devices()``:
a gather copies every card's rows to every card (peer copies), and the
steps take and give lists of per-card tensors.  A ``CardGroup`` may
also span the processes of a process group, every rank with the same
number of cards, as the JAX mesh spans every process's devices: shard
``rank * n_local + c`` is card c of that rank (processes major, local
devices minor), and a gather joins each rank's cards on its first card
before one ``all_gather`` across the ranks.

The host-side numpy helpers (``split_events_to_tiles``,
``split_excl_to_tiles``, ``merge_tile_peaks`` and its loop oracle,
``exact_q_table``) are copies of the JAX module's, held to them by
tests/test_torch_parallel.py; ``split_events_flat``, the split without
its padding that the sharded engine uploads, is the port's own.
"""

from __future__ import annotations

from functools import partial, wraps
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.compact import (SKIP, assign_qvals, distinct_pvals_k,
                           merge_fisher, pileup_runs, rle_pv, rle_runs)
from ..ops.peaks import TilePeaks, call_peaks
from ..ops.pipeline import (TileResult, analyze_tile_core,
                            tile_class_totals, tile_coverage, tile_stats)

PEAK_CAP = 4096            # per-tile candidate slots (call_peaks k)


class CardGroup:
    """The shards of one group, in shard order: this process's cards and,
    under a process group, every rank's.

    ``devices``: one device a shard (a device may repeat: two shards on
    one card); None for one shard on whatever device its tensors are.
    ``procs``: a ``torch.distributed`` process group whose ranks each
    hold ``n_local`` cards, the same count on every rank (checked here
    with one gather: unequal counts raise ``ValueError`` on every rank);
    card c of rank r is shard ``r * n_local + c``.  Per-card values are
    lists, one entry a card.
    """

    def __init__(self, devices: Optional[Sequence] = None, procs=None):
        self.devices = None if devices is None \
            else [torch.device(d) for d in devices]
        self.n_local = 1 if devices is None else len(self.devices)
        if self.n_local < 1:
            raise ValueError("a CardGroup needs at least one device")
        self.procs = procs
        n_proc, rank = world_rank(procs)
        if procs is not None:
            counts = gather_rows(torch.tensor(
                [self.n_local], device=self._home(procs)), procs).tolist()
            if len(set(counts)) > 1:
                raise ValueError(f"the ranks of the process group hold "
                                 f"{counts} cards; every rank needs the "
                                 f"same count")
        self.size = n_proc * self.n_local       # shards in all
        self.first = rank * self.n_local        # this process's first

    def _home(self, procs) -> torch.device:
        """The rank's first card, where its collectives run."""
        if self.devices is not None:
            return self.devices[0]
        import torch.distributed as dist
        if dist.get_backend(procs) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def gather(self, xs: List[torch.Tensor],
               ragged: bool = False) -> List[torch.Tensor]:
        """Per-card [t, ...] -> per-card [size * t, ...]: every shard's
        rows in shard order, on every card (with ``ragged``, 1-D rows of
        any length a shard)."""
        if self.procs is None:
            self._check(xs)
            if self.n_local == 1:
                return list(xs)
            return [torch.cat([x.to(d) for x in xs]) for d in self.devices]
        full = self.gather_first(xs, ragged)
        return [full] + [full.to(d) for d in (self.devices or [])[1:]]

    def gather_first(self, xs: List[torch.Tensor],
                     ragged: bool = False) -> torch.Tensor:
        """Every shard's rows in shard order on this rank's first card:
        the rank's cards' rows peer-copied onto it in card order, then,
        under a process group, one ``all_gather`` across the ranks from
        it (``gather_ragged``'s with ``ragged``)."""
        self._check(xs)
        home = xs[0].device
        joined = xs[0] if len(xs) == 1 \
            else torch.cat([x.to(home) for x in xs])
        if self.procs is None:
            return joined
        return (gather_ragged if ragged else gather_rows)(joined,
                                                          self.procs)

    def _check(self, xs) -> None:
        if len(xs) != self.n_local:
            raise ValueError(f"{len(xs)} tensors for {self.n_local} cards")


def world_rank(group) -> tuple:
    """(shards, this process's first shard) of ``group``: a process
    group's (world size, rank), a ``CardGroup``'s shards; (1, 0)
    without one."""
    if group is None:
        return 1, 0
    if isinstance(group, CardGroup):
        return group.size, group.first
    import torch.distributed as dist
    return dist.get_world_size(group), dist.get_rank(group)


def gather_rows(x, group):
    """Shard-local [t, ...] -> [W*t, ...] in shard order, on every
    shard.

    ``all_gather`` over a process group (bool rides as uint8); over a
    ``CardGroup`` ``x`` is a list of per-card tensors and so is the
    result; ``x`` itself without a group.
    """
    if group is None:
        return x
    if isinstance(group, CardGroup):
        return group.gather(x)
    import torch.distributed as dist
    w, _ = world_rank(group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(w)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def gather_ragged(x, group):
    """Shard-local 1-D rows of any length -> every shard's rows
    concatenated in shard order, on every shard; ``x`` without a group.
    Over a ``CardGroup`` ``x`` is a list of per-card tensors and so is
    the result."""
    if group is None:
        return x
    if isinstance(group, CardGroup):
        return group.gather(x, ragged=True)
    n = gather_rows(torch.tensor([x.shape[0]], device=x.device),
                    group).tolist()
    width = max(n)
    if width == 0:
        return x
    pad = torch.zeros(width - x.shape[0], dtype=x.dtype, device=x.device)
    parts = gather_rows(torch.cat([x, pad]), group).split(width)
    return torch.cat([part[:k] for part, k in zip(parts, n)])


def _own_rows(full: torch.Tensor, shard: int, t: int) -> torch.Tensor:
    return full[shard * t:(shard + 1) * t]


def exclusive_carries(totals, group):
    """Each shard's [t, 4] carries: the exclusive prefix of every
    tile's class totals in global tile order.  Over a ``CardGroup``
    ``totals`` is a list of per-card tensors and so is the result."""
    if isinstance(group, CardGroup):
        return [_own_rows(_exclusive(full), group.first + c, x.shape[0])
                for c, (full, x) in enumerate(zip(group.gather(totals),
                                                  totals))]
    _, rank = world_rank(group)
    return _own_rows(_exclusive(gather_rows(totals, group)), rank,
                     totals.shape[0])


def _exclusive(flat: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(flat[:1]),
                      torch.cumsum(flat, dim=0, dtype=torch.int32)[:-1]])


def each(fn, *args, **kw):
    """``fn`` on each card: list arguments hold one value a card, the
    others are shared; a tuple result becomes a tuple (a named one
    stays named) of per-card lists, any other a list."""
    n = {len(a) for a in args if isinstance(a, list)}
    if len(n) != 1:
        raise ValueError(f"per-card arguments of lengths {sorted(n)}")
    outs = [fn(*(a[c] if isinstance(a, list) else a for a in args), **kw)
            for c in range(n.pop())]
    return _by_field(outs)


def _by_field(outs: list):
    """A list of per-card results -> per-card lists of each field."""
    if not isinstance(outs[0], tuple):
        return outs
    fields = [list(x) for x in zip(*outs)]
    return type(outs[0])(*fields) if hasattr(outs[0], "_fields") \
        else tuple(fields)


def _first(out):
    """The one card's entries of a step's per-card result."""
    if isinstance(out, list):
        return out[0]
    if isinstance(out, tuple):
        fields = [_first(x) for x in out]
        return type(out)(*fields) if hasattr(out, "_fields") \
            else tuple(fields)
    return out


def _cardwise(step):
    """A step of ``ShardedKernels`` written over per-card lists.  Over a
    ``CardGroup`` it takes and gives them; otherwise (no group, or one
    rank of a process group) it takes and gives one card's tensors."""
    @wraps(step)
    def run(self, *args, **kw):
        if self.listed:
            return step(self, *args, **kw)
        return _first(step(self, *(
            [a] if isinstance(a, (torch.Tensor, np.ndarray)) else a
            for a in args), **kw))
    return run


def _stack(rows):
    """Per-tile tuples of tensors -> a tuple of [t, ...] tensors."""
    return tuple(torch.stack(list(x)) for x in zip(*rows))


class ShardedKernels:
    """The steps of the sharded pipeline over each shard's tiles.

    One instance per tile length (and distinct-table width ``k``).
    Every step takes and returns [t, ...] tensors on a shard's card: one
    card's tensors without a group or under a process group, lists of
    per-card tensors over a ``CardGroup`` (each step is issued to every
    card before any result is read).  Only the fragment sums, the
    distinct (p, bp) tables, the tiles' edges and, with ``replicated``,
    the peak arrays are gathered across shards.

      cov:      events -> resident per-tile interval arrays (K1, one
                launch per tile with its own carry), per-tile fragment
                sums gathered for the host's float64 lambda and control
                factor (calcFactor, Genrich.c:1980-2046);
      runs:     each tile's rows merged into the exact engine's
                intervals (``pileup_runs``), and which tiles continue
                the previous tile's last interval;
      run_edges: the first and last p-value runs of a replicate's
                tiles, from which the Fisher rows' ``cont`` follows;
      stats:    -log10 p per interval (K2, one launch over a card's
                tiles: the function is elementwise);
      distinct: each shard's distinct (p, bp) table, fixed width k;
      peaks:    q assignment through the host's (p -> q) table, then the
                peak caller per tile (K4);
      rle, rle_pv, fisher: the log, archive and Fisher steps (K3), one
                card's tiles each (``each`` runs them on every card).
    """

    def __init__(self, tile_len: int, k_distinct: int = 1 << 13,
                 group=None):
        self.tile_len = int(tile_len)
        self.k = int(k_distinct)
        self.group = group
        self.listed = isinstance(group, CardGroup)
        self.cards = group if self.listed else CardGroup(procs=group)

    def gather(self, x):
        return gather_rows(x, self.group)

    def _shard(self, c: int) -> int:
        return self.cards.first + c

    def _prev(self, xs):
        """Per-card [t] -> the value of the tile before each tile in
        global order (the first tile gets its own); the tile before may
        be on another shard, so every tile's value is gathered."""
        return [_own_rows(torch.cat([full[:1], full[:-1]]), self._shard(c),
                          x.shape[0])
                for c, (full, x) in enumerate(zip(self.cards.gather(xs),
                                                  xs))]

    def _first_tile(self, c: int, t: int, device) -> torch.Tensor:
        return torch.arange(t, device=device) + self._shard(c) * t == 0

    @_cardwise
    def cov(self, es, ee, ec, cs, ce, cc, excl, limit,
            levels: bool = False):
        """[t, E] events (count 0 pads), [t, K, 2] exclusions, host
        ``limit`` [t] -> (starts, ends, ev, cr, excluded, live) [t, M]
        and the gathered per-tile fragment sums [W*t] (expt, ctrl);
        with ``levels``, then the exact treatment levels [t, M]
        (``tile_coverage``'s ninth array)."""
        carry_e = exclusive_carries(
            [tile_class_totals(*x) for x in zip(es, ee, ec)], self.cards)
        carry_c = exclusive_carries(
            [tile_class_totals(*x) for x in zip(cs, ce, cc)], self.cards)
        outs = [_stack(tile_coverage(es[c][i], ee[c][i], ec[c][i],
                                     cs[c][i], ce[c][i], cc[c][i],
                                     excl[c][i], self.tile_len,
                                     carry_e[c][i], carry_c[c][i],
                                     int(limit[c][i]), levels)
                       for i in range(es[c].shape[0]))
                for c in range(len(es))]
        frag = self.cards.gather([o[6] for o in outs])
        cfrag = self.cards.gather([o[7] for o in outs])
        return _by_field([o[:6] + (f, cf) + o[8:]
                          for o, f, cf in zip(outs, frag, cfrag)])

    @_cardwise
    def runs(self, starts, ends, ev, cr, excluded, live, level, excl,
             tile_bound, lam, factor):
        """Each tile's rows merged into the exact engine's intervals
        (``pileup_runs``), in the [t, M] layout: dead rows of length 0
        after each tile's count.  ``tile_bound`` [t] marks the tiles
        whose start is an -E coordinate.  Returns (starts, ends, ev, cr,
        excluded, counts [t], rows merged [t], cont [t]): ``cont`` is
        True where a tile's first interval continues the previous tile's
        last one (same exclusion state, and outside exclusions the same
        exact treatment level and control value, with no -E coordinate
        at the tile start): one interval of the exact engine that the
        tile boundary cuts in two.  The previous tile may be on another
        shard, so every tile's last interval is gathered."""
        per = [_stack(pileup_runs(starts[c][i], ends[c][i], ev[c][i],
                                  cr[c][i], excluded[c][i], live[c][i],
                                  level[c][i], excl[c][i], lam, factor)
                      for i in range(starts[c].shape[0]))
               for c in range(len(starts))]
        last = [(p[7].long() - 1).clamp_min(0)[:, None] for p in per]
        prev = [self._prev([p[j].gather(1, lc)[:, 0]
                            for p, lc in zip(per, last)])
                for j in (5, 6, 4)]                     # w, net, x
        out = []
        for c, (s, e, v, cr_, x, w, net, n, n_rows) in enumerate(per):
            first = self._first_tile(c, n.shape[0], n.device)
            cont = ((n > 0) & ~first & ~tile_bound[c]
                    & (x[:, 0] == prev[2][c])
                    & (x[:, 0] | ((w[:, 0] == prev[0][c])
                                  & (net[:, 0] == prev[1][c]))))
            out.append((s, e, v, cr_, x, n, n_rows, cont))
        return _by_field(out)

    @staticmethod
    def stats(ev, cr, excluded, lam, factor):
        return tile_stats(ev.reshape(-1), cr.reshape(-1),
                          excluded.reshape(-1), factor, lam).reshape(ev.shape)

    @_cardwise
    def distinct(self, starts, ends, pval, live):
        """Each shard's tiles flattened into one [k] table; returns the
        gathered (p [W*k], bp [W*k], counts [W])."""
        tabs = [distinct_pvals_k(s.reshape(-1), e.reshape(-1),
                                 p.reshape(-1), lv.reshape(-1), self.k)
                for s, e, p, lv in zip(starts, ends, pval, live)]
        return (self.cards.gather([t[0] for t in tabs]),
                self.cards.gather([t[1] for t in tabs]),
                self.cards.gather([t[2].reshape(1) for t in tabs]))

    @staticmethod
    def rle(starts, ends, pv, ev, cr, excluded, live, lam, factor):
        return _stack(rle_runs(starts[i], ends[i], pv[i], ev[i], cr[i],
                               excluded[i], live[i], lam, factor)
                      for i in range(starts.shape[0]))

    @staticmethod
    def rle_pv(starts, ends, pv, live, limit):
        return _stack(rle_pv(starts[i], ends[i], pv[i], live[i],
                             int(limit[i]))
                      for i in range(starts.shape[0]))

    @_cardwise
    def run_edges(self, pv_b, b):
        """One replicate's per-tile RLE (``rle_pv``: p [t, M], run counts
        [t]) -> (each tile's first run's p, the last run's p of the tile
        before it, and whether both exist) [t]; the padding rows are no
        runs.  The tile before may be on another shard, so every tile's
        last run is gathered."""
        has = [n > 0 for n in b]
        last = [p.gather(1, (n.long() - 1).clamp_min(0)[:, None])[:, 0]
                for p, n in zip(pv_b, b)]
        prev_p, prev_has = self._prev(last), self._prev(has)
        return _by_field([
            (p[:, 0], prev_p[c], has[c] & prev_has[c]
             & ~self._first_tile(c, p.shape[0], p.device))
            for c, p in enumerate(pv_b)])

    def peaks(self, use_q: bool, min_len: int, max_gap: int,
              replicated: bool, k_peaks: int):
        """The peak-calling step, ``k_peaks`` candidate slots a tile.
        With ``replicated`` the per-tile peak arrays are gathered so
        every shard holds all of them (the host boundary merge needs
        every tile)."""
        return partial(self._peaks, use_q, min_len, max_gap, replicated,
                       k_peaks)

    @_cardwise
    def _peaks(self, use_q, min_len, max_gap, replicated, k_peaks, starts,
               ends, pval, live, tab_p, tab_q, min_pq, min_auc):
        out = []
        for c, pv in enumerate(pval):
            if use_q:
                stat = assign_qvals(pv.reshape(-1), tab_p[c],
                                    tab_q[c]).reshape(pv.shape)
                qv = stat
            else:
                stat = pv
                qv = torch.full_like(pv, SKIP)
            out.append(TilePeaks(*_stack(
                call_peaks(starts[c][i], ends[c][i], stat[i], pv[i], qv[i],
                           live[c][i], float(np.float32(min_pq)),
                           float(np.float32(min_auc)), min_len, max_gap,
                           k_peaks)
                for i in range(pv.shape[0]))))
        res = _by_field(out)
        if replicated:
            res = TilePeaks(*(self.cards.gather(f) for f in res))
        return res

    def fisher(self, r: int):
        """combinePval (Genrich.c:612-667) per tile across r replicate
        RLEs: arguments are r end arrays then r p-value arrays, [t, M_i]
        each, padded with (tile limit, SKIP) rows."""
        return partial(self._fisher, r)

    @staticmethod
    def _fisher(r, *arrs):
        return _stack(merge_fisher([a[i] for a in arrs[:r]],
                                   [a[i] for a in arrs[r:]])
                      for i in range(arrs[0].shape[0]))


def sharded_analyze(start, end, count, tile_len: int, genome_len: int,
                    min_pq: float, min_auc: float, min_len: int = 0,
                    max_gap: int = 100, group=None):
    """The light tile pipeline (no control, no exclusions) over ranks.

    start/end/count: this rank's [t, E] tile-local events (split with
    ``split_events_to_tiles``).  Lambda is the float32 sum of every
    tile's weighted fragment length over ``genome_len``; each tile runs
    ``analyze_tile_core`` with its carry.  Returns (TileResult of the
    gathered [T, K] peak arrays, lambda).
    """
    w = torch.where(count > 0, 1.0 / count.clamp_min(1).to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=count.device))
    local = ((end - start).to(torch.float32) * w).sum(dim=1).sum()
    lam = gather_rows(local.reshape(1), group).sum() \
        / np.float32(genome_len)
    lam = float(lam)
    carries = exclusive_carries(tile_class_totals(start, end, count), group)
    res = [analyze_tile_core(start[i], end[i], count[i], tile_len,
                             carries[i], lam, min_pq, min_auc, min_len,
                             max_gap) for i in range(start.shape[0])]
    peaks = TilePeaks(*(gather_rows(f, group)
                        for f in _stack(r.peaks for r in res)))
    frag, n = (gather_rows(torch.stack(x), group)
               for x in zip(*((r.frag_len, r.n_intervals) for r in res)))
    return TileResult(peaks, frag, n), np.float32(lam)


def exact_q_table(pv_gathered, w_gathered, d_gathered, k: int,
                  genome_len: int):
    """Host-side exact BH from the gathered per-shard distinct tables.

    Merges shards' (p, bp) pairs (np.unique + summed uint64 lengths)
    and runs the exact float32 q sweep (engine/qvalue.py, mirroring
    computeQval Genrich.c:352-401).  Deterministic and identical on
    every process.  Returns (tab_p, tab_q, total_bp, all_one) with
    tab_p padded to a power of two with +inf.  Raises if any shard's
    distinct count exceeded k (rerun with a wider k — never silent).
    """
    from ..engine import qvalue

    pv_g = np.asarray(pv_gathered)
    w_g = np.asarray(w_gathered)
    d_g = np.asarray(d_gathered).reshape(-1)
    if (d_g > k).any():
        raise ValueError(
            f"distinct p-value overflow: a shard saw {int(d_g.max())}"
            f" > k_distinct={k}; rebuild ShardedKernels with a wider"
            f" k_distinct")
    ps, ws = [], []
    for i, d in enumerate(d_g):
        d = int(d)
        if d:
            ps.append(pv_g[i * k:i * k + d])
            ws.append(w_g[i * k:i * k + d].astype(np.uint64))
    if not ps:
        return (np.full(1, np.inf, np.float32),
                np.zeros(1, np.float32), 0, False)
    _, _, tab_p, tab_q, total_bp, all_one = \
        qvalue.merge_distinct_tables(ps, ws, genome_len, lo=1 << 8)
    return tab_p, tab_q, total_bp, all_one


def sharded_analyze_full(es, ee, ec, cs, ce, cc, excl, tile_len: int,
                         genome_len: int, min_pq: float, min_auc: float,
                         min_len: int = 0, max_gap: int = 100,
                         qval_opt: bool = False,
                         k_distinct: int = 1 << 13, limit=None,
                         kern: Optional[ShardedKernels] = None, group=None):
    """Full pipeline over this rank's tiles: ctrl + exclusions + exact BH.

    Inputs are this rank's [t, ...] tensors on its device, or over a
    ``CardGroup`` lists of each card's; ``excl`` is [t, K, 2] tile-local
    exclusions padded with tile_len; ``limit`` [t] (host ints, a list of
    each card's over a ``CardGroup``) clips each tile's span at the
    chromosome's end.  Returns (TileResult(peak arrays of every shard,
    on the first card; the gathered fragment sums), lambda, factor).
    """
    if kern is None:
        kern = ShardedKernels(tile_len, k_distinct, group)
    if not kern.listed:
        # one card's tensors: the same steps over a list of one card
        kern = ShardedKernels(kern.tile_len, kern.k, kern.cards)
        es, ee, ec, cs, ce, cc, excl = ([x] for x in (es, ee, ec, cs, ce,
                                                      cc, excl))
        limit = None if limit is None else [limit]
    if limit is None:
        limit = [np.full(x.shape[0], tile_len, np.int64) for x in es]
    (starts, ends, ev, cr, excluded, live, frag_all,
     cfrag_all) = kern.cov(es, ee, ec, cs, ce, cc, excl, limit)
    frag = float(frag_all[0].cpu().numpy().astype(np.float64).sum())
    cfrag = float(cfrag_all[0].cpu().numpy().astype(np.float64).sum())
    lam = np.float32(frag / genome_len)
    factor = np.float32(1.0) if cfrag == 0.0 \
        else np.float32(frag / cfrag)
    pval = each(kern.stats, ev, cr, excluded, lam, factor)
    if qval_opt:
        pv_all, w_all, d_all = (x[0].cpu().numpy() for x in kern.distinct(
            starts, ends, pval, live))
        tab_p, tab_q, _, _ = exact_q_table(pv_all, w_all, d_all, kern.k,
                                           genome_len)
    else:
        tab_p = np.full(1, np.inf, np.float32)
        tab_q = np.zeros(1, np.float32)
    tabs = [[torch.as_tensor(t, device=x.device) for x in es]
            for t in (tab_p, tab_q)]
    # replicated: over one card with no process group the identity
    peaks = kern.peaks(qval_opt, min_len, max_gap, True, PEAK_CAP)(
        starts, ends, pval, live, *tabs, min_pq, min_auc)
    return TileResult(_first(peaks), frag_all[0], None), lam, factor


def merge_tile_peaks(result: TileResult, tile_len: int,
                     min_auc: float, min_len: int, max_gap: int):
    """Host-side merge of peaks straddling tile boundaries.

    Adjacent tiles' edge candidates join when the global gap is within
    maxGap and no SKIP interval separates them (the same rule the
    sequential reference applies, callPeaks Genrich.c:1026-1040).
    Assumes max_gap < tile_len so siteless tiles always break chains.
    Returns [(start, end, auc, summit_pval, summit_qval, summit_pos)].

    Fully vectorized (grouping by a join-flag cumsum + segmented
    reductions): the sequential tail of the sharded pipeline stays
    O(candidates) numpy work, not a Python loop — at 10^4 tiles with
    dense candidate caps this is ~100x the loop formulation (kept
    below as ``_merge_tile_peaks_loop``, the oracle for the property
    test in tests/test_mesh_merge.py).
    """
    assert max_gap < tile_len
    pk = result.peaks
    cand = np.asarray(pk.cand)
    n_tiles, cap = cand.shape
    t_idx, k_idx = np.nonzero(cand)
    n = len(t_idx)
    if n == 0:
        return []
    starts = np.asarray(pk.start)[t_idx, k_idx].astype(np.int64)
    ends = np.asarray(pk.end)[t_idx, k_idx].astype(np.int64)
    aucs = np.asarray(pk.auc)[t_idx, k_idx]
    spv = np.asarray(pk.summit_pval)[t_idx, k_idx]
    sqv = np.asarray(pk.summit_qval)[t_idx, k_idx]
    spos = np.asarray(pk.summit_pos)[t_idx, k_idx].astype(np.int64)
    sstat = np.asarray(pk.summit_stat)[t_idx, k_idx]
    slen = np.asarray(pk.summit_len)[t_idx, k_idx].astype(np.int64)
    skip_head = np.asarray(pk.skip_head).astype(bool).reshape(-1)
    skip_tail = np.asarray(pk.skip_tail).astype(bool).reshape(-1)

    # candidates in (tile, start, k) order — the loop's visit order
    perm = np.lexsort((k_idx, starts, t_idx))
    t_idx, starts, ends = t_idx[perm], starts[perm], ends[perm]
    aucs, spv, sqv = aucs[perm], spv[perm], sqv[perm]
    spos, sstat, slen = spos[perm], sstat[perm], slen[perm]
    g_start = starts + t_idx.astype(np.int64) * tile_len
    g_end = ends + t_idx.astype(np.int64) * tile_len

    # a candidate joins the previous one iff it is its tile's first
    # candidate, the previous candidate sits in the adjacent tile,
    # neither side has a SKIP run at the boundary, and the global gap
    # is within maxGap
    first_in_tile = np.empty(n, bool)
    first_in_tile[0] = True
    first_in_tile[1:] = t_idx[1:] != t_idx[:-1]
    join = np.zeros(n, bool)
    if n > 1:
        prev_t = t_idx[:-1]
        join[1:] = (first_in_tile[1:]
                    & (prev_t == t_idx[1:] - 1)
                    & ~skip_tail[prev_t]
                    & ~skip_head[t_idx[1:]]
                    & (g_start[1:] - g_end[:-1] <= max_gap))
    group = np.cumsum(~join) - 1
    seg = np.flatnonzero(~join)          # first index of each group

    out_start = g_start[seg]
    out_end = g_end[np.append(seg[1:] - 1, n - 1)]
    # float32 AUC: a strict left-fold per group, bit-identical to the
    # sequential loop's `auc = f32(auc + next)` (np.add.reduceat is
    # not — it may reassociate).  One vectorized masked add per chain
    # position: O(longest chain) passes, each across all groups.
    sizes = np.diff(np.append(seg, n))
    out_auc = aucs[seg].astype(np.float32).copy()
    for j in range(1, int(sizes.max())):
        m = sizes > j
        out_auc[m] = (out_auc[m] + aucs[seg[m] + j]) \
            .astype(np.float32)

    # summit: strictly-greater stat wins; equal stat + strictly longer
    # interval wins; otherwise the earlier candidate keeps it.  That
    # is the per-group lexicographic max of (stat, slen) with earliest
    # visit order breaking ties — computed via one ranking sort +
    # segmented min over ranks.
    rank_perm = np.lexsort((np.arange(n), -slen, -sstat))
    rank = np.empty(n, np.int64)
    rank[rank_perm] = np.arange(n)
    win = rank_perm[np.minimum.reduceat(rank, seg)]

    out_pval = spv[win]
    out_qval = sqv[win]
    out_pos = (g_start[win] - out_start) + spos[win]

    keep = (out_auc >= np.float32(min_auc)) \
        & (out_end - out_start >= min_len)
    return [(int(s), int(e), a, p, q, int(x))
            for s, e, a, p, q, x in zip(
                out_start[keep], out_end[keep], out_auc[keep],
                out_pval[keep], out_qval[keep], out_pos[keep])]


def _merge_tile_peaks_loop(result: TileResult, tile_len: int,
                           min_auc: float, min_len: int,
                           max_gap: int):
    """Reference formulation of ``merge_tile_peaks`` (sequential).

    Kept as the oracle for the equivalence property test; the
    vectorized version above must match it tuple-for-tuple.
    """
    assert max_gap < tile_len
    pk = result.peaks
    n_tiles = np.asarray(pk.cand).shape[0]
    cand = np.asarray(pk.cand)
    starts = np.asarray(pk.start)
    ends = np.asarray(pk.end)
    aucs = np.asarray(pk.auc)
    spv = np.asarray(pk.summit_pval)
    sqv = np.asarray(pk.summit_qval)
    spos = np.asarray(pk.summit_pos)
    sstat = np.asarray(pk.summit_stat)
    slen = np.asarray(pk.summit_len)
    skip_head = np.asarray(pk.skip_head)
    skip_tail = np.asarray(pk.skip_tail)

    out = []
    pending = None  # dict of current open peak (global coords)

    def close(p):
        if p is not None and p["auc"] >= np.float32(min_auc) \
                and p["end"] - p["start"] >= min_len:
            out.append((p["start"], p["end"], p["auc"], p["pval"],
                        p["qval"], p["pos"]))

    for t in range(n_tiles):
        idxs = np.flatnonzero(cand[t])
        order = idxs[np.argsort(starts[t, idxs], kind="stable")]
        for j, k in enumerate(order):
            g_start = int(starts[t, k]) + t * tile_len
            g_end = int(ends[t, k]) + t * tile_len
            join = (pending is not None and j == 0
                    and pending["tile"] == t - 1
                    and not pending["skip_tail"]
                    and not bool(skip_head[t])
                    and g_start - pending["end"] <= max_gap)
            if join:
                # merge the boundary candidate into the open peak
                right_pos = int(spos[t, k]) + (g_start
                                               - pending["start"])
                if sstat[t, k] > pending["stat"] or (
                        sstat[t, k] == pending["stat"]
                        and int(slen[t, k]) > pending["slen"]):
                    pending.update(pval=spv[t, k], qval=sqv[t, k],
                                   pos=right_pos, stat=sstat[t, k],
                                   slen=int(slen[t, k]))
                pending["end"] = g_end
                pending["auc"] = np.float32(pending["auc"]
                                            + aucs[t, k])
            else:
                close(pending)
                pending = {"start": g_start, "end": g_end,
                           "auc": np.float32(aucs[t, k]),
                           "pval": spv[t, k], "qval": sqv[t, k],
                           "pos": int(spos[t, k]),
                           "stat": sstat[t, k],
                           "slen": int(slen[t, k])}
            pending["tile"] = t
            pending["skip_tail"] = bool(skip_tail[t])
    close(pending)
    return out


def split_excl_to_tiles(bed, n_tiles: int, tile_len: int) -> np.ndarray:
    """-E pairs (flat [s0, e0, s1, e1, ...]) -> [n_tiles, K, 2]
    tile-local clipped pairs, K a power of two, padded with
    (tile_len, tile_len) rows (the convention _excluded expects).

    Fully vectorized (repeat + one stable sort), same scheme as
    ``split_events_to_tiles``: a pair spanning several tiles is cut at
    every boundary; within a tile, pairs keep input order.  Matters at
    find_ns-scale BED density (a genome-wide N-homopolymer BED can
    hold millions of 1-bp pairs).
    """
    a = np.asarray(bed[0::2], np.int64)
    b = np.asarray(bed[1::2], np.int64)
    keep = (b > a) & (a < n_tiles * tile_len) & (b > 0)
    a, b = a[keep], b[keep]
    if len(a) == 0:
        return np.full((n_tiles, 1, 2), tile_len, np.int32)
    t0 = np.maximum(a, 0) // tile_len
    t1 = np.minimum((b - 1) // tile_len, n_tiles - 1)
    pieces = (t1 - t0 + 1).astype(np.int64)
    off = np.cumsum(pieces) - pieces
    total = int(pieces.sum())
    k_idx = np.arange(total, dtype=np.int64) - np.repeat(off, pieces)
    tile = np.repeat(t0, pieces) + k_idx
    base = tile * tile_len
    lo = np.maximum(np.repeat(a, pieces) - base, 0)
    hi = np.minimum(np.repeat(b, pieces) - base, tile_len)
    order = np.argsort(tile, kind="stable")
    tile_s = tile[order]
    per_tile = np.bincount(tile_s, minlength=n_tiles).astype(np.int64)
    slot = np.arange(total, dtype=np.int64) \
        - np.repeat(np.cumsum(per_tile) - per_tile, per_tile)[:total]
    k = 1
    while k < int(per_tile.max()):
        k <<= 1
    out = np.full((n_tiles, k, 2), tile_len, np.int32)
    out[tile_s, slot, 0] = lo[order]
    out[tile_s, slot, 1] = hi[order]
    return out


def split_events_flat(start: np.ndarray, end: np.ndarray,
                      count: np.ndarray, n_tiles: int, tile_len: int):
    """Host-side: global events -> flat tile-major tile-local pieces.

    A fragment spanning tile boundaries is cut at every boundary into
    per-tile pieces ((s, tile_len) in the first tile, full (0,
    tile_len) covers in any middle tiles, (0, e) in the last), so each
    tile's event list is self-contained and balanced: every add+sub
    row pair is canon-neutral, so the inter-tile class-total carries
    reduce to canonical zero under this convention.  Fully
    vectorized (one repeat + one stable sort); no per-event Python.

    Returns (s, e, c) int32 [P], the pieces in tile order (input order
    within a tile), and int64 offsets [n_tiles + 1]: tile t's pieces
    are s[off[t]:off[t + 1]].
    """
    start = np.asarray(start, np.int64)
    end = np.asarray(end, np.int64)
    count = np.asarray(count, np.int32)
    if len(start) == 0:
        z = np.zeros(0, np.int32)
        return z, z.copy(), z.copy(), np.zeros(n_tiles + 1, np.int64)
    if np.any(start >= end):
        raise ValueError("empty or inverted event (start >= end)")
    ts = start // tile_len
    te = np.minimum((end - 1) // tile_len, n_tiles - 1)  # inclusive
    if np.any(ts >= n_tiles) or np.any(ts < 0):
        raise ValueError("event start outside the tile grid")
    pieces = (te - ts + 1).astype(np.int64)

    # piece k of event i lives in tile ts[i]+k; build the flat piece
    # list with repeat + a concatenated-arange for k
    off = np.cumsum(pieces) - pieces
    total = int(pieces.sum())
    k = np.arange(total, dtype=np.int64) - np.repeat(off, pieces)
    tile = np.repeat(ts, pieces) + k
    base = tile * tile_len
    s_loc = np.maximum(np.repeat(start, pieces) - base, 0)
    e_loc = np.minimum(np.repeat(end, pieces) - base, tile_len)
    c_rep = np.repeat(count, pieces)

    # bucket pieces by tile (stable: preserves input event order)
    order = np.argsort(tile, kind="stable")
    per_tile = np.bincount(tile, minlength=n_tiles).astype(np.int64)
    offsets = np.zeros(n_tiles + 1, np.int64)
    offsets[1:] = np.cumsum(per_tile)
    return (s_loc[order].astype(np.int32), e_loc[order].astype(np.int32),
            c_rep[order], offsets)


def split_events_to_tiles(start: np.ndarray, end: np.ndarray,
                          count: np.ndarray, n_tiles: int,
                          tile_len: int, pad_to: Optional[int] = None,
                          on_overflow: str = "grow"):
    """Host-side: global events -> per-tile padded tile-local arrays.

    The pieces of ``split_events_flat``, each tile's in a row of width
    E.  ``pad_to`` sets the minimum per-tile width E (shape stability
    for jit reuse).  If some tile holds more events than ``pad_to``:
    ``on_overflow="grow"`` widens E to fit (single-host default);
    ``"error"`` raises ValueError (multi-host callers, where E must
    agree across processes).  Events are never silently dropped.

    Returns (out_s, out_e, out_c) int32 [n_tiles, E]; padding rows are
    (tile_len, tile_len, 0).
    """
    if len(start) == 0:
        e_max = pad_to or 1
        return (np.full((n_tiles, e_max), tile_len, np.int32),
                np.full((n_tiles, e_max), tile_len, np.int32),
                np.zeros((n_tiles, e_max), np.int32))
    s, e, c, off = split_events_flat(start, end, count, n_tiles, tile_len)
    per_tile = np.diff(off)
    total = int(off[-1])
    need = int(per_tile.max()) if total else 1
    e_max = max(pad_to or 1, 1)
    if need > e_max:
        if pad_to is not None and on_overflow == "error":
            raise ValueError(
                f"tile event overflow: a tile holds {need} events "
                f"but pad_to={pad_to} (shape-locked caller)")
        e_max = need
    tile_s = np.repeat(np.arange(n_tiles, dtype=np.int64), per_tile)
    slot = np.arange(total, dtype=np.int64) - np.repeat(off[:-1], per_tile)
    out_s = np.full((n_tiles, e_max), tile_len, np.int32)
    out_e = np.full((n_tiles, e_max), tile_len, np.int32)
    out_c = np.zeros((n_tiles, e_max), np.int32)
    out_s[tile_s, slot] = s
    out_e[tile_s, slot] = e
    out_c[tile_s, slot] = c
    return out_s, out_e, out_c
