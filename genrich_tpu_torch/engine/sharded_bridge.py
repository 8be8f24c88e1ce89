"""Tile-sharded device engine for the CLI (twin of engine/sharded_bridge.py).

``python -m genrich_tpu_torch --engine sharded``.  The engine contract
of ``TorchEngine`` (pipeline.py drives both), but every chromosome is
cut into a grid of power-of-two tiles and every numeric stage runs the
steps of ``parallel/mesh.ShardedKernels`` over this rank's tiles: the
host splits events by tile (``split_events_flat``), each tile scans
from the carry of the tiles before it (K1), p-values run over all tiles
(K2), each tile calls its own peaks (K5 and K4, ``PEAK_CAP`` candidate
slots a tile, more when a tile has more) and the host merges peaks that
straddle tile boundaries (``merge_tile_peaks``); the -f/-k logs stitch
the tiles' RLE runs, and several replicates combine tile by tile (K3).
Before the p-values each
tile's rows are merged into the exact engine's intervals
(``merge_rows``), as in TorchEngine.  A merged peak that straddles a
boundary gets its AUC and summit taken again over its rows in genomic
order (``_row_order_peaks``), with an interval that the boundary cut
counted once, as TorchEngine's K4 and the exact engine take one peak;
the JAX twin keeps the sum of its tiles' AUCs and their best summit.

Reference semantics per stage (float32, as TorchEngine):
  coverage/pileup   savePileupExpt/Ctrl   Genrich.c:2052-2295
  p-values          savePval/calcPval     Genrich.c:1628-1794
  Fisher            combinePval           Genrich.c:612-667
  q-values          computeQval           Genrich.c:146-401 (exact
                    distinct-value BH, host float32 sweep)
  peak calling      callPeaks             Genrich.c:977-1069

With no process group the engine spans the cards it is given, one
shard each, as the JAX engine's mesh spans ``jax.devices()``: "cuda"
is every card the process sees (``CUDA_VISIBLE_DEVICES`` restricts
it), "cuda:i" one card, "cpu" one CPU context, and a list of devices
those (a device may repeat; the tests pass several "cpu" entries).
Each chromosome's tiles go to the cards in contiguous blocks, the host
splits the events once and each card receives its own tiles', every
step is issued to every card before any result is read, and the
collectives of ``parallel/mesh.py`` over a ``CardGroup`` (peer copies)
couple them.  Under a process group
(``parallel/distributed.init_distributed``: NCCL on CUDA, gloo on the
CPU) each rank keeps its own cards (``rank_devices``: a list as given,
"cuda:i" one, a bare "cuda" the rank's share of the host's cards under
torchrun's ``LOCAL_WORLD_SIZE``, else the card ``RANK`` modulo the
host's), every rank the same count, and the collectives join a rank's
cards on its first before one collective across the ranks: the JAX
engine's mesh over every process's devices.  ``n_shards`` (the JAX engine's mesh size D) defaults
to the shards in all; on one card a chromosome of the 2.75 Gbp
main-path genome is five tiles of 2^28 bp.  Tests pass ``n_shards=8``
to cut the grid as the JAX tests' 8 virtual devices do.

The engine's per-chromosome state holds one tensor a card in a list;
host reads pull every card's rows (``_pull``: one accounted fetch a
card, or under a process group the rank's cards joined and gathered
across the ranks, one fetch) and join them in shard order.

What the JAX engine does for the TPU and this one does not: no monotone
event-width floor and no power-of-two size buckets (eager PyTorch needs
no fixed shapes); no all-padding control triple for a run without
control (the control arrays are [t, 0]); events upload as int32 ends,
not the uint16-length wire.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops.compact import assign_qvals
from ..ops.peaks import TilePeaks
from ..ops.pipeline import TileResult
from ..parallel.distributed import (init_distributed, local_devices,
                                    local_tile_range, rank_devices)
from ..parallel.mesh import (PEAK_CAP, CardGroup, ShardedKernels, each,
                             gather_rows, merge_tile_peaks,
                             world_rank, split_events_flat,
                             split_excl_to_tiles)
from . import qvalue
from .host_fallback import INT32_MAX, HostChromMixin
from .perf import PerfMixin, span
from .pileup import Pileup
from .torch_bridge import (PEAK_CAP as CHROM_PEAK_CAP, SKIP, check_device,
                           chrom_peaks, fetch_chrom_peaks, pow2)

F32 = np.float32


def expand_flat(fs, fe, fc, off, n_tiles: int, width: int, tile_len: int):
    """Flat tile-major events + [T+1] offsets -> a [T, width] triple.

    Rows past a tile's count become (tile_len, tile_len, 0) padding.
    Plain PyTorch gathers on the device (the JAX engine's
    ``_expand_flat32``).
    """
    dev = off.device
    if fs.numel() == 0:
        pad = torch.full((n_tiles, width), tile_len, dtype=torch.int32,
                         device=dev)
        return pad, pad.clone(), torch.zeros((n_tiles, width),
                                             dtype=torch.uint8, device=dev)
    idx = off[:-1, None] + torch.arange(width, device=dev)
    pad = idx >= off[1:, None]
    idx = idx.clamp(max=fs.numel() - 1)
    return (fs[idx].masked_fill(pad, tile_len),
            fe[idx].masked_fill(pad, tile_len), fc[idx].masked_fill(pad, 0))


class ShardedTorchEngine(PerfMixin, HostChromMixin):
    """Per-run sharded device context over ``device``: every card the
    process sees for "cuda", one for "cuda:i" or "cpu", or a list of
    devices; under a process group the rank's cards
    (``rank_devices``)."""

    MAX_TILE_LEN = 1 << 28   # keeps positions well inside int32; a
                             # chromosome longer than D * cap gets
                             # several tiles per shard

    def __init__(self, device="cuda", n_shards: Optional[int] = None,
                 min_tile_len: int = 1 << 16):
        listed = isinstance(device, (list, tuple))
        for d in device if listed else [device]:
            check_device(d)
        procs = init_distributed(device)
        devices = local_devices(device) if procs is None \
            else rank_devices(device, world_rank(procs)[1])
        for d in devices:
            # a card that cannot take a tensor fails here, not mid-run
            torch.zeros(1, device=d)
        self.devices = devices
        self.device = devices[0]
        self.cards = CardGroup(devices, procs)
        self.world, self.rank = world_rank(self.cards)
        self.D = self.world if n_shards is None else int(n_shards)
        if self.D < 1 or self.D % self.world:
            raise ValueError(f"n_shards={self.D} must be a positive "
                             f"multiple of the {self.world} shards")
        self.min_tile_len = min_tile_len
        self._kernels: Dict[int, ShardedKernels] = {}
        self._chrom: Dict[int, dict] = {}
        self._reps: List[Dict[int, tuple]] = []
        self._qtable = None
        self._qtable_host = (np.zeros(0, F32), np.zeros(0, F32))
        self._fixed_grid = None
        self._lo = min_tile_len           # the least tile_len (prepare)
        self.begin_run()

    def begin_run(self) -> None:
        """Reset the per-analysis accounting, plus the grid, the peaks
        that the host caller or the boundary merge finished and the
        chromosomes whose peaks were called again with more slots."""
        super().begin_run()
        self.perf.update(grid_tile_len=0, grid_tiles=0, straddling_peaks=0,
                         peak_merge_s=0.0, host_peak_chroms=0,
                         peak_redispatch=0,
                         interval_rows=0, real_rows=0, merged_rows=0,
                         merged_width=0)

    # --- cards -----------------------------------------------------------

    def _step(self, fn, *args, **kw):
        """A step over every card, accounted as one dispatch a card;
        list arguments hold one value a card (``ShardedKernels``' steps
        take them whole)."""
        return self._dispatch(fn, len(self.devices), fn, *args, **kw)

    def _each(self, fn, *args, **kw):
        """``fn`` on each card's values (``mesh.each``), accounted as a
        step of ``fn``."""
        return self._dispatch(fn, len(self.devices), each, fn, *args, **kw)

    def _put_all(self, arr) -> list:
        """One host array on every card."""
        return [self._put(arr, d) for d in self.devices]

    def _pull(self, values, ragged: bool = False) -> list:
        """Per-card values -> numpy, each every shard's rows in shard
        order: across a process group the rank's cards joined on its
        first and gathered across the ranks (1-D rows of any length with
        ``ragged``), then pulled from each card (one accounted fetch a
        card) and joined on the host.  ``values`` may
        be a generator: it runs inside the fetch, so the host syncs of
        its selections are accounted as the fetch they are."""
        procs = self.cards.procs
        sizes = []

        def flat():
            for v in values:
                if procs is not None:
                    v = [self.cards.gather_first(v, ragged)]
                sizes.append(len(v))
                yield from v
        got = iter(self._fetch_many(flat()))
        return [np.concatenate(g) if len(g) > 1 else g[0]
                for g in ([next(got) for _ in range(n)] for n in sizes)]

    def _blocks(self, r: range) -> List[range]:
        """This process's tiles ``r`` cut into one contiguous block a
        card, in card order."""
        per = len(r) // len(self.devices)
        return [range(r.start + c * per, r.start + (c + 1) * per)
                for c in range(len(self.devices))]

    # --- grid ------------------------------------------------------------

    def prepare(self, max_chrom_len: int = 0, max_gap: int = 0) -> None:
        """Fix ONE (tile_len, n_tiles) grid for the run, from the longest
        device chromosome, and build the CUDA kernels.

        Shorter chromosomes pad to the same grid (trailing tiles get
        limit 0), as in the JAX engine.  Every tile is longer than
        ``max_gap`` (the boundary merge's premise) up to
        ``MAX_TILE_LEN``; a gap that not even such a tile holds calls
        each chromosome's peaks once over its gathered rows
        (``peaks_submit``).  Runs once per
        analysis, so a serve process fed inputs of other sizes
        re-derives it.  Of the JAX engine's arguments only
        ``max_chrom_len`` is taken: the event and exclusion maxima
        sized its shape buckets, which eager PyTorch does not need.
        """
        if self.device.type == "cuda":
            kernels.library()
        self._lo = min(pow2(max_gap + 1, lo=self.min_tile_len),
                       self.MAX_TILE_LEN)
        self._fixed_grid = None
        if max_chrom_len:
            tl = pow2(-(-max_chrom_len // self.D), lo=self._lo)
            tl = min(tl, self.MAX_TILE_LEN)
            t = -(-max_chrom_len // tl)
            self._fixed_grid = (tl, -(-t // self.D) * self.D)
            self.perf.update(grid_tile_len=self._fixed_grid[0],
                             grid_tiles=self._fixed_grid[1])

    def _grid(self, chrom_len: int) -> Tuple[int, int, np.ndarray]:
        """(tile_len, n_tiles, per-tile limits) for a chromosome: the
        run's grid when it covers the chromosome, else its own."""
        fixed = self._fixed_grid
        if fixed is not None and fixed[0] * fixed[1] >= chrom_len:
            tl, t = fixed
        else:
            tl = pow2(-(-chrom_len // self.D), lo=self._lo)
            tl = min(tl, self.MAX_TILE_LEN)
            t = -(-chrom_len // tl)
            t = -(-t // self.D) * self.D
        limit = np.clip(chrom_len - np.arange(t, dtype=np.int64) * tl, 0, tl)
        return tl, t, limit

    def _kern(self, tile_len: int) -> ShardedKernels:
        k = self._kernels.get(tile_len)
        if k is None:
            k = self._kernels[tile_len] = ShardedKernels(tile_len,
                                                         group=self.cards)
        return k

    # --- input staging ---------------------------------------------------

    def _stage_events(self, s, e, c, off, w: int, tile_len: int,
                      device=None):
        """Upload one flat tile-major event triple (``split_events_flat``:
        int32 starts and ends, count codes as uint8) and its int64 [T+1]
        offsets to ``device`` (the first card by default); the device
        gathers each tile's slice into the [T, w] layout and writes the
        padding rows itself."""
        put = partial(self._put, device=device)
        return self._call(expand_flat, put(s), put(e),
                          put(c.astype(np.uint8)), put(off),
                          off.shape[0] - 1, w, tile_len)

    # --- stage 1: coverage (resident) -------------------------------------

    def coverage_chrom(self, cidx: int, expt_ev, ctrl_ev,
                       bed: List[int], chrom_len: int) -> tuple:
        """Per-tile coverage of one chromosome (asynchronous); returns
        the gathered per-tile fragment sums, or floats for a host
        chromosome (over 2^31-1 bp).  The host splits the events once;
        each card receives its block's."""
        if chrom_len > INT32_MAX:
            return self.host_coverage_chrom(cidx, expt_ev, ctrl_ev,
                                            bed, chrom_len)
        tile_len, n_tiles, limit = self._grid(chrom_len)
        blocks = self._blocks(local_tile_range(n_tiles))
        kern = self._kern(tile_len)
        staged = [[] for _ in range(6)]
        for j, ev in enumerate((expt_ev, ctrl_ev)):
            if ev is None:
                ev = (np.zeros(0, np.int64),) * 3
            s, e, c, off = split_events_flat(ev[0], ev[1], ev[2], n_tiles,
                                             tile_len)
            # every card pads to the widest tile of all, so the gathered
            # [t, ...] arrays agree in shape
            w = int(np.diff(off).max())
            for r, dev in zip(blocks, self.devices):
                lo, hi = off[r.start], off[r.stop]
                for i, x in enumerate(self._stage_events(
                        s[lo:hi], e[lo:hi], c[lo:hi],
                        off[r.start:r.stop + 1] - lo, w, tile_len, dev)):
                    staged[3 * j + i].append(x)
        excl_all = split_excl_to_tiles(bed, n_tiles, tile_len)
        excl = [self._put(excl_all[r.start:r.stop], d)
                for r, d in zip(blocks, self.devices)]
        limit = [limit[r.start:r.stop] for r in blocks]
        cuts = [b for b in bed if 0 < b < chrom_len]
        (starts, ends, ev, cr, excluded, live, frag_all, cfrag_all,
         level) = self._step(kern.cov, *staged, excl, limit, levels=True)
        # tiles whose start is an -E coordinate (a tile-local pair that
        # starts at 0 may be the rest of one cut by the boundary)
        tile_bound = [self._put(np.isin(np.arange(r.start, r.stop)
                                        * tile_len, cuts), d)
                      for r, d in zip(blocks, self.devices)]
        self._chrom[cidx] = {
            "starts": starts, "ends": ends, "ev": ev, "cr": cr,
            "excluded": excluded, "live": live, "len": chrom_len,
            "tile_len": tile_len, "limit": limit, "level": level,
            "excl": excl, "tile_bound": tile_bound,
        }
        # every card holds the gathered sums: the first card's are read
        return frag_all[0], cfrag_all[0]

    def coverage_finish(self, handles) -> Tuple[float, float]:
        """Resolve coverage handles (one pull): float64 sums of the
        per-tile sums, then Python float adds in submission order."""
        dev = [x for h in handles for x in h if isinstance(x, torch.Tensor)]
        got = iter(self._fetch_many(dev) if dev else ())
        frag = 0.0
        cfrag = 0.0
        for fe, fc in handles:
            if isinstance(fe, torch.Tensor):
                fe, fc = next(got), next(got)
            frag += float(np.asarray(fe, np.float64).sum())
            cfrag += float(np.asarray(fc, np.float64).sum())
        return frag, cfrag

    # --- stage 2: p-values (resident) --------------------------------------

    def stats_all(self, lam: float, factor: float) -> None:
        """Merge the rows into the exact engine's intervals
        (``merge_rows``), then -log10 p over every tile (K2)."""
        self._lam = F32(lam)
        self._factor = F32(factor)
        self.merge_rows()
        for st in self._chrom.values():
            if st.get("host"):
                continue
            st["pv"] = self._each(ShardedKernels.stats, st["ev"], st["cr"],
                                  st["excluded"], self._lam, self._factor)
        self.host_stats(lam, factor)

    def merge_rows(self) -> None:
        """Each tile's rows merged into the exact engine's intervals
        (``ShardedKernels.runs``), the [t, M] layout narrowed to the
        widest tile's interval count on any shard: one pull of every
        chromosome's counts.  ``cont`` stays for the summits and AUCs of
        peaks that straddle a tile boundary."""
        pend = []
        keys = ("starts", "ends", "ev", "cr", "excluded")
        for st in self._chrom.values():
            if st.get("host"):
                continue
            kern = self._kern(st["tile_len"])
            width = sum(x.numel() for x in st["starts"]) \
                * self.world // len(self.devices)
            out = self._step(kern.runs, *(st[key] for key in keys),
                             st["live"], st.pop("level"), st.pop("excl"),
                             st.pop("tile_bound"), self._lam, self._factor)
            st.update(zip(keys, out[:5]), cont=out[7])
            pend.append((st, width, out[5], out[6]))
        if not pend:
            return
        got = self._pull(x for _, _, n, rows in pend for x in (n, rows))
        p = self.perf
        for j, (st, width, ns, _) in enumerate(pend):
            n, rows = got[2 * j], got[2 * j + 1]
            k = max(int(n.max()), 1)
            p["interval_rows"] += width
            p["real_rows"] += int(rows.sum())
            p["merged_rows"] += int(n.sum())
            p["merged_width"] += k * n.shape[0]
            for key in keys:
                st[key] = [x[:, :k].contiguous() for x in st[key]]
            st["live"] = [torch.arange(k, device=x.device) < x[:, None]
                          for x in ns]

    # --- multi-replicate: archive + per-tile Fisher --------------------------

    def archive_replicate(self) -> None:
        """Per-tile p-value RLE compaction, with each tile's first run's p
        and the previous tile's last run's p (``ShardedKernels.run_edges``);
        coverage arrays released.  The archive keeps each tile's whole
        padded width and pulls no count: those rows add to
        ``perf["archive_rows"]``."""
        rep: Dict[int, tuple] = {}
        for cidx, st in self._chrom.items():
            if st.get("host"):
                rep[cidx] = self.host_archive(st)
                continue
            e_b, pv_b, b = self._each(ShardedKernels.rle_pv, st["starts"],
                                      st["ends"], st["pv"], st["live"],
                                      st["limit"])
            edges = self._step(self._kern(st["tile_len"]).run_edges, pv_b, b)
            self.perf["archive_rows"] += sum(e.numel() for e in e_b)
            rep[cidx] = (e_b, pv_b, st["len"], st["tile_len"], st["limit"],
                         edges)
        self._reps.append(rep)
        self._chrom.clear()

    def finalize_fisher(self) -> None:
        """combinePval across replicates, tile by tile (K3).  A tile's
        first combined interval continues the previous tile's last one
        (``cont``) iff in every replicate the tile's first run has the p
        of the previous tile's last run: the boundary cut one run of each,
        and the exact engine has no break there.  K3's lanes (every
        tile's merged width, summed over the cards) add to
        ``perf["fisher_rows"]``."""
        chroms = sorted({c for rep in self._reps for c in rep})
        for cidx in chroms:
            present = [rep[cidx] for rep in self._reps if cidx in rep]
            if any(self.host_is_archived(r) for r in present):
                self.host_fisher(cidx, present)
                continue
            self.perf["fisher_rows"] += sum(e.numel() for p in present
                                            for e in p[0])
            kern = self._kern(present[0][3])
            starts, ends, comb, live = self._each(
                kern.fisher(len(present)), *(p[0] for p in present),
                *(p[1] for p in present))
            cont = [torch.stack([both[c] & (first[c] == prev_last[c])
                                 for *_, (first, prev_last, both)
                                 in present]).all(0)
                    for c in range(len(self.devices))]
            self._chrom[cidx] = {
                "starts": starts, "ends": ends, "pv": comb,
                "live": live, "len": present[0][2],
                "tile_len": present[0][3], "limit": present[0][4],
                "cont": cont,
            }
        self._reps.clear()

    # --- host-RLE paths (-f/-k logs, -X, host peak caller) -------------------

    def pval_pileup(self, cidx: int) -> Pileup:
        st = self._chrom[cidx]
        if st.get("host"):
            return self.host_pval_pileup(st)
        e_b, pv_b, b = self._each(ShardedKernels.rle_pv, st["starts"],
                                  st["ends"], st["pv"], st["live"],
                                  st["limit"])
        ends, (pv,) = self._stitch(e_b, (pv_b,), b, st)
        if len(ends) == 0:
            return Pileup(np.array([st["len"]], np.int64), np.zeros(1, F32))
        return Pileup(ends, pv)

    def pvalue_pileups(self, cidx: int) -> Tuple[Pileup, Pileup, Pileup]:
        st = self._chrom[cidx]
        if st.get("host"):
            return self.host_pvalue_pileups(st)
        e_b, pv_b, ev_b, cv_b, b = self._each(
            ShardedKernels.rle, st["starts"], st["ends"], st["pv"], st["ev"],
            st["cr"], st["excluded"], st["live"], self._lam, self._factor)
        ends, (pv, ev, cv) = self._stitch(e_b, (pv_b, ev_b, cv_b), b, st)
        if len(ends) == 0:
            end = np.array([st["len"]], np.int64)
            return (Pileup(end, np.zeros(1, F32)),
                    Pileup(end, np.full(1, self._lam, F32)),
                    Pileup(end, np.zeros(1, F32)))
        return Pileup(ends, ev), Pileup(ends, cv), Pileup(ends, pv)

    def _stitch(self, e_b, vals, b, st):
        """Per-tile RLE arrays of every shard -> one chromosome RLE
        (host).

        Offsets tile-local ends to chromosome coordinates and merges
        the artificial run break at each tile boundary when the
        run-defining p-value is equal on both sides (keeping the later
        run's companion values, i.e. the run's final boundary row).
        """
        tile_len = st["tile_len"]
        fetched = self._pull((b, e_b) + tuple(vals))
        b_np, e_np = fetched[0], fetched[1]
        v_np = list(fetched[2:])
        ends_parts, val_parts = [], [[] for _ in v_np]
        for t in range(e_np.shape[0]):
            n = int(b_np[t])
            if n == 0:
                continue
            ends_parts.append(e_np[t, :n].astype(np.int64) + t * tile_len)
            for j, v in enumerate(v_np):
                val_parts[j].append(v[t, :n])
        if not ends_parts:
            return np.zeros(0, np.int64), tuple(
                np.zeros(0, F32) for _ in v_np)
        ends = np.concatenate(ends_parts)
        vs = [np.concatenate(p) for p in val_parts]
        # merge runs across tile boundaries: drop row i when the next
        # row has the same p-value (vs[0] is the run key)
        same = np.concatenate([vs[0][1:] == vs[0][:-1], np.zeros(1, bool)])
        boundary = (ends % tile_len) == 0
        keep = ~(same & boundary & (ends < st["len"]))
        return ends[keep], tuple(v[keep] for v in vs)

    # --- stage 3: q-values ---------------------------------------------------

    def qvalue_table(self, genome_len: int) -> bool:
        """Exact genome-wide BH from the per-shard distinct (p, bp) tables.

        Every chromosome's table is submitted before any is pulled; a
        table that overflowed its width k is computed again, just for
        that chromosome, with k widened to fit -- loud, never a silent
        truncation.  Every card holds the gathered tables: the first
        card's are read.
        """
        ps, ws = [], []
        pend = []
        for st in self._chrom.values():
            if st.get("host"):
                hp, hw = self.host_distinct(st)
                if len(hp):
                    ps.append(np.asarray(hp, F32))
                    ws.append(np.asarray(hw, np.uint64))
                continue
            kern = self._kern(st["tile_len"])
            pend.append((st, kern, self._step(
                kern.distinct, st["starts"], st["ends"], st["pv"],
                st["live"])))
        d_nps = []
        while pend:
            d_nps = self._fetch_many([out[2][0] for _, _, out in pend])
            redo = [i for i, ((_, kern, _), d_np)
                    in enumerate(zip(pend, d_nps))
                    if not (d_np <= kern.k).all()]
            if not redo:
                break
            for i in redo:
                st = pend[i][0]
                kern = ShardedKernels(st["tile_len"],
                                      pow2(int(d_nps[i].max())), self.cards)
                self._kernels[st["tile_len"]] = kern
                pend[i] = (st, kern, self._step(
                    kern.distinct, st["starts"], st["ends"], st["pv"],
                    st["live"]))
        if pend:
            flat = self._fetch_many([x[0] for _, _, (pv_all, w_all, _)
                                     in pend for x in (pv_all, w_all)])
            for j, ((_, kern, _), d_np) in enumerate(zip(pend, d_nps)):
                pv_g, w_g = flat[2 * j], flat[2 * j + 1]
                for i, d in enumerate(d_np):
                    d = int(d)
                    if d:
                        ps.append(pv_g[i * kern.k:i * kern.k + d])
                        ws.append(w_g[i * kern.k:i * kern.k + d]
                                  .astype(np.uint64))
        if not ps:
            z = self._zeros()
            self._qtable = (z, z)
            self._qtable_host = (np.zeros(0, F32), np.zeros(0, F32))
            return False
        with span("pipeline.qvalue_merge", self.perf, "qvalue_merge_s"):
            uv, qv, tab_p, tab_q, _, all_one = \
                qvalue.merge_distinct_tables(ps, ws, genome_len, lo=1 << 8)
        self._qtable = (self._put_all(tab_p), self._put_all(tab_q))
        self._qtable_host = (uv, qv)
        return all_one

    def _zeros(self) -> list:
        """A float32 [1] zero on every card."""
        return [torch.zeros(1, dtype=torch.float32, device=d)
                for d in self.devices]

    # --- stage 4: peaks ------------------------------------------------------

    def peaks_submit(self, cidx: int, min_pq: float, min_auc: float,
                     min_len: int, max_gap: int, use_q: bool):
        """Queue per-tile peak calling (no blocking), ``PEAK_CAP``
        candidate slots a tile.  None for a host chromosome (over
        2^31-1 bp: the pipeline's host peak caller then finishes it,
        counted in ``perf["host_peak_chroms"]``).  A ``max_gap`` that
        reaches a tile (a -g of ``MAX_TILE_LEN`` or more) calls the
        chromosome's peaks once over its rows of every tile
        (``_chrom_rows``), ``CHROM_PEAK_CAP`` slots, as TorchEngine
        calls them."""
        st = self._chrom[cidx]
        if st.get("host"):
            self.perf["host_peak_chroms"] += 1
            return None
        if use_q:
            tab_p, tab_q = self._qtable
        else:
            tab_p = tab_q = self._zeros()
        for key in ("ev", "cr", "excluded"):
            st.pop(key, None)
        if max_gap >= st["tile_len"]:
            rows = self._chrom_rows(st)
            cap = min(CHROM_PEAK_CAP, rows[0].shape[0])

            def chrom(k):
                return self._call(chrom_peaks, *rows, (tab_p[0], tab_q[0]),
                                  min_pq, min_auc, min_len, max_gap, use_q,
                                  k)
            return "chrom", (chrom, chrom(cap), cap, rows[0].shape[0])
        kern = self._kern(st["tile_len"])
        cap = min(PEAK_CAP, st["starts"][0].shape[1])

        def dispatch(k):
            # not replicated: ``_pull`` gathers what the host merge needs
            return self._step(kern.peaks(use_q, min_len, max_gap, False, k),
                              st["starts"], st["ends"], st["pv"], st["live"],
                              tab_p, tab_q, min_pq, min_auc)
        return "tiles", (dispatch, dispatch(cap), cap, st, min_pq, min_auc,
                         min_len, max_gap, use_q)

    def _chrom_rows(self, st):
        """The chromosome's live, non-empty rows of every shard in
        genomic order and chromosome coordinates (int32: a device
        chromosome is under 2^31 bp), a row that a tile boundary cut in
        two (``cont`` of the later tile, as ``_row_order_peaks`` reads
        it) joined back into the one interval it is: (starts, ends, p,
        live), on the first card (under a process group every rank
        holds the same rows, so every rank launches the same shapes).
        One accounted fetch: every shard's row count."""
        tl = st["tile_len"]
        takes, cols = [], []
        for c, (starts, ends) in enumerate(zip(st["starts"], st["ends"])):
            t = starts.shape[0]
            off = (torch.arange(t, dtype=torch.int64, device=starts.device)
                   + (self.rank + c) * t)[:, None] * tl
            takes.append((st["live"][c] & (ends > starts)).reshape(-1))
            cols.append([(starts + off).reshape(-1),
                         (ends + off).reshape(-1), st["pv"][c].reshape(-1),
                         ((starts == 0) & st["cont"][c][:, None])
                         .reshape(-1)])
        n = self._pull([[x.sum(dtype=torch.int64).reshape(1)
                         for x in takes]])[0]
        cols = [[x[take] for x in col] for col, take in zip(cols, takes)]
        dev = self.device
        # the rank's cards' rows joined on its first card, in card order
        cols = [torch.cat([col[j].to(dev) for col in cols])
                for j in range(4)]
        if self.cards.procs is not None:
            # padded to the most rows a rank holds, for one gather across
            # the ranks
            per_rank = n.reshape(-1, len(self.devices)).sum(1)
            width = max(int(per_rank.max()), 1)
            parts = [gather_rows(torch.cat([x, x.new_zeros(
                width - x.shape[0])]), self.cards.procs).split(width)
                for x in cols]
            cols = [torch.cat([p[:int(k)] for p, k in zip(part, per_rank)])
                    for part in parts]
        g_start, g_end, pv, cont = cols
        cut = torch.zeros_like(cont)
        cut[1:] = cont[1:] & (g_start[1:] == g_end[:-1])
        head = torch.nonzero(~cut).squeeze(1)
        last = torch.cat([head[1:] - 1, head.new_full((1,), cut.shape[0] - 1)])
        return (g_start[head].to(torch.int32), g_end[last].to(torch.int32),
                pv[head], torch.ones(head.shape[0], dtype=torch.bool,
                                     device=dev))

    def peaks_fetch(self, handle):
        """Resolve a ``peaks_submit`` handle: a chromosome's call as
        TorchEngine resolves it (``fetch_chrom_peaks``), or the tiles'.
        Of the tiles': the host boundary merge, the row-order AUC and
        summit of each merged peak that straddles a
        tile boundary, and the min-AUC filter; returns the peak arrays.
        When a tile has more candidates than its slots, the chromosome's
        peak step runs again on the device with the largest count of its
        tiles, rounded up to a power of two (at most the tile width), as
        every tile's slots (``perf["peak_redispatch"]``).  Every shard's
        tiles are pulled (gathered across ranks), so every rank
        launches the same shape."""
        kind, handle = handle
        if kind == "chrom":
            return fetch_chrom_peaks(self, handle)
        dispatch, res, cap, st, min_pq, min_auc, min_len, max_gap, use_q = \
            handle
        res = self._pull(res)
        n = int(res[-1].max())                 # n_peaks of every tile
        if n > cap:
            self.perf["peak_redispatch"] += 1
            res = self._pull(dispatch(
                min(pow2(n), st["starts"][0].shape[1])))
        with span("pipeline.peak_merge", self.perf, "peak_merge_s"):
            tile_len = st["tile_len"]
            # no AUC filter yet: a straddling peak's AUC changes below
            merged = merge_tile_peaks(
                TileResult(TilePeaks(*res), None, None), tile_len, -np.inf,
                min_len, max_gap)
            starts = np.array([m[0] for m in merged], np.int64)
            ends = np.array([m[1] for m in merged], np.int64)
            aucs = np.array([m[2] for m in merged], F32)
            spv = np.array([m[3] for m in merged], F32)
            sqv = np.array([m[4] for m in merged], F32)
            spos = np.array([m[5] for m in merged], np.int64)
            strad = starts // tile_len < (ends - 1) // tile_len
            if strad.any():
                got = self._row_order_peaks(st, starts[strad], ends[strad],
                                            min_pq, use_q)
                aucs[strad], spv[strad], sqv[strad], spos[strad] = got
            keep = aucs >= F32(min_auc)
            self.perf["straddling_peaks"] += int((strad & keep).sum())
        return (starts[keep], ends[keep], aucs[keep], spv[keep], sqv[keep],
                spos[keep])

    def _row_order_peaks(self, st, p_start, p_end, min_pq: float,
                         use_q: bool):
        """AUC and summit of each peak [p_start, p_end) (chromosome
        coordinates) over its significant rows in genomic order across
        tiles, as K4 and the exact engine's updatePeak take them: float32
        ``auc = f32(auc + f32(len * f32(stat - min_pq)))``; the summit is
        the first row of maximum stat for its p and q, and the longest
        such row, the first of equal length, for its position (the
        row's midpoint, relative to p_start).  A row that a tile boundary
        cut in two (``cont`` of the later tile, from ``merge_rows`` or,
        on the Fisher path, ``finalize_fisher``) counts as the one
        interval it is, at its full length.  Each card selects the rows
        of its own tiles; shards hold consecutive tiles, so the pulled
        rows are in genomic order.  Returns (auc, summit p, summit q,
        summit offset) arrays."""
        tl = st["tile_len"]
        thr = F32(min_pq)
        sel = []
        for c, (starts, ends, pv) in enumerate(zip(st["starts"], st["ends"],
                                                   st["pv"])):
            stat = assign_qvals(pv.reshape(-1), self._qtable[0][c],
                                self._qtable[1][c]).reshape(pv.shape) \
                if use_q else pv
            t = starts.shape[0]
            dev = starts.device
            off = (torch.arange(t, dtype=torch.int64, device=dev)
                   + (self.rank + c) * t)[:, None] * tl
            g_start = (starts + off).reshape(-1)
            g_end = (ends + off).reshape(-1)
            cont = ((starts == 0) & st["cont"][c][:, None]).reshape(-1)
            sig = st["live"][c] & (ends > starts) & (stat > float(thr))
            peak = torch.searchsorted(torch.as_tensor(p_start, device=dev),
                                      g_start, right=True) - 1
            take = sig.reshape(-1) & (peak >= 0) & (
                g_end <= torch.as_tensor(p_end, device=dev)[
                    peak.clamp_min(0)])
            sel.append(((peak, g_start, g_end, stat.reshape(-1),
                         pv.reshape(-1), cont), take))
        # the selections run inside the pull, whose fetch accounts their
        # host syncs
        peak, g_start, g_end, stat, pv, cont = self._pull(
            ([cols[j][take] for cols, take in sel] for j in range(6)),
            ragged=True)
        k = len(p_start)
        out = (np.zeros(k, F32), np.full(k, F32(SKIP)), np.full(k, F32(SKIP)),
               np.zeros(k, np.int64))
        if not len(peak):
            return out
        cut = (g_end[:-1] == g_start[1:]) & cont[1:] & (peak[:-1] == peak[1:])
        head = np.flatnonzero(np.concatenate([[True], ~cut]))
        g_end = g_end[np.concatenate([head[1:] - 1, [len(g_end) - 1]])]
        g_start, stat, pv, peak = (a[head] for a in (g_start, stat, pv, peak))
        lens = g_end - g_start
        contrib = lens.astype(F32) * (stat - thr)
        auc, spv, sqv, spos = out
        for j in range(k):
            rows = np.flatnonzero(peak == j)
            if not len(rows):
                continue
            # a sequential float32 sum (add.accumulate never reassociates)
            auc[j] = np.cumsum(contrib[rows], dtype=F32)[-1]
            top = rows[stat[rows] == stat[rows].max()]
            spv[j] = pv[top[0]]
            sqv[j] = stat[top[0]] if use_q else F32(SKIP)
            best = top[np.argmax(lens[top])]
            spos[j] = (g_start[best] + g_end[best]) // 2 - p_start[j]
        return out

    def release(self) -> None:
        """Drop the run's tensors on every card (the kernels stay)."""
        self._chrom.clear()
        self._reps.clear()
        self._qtable = None
