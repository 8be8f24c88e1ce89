"""Process groups and tile partitioning (twin of parallel/distributed.py).

Each rank of a ``torch.distributed`` process group owns a contiguous
block of the genome's tiles and spreads it over its own devices
(``rank_devices``), one block a device, as the JAX module spreads a
process's block over its local devices; the collectives of ``mesh.py``
(the carries' and fragment sums' gathers, the distinct (p, bp) tables,
the replicated peak arrays) are the only traffic between ranks, each
joining the rank's devices on its first before one collective across
the ranks.  There is no global-array constructor: where the JAX
module's ``make_global`` builds one ``jax.Array`` from every process's
rows, a rank here passes its devices' rows to the steps.

``init_distributed`` joins a group from the standard environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): NCCL when
the device is CUDA, gloo on the CPU.  Without those variables it does
nothing and every step runs locally.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.peaks import TilePeaks
from ..ops.pipeline import TileResult
from .mesh import (CardGroup, ShardedKernels, merge_tile_peaks,
                   sharded_analyze_full, split_events_to_tiles,
                   split_excl_to_tiles)

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def init_distributed(device) -> Optional[object]:
    """The default process group, joined from the environment if needed.

    Returns None (no group, local steps) unless ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK`` are all set.  The backend is NCCL for a
    CUDA ``device`` (a list: its first) and gloo for the CPU, and the
    current card is the rank's first (``rank_devices``); a group that is
    already initialised with the other backend, or that fails to form,
    raises.
    """
    import torch.distributed as dist

    first = device[0] if isinstance(device, (list, tuple)) else device
    kind = torch.device(first).type
    want = "nccl" if kind == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != want:
            raise RuntimeError(f"process group uses {dist.get_backend()}, "
                               f"but a {kind} device needs {want}")
        return dist.group.WORLD
    if not all(os.environ.get(k) for k in _ENV):
        return None
    if want == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL process group requested but no CUDA "
                               "card is available")
        # every collective of the rank runs from its first card
        torch.cuda.set_device(rank_devices(device,
                                           int(os.environ["RANK"]))[0])
    dist.init_process_group(want, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return dist.group.WORLD


def rank_devices(device, rank: int) -> list:
    """A rank's devices under a process group, one shard each.

    A list or tuple is taken as it is (a device may repeat), ``cuda:i``
    and ``cpu`` are one device.  A bare ``cuda`` is, when torchrun's
    ``LOCAL_WORLD_SIZE`` is set, the rank's share of this host's cards:
    ``k = device_count() // LOCAL_WORLD_SIZE`` cards from ``LOCAL_RANK *
    k`` (an uneven split raises); so ``LOCAL_WORLD_SIZE=1`` is one
    process a host over every card it sees, the JAX package's form.
    Otherwise a bare ``cuda`` is the one card ``rank`` modulo this
    host's cards.  A CUDA device that is not there raises.
    """
    if isinstance(device, (list, tuple)):
        return local_devices(device)
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return local_devices(device)
    n = torch.cuda.device_count()
    if not os.environ.get("LOCAL_WORLD_SIZE"):
        return local_devices([torch.device("cuda", rank % max(n, 1))])
    per_host = int(os.environ["LOCAL_WORLD_SIZE"])
    if "LOCAL_RANK" not in os.environ:
        raise ValueError("LOCAL_WORLD_SIZE is set but LOCAL_RANK is not")
    if per_host < 1 or n % per_host or n == 0:
        raise ValueError(f"{n} CUDA cards do not split evenly over "
                         f"LOCAL_WORLD_SIZE={per_host} ranks")
    k = n // per_host
    local = int(os.environ["LOCAL_RANK"])
    return local_devices([torch.device("cuda", i)
                          for i in range(local * k, (local + 1) * k)])


def local_devices(device) -> list:
    """The devices of a process with no process group, one shard each:
    ``cuda`` without an index spans every card this process sees (the
    JAX engine's mesh over ``jax.devices()``; ``CUDA_VISIBLE_DEVICES``
    restricts it), ``cuda:i`` and ``cpu`` are one, and a list or tuple
    is taken as it is (a device may repeat).  A CUDA device that is not
    there raises."""
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
    else:
        devices = [torch.device(device)]
        if devices[0].type == "cuda" and devices[0].index is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("no device given")
    for d in devices:
        if d.type == "cuda" and not (
                torch.cuda.is_available()
                and 0 <= (d.index or 0) < torch.cuda.device_count()):
            raise RuntimeError(f"device {d} requested but this process "
                               f"sees {torch.cuda.device_count()} CUDA "
                               f"cards")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {d}")
    return devices


def _proc() -> tuple:
    """(process count, this process's rank) of the default group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_tile_range(n_tiles: int) -> range:
    """The contiguous block of global tiles this process owns."""
    n_proc, pid = _proc()
    if n_tiles % n_proc:
        raise ValueError(
            f"n_tiles={n_tiles} must be a multiple of the process "
            f"count {n_proc}; pad the tile grid (empty tiles are "
            f"cheap) before sharding")
    per = n_tiles // n_proc
    return range(pid * per, (pid + 1) * per)


def host_local_events(start: np.ndarray, end: np.ndarray,
                      count: np.ndarray, n_tiles: int, tile_len: int,
                      pad_to: int):
    """Split this host's events into its local tile rows.

    Returns [T_local, pad_to] arrays for the tiles in
    ``local_tile_range`` only.  ``pad_to`` is mandatory (every process
    must agree on the event width), so overflow raises instead of
    regrowing.
    """
    s, e, c = split_events_to_tiles(start, end, count, n_tiles,
                                    tile_len, pad_to,
                                    on_overflow="error")
    r = local_tile_range(n_tiles)
    return s[r.start:r.stop], e[r.start:r.stop], c[r.start:r.stop]


def distributed_analyze(start, end, count, n_tiles: int,
                        tile_len: int, genome_len: int,
                        min_pq: float, min_auc: float,
                        min_len: int = 0, max_gap: int = 100,
                        qval_opt: bool = False, ctrl=None,
                        excl_bed=None, limit=None,
                        pad_to: Optional[int] = None,
                        k_distinct: int = 1 << 13, device="cuda"):
    """Full multi-process sharded analysis of one chromosome.

    Every process calls this with the same parameters and the whole
    event lists; each keeps only its own tiles' rows, cut into one
    contiguous block a device of ``rank_devices(device, rank)`` (a list
    of devices, a device may repeat; for a bare "cuda" the rank's share
    of this host's cards, or one), the collectives span the default
    process group (if any) and the devices of every rank, and the
    outputs that reach the host (fragment sums, the distinct (p, bp)
    tables, the per-tile peak arrays) are gathered so that every
    process computes the identical final peak list.

    Returns (peaks, lam, factor) where peaks is the merged
    [(start, end, auc, summit_pval, summit_qval, summit_pos)] list.
    """
    group = init_distributed(device)
    cards = CardGroup(rank_devices(device, _proc()[1]), group)
    kern = ShardedKernels(tile_len, k_distinct, cards)

    if ctrl is None:
        ctrl = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.int32))
    if pad_to is None:
        # width must be agreed across processes: derive it from the
        # full (replicated) event lists
        w = 1
        for (s_, e_, c_) in ((start, end, count), ctrl):
            rows = split_events_to_tiles(s_, e_, c_, n_tiles,
                                         tile_len)[0]
            while w < rows.shape[1]:
                w <<= 1
        pad_to = w

    r = local_tile_range(n_tiles)
    if len(r) % cards.n_local:
        raise ValueError(f"a rank's {len(r)} tiles do not split over its "
                         f"{cards.n_local} devices")
    per = len(r) // cards.n_local
    es, ee, ec = host_local_events(start, end, count, n_tiles,
                                   tile_len, pad_to)
    cs, ce, cc = host_local_events(ctrl[0], ctrl[1], ctrl[2],
                                   n_tiles, tile_len, pad_to)
    excl = split_excl_to_tiles(excl_bed or [], n_tiles, tile_len)
    if limit is None:
        limit = np.full(n_tiles, tile_len, np.int32)
    limit = np.asarray(limit)[r.start:r.stop]
    blocks = [slice(c * per, (c + 1) * per) for c in range(cards.n_local)]
    args = [[torch.as_tensor(x[b], device=d)
             for b, d in zip(blocks, cards.devices)]
            for x in (es, ee, ec, cs, ce, cc, excl[r.start:r.stop])]
    res, lam, factor = sharded_analyze_full(
        *args, tile_len, genome_len, min_pq, min_auc, min_len, max_gap,
        qval_opt, k_distinct, [limit[b] for b in blocks], kern, cards)
    host = TilePeaks(*(f.cpu().numpy() for f in res.peaks))
    peaks = merge_tile_peaks(TileResult(host, None, None), tile_len,
                             min_auc, min_len, max_gap)
    return peaks, float(lam), float(factor)
