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
nothing and every step runs locally.  ``scoped_group`` leaves a group
that was joined inside its block (the CLI runs each analysis in one,
the server its whole loop); a group that was there before stays its
maker's to end.
"""

from __future__ import annotations

import os
import traceback
from contextlib import contextmanager
from typing import Optional

import torch

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


@contextmanager
def scoped_group():
    """Runs a block, then leaves the default process group if the block
    joined it (``init_distributed``); a group that was there before the
    block stays.

    The group is left on every way out of the block: after a clean end
    the ranks first meet at a barrier, so that no rank closes its
    connections while a peer still finishes a collective; after an
    exception (which goes on) there is no barrier, since the peers may
    be inside another collective, and a peer left waiting fails on the
    closed connections.  The block's objects that hold the group (an
    engine, its ``CardGroup``) must be gone when it ends: then
    ``destroy_process_group`` drops the group's last reference, and its
    destructor joins gloo's worker threads while the interpreter still
    runs.  A gloo worker left running into interpreter teardown can
    release a finished collective's tensors after finalization began;
    taking the interpreter lock there ends the thread inside a
    ``noexcept`` frame, and the process aborts with "terminate called
    without an active exception".  Under NCCL, leaving is what lets the
    group's pending work finish (a group destructed without it warns
    that it was "NOT destroyed").
    """
    import torch.distributed as dist

    def joined() -> bool:
        return dist.is_available() and dist.is_initialized()

    before = joined()
    try:
        yield
    except BaseException as e:
        if not before and joined():
            # the traceback's finished frames hold the engine, and with
            # it the group: their locals go first
            traceback.clear_frames(e.__traceback__)
            dist.destroy_process_group()
        raise
    if not before and joined():
        try:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[torch.cuda.current_device()])
            else:
                dist.barrier()
        finally:
            dist.destroy_process_group()


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
