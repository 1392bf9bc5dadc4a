"""Process-group runtime of the port: its counterpart of ``tpusparse/dist.py``.

The reference binds one MPI rank to one GPU (``mpirun -np N`` + ``cudaSetDevice(rank)``,
cg_solver_mgpu_partitioned.cu:259); the JAX package ran one process per host over a device
mesh.  The port is back to the reference's model: one process per rank, joined by
``torch.distributed`` with the ``gloo`` backend, each rank driving one device.  gloo moves
CPU tensors only, so a rank stages what it sends through host memory, as the reference
staged its halos through pinned buffers (cudaMemcpyAsync D2H -> MPI -> H2D,
cg_solver_mgpu_partitioned.cu:160-231); NCCL, which would move device memory directly,
refuses two ranks on one card.

Outside a process group every helper sees one rank (rank 0 of 1), so the solvers also run
in a plain process.  Two ways in:

  - ``initialize_multihost``: join a group from the torchrun environment (``env://``) or
    from explicit arguments;
  - ``launch_local(fn, nranks, *args)``: spawn ``nranks`` processes on this host, each
    joined through a ``file://`` store in a temporary directory (no TCP port to pick),
    rank i on ``cuda:(i % device_count)`` or on the CPU; returns rank 0's result.  This is
    how one command drives N ranks, as the JAX package's single-process mesh did.
"""

from __future__ import annotations

import collections
import datetime
import os
import queue as _queue
import socket
import tempfile
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as tdist

# how long a collective may wait for its peers before gloo gives up
TIMEOUT = datetime.timedelta(seconds=300)


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join the process group (gloo).  With no arguments the torchrun environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) says where and who;
    ``coordinator`` (``host:port`` or a URL such as ``tcp://localhost:29500``),
    ``num_processes`` and ``process_id`` say it explicitly.  A no-op when this process
    already belongs to a group."""
    if tdist.is_initialized():
        return
    init = "env://"
    if coordinator:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    tdist.init_process_group(
        "gloo", init_method=init, timeout=TIMEOUT,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_multihost() -> bool:
    """Whether this process is one of several ranks."""
    return world_size() > 1


def rank_device(platform: str = "cuda") -> torch.device:
    """This rank's device: the CPU when asked for, else the card ``torch.cuda`` has current
    (``launch_local`` sets it), or card ``LOCAL_RANK % device_count`` under torchrun.
    Raises when there is no card."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank()}: CUDA requested but no card is visible (pass "
                           "--platform=cpu / device='cpu' for the plain CPU path)")
    if "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def describe_group(device=None) -> dict:
    """Topology provenance for exports, with the keys of the JAX package's
    ``describe_mesh``: the band axis ``x`` over the ranks, one device per rank, the kinds
    of the ranks' devices, and the process (rank) of each."""
    n = world_size()
    kinds = _all_objects(_device_kind(device))
    return {
        "axes": {"x": n},
        "num_devices": n,
        "num_processes": n,
        "device_kinds": sorted(set(kinds)),
        "process_of_device": list(range(n)),
    }


def ranks_per_card(device) -> int:
    """The most ranks that share one card of one host (1 when none shares; 0 on the
    CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    places = _all_objects((socket.gethostname(), index))
    return max(collections.Counter(places).values())


def local_band_rows(grid_size: int, num_devices: int, device_index: int) -> tuple:
    """Row range [lo, hi) of a rank's band in the reference's partition
    (cg_solver_mgpu_partitioned.cu:262-268: n/P each, the first n % P ranks one more), the
    JAX package's helper of the same name.  The sharded solver does not use it: as the
    JAX solver, it gives every rank ceil(g/P) rows and pads the last ranks' bands with
    (−g) mod P zero rows (``solvers.cg_sharded.make_sharded_operator``), so that every
    band has one shape."""
    base = grid_size // num_devices
    rem = grid_size - base * num_devices
    lo = device_index * base + min(device_index, rem)
    hi = lo + base + (1 if device_index < rem else 0)
    return lo, hi


def gather_to_host(x, rows: int = 0):
    """Every rank's band of a row-banded field, stacked in rank order on rank 0's host, as
    a numpy array; ``rows`` > 0 keeps the first ``rows`` rows (drops a padded tail).

    Collective: every rank calls it.  Rank 0 gets the field and the other ranks get None,
    as the reference's ``MPI_Gatherv`` to root (cg_solver_mgpu_partitioned.cu:834-851);
    the JAX package's ``process_allgather`` instead gave every host the whole field.  Each
    band goes to its host, then by gloo to rank 0; bands may differ in rows."""
    band = x.detach().to("cpu").contiguous()
    if world_size() == 1:
        out = band
    else:
        sizes = _all_objects(band.shape[0])
        most = max(sizes)
        if band.shape[0] < most:  # gloo's gather takes equal shapes: pad, then trim
            band = torch.cat([band, band.new_zeros((most - band.shape[0],) + band.shape[1:])])
        whole = band.new_empty((most * world_size(),) + band.shape[1:]) if rank() == 0 \
            else None
        parts = list(whole.chunk(world_size())) if whole is not None else None
        tdist.gather(band, parts, dst=0)
        if whole is None:
            return None
        out = whole if len(set(sizes)) == 1 else torch.cat(
            [part[:size] for part, size in zip(parts, sizes)])
    out = out.numpy()
    return out[:rows] if rows else out


def barrier() -> None:
    """Cross-rank barrier: the reference's MPI_Barrier before timing
    (cg_solver_mgpu_partitioned.cu:405).  A no-op for one rank."""
    if world_size() > 1:
        tdist.barrier()


def rank_time_stats(duration_s: float) -> Optional[dict]:
    """Every rank's solve time gathered, reduced to MAX (the bottleneck rank) and MIN, and
    the load imbalance (max − min) / max in percent: the reference's formula
    (cg_solver_mgpu_partitioned.cu:749-800) and the JAX package's dict.  Call with a
    duration measured after ``barrier`` so that the start edges align.  None for one
    rank."""
    if world_size() <= 1:
        return None
    per = np.asarray(_all_objects(float(duration_s)), np.float64) * 1e3
    mx, mn = float(per.max()), float(per.min())
    return {
        "solve_time_max_ms": mx,
        "solve_time_min_ms": mn,
        "load_imbalance_pct": 100.0 * (mx - mn) / mx if mx > 0 else 0.0,
        "per_process_ms": [round(float(v), 3) for v in per],
    }


def env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    return default if v is None else v not in ("0", "false", "False", "")


def _device_kind(device) -> str:
    dev = torch.device(device) if device is not None else torch.device("cpu")
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _all_objects(obj) -> list:
    """[obj of rank 0, obj of rank 1, ...] on every rank."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    tdist.all_gather_object(out, obj)
    return out


# ---------------------------------------------------------------------------
# Local launcher
# ---------------------------------------------------------------------------


def launch_local(fn, nranks: int, *args, device: str = "cuda"):
    """Run ``fn(rank_device, *args)`` on ``nranks`` spawned processes of this host joined
    in one gloo group, and return rank 0's result (which must pickle).  Rank i runs on
    ``cuda:(i % device_count)``, so ranks share cards when there are more ranks than
    cards, or on the CPU with ``device="cpu"``.  ``fn`` must be importable by name (a
    module-level function).

    The group meets through a ``file://`` store in a temporary directory, so no TCP port
    is chosen, and gloo talks over the loopback interface unless ``GLOO_SOCKET_IFNAME``
    says otherwise.  A rank that raises, or dies, makes this raise ``RuntimeError`` with
    its traceback, after the other ranks are stopped; a rank that finds no card raises."""
    if nranks < 1:
        raise ValueError(f"nranks must be >= 1, got {nranks}")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tpusparse_torch_group_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, nranks, store, device, results, args))
                 for r in range(nranks)]
        for p in procs:
            p.start()
        failed = True
        try:
            out, pending = None, set(range(nranks))
            while pending:
                try:
                    r, ok, payload = results.get(timeout=1.0)
                except _queue.Empty:
                    dead = [(r, procs[r].exitcode) for r in sorted(pending)
                            if procs[r].exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} of {nranks} exited with code "
                                           f"{dead[0][1]} before it reported") from None
                    continue
                pending.discard(r)
                if not ok:
                    raise RuntimeError(f"rank {r} of {nranks} failed:\n{payload}")
                if r == 0:
                    out = payload
            failed = False
            return out
        finally:
            for p in procs:
                if failed and p.is_alive():
                    p.terminate()
                p.join()
            results.close()


def _rank_main(fn, r, nranks, store, device, results, args):
    """A spawned rank: join the group, pick the device, run ``fn``, report, leave."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        tdist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                                 world_size=nranks, timeout=TIMEOUT)
        if device == "cpu":
            dev = torch.device("cpu")
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // nranks))
        else:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError(f"rank {r}: no CUDA card is visible")
            torch.cuda.set_device(r % count)
            dev = torch.device("cuda", r % count)
        out = fn(dev, *args)
        results.put((r, True, out if r == 0 else None))
    except BaseException:  # noqa: BLE001 - every failure goes to the launcher
        results.put((r, False, traceback.format_exc()))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
