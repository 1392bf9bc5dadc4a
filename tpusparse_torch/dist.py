"""Process-group and device-mesh runtime of the port: its counterpart of ``tpusparse/dist.py``.

Two ways to run the sharded CG, as the JAX package has two:

  - one process over a mesh of devices (``Mesh``; ``make_band_mesh``, ``make_mesh``,
    ``describe_mesh``), the JAX package's single controller: the process holds every
    shard and moves halos between them with device copies (``solvers.cg_sharded``);
    shards outnumbering the cards take turns on them, shard i on ``cuda:(i % count)``;
  - one process per rank, joined by ``torch.distributed`` with the ``gloo`` backend, each
    rank driving one device: the reference's model (one MPI rank per GPU, ``mpirun -np
    N`` + ``cudaSetDevice(rank)``, cg_solver_mgpu_partitioned.cu:259).  gloo moves CPU
    tensors only, so a rank stages what it sends through host memory, as the reference
    staged its halos through pinned buffers (cudaMemcpyAsync D2H -> MPI -> H2D,
    cg_solver_mgpu_partitioned.cu:160-231);
  - both at once (``make_rank_mesh``), the JAX package's multi-host mode: each rank of a
    gloo group drives a mesh of its own shards, one global band or block mesh across the
    ranks.

Between ranks whose cards are all their own (``device_group``), halos and dots go card to
card by NCCL, in a group of its own (``nccl_group``), whose calls a rank's sharded CG
captures into its one CUDA graph; ranks on the CPU, and ranks that share a card (where
NCCL refuses to run), stage them through the host by gloo.  The default group stays gloo:
barriers, gathers to the host and the provenance go through it.

Outside a process group every helper sees one rank (rank 0 of 1), so the solvers also run
in a plain process.  Two ways into a group:

  - ``initialize_multihost``: join a group from the torchrun environment (``env://``) or
    from explicit arguments;
  - ``launch_local(fn, nranks, *args)``: spawn ``nranks`` processes on this host, each
    joined through a ``file://`` store in a temporary directory (no TCP port to pick),
    rank i on ``cuda:(i % device_count)`` or on the CPU; returns rank 0's result.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import queue as _queue
import socket
import tempfile
import threading
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from ._device import host_numpy
from .bench import profiling

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


def describe_group(device=None, transport: Optional[str] = None) -> dict:
    """Topology provenance of a group's exports (the mesh's is ``describe_mesh``), with the
    keys of the JAX package's ``describe_mesh``: the band axis ``x`` over the ranks, one
    device per rank, the kinds of the ranks' devices, and the process (rank) of each; and
    ``transport`` (``nccl`` or ``gloo``: what moved the halos and dots) when given.
    Collective: every rank calls it."""
    n = world_size()
    kinds = _all_objects(_device_kind(device))
    out = {
        "axes": {"x": n},
        "num_devices": n,
        "num_processes": n,
        "device_kinds": sorted(set(kinds)),
        "process_of_device": list(range(n)),
    }
    return out if transport is None else {**out, "transport": transport}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of devices: the counterpart of ``jax.sharding.Mesh``.  ``shape`` is (N,) for
    row bands or (R, C) for 2-D blocks, ``axis_names`` ("x",) or ("x", "y"), ``devices``
    one ``torch.device`` a shard, row-major (shard i·C + j holds block (i, j)).  Several
    shards may name one device.  ``processes``: the ranks it spans (1: this process drives
    every shard); ``rank``: this process's, which drives the shards ``local``, N /
    ``processes`` in a row of the row-major numbering (``make_rank_mesh``)."""

    shape: tuple
    axis_names: tuple
    devices: tuple
    processes: int = 1
    rank: int = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        """The shards this process drives."""
        per = self.size // self.processes
        return range(self.rank * per, (self.rank + 1) * per)

    def shards_per_card(self) -> int:
        """The most shards on one card (0 when every shard is on the CPU)."""
        cards = [d for d in self.devices if d.type == "cuda"]
        return max(collections.Counter(cards).values()) if cards else 0


def _mesh_devices(n: int, devices) -> tuple:
    """n devices for a mesh: ``devices`` None or "cuda", shard i on ``cuda:(i %
    device_count)`` (raises without a card); "cpu", every shard on the CPU; a sequence,
    shard i on its entry i % len."""
    if devices is None or isinstance(devices, (str, torch.device)):
        kind = torch.device(devices or "cuda").type
        if kind == "cpu":
            return (torch.device("cpu"),) * n
        if kind != "cuda":
            raise ValueError(f"a mesh's devices are cuda or cpu, got {devices!r}")
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass devices='cpu' for a mesh on the "
                               "CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    devs = [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return tuple(devs[i % len(devs)] for i in range(n))


def make_mesh(shape, axis_names=("x", "y"), devices=None) -> Mesh:
    """A mesh of ``shape`` (every extent >= 1) over ``devices`` (``_mesh_devices``): the
    JAX CLI's ``jax.make_mesh((r, c), ("x", "y"))``."""
    shape = tuple(int(v) for v in shape)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {tuple(axis_names)}")
    return Mesh(shape, tuple(axis_names), _mesh_devices(int(np.prod(shape)), devices))


def make_band_mesh(num_devices: int = 0, devices=None) -> Mesh:
    """The 1-D mesh over the row-band axis "x" (the JAX package's ``make_band_mesh``):
    ``num_devices`` shards, by default one a visible card (one shard on the CPU, or one a
    device of a ``devices`` sequence); ``devices`` as ``_mesh_devices``."""
    n = int(num_devices)
    if not n:
        if isinstance(devices, Sequence) and not isinstance(devices, str):
            n = len(devices)
        elif torch.device(devices or "cuda").type == "cuda" and torch.cuda.is_available():
            n = torch.cuda.device_count()
        else:
            n = 1
    return make_mesh((n,), ("x",), devices)


def make_rank_mesh(shape=0, devices=None) -> Mesh:
    """The mesh across the ranks of the group (the JAX package's ``make_band_mesh`` or
    ``jax.make_mesh((r, c), ("x", "y"))`` after ``jax.distributed.initialize``): ``shape``
    an int N, N row bands (0: one a rank), or (R, C), R·C blocks numbered row-major
    (shard i·C + j holds block (i, j)).  With W ranks and L = N / W (or R·C / W), rank r
    drives shards [r·L, (r+1)·L), JAX's numbering, process by process; shard i sits on
    ``cuda:(i % device_count)`` or, with ``devices="cpu"``, on the CPU (``_mesh_devices``).
    ValueError unless W divides the shards.  Outside a group it is ``make_band_mesh``'s or
    ``make_mesh``'s mesh."""
    w = world_size()
    if isinstance(shape, (tuple, list)):
        shape, axes = tuple(int(v) for v in shape), ("x", "y")
        if len(shape) != 2 or min(shape) < 1:
            raise ValueError(f"a 2-D mesh across ranks is (R, C), got {shape}")
    else:
        shape, axes = (int(shape) or w,), ("x",)
    n = int(np.prod(shape))
    if n < 1 or n % w:
        raise ValueError(f"a mesh across {w} ranks needs a multiple of {w} shards, got {n}")
    return Mesh(shape, axes, _mesh_devices(n, devices), w, rank())


def describe_mesh(mesh: Mesh, transport: Optional[str] = None) -> dict:
    """Topology provenance for exports (the JAX package's ``describe_mesh``): the axes,
    the shards, the processes, the kinds of the devices, the process of each shard, and
    the device of each shard; and ``transport`` (``mesh``, ``nccl`` or ``gloo``) when
    given."""
    per = mesh.size // mesh.processes
    out = {
        "axes": dict(zip(mesh.axis_names, mesh.shape)),
        "num_devices": mesh.size,
        "num_processes": mesh.processes,
        "device_kinds": sorted({_device_kind(d) for d in mesh.devices}),
        "process_of_device": [i // per for i in range(mesh.size)],
        "devices": [str(d) for d in mesh.devices],
    }
    return out if transport is None else {**out, "transport": transport}


def _as_devices(device) -> list:
    """A device, or a sequence of them, as a list of ``torch.device``s (a card without an
    index: the current one)."""
    devs = [device] if device is None or isinstance(device, (str, torch.device)) \
        else list(device)
    devs = [torch.device(d) if d is not None else torch.device("cpu") for d in devs]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


def ranks_per_card(device) -> int:
    """The most ranks that use one card of one host (1 when none shares; 0 on the CPU).
    ``device``: this rank's device, or the devices of its shards.  Collective on cards:
    every rank calls it."""
    cards = [d for d in _as_devices(device) if d.type == "cuda"]
    if not cards:
        return 0
    host = socket.gethostname()
    places = _all_objects(sorted({(host, d.index) for d in cards}))
    return max(collections.Counter(p for mine in places for p in mine).values())


_NCCL = []  # the group's NCCL group, made once a process


def device_group(device=None, transport: Optional[str] = None):
    """The group that moves halos and dots between the ranks on their cards: an NCCL group
    of every rank (``nccl_group``), when every rank's cards are its own (``ranks_per_card``
    1 on every rank); else None, gloo through the host: ranks on the CPU, and ranks that
    share a card, where NCCL refuses to run.  ``device``: this rank's device, or its
    shards' (the first is the one NCCL runs on).  ``transport`` "gloo" asks for None
    whatever the cards; "nccl" for the NCCL group, in a group of one rank too (the one-card
    run of a graph a rank), ValueError off the cards, outside a group and where ranks
    share a card; None decides.  Over NCCL a rank's sharded CG runs its loop from one CUDA
    graph with NCCL's calls inside it (``solvers.cg_sharded.MeshLoop``), or from one graph
    a card of the rank with NCCL's calls in its first card's
    (``solvers.cg_sharded.RankCardLoop``); over gloo the host steps it.

    Collective on cards: every rank calls it with the same ``transport``; outside a group
    and on the CPU it returns None without one.  Raises when every rank has cards of its
    own and the NCCL group cannot be made: nothing carries on through gloo then."""
    if transport not in (None, "gloo", "nccl"):
        raise ValueError(f"transport is None or 'gloo', or 'nccl' to ask for NCCL, got "
                         f"{transport!r}")
    devs = _as_devices(device)
    cards = all(d.type == "cuda" for d in devs)
    if transport == "nccl" and not (cards and tdist.is_initialized()):
        raise ValueError(f"transport='nccl' moves tensors between the cards of a group's "
                         f"ranks: {[str(d) for d in devs]} "
                         f"{'in' if tdist.is_initialized() else 'outside'} a group")
    if transport == "gloo" or not cards or world_size() == 1 and transport is None:
        return None
    if world_size() > 1 and ranks_per_card(devs) != 1:
        if transport == "nccl":
            raise ValueError(f"rank {rank()}: transport='nccl', but ranks share a card, "
                             "where NCCL refuses to run")
        return None
    return nccl_group(devs[0])


def nccl_group(device):
    """The NCCL group of every rank of the group (``tdist.new_group(backend="nccl")``),
    made once a process on this rank's card ``device`` (a group of one rank too: the
    one-card check of a captured NCCL call).  Collective the first time: every rank calls
    it.  NCCL sets its communicator up at the group's first collective, which every rank
    must join: an all-gather here makes it, outside any timed solve and any capture.

    NCCL is asked not to tie its captured calls to its other work by events
    (``NCCL_GRAPH_MIXING_SUPPORT=0``, unless the caller set it): the body of a CUDA
    graph's conditional node may hold kernels, copies and fills but no event node, and a
    rank's loop captures NCCL's calls into one (with it on, that capture failed on an
    H100 with cudaErrorInvalidValue).  A rank never has a captured and an eager call of
    one group outstanding at once: the eager ones are ordered on its stream before the
    replay, which the host waits for.

    The group and its first all-gather make an ``NCCL_Group`` span (``bench.profiling``)."""
    if not _NCCL:
        if not tdist.is_nccl_available():
            raise RuntimeError(f"rank {rank()}: every rank has cards of its own but this "
                               "torch has no NCCL (pass transport='gloo' to stage through "
                               "the host)")
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
        dev = _as_devices(device)[0]
        with profiling.scope(profiling.PHASE_NCCL_GROUP), torch.cuda.device(dev):
            group = tdist.new_group(backend="nccl", timeout=TIMEOUT)
            probe = torch.empty(world_size(), device=dev)
            tdist.all_gather_into_tensor(probe, torch.ones(1, device=dev), group=group)
            torch.cuda.synchronize(dev)
        _NCCL.append(group)
    return _NCCL[0]


def abort_nccl(group) -> None:
    """Forget ``group`` and abort its communicator: what a rank does when a peer never
    came to a captured call.  The abort runs on a thread of its own and this returns at
    once: ``group.abort()`` did not return on an H100 while a captured NCCL kernel waited
    for a peer that never came, and a rank that skips it hangs in
    ``destroy_process_group``.  Free the captured loops (``solvers.cg_sharded.
    clear_caches``) before the group goes: both ranks did, and exited."""
    if group in _NCCL:
        _NCCL.remove(group)
    threading.Thread(target=group.abort, name="nccl abort", daemon=True).start()


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
    a numpy array (f32 for a bf16 field, widened exactly); ``rows`` > 0 keeps the first
    ``rows`` rows (drops a padded tail).

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
    out = host_numpy(out)
    return out[:rows] if rows else out


def block_of(rank_: int, mesh_shape, grid_size: int) -> tuple:
    """((row_lo, row_hi), (col_lo, col_hi)): the grid block of rank ``rank_`` on an R×C
    mesh, row-major (rank k = i·C + j holds block (i, j)), as the JAX package's
    ``P("x", "y")`` sharding placed it.  The grid must divide by R and C."""
    nr, nc = (int(v) for v in mesh_shape)
    g = int(grid_size)
    if g % nr or g % nc:
        raise ValueError(f"grid {g} must divide the mesh extents ({nr}, {nc})")
    if not 0 <= rank_ < nr * nc:
        raise ValueError(f"rank {rank_} is not on a {nr}x{nc} mesh")
    i, j = divmod(rank_, nc)
    h, w = g // nr, g // nc
    return (i * h, (i + 1) * h), (j * w, (j + 1) * w)


def gather_blocks_to_host(x, mesh_shape):
    """Every rank's blocks of a 2-D decomposed field, put in place on rank 0's host as the
    whole (R·h, C·w) numpy field; the other ranks get None, as ``gather_to_host``.  ``x``:
    the rank's one block (a group of R·C ranks), or its blocks of a mesh across the ranks
    (a sequence: shards [r·L, (r+1)·L) of ``make_rank_mesh((R, C))``).  Collective: every
    rank calls it, and the W ranks' blocks must number R·C.  The blocks go to their host,
    then by gloo to rank 0."""
    nr, nc = (int(v) for v in mesh_shape)
    blocks = [x] if torch.is_tensor(x) else list(x)
    n, per = world_size(), len(blocks)
    if nr * nc != n * per:
        raise ValueError(f"a {nr}x{nc} mesh needs {nr * nc} blocks, the group's {n} ranks "
                         f"hold {per} each")
    local = torch.stack([b.detach().to("cpu") for b in blocks])
    if n == 1:
        parts = list(local)
    else:
        whole = local.new_empty((n,) + tuple(local.shape)) if rank() == 0 else None
        tdist.gather(local, list(whole) if whole is not None else None, dst=0)
        if whole is None:
            return None
        parts = list(whole.reshape((n * per,) + tuple(local.shape[1:])))
    return host_numpy(torch.cat([torch.cat(parts[i * nc:(i + 1) * nc], dim=1)
                                 for i in range(nr)], dim=0))


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
