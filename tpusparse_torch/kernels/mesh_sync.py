"""Card-to-card synchronisation of the per-card sharded CG loop: CUDA kernels and their
plain PyTorch twins.

Ports no TPU kernel: the counterpart of ``jax.lax.ppermute`` and ``jax.lax.psum`` inside
the JAX package's sharded ``lax.while_loop`` (``tpusparse/solvers/cg_sharded.py:427-476``),
as ``kernels/graph.py`` is the counterpart of its condition.  ``solvers/cg_sharded.CardLoop``
replays one CUDA graph a shard on the shard's card; at each sync point of an iteration a
shard publishes, then waits (``csrc/mesh_sync.cu``):

  ``publish_rows(ctl, links)``           its boundary rows (on a 2-D mesh also its side
                                         columns) into its neighbours' halo buffers, then
                                         each neighbour's flag for the sync point
  ``publish_partial(ctl, part, links)``  its 0-d dot partial into its slot of every
                                         shard's slot array, then its flag there
  ``wait(ctl, flags, mask, code, bound_ns, slots, out)``
                                         until every flag of ``mask`` holds the epoch; with
                                         ``slots``, their sum in shard order into ``out``

A shard's ``ctl`` is two int64 on its device: the epoch, which every wait advances by one
(a publish sets its flags to the epoch + 1, the wait that follows waits for it), and the
error word, 0 until a wait passes ``bound_ns`` and writes its ``code`` there (a dot's wait
then writes NaN, which stops the loop).  ``links`` (``row_links``, ``partial_links``) name
the destinations and carry the table the kernel reads them from.  Dots are f32 or f64 (a
bf16 state's are f32); rows are moved as bits of the state's width.

Each has a ``*_plain`` twin of the same signature for CPU tensors (the tests' shards,
every shard of a mesh in one process).  The host cannot spin while the other shards run,
so a wait's twin looks once: it returns False and changes nothing when a flag has not
reached the epoch and ``bound_ns`` > 0 (the caller runs another shard and tries again);
``bound_ns`` = 0 is a wait whose bound has passed, the error path.  A kernel's wrapper
returns True: its wait is on the card.  The twin of a wait also raises when a flag is
beyond the epoch: a writer ran ahead of its reader, which the loop's order forbids
(``check_epochs`` asks the same of the halo rows a kernel is about to read).

``LAUNCHES[name]`` counts each wrapper's kernel launches (twins do not count).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import _build
from ._launch import counter, stream

LAUNCHES = counter(("mesh_publish_rows", "mesh_publish_partial", "mesh_wait"))
# the dots' dtype -> the suffix of the C entry points
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_WIDTHS = (2, 4, 8)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclasses.dataclass(eq=False)
class Links:
    """What one shard publishes at one sync point: ``items``, (source, destination, flag)
    a neighbour for rows, (slot, flag) a shard for a partial; ``table``, the int64 table
    the kernel reads them from, on the publisher's card (None on the CPU)."""

    items: tuple
    table: Optional[torch.Tensor]


def row_links(items, device) -> Links:
    """The links of a shard's rows: ``items`` (source, destination, flag), a source a 1-D
    view of the shard's field (a row, or a strided column), its destination a contiguous
    1-D halo buffer of the same length and dtype on the neighbour's device, the flag a
    one-element int64 view of the neighbour's flags."""
    items = tuple(items)
    for src, dst, flag in items:
        if src.dim() != 1 or dst.dim() != 1 or not dst.is_contiguous() \
                or src.numel() != dst.numel() or src.dtype != dst.dtype:
            raise ValueError(f"a row link joins a 1-D view to a contiguous 1-D buffer of its "
                             f"length and dtype, got {tuple(src.shape)} {src.dtype} -> "
                             f"{tuple(dst.shape)} {dst.dtype}")
        if src.element_size() not in _WIDTHS:
            raise ValueError(f"rows of {src.dtype} cannot be published")
        _check_flag(flag)
    table = None
    if torch.device(device).type == "cuda":
        table = torch.tensor([[s.data_ptr(), s.stride(0), s.numel(), d.data_ptr(),
                               f.data_ptr()] for s, d, f in items], dtype=torch.int64,
                             device=device)
    return Links(items, table)


def partial_links(items, device) -> Links:
    """The links of a shard's partial: ``items`` (slot, flag), a 0-d view of each shard's
    slot array (f32 or f64) and of its flags, on that shard's device."""
    items = tuple(items)
    for slot, flag in items:
        if slot.numel() != 1 or slot.dtype not in _SUFFIX:
            raise ValueError(f"a slot is one f32 or f64 element, got {tuple(slot.shape)} "
                             f"{slot.dtype}")
        _check_flag(flag)
    table = None
    if torch.device(device).type == "cuda":
        table = torch.tensor([s.data_ptr() for s, _ in items] + [f.data_ptr() for _, f in items],
                             dtype=torch.int64, device=device)
    return Links(items, table)


def _check_flag(flag):
    if flag.numel() != 1 or flag.dtype != torch.int64:
        raise ValueError(f"a flag is one int64 element, got {tuple(flag.shape)} {flag.dtype}")


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def publish_rows_plain(ctl, links) -> bool:
    """Plain twin of ``publish_rows``."""
    epoch = int(ctl[0]) + 1
    for src, dst, flag in links.items:
        dst.copy_(src)
        flag.fill_(epoch)
    return True


def publish_partial_plain(ctl, part, links) -> bool:
    """Plain twin of ``publish_partial``."""
    epoch = int(ctl[0]) + 1
    for slot, flag in links.items:
        slot.copy_(part.reshape(slot.shape))
        flag.fill_(epoch)
    return True


def wait_plain(ctl, flags, mask, code, bound_ns, slots=None, out=None) -> bool:
    """Plain twin of ``wait``: False, nothing changed, if a flag of ``mask`` is below the
    epoch and ``bound_ns`` > 0; else the wait done (the error path if a flag is below it),
    True.  RuntimeError if a flag is beyond it."""
    epoch, error = ctl.tolist()
    epoch += 1
    if error == 0:
        seen = {j: v for j, v in enumerate(flags.tolist()) if (mask >> j) & 1}
        ahead = {j: v for j, v in seen.items() if v > epoch}
        if ahead:
            raise RuntimeError(f"flags {ahead} are beyond epoch {epoch}: a writer ran ahead "
                               "of its reader")
        if any(v < epoch for v in seen.values()):
            if bound_ns > 0:
                return False
            ctl[1] = code
    if slots is not None:
        if int(ctl[1]):
            out.fill_(float("nan"))
        else:
            out.copy_(slots[0])
            for t in slots[1:]:
                out.add_(t)
    ctl[0] = epoch
    return True


def check_epochs(flags, mask, epoch) -> None:
    """On the CPU: raise unless every flag of ``mask`` holds ``epoch``, the epoch of the
    sync point whose data is about to be read (a writer that ran ahead would have raised
    it)."""
    bad = {j: v for j, v in enumerate(flags.tolist()) if (mask >> j) & 1 and v != epoch}
    if bad:
        raise RuntimeError(f"flags {bad} do not hold epoch {epoch} where their data is read")


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_ctl(ctl):
    if not (ctl.is_cuda and ctl.dtype == torch.int64 and ctl.numel() == 2
            and ctl.is_contiguous()):
        raise ValueError("ctl must be two contiguous int64 elements on a card")


def _check_table(links, ctl):
    if links.table is None or links.table.device != ctl.device:
        raise ValueError(f"the links' table must lie on {ctl.device}, the publisher's card")


def publish_rows(ctl, links) -> bool:
    """Store each link's source into its destination on the neighbour's card, then set the
    neighbour's flag to the epoch + 1 (system-scope release, after the data)."""
    if ctl.device.type == "cpu":
        return publish_rows_plain(ctl, links)
    _check_ctl(ctl)
    _check_table(links, ctl)
    width = links.items[0][0].element_size()
    _build.check(_build.lib().tps_mesh_publish_rows(
        links.table.data_ptr(), len(links.items), width, ctl.data_ptr(), stream(ctl)),
        "mesh publish_rows")
    LAUNCHES["mesh_publish_rows"] += 1
    return True


def publish_partial(ctl, part, links) -> bool:
    """Store the 0-d ``part`` into every link's slot, then set its flag to the epoch + 1
    (system-scope release, after the data)."""
    if ctl.device.type == "cpu":
        return publish_partial_plain(ctl, part, links)
    _check_ctl(ctl)
    _check_table(links, ctl)
    if part.device != ctl.device or part.numel() != 1 or part.dtype not in _SUFFIX \
            or part.dtype != links.items[0][0].dtype:
        raise ValueError(f"part must be one element of the slots' dtype on {ctl.device}")
    fn = getattr(_build.lib(), f"tps_mesh_publish_partial_{_SUFFIX[part.dtype]}")
    _build.check(fn(part.data_ptr(), links.table.data_ptr(), len(links.items), ctl.data_ptr(),
                    stream(ctl)), "mesh publish_partial")
    LAUNCHES["mesh_publish_partial"] += 1
    return True


def wait(ctl, flags, mask, code, bound_ns, slots=None, out=None) -> bool:
    """Wait on the card until every flag of ``mask`` (bit j: ``flags[j]``) holds the epoch
    + 1, at most ``bound_ns`` (else ``code`` goes into the error word); with ``slots``,
    then their sum in index order, left to right, in their dtype into the 0-d ``out`` (NaN
    on the error path).  Advances the epoch.  Returns True: the wait is a launch."""
    if ctl.device.type == "cpu":
        return wait_plain(ctl, flags, mask, code, bound_ns, slots, out)
    _check_ctl(ctl)
    n = flags.numel()
    if flags.device != ctl.device or flags.dtype != torch.int64 or not flags.is_contiguous() \
            or not 0 < n <= 64 or not 0 <= mask < 1 << n:
        raise ValueError(f"flags must be 1 to 64 contiguous int64 on {ctl.device}, the mask "
                         "within them")
    acc = torch.float64 if slots is None else slots.dtype
    if slots is not None and (slots.device != ctl.device or acc not in _SUFFIX
                              or slots.numel() != n or not slots.is_contiguous()
                              or out is None or out.numel() != 1 or out.dtype != acc
                              or out.device != ctl.device):
        raise ValueError("slots must be one f32 or f64 element a flag, out one of their "
                         f"dtype, on {ctl.device}")
    fn = getattr(_build.lib(), f"tps_mesh_wait_{_SUFFIX[acc]}")
    _build.check(fn(ctl.data_ptr(), flags.data_ptr(), n, mask,
                    None if slots is None else slots.data_ptr(),
                    None if out is None else out.data_ptr(), code, bound_ns, stream(ctl)),
                 "mesh wait")
    LAUNCHES["mesh_wait"] += 1
    return True


# ---------------------------------------------------------------------------
# Set-up on the cards
# ---------------------------------------------------------------------------


def preload(device) -> None:
    """Before a capture on ``device``: load the kernels' module there (lazy loading would
    load it at the first launch, inside the capture)."""
    with torch.cuda.device(device):
        _build.check(_build.lib().tps_mesh_preload(), "mesh preload")


def enable_peer(device, peer) -> None:
    """Let kernels on card ``device`` load and store card ``peer``'s memory."""
    _build.check(_build.lib().tps_mesh_enable_peer(int(device), int(peer)),
                 f"peer access from cuda:{device} to cuda:{peer}")

