"""Launch plumbing the kernel wrappers share: argument checks, scalars, pointers, streams.

The wrappers call these only on their kernel path, after a CPU tensor has gone to the
plain twin: what reaches them must be a CUDA tensor the kernels can take, or they raise.

The state dtypes are f32, f64 and bf16 (``SUFFIX``).  A bf16 state follows one rounding
contract, the JAX package's, in every kernel and in its plain twin:

1. Fields are stored in bf16.  Every elementwise operation a JAX kernel writes is computed
   in f32 from bf16 operands with the ``_rn`` intrinsics (no contraction, no ``__hfma2``)
   and rounded to bf16 (``__float2bfloat16_rn``) after each operation, in the JAX
   kernel's order: K4 ``x + (α·p)`` and ``r − (α·Ap)``; K5 ``r + (β·p)``; K7
   ``(α·x) + (β·y)``; K8 ``C·x + W·xw + E·xe + N·xn + S·xs`` left to right; K3
   ``diag·x + offdiag·(((N + S) + W) + E)`` with diag and offdiag rounded to bf16; K11
   ``acc + data[d]·x`` per diagonal from 0.  The ELL kernel follows its JAX kernel's own
   f32 accumulator: the products (exact in f32) summed in f32 in slot order, y rounded to
   bf16 once; its body rounds each product to bf16 first, but XLA folds that round trip
   away, and the JAX kernel's y is the exact products' sum (``csrc/ell.cu``).  This is
   what eager PyTorch bf16 ops and XLA's CPU compute, so the plain twins are plain bf16
   torch expressions in that order, and kernel, twin and JAX agree bit for bit on
   fields.
2. α and β are bf16 0-d tensors on the device, as in JAX: ``scalar`` casts them to the
   state's dtype.
3. Dots accumulate in f32 (``_device.acc_dtype``, the counterpart of the JAX package's
   ``blas1._acc_dtype``): each product of two stored bf16 values is exact in f32, and the
   partials and the final sum are f32, in the fixed order of ``csrc/reduce.cuh``
   (``dot_buffers``).  JAX instead rounds each grid block's partial to bf16, a block
   partition of the TPU's VMEM; the port does not copy that, so its dots differ from
   JAX's by a bounded amount (relative 1e-2 covers it).
4. Host checksums (Sum, Norm2) are computed in f64 from the bf16 values
   (``_device.host_numpy`` widens them exactly), never summed in bf16.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .. import _build
from .._device import acc_dtype

# state dtypes the kernels take -> the suffix of their C entry points
SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}


def check_field(t, like):
    """A contiguous, non-empty CUDA tensor of f32/f64/bf16 with ``like``'s device, dtype
    and shape."""
    if not t.is_cuda:
        raise ValueError(f"expected a CUDA tensor (or CPU for the plain twin), got "
                         f"device {t.device}")
    if t.dtype not in SUFFIX:
        raise ValueError(f"unsupported dtype {t.dtype}: the kernels take float32, float64 "
                         "and bfloat16")
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"tensors disagree: {t.device}/{t.dtype} vs "
                         f"{like.device}/{like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"expected a field of shape {tuple(like.shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError("fields must be contiguous")
    if t.numel() < 1:
        raise ValueError(f"empty field {tuple(t.shape)}")
    return t.numel()


def overlaps(a, b) -> bool:
    """Whether the storage of two contiguous tensors shares any byte."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def check_apart(written, read):
    """Raise unless no tensor of ``written`` (name -> tensor) overlaps another of them or
    one of ``read``: an in-place kernel reads each element it writes in one thread only,
    and neighbouring threads must never see a half-updated field."""
    names = list(written)
    for i, w in enumerate(names):
        for other, t in [*((n, written[n]) for n in names[i + 1:]), *read.items()]:
            if overlaps(written[w], t):
                raise ValueError(f"{w} must not overlap {other}")


def scalar(v, like):
    """α/β as a 0-d tensor on ``like``'s device and dtype (a no-op when it already is); a
    cast goes into a workspace buffer while one is in use."""
    ws = _WORKSPACE
    if ws is not None and not (torch.is_tensor(v) and v.dtype == like.dtype
                               and v.device == like.device):
        t = ws.take((), like.dtype, like.device)
        return t.copy_(v.reshape(())) if torch.is_tensor(v) else t.fill_(v)
    t = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t.reshape(())


def check_state(t, what):
    """Raise for a bf16 state where a kernel has no bf16 instance (K1, K2, K9, K10: the
    JAX recompute and fused loops that they serve reject a bf16 state)."""
    if t.dtype == torch.bfloat16:
        raise ValueError(f"{what} has no bf16-state kernel: the JAX package's recompute "
                         "and fused CG loops reject a bf16 state; use the classic loop")


def buffer(shape, dtype, device):
    """A buffer for a result: the workspace's while one is in use, else a new one."""
    ws = _WORKSPACE
    if ws is not None:
        return ws.take(tuple(shape), dtype, device)
    return torch.empty(shape, dtype=dtype, device=device)


def dot_buffers(like, nparts):
    """The 0-d result and the ``nparts`` per-block partials of a kernel's dot, in the
    dtype its dot accumulates in (``acc_dtype``: f32 for a bf16 state); a workspace's
    buffers while one is in use."""
    acc = acc_dtype(like.dtype)
    return buffer((), acc, like.device), buffer((nparts,), acc, like.device)


_TICKETS = {}


def dot_tickets(like, cuda_stream):
    """The ticket counter of the one-launch dots (K6, the vector bodies of K3, K1 and K2)
    on ``like``'s device and the stream ``cuda_stream``: a zeroed int32 tensor, made at its first use and
    kept; the workspace's own while one is in use.  The kernel's last block resets it to
    0, so it needs no reset from the host between launches, nor in a CUDA graph; launches
    on other streams may run at the same time, so each stream has its own."""
    if _WORKSPACE is not None:
        return _WORKSPACE.tickets
    key = (like.device, cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=like.device)
    return t


class Workspace:
    """The buffers that the wrappers called by a captured loop write their dots, partials
    and cast scalars into, and the ticket counter of their one-launch dots.

    The body of a conditional node is captured on a stream that PyTorch's allocator knows
    nothing of (``kernels/graph.py``), so it may allocate nothing.  An eager pass of the
    same calls, in the same order, first records the buffers they ask for (``use(ws)``
    while ``ws.recording``); the capture then hands them out again in that order
    (``ws.rewind()`` before each pass of the calls), checking shape and dtype.  Captured
    iterations run one after another, so they may share the buffers.  The ticket counter
    is the graph's own, never a stream's: the body's stream is not the one a replay runs
    on."""

    def __init__(self, device):
        self.tickets = torch.zeros(1, dtype=torch.int32, device=device)
        self.buffers = []
        self.recording = True
        self._next = 0

    def take(self, shape, dtype, device):
        if self.recording:
            t = torch.empty(shape, dtype=dtype, device=device)
            self.buffers.append(t)
            return t
        if self._next >= len(self.buffers):
            raise RuntimeError("the captured calls asked for more buffers than the "
                               "recorded pass")
        t = self.buffers[self._next]
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
            raise RuntimeError(f"the captured calls asked for {tuple(shape)} {dtype} where "
                               f"the recorded pass had {tuple(t.shape)} {t.dtype}")
        self._next += 1
        return t

    def rewind(self):
        """Stop recording; the next ``take`` hands out the first buffer again."""
        self.recording = False
        self._next = 0


_WORKSPACE = None


@contextlib.contextmanager
def use(ws):
    """Route ``dot_buffers``, ``scalar``'s casts and ``dot_tickets`` to ``ws``."""
    global _WORKSPACE
    prev, _WORKSPACE = _WORKSPACE, ws
    try:
        yield ws
    finally:
        _WORKSPACE = prev


# every kernel module's launch counts ({wrapper: launches}), registered at its import
COUNTERS = []
# the launches that CUDA-graph replays made, by wrapper: a capture records launches and
# runs none, so it sets them apart (``set_apart``) and each replay adds them here
# (``count_replay``); a wrapper's own count holds its eager launches only
REPLAYED = {}


def counter(names):
    """A kernel module's launch counts, one per wrapper name, each 0, registered."""
    counts = dict.fromkeys(names, 0)
    COUNTERS.append(counts)
    return counts


@contextlib.contextmanager
def set_apart():
    """Yields a dict that holds, after the block, the launches the wrappers counted inside
    it ({wrapper: launches}), and puts every count back as it was before the block: a
    capture (whose replays ``count_replay`` counts) or a graph's warm-up (set-up)."""
    before = [dict(c) for c in COUNTERS]
    launches = {}
    try:
        yield launches
    finally:
        for i, c in enumerate(COUNTERS):  # a module imported in the block starts at 0
            b = before[i] if i < len(before) else dict.fromkeys(c, 0)
            launches.update({n: v - b[n] for n, v in c.items() if v != b[n]})
            c.update(b)


def count_replay(launches, times=1):
    """One replay's launches ({wrapper: launches}), ``times`` over, into ``REPLAYED``."""
    for name, n in launches.items():
        REPLAYED[name] = REPLAYED.get(name, 0) + n * times


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def row_out(out, x, shape):
    """The y of a row kernel (ELL, DIA): ``out`` once checked (a contiguous tensor of
    ``shape`` on x's device and dtype that does not overlap x), else a new one."""
    if out is None:
        return x.new_empty(shape)
    if out.device != x.device or out.dtype != x.dtype or tuple(out.shape) != tuple(shape) \
            or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {tuple(shape)} {x.dtype} tensor on "
                         f"{x.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    if overlaps(out, x):
        raise ValueError("out must not overlap x: the kernel reads x while y is written")
    return out


# the library's size query, asked once per size so that a launch makes one foreign call,
# the kernel's own
@functools.lru_cache(maxsize=64)
def row_partials(n):
    """The number of per-block partials a dot of the one-thread-per-row kernels
    (csrc/rows.cuh: spmv_ell, spmv_dia) over n rows needs."""
    return _build.lib().tps_row_partials(n)
