"""Conditional nodes of a CUDA graph: the device-resident CG loop's condition on the card.

Ports no TPU kernel: the counterpart of the condition of the JAX package's
``lax.while_loop`` (``tpusparse/solvers/cg.py:360-379``), ``k < max_iters and rr > tol2``.
``solvers/cg.DeviceLoop`` captures its iterations into the body of a WHILE node and
guards each further iteration of the body with an IF node; ``cond_kernel``
(``csrc/graph.cu``, one thread) reads k, rr and tol2 from device memory and sets the
node's condition.  The host never reads them while the loop runs.

  ``conditional(kind, ...)``  while capturing on the current stream: a node of ``kind``
                              (``IF`` or ``WHILE``) whose condition the kernel sets just
                              before it; the body is captured inside the ``with`` block on
                              a stream of its own, made the current one
  ``set_cond(handle, ...)``   the kernel again, at the end of a WHILE body
  ``cond_plain(...)``         the kernel's plain twin: the condition read on the host

PyTorch 2.11 has no conditional nodes of its own (``CUDAGraph.begin_capture_to_if_node``
came later), so the nodes are added by the port's C code to the graph that
``torch.cuda.graph`` captures.  PyTorch's allocator does not see a body's capture: a body
allocates nothing (``_launch.Workspace`` holds its buffers, ``DeviceLoop`` checks).

``LAUNCHES["cg_cond"]`` counts the kernel's launches into a capture (each replay runs
them again; ``DeviceLoop`` counts those).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from .. import _build
from ._launch import counter, stream

LAUNCHES = counter(("cg_cond",))
IF, WHILE = 0, 1
# the dots' dtype -> the suffix of the C entry points
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    LAUNCHES["cg_cond"] = 0


def cond_plain(k, max_iters, rr, tol2) -> bool:
    """Plain twin of the kernel: k < max_iters and rr > tol2, read on the host (strict:
    rr = 0 = tol2 runs no step; a NaN stops the loop)."""
    return int(k) < max_iters and bool(rr > tol2)


def preload(device) -> None:
    """Before a capture on ``device``: load the kernel's module (lazy loading would load it
    at its first launch, inside the capture) and make the body streams."""
    _build.check(_build.lib().tps_graph_preload(), "graph preload")
    for kind in (IF, WHILE):
        body_stream(device, kind)


def _check(k, rr, tol2):
    if not (k.is_cuda and k.dtype == torch.int64 and k.numel() == 1):
        raise ValueError("k must be a one-element int64 CUDA tensor")
    if rr.dtype not in _SUFFIX or tol2.dtype != rr.dtype or rr.numel() != 1 \
            or tol2.numel() != 1:
        raise ValueError("rr and tol2 must be one-element f32 or f64 tensors of one dtype")
    if rr.device != k.device or tol2.device != k.device:
        raise ValueError("k, rr and tol2 must share a device")


def set_cond(handle, k, max_iters, rr, tol2) -> None:
    """Launch the kernel on the current stream (which must be capturing): the node of
    ``handle`` runs (again) iff k < max_iters and rr > tol2."""
    _check(k, rr, tol2)
    fn = getattr(_build.lib(), f"tps_graph_cond_set_{_SUFFIX[rr.dtype]}")
    _build.check(fn(handle, k.data_ptr(), max_iters, rr.data_ptr(), tol2.data_ptr(),
                    stream(k)), "graph cond")
    LAUNCHES["cg_cond"] += 1


_BODY_STREAMS = {}


def body_stream(device, kind):
    """The stream that the bodies of ``kind``'s nodes are captured on, on ``device``: one
    of the port's own, made at first use (``preload``, before a capture) and kept.
    PyTorch's pool hands out its streams in turn, so one of them may be the stream that
    ``torch.cuda.graph`` captures on.  A capture only records on it; replays run on the
    caller's stream.  Another ``kind`` (any other key) names another stream of the
    port's own: the per-card loop's capture and replay streams."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = (device, kind)
    if key not in _BODY_STREAMS:
        raw = ctypes.c_void_p()
        with torch.cuda.device(key[0]):
            _build.check(_build.lib().tps_graph_stream_create(ctypes.byref(raw)),
                         "graph body stream")
        _BODY_STREAMS[key] = torch.cuda.ExternalStream(raw.value, device=key[0])
    return _BODY_STREAMS[key]


@contextlib.contextmanager
def conditional(kind, k, max_iters, rr, tol2):
    """While the current stream captures: launch the kernel, add a conditional node of
    ``kind`` behind it, and capture the ``with`` block into the node's body on
    ``body_stream(k.device, kind)`` (made the current stream).  Yields the node's handle
    (``set_cond`` sets a WHILE node's condition at the end of its body).  Nodes of one
    kind nest in nodes of the other only (a kind's bodies share its stream)."""
    _check(k, rr, tol2)
    body = body_stream(k.device, kind)
    fn = getattr(_build.lib(), f"tps_graph_cond_begin_{_SUFFIX[rr.dtype]}")
    handle = ctypes.c_ulonglong()
    _build.check(fn(kind, k.data_ptr(), max_iters, rr.data_ptr(), tol2.data_ptr(), stream(k),
                    body.cuda_stream, ctypes.byref(handle)), "graph conditional node")
    LAUNCHES["cg_cond"] += 1
    try:
        with torch.cuda.stream(body):
            yield handle.value
    finally:
        _build.check(_build.lib().tps_graph_cond_end(body.cuda_stream), "graph node body")
