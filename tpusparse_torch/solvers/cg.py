"""Single-device Conjugate Gradient solver of the port.

Counterpart of ``tpusparse/solvers/cg.py``, same algorithm and iteration-count semantics
(reference cg_solver.cu:538-650; ``iterations`` counts the converging iteration):

    r0 = b - A·x0 ; p0 = r0 ; rr0 = <r0, r0> ; converged <=> rr < tol²·<b, b>
    loop:  Ap = A·p ; α = rr / <p, Ap> ; x += α·p ; r -= α·Ap ; rr' = <r, r>
           β = rr' / rr ; p = r + β·p

Three loops, as in the JAX package:

  - recompute-Ap (default when the operator has both passes): pass A forms p' = r + β·p
    and <p', A·p'> (kernel K1), pass B forms x', r' and <r', r'> recomputing A·p' from p'
    (kernel K2).  Ap never reaches device memory: 8 words per point per iteration.  Pass A
    writes p' into a second buffer, and the two p buffers swap every iteration.
  - fused p-update (``fused_pupdate=True``, opt-in): the operator's fused pass forms
    p' = r + β·p, A·p' and <p', A·p'> in one pass (K9 with planes, K10 for the constant
    stencil), then K4 forms x', r' and <r', r'>; β = 0 with p = 0 on the first iteration.
    9 + 6 = 15 words per point with K9, 4 + 6 = 10 with K10.  p' goes to a second buffer
    and the two swap, as in the recompute loop.
  - classic: ``run_device_dot`` (the operator's SpMV with its fused dot: K3, or K8 with
    planes), then the BLAS1 kernels: K4 (x, r and <r, r> in one pass) and K5 (p).  With
    K3 that is 2 + 6 + 3 = 11 words per point per iteration, with K8 7 + 6 + 3 = 16.
    ``use_pallas_blas1=False`` runs those updates as plain PyTorch ops instead, the
    counterpart of the JAX package's XLA path; eager PyTorch runs each op as its own pass
    (~18 words per point with K3).

The BLAS1 kernels also form the start: K6 gives <r0, r0> (and <b, b>), and for a nonzero
x0, K7 gives r0 = b - A·x0 with <r0, r0> in one pass.

A bf16 state (``--dtype=bf16``) runs the classic and the stepped loops, as in the JAX
package, whose recompute and fused loops reject one (``check_loop``): fields in bf16,
dots, rr and the convergence test in f32, α and β rounded to bf16 (``_launch``'s
contract).

α, β, rr and <p, Ap> stay on the device as 0-d tensors, and the kernels read α and β
through a device pointer.  On a card, ``cg_solve`` runs its loop from a captured CUDA graph
(``DeviceLoop``), the counterpart of the JAX package's ``lax.while_loop``: the iterations
sit in the body of a WHILE node whose condition, k < max_iters and rr > tol², a kernel sets
on the card (``kernels/graph.py``), so the host reads the device once a solve, for
(rr, <b, b>, k) at its end.  ``graph=False`` runs the eager loop instead, which reads the
flag rr > tol² to the host every iteration, the reference's own poll
(cg_solver.cu:598-599); the two run the same kernels in the same order, so they give the
same iterations and the same x bit for bit.  The eager loop also runs on the CPU, for the
plain twins' operators (``*-xla``, ``ell``), ``bcoo`` (cuSPARSE) and
``use_pallas_blas1=False``, whose calls allocate their results and so cannot be captured
(``DeviceOperator.captures``).

``cg_solve_stepped`` is the host-stepped classic loop of the CLI's ``--timers`` and
``--host``: every phase ends in a sync, and its wall time goes to the ``spmv``, ``blas1``
or ``reduction`` bucket of ``CGStats``.  Every loop marks its phases with
``bench.profiling.scope`` (``SpMV``, ``BLAS_AXPY``, ``BLAS_Update_P``), which a trace shows
as ranges; the stepped loop also marks its reads of the dots to the host
(``bench.profiling.annotate``, ``Dot_Product``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from .._device import acc_dtype
from ..bench import profiling
from ..kernels import _launch, blas1
from ..kernels import graph as graph_kernels


@dataclasses.dataclass
class CGConfig:
    """Parity with reference CGConfig (include/solvers/cg_solver.h:21-26).  No solver
    reads ``enable_detailed_timers``: the phase timers are ``cg_solve_stepped``'s, which
    times every run (the CLI's ``--timers`` runs it)."""

    max_iters: int = 1000
    tolerance: float = 1e-6
    verbose: int = 0
    enable_detailed_timers: bool = False


@dataclasses.dataclass
class CGStats:
    """Parity with reference CGStats (include/solvers/cg_solver.h:28-43); the same fields
    as ``tpusparse.solvers.cg.CGStats``.  ``cg_solve_stepped`` fills the phase buckets
    (``spmv``, ``blas1``, ``reduction``) and ``total_time_ms`` with the loop's wall time;
    ``cg_solve`` leaves the buckets at zero.  The collective buckets (``halo``,
    ``allreduce``) are the sharded stepped loop's (``cg_sharded.cg_solve_sharded_stepped``),
    zero here.  The dispatch ones stay zero everywhere: the JAX package's dispatch
    correction is a relay correction with no counterpart here."""

    iterations: int = 0
    converged: bool = False
    residual_norm: float = 0.0
    relative_residual: float = 0.0
    total_time_ms: float = 0.0
    spmv_time_ms: float = 0.0
    blas1_time_ms: float = 0.0
    reduction_time_ms: float = 0.0
    halo_time_ms: float = 0.0
    allreduce_time_ms: float = 0.0
    dispatch_block_ms: float = 0.0
    dispatch_readback_ms: float = 0.0
    dispatch_clipped: tuple = ()


def converged(res: float, b_norm: float, tolerance: float, iterations: int,
              max_iters: int) -> bool:
    """Whether a solve that ended at residual norm ``res`` after ``iterations`` met its
    stopping rule: ‖r‖ < tol·‖b‖ (a zero b at once).  Tolerance 0 asks for no residual but
    a fixed count, HPCG's timed CG sets (``src/main.cpp``: 50 iterations at tolerance 0):
    such a solve converged once it has run all ``max_iters`` iterations with a finite
    residual (a NaN ends the loop early), or earlier on an exactly zero residual, where
    every loop stops."""
    if b_norm <= 0:
        return True
    if tolerance == 0:
        return (iterations == max_iters and math.isfinite(res)) or res == 0
    return res < tolerance * b_norm


def uses_recompute(op, recompute_ap: Optional[bool] = None) -> bool:
    """Whether ``cg_solve(op, recompute_ap=...)`` runs the recompute-Ap loop: None picks it
    when the operator provides both passes, False never, True always (ValueError if the
    operator lacks them)."""
    avail = op.run_pupdate_dot_op is not None and op.run_update_recompute_op is not None
    if recompute_ap is True and not avail:
        raise ValueError(f"recompute_ap requested but operator '{op.name}' lacks "
                         "run_pupdate_dot_op/run_update_recompute_op")
    return avail and recompute_ap is not False


def check_loop(dtype, loop: str) -> None:
    """Raise ValueError when ``loop`` (``"recompute"`` or ``"fused"``) is asked of a bf16
    state: the JAX package's recompute and fused loops reject one (``lax.while_loop``'s
    carry changes type, ``tpusparse/solvers/cg.py:368``), so K1, K2, K9 and K10 have no
    bf16 instance.  The classic loop runs it."""
    if dtype == torch.bfloat16 and loop in ("recompute", "fused"):
        raise ValueError(f"the {loop} CG loop does not take a bf16 state (the JAX "
                         "package's rejects it too); use the classic loop: "
                         "recompute_ap=False, or --loop=classic")


def cg_solve(op, b=None, x0=None, *, config: Optional[CGConfig] = None,
             b_is_ones: bool = False, recompute_ap: Optional[bool] = None,
             use_pallas_blas1: Optional[bool] = None, fused_pupdate: Optional[bool] = None,
             graph: Optional[bool] = None):
    """Solve A·x = b on the operator's device.  Returns (x, CGStats).

    Args:
      op: an ``ops.DeviceOperator``.
      b: right-hand side field on ``op.device`` (ignored when ``b_is_ones``).
      x0: initial guess (default zeros); nonzero x0 computes r0 = b - A·x0 through
        ``op.run_device``.
      b_is_ones: b is the canonical all-ones right-hand side and x0 = 0; r0 = ones is made
        on the device and no separate b is kept.
      recompute_ap: None uses the recompute-Ap loop when the operator provides both passes;
        False forces the classic loop; True raises if the operator lacks the passes.
      use_pallas_blas1: True or None runs the BLAS1 kernels K4-K7 (the start's dots and
        r0, the classic and fused loops' updates); False runs those steps as plain PyTorch
        ops.
        None means True here, unlike the JAX package, whose accelerator default was XLA:
        XLA fused those updates into single passes, eager PyTorch does not.
      fused_pupdate: True runs the fused p-update loop through the operator's
        ``run_fused_pupdate_op`` (ValueError if it has none, or with ``recompute_ap=True``);
        None and False leave it off, as the JAX package's default.
      graph: None runs the loop from a captured CUDA graph (``DeviceLoop``) when the
        operator is on a card and ``captures`` and the BLAS1 kernels run, else the eager
        loop; True insists on the graph (ValueError where it cannot run); False runs the
        eager loop.  A capture or replay that fails raises: nothing falls back.

    A bf16 state (``op.dtype``) runs the classic loop only: the recompute loop, also when
    None picks it, and the fused loop raise ValueError (``check_loop``).  Its dots, rr and
    <b, b> are f32; α and β are rounded to bf16 where the kernels take them.

    The x returned is the caller's: a later solve never writes into it.
    """
    config = config or CGConfig()
    fused = bool(fused_pupdate)
    if fused and op.run_fused_pupdate_op is None:
        raise ValueError(f"fused_pupdate requested but operator '{op.name}' has no "
                         "run_fused_pupdate_op")
    if fused and recompute_ap is True:
        raise ValueError("recompute_ap and fused_pupdate exclude each other")
    kernels = use_pallas_blas1 is not False
    if b_is_ones and x0 is not None:
        raise ValueError("b_is_ones implies x0 = 0")
    recompute = not fused and uses_recompute(op, recompute_ap)
    loop = "fused" if fused else "recompute" if recompute else "classic"
    check_loop(op.dtype, loop)
    on_card = op.device.type == "cuda"
    if graph is None:
        graph = on_card and op.captures and kernels
    elif graph and not (on_card and op.captures and kernels):
        raise ValueError(f"graph=True needs an operator on a card whose calls can be "
                         f"captured and the BLAS1 kernels; operator '{op.name}' on "
                         f"{op.device} (captures={op.captures}), use_pallas_blas1="
                         f"{use_pallas_blas1}")

    t0 = time.perf_counter()
    if not b_is_ones:
        if b is None or tuple(b.shape) != tuple(op.field_shape):
            raise ValueError(f"b must be a field of shape {op.field_shape}")
        b = b.to(device=op.device, dtype=op.dtype)
    with solve_scope():
        if graph:
            x, k, rr_f, bb_f = DeviceLoop.of(op, loop, config).solve(b, x0, b_is_ones)
        else:
            x, k, rr_f, bb_f = _eager_loop(op, b, x0, b_is_ones, config, loop, kernels)
    total_ms = (time.perf_counter() - t0) * 1e3
    res = rr_f ** 0.5
    b_norm = bb_f ** 0.5
    stats = CGStats(
        iterations=k,
        converged=converged(res, b_norm, config.tolerance, k, config.max_iters),
        residual_norm=res,
        relative_residual=res / b_norm if b_norm > 0 else 0.0,
        total_time_ms=total_ms,
    )
    return x, stats


def _eager_loop(op, b, x0, b_is_ones, config, loop, kernels):
    """The loop run op by op from the host, which reads rr > tol² every iteration.
    Returns (x, iterations, rr, <b, b>), the last two as Python floats."""
    cg_update = blas1.cg_update if kernels else blas1.cg_update_plain
    with profiling.scope(profiling.PHASE_START):
        if x0 is None:
            r = op.ones_b() if b_is_ones else b.clone()  # the loops update r in place
            x = torch.zeros_like(r)
            rr = bb = _dot(kernels)(r, r)
        else:
            x, r, rr, bb = _start_from(x0, b, op.run_device, kernels)
        tol2 = (config.tolerance * config.tolerance) * bb

    k = 0
    if loop != "classic":
        fused = loop == "fused"
        p_prev = torch.zeros_like(r)
        p_buf = torch.empty_like(r)
        rr_prev = torch.ones_like(rr)
        zero = torch.zeros_like(rr)
        # strict >: a zero right-hand side (rr0 = 0 = tol2) runs no 0/0 step
        while k < config.max_iters and _read(rr > tol2):
            beta = zero if k == 0 else rr / rr_prev
            if fused:
                with profiling.scope(profiling.PHASE_SPMV):
                    p, ap, pap = op.run_fused_pupdate_op(beta, r, p_prev, out=p_buf)
                with profiling.scope(profiling.PHASE_AXPY):
                    x, r, rr_new = cg_update(rr / pap, x, r, p, ap)
                del ap
            else:
                with profiling.scope(profiling.PHASE_SPMV):
                    p, pap = op.run_pupdate_dot_op(beta, r, p_prev, out=p_buf)
                with profiling.scope(profiling.PHASE_AXPY):
                    x, r, rr_new = op.run_update_recompute_op(rr / pap, x, r, p)
            p_buf, p_prev = p_prev, p
            rr_prev, rr = rr, rr_new
            k += 1
    else:
        p_update = blas1.p_update if kernels else blas1.p_update_plain
        # its own buffer: K4 updates r in place while it reads p (in the JAX loop p *is*
        # r on the first iteration)
        p = r.clone()
        while k < config.max_iters and _read(rr > tol2):
            with profiling.scope(profiling.PHASE_SPMV):
                ap, pap = op.run_device_dot(p)
            with profiling.scope(profiling.PHASE_AXPY):
                x, r, rr_new = cg_update(rr / pap, x, r, p, ap)
            del ap
            with profiling.scope(profiling.PHASE_UPDATE_P):
                p_update(rr_new / rr, r, p)  # p = r + β·p
            rr = rr_new
            k += 1

    rr_f, bb_f = _read(torch.stack([rr, bb])).tolist()  # one read; also the sync
    return x, k, rr_f, bb_f


# cg_solve's device-to-host reads (the eager loop's flag each iteration and its closing
# read; the graph loop's one read a solve), graph replays, solves (every solver's root
# span, ``solve_scope``: the last solve's id) and graph captures, summed over its calls
COUNTS = {"host_reads": 0, "replays": 0, "solves": 0, "captures": 0}
# the kernel launches that graph replays made, by wrapper name (``_launch.REPLAYED``): the
# iterations a replay ran (k, read from the card) times the launches of one captured
# iteration, and the condition kernel's; a wrapper's own count (``LAUNCHES`` of its module)
# holds the eager launches only (the start's), since a capture sets its launches apart
LAUNCHES = _launch.REPLAYED


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def reset_launches() -> None:
    LAUNCHES.clear()


def solve_scope():
    """A solve's root span (``CG_Solver``), under the next solve id: every solver opens
    one around a solve, so the solves of ranks that run in lockstep share their ids."""
    COUNTS["solves"] += 1
    return profiling.scope(profiling.PHASE_SOLVER, solve=COUNTS["solves"])


def _read(t):
    """t read to the host (the caller calls ``bool`` or ``tolist``), counted."""
    COUNTS["host_reads"] += 1
    return t if t.device.type == "cpu" else t.cpu()


# the iterations one body of the graph loop's WHILE node runs: the first unguarded (the
# node's condition held), each further one under an IF node.  Even, so that the recompute
# and fused loops' two p buffers alternate in step with the iterations.
UNROLL = 2


@dataclasses.dataclass
class _Slot:
    """A solution (a field, or a mesh's tuple of shard fields) and the graph captured on
    it: free again once no tensor but the slot's uses their storage (the x a solve
    returned was dropped)."""

    x: object
    graph: object
    refs: list  # (StorageWeakRef, its use count while only the slot holds it) a field

    @classmethod
    def of(cls, x):
        """x's slot, no graph captured yet."""
        fields = x if isinstance(x, tuple) else (x,)
        refs = [StorageWeakRef(t.untyped_storage()) for t in fields]
        return cls(x, None, [(ref, torch._C._storage_Use_Count(ref.cdata)) for ref in refs])

    def free(self) -> bool:
        return all(torch._C._storage_Use_Count(ref.cdata) <= uses for ref, uses in self.refs)


class DeviceLoop:
    """The CG loop run on the card from a captured CUDA graph: the counterpart of the JAX
    package's jit-compiled ``lax.while_loop`` solve.

    One per operator, loop (``"recompute"``, ``"fused"``, ``"classic"``), dtype, field
    shape, ``max_iters`` and ``tolerance``: ``key``, under which ``of`` caches it in
    ``op.graphs`` (as ``tpusparse.solvers.cg._SOLVER_CACHE``; ``op.free()`` drops it).
    The start is not part of the key: it runs eagerly into the loop's fields.

    It owns the loop's state (r, one or two p buffers, Ap, rr, the previous rr, <b, b>,
    tol², α, β and the iteration count k, all on the device) and its slots, each a
    solution field x with the graph captured on it.  ``solve`` takes a free slot (a new
    one, captured, if the x of every slot is still held by a caller), runs the start
    eagerly into the state (K6, or K7 and K6 for a seeded x0), replays the slot's graph
    once and reads (rr, <b, b>, k) to the host in one read.

    The graph: a kernel sets the WHILE node's condition, k < max_iters and rr > tol²;
    the node's body runs ``unroll`` iterations, the first at once (``guard_first``: under
    an IF node too), each further one under an IF node whose condition the kernel sets
    from the state the iteration before left;
    at the body's end the kernel sets the WHILE node's condition again
    (``kernels/graph.py``).  Once the condition is false it stays false (a skipped
    iteration changes nothing), so no iteration runs after the loop has stopped.  The
    recompute and fused loops write p' into the two p buffers in turn, by the iteration's
    parity, which ``unroll`` being even keeps in step with k; the classic loop updates p in
    place.

    Each iteration calls the same wrappers in the same order as the eager loop, with the
    same scalars, so the two give the same iterations and x bit for bit.  The body
    allocates nothing: its fields are the loop's own (``out=``, ``y_out=``), its scalars
    are formed with ``out=``, and the wrappers' dot buffers, bf16 casts and ticket
    counter come from a ``_launch.Workspace`` that one eager iteration records before the
    first capture; a capture that allocates raises.

    On the CPU (the tests) ``solve`` runs the same structure with each node's condition
    read on the host (``graph.cond_plain``): the loop's Python, run instead of captured.
    """

    def __init__(self, op, loop, max_iters, tolerance, unroll=UNROLL):
        self._init_loop(loop, op.dtype, op.device, max_iters, tolerance, unroll)
        self.graphed = self.device.type == "cuda"
        self.shape = tuple(op.field_shape)
        self._spmv, self._spmv_dot = op.run_device, op.run_device_dot
        self._pupdate_dot, self._update_recompute = (op.run_pupdate_dot_op,
                                                     op.run_update_recompute_op)
        self._fused = op.run_fused_pupdate_op
        self.r = self._new_x()
        self.p = (self._new_x(),) if loop == "classic" else (self._new_x(), self._new_x())
        self.ap = None if loop == "recompute" else self._new_x()

    def _init_loop(self, loop, dtype, device, max_iters, tolerance, unroll):
        """The loop's settings and its scalars on ``device``: rr, the previous rr, <b, b>,
        tol², α, β (in the dots' dtype), 0, the first-iteration flag and k."""
        if unroll < 2 or unroll % 2:
            raise ValueError(f"unroll must be even and at least 2, got {unroll}")
        if loop not in ("recompute", "fused", "classic"):
            raise ValueError(f"unknown loop {loop!r}")
        check_loop(dtype, loop)
        self.loop, self.max_iters, self.tolerance, self.unroll = loop, max_iters, tolerance, \
            unroll
        self.device, self.dtype = device, dtype
        acc = acc_dtype(dtype)

        def word(dtype=acc):
            return torch.empty((), dtype=dtype, device=device)

        self.rr, self.rr_prev, self.bb, self.tol2, self.alpha, self.beta = (
            word() for _ in range(6))
        self.zero = torch.zeros((), dtype=acc, device=device)
        self.first = word(torch.bool)
        self.k = torch.zeros((), dtype=torch.int64, device=device)
        self.slots = []
        self.workspace = None
        self.per_iteration = None  # wrapper -> launches of one captured iteration
        self.capture_stream = None  # the stream captures run on (None: torch.cuda.graph's)
        # torch.cuda.graph's capture_error_mode: "global" unless the body holds calls that
        # another thread of the process may meet mid-capture (a rank's NCCL calls)
        self.capture_mode = "global"
        # every iteration of the WHILE body under an IF node, the first too: where an
        # iteration holds NCCL's calls, whose stream, once joined to the WHILE body's
        # capture, stays in it until it ends, so that no IF body captured inside it may
        # take that stream again
        self.guard_first = False

    def _new_x(self):
        """A field of the loop's shape: a solution slot's, or a state field."""
        return torch.empty(self.shape, dtype=self.dtype, device=self.device)

    @staticmethod
    def key(op, loop, max_iters, tolerance):
        return (loop, op.dtype, tuple(op.field_shape), max_iters, tolerance)

    @classmethod
    def of(cls, op, loop, config):
        """The operator's loop for ``config``, made and cached in ``op.graphs`` at first
        use."""
        key = cls.key(op, loop, config.max_iters, config.tolerance)
        if key not in op.graphs:
            op.graphs[key] = cls(op, loop, config.max_iters, config.tolerance)
        return op.graphs[key]

    # -- the solve ----------------------------------------------------------------------

    def solve(self, b, x0=None, b_is_ones=False):
        """One solve: (x, iterations, rr, <b, b>), the last two Python floats.  b is a
        field of the loop's shape, device and dtype (ignored when ``b_is_ones``)."""
        x, k, rr_f, bb_f = self._run(lambda x: self._start(x, b, x0, b_is_ones))
        return x.view(self.shape), k, rr_f, bb_f

    def _run(self, start):
        """Take a free slot, ``start(x)`` on its solution, run the loop (one replay, or on
        the host) and read (rr, <b, b>, k) in one read: (x, k, rr, <b, b>)."""
        with profiling.scope(profiling.PHASE_SLOT):
            slot = self._slot()
        with profiling.scope(profiling.PHASE_START):
            start(slot.x)
        with profiling.scope(profiling.PHASE_REPLAY):
            if slot.graph is None:
                self._run_host(slot.x)
            else:
                self._replay(slot.graph)
                COUNTS["replays"] += 1
        with profiling.scope(profiling.PHASE_READ):
            status = torch.stack([self.rr.double(), self.bb.double(), self.k.double()])
            rr_f, bb_f, k = _read(status).tolist()  # the one read; also the sync
        k = int(k)
        if slot.graph is not None:
            self._count_replay(k)
        return slot.x, k, rr_f, bb_f

    def _replay(self, graph):
        """Replay the slot's graph on the current stream."""
        graph.replay()

    def _start(self, x, b, x0, b_is_ones):
        """r0, x0, <r0, r0>, <b, b>, tol², k = 0 and the loop's first p into the state,
        eagerly, as the eager loop forms them."""
        if x0 is None:
            if b_is_ones:
                self.r.fill_(1)
            else:
                self.r.copy_(b)
            x.zero_()
            rr = blas1.dot(self.r, self.r)
            self.rr.copy_(rr)
            self.bb.copy_(rr)
        else:
            x1, r, rr, bb = _start_from(x0, b, self._spmv, True)
            x.copy_(x1)
            self.r.copy_(r)
            self.rr.copy_(rr)
            self.bb.copy_(bb)
        torch.mul(self.bb, self.tolerance * self.tolerance, out=self.tol2)
        self.k.zero_()
        if self.loop == "classic":
            self.p[0].copy_(self.r)
        else:
            self.p[1].zero_()  # the first iteration's p_prev: p' = r + 0·0
            self.rr_prev.fill_(1)

    def _iteration(self, x, parity):
        """One CG iteration on the state, the eager loop's calls in its order; writes no
        field but the state's and allocates nothing under a workspace."""
        rr, alpha, beta = self.rr, self.alpha, self.beta
        if self.loop == "classic":
            p = self.p[0]
            with profiling.scope(profiling.PHASE_SPMV):
                _, pap = self._spmv_dot(p, out=self.ap)
            torch.div(rr, pap, out=alpha)
            with profiling.scope(profiling.PHASE_AXPY):
                _, _, rr_new = blas1.cg_update(alpha, x, self.r, p, self.ap)
            torch.div(rr_new, rr, out=beta)
            with profiling.scope(profiling.PHASE_UPDATE_P):
                blas1.p_update(beta, self.r, p)  # p = r + β·p
        else:
            p, p_prev = self.p[parity], self.p[1 - parity]
            torch.eq(self.k, 0, out=self.first)
            torch.div(rr, self.rr_prev, out=beta)
            torch.where(self.first, self.zero, beta, out=beta)  # β = 0 on the first step
            if self.loop == "fused":
                with profiling.scope(profiling.PHASE_SPMV):
                    _, _, pap = self._fused(beta, self.r, p_prev, out=p, y_out=self.ap)
                torch.div(rr, pap, out=alpha)
                with profiling.scope(profiling.PHASE_AXPY):
                    _, _, rr_new = blas1.cg_update(alpha, x, self.r, p, self.ap)
            else:
                with profiling.scope(profiling.PHASE_SPMV):
                    _, pap = self._pupdate_dot(beta, self.r, p_prev, out=p)
                torch.div(rr, pap, out=alpha)
                with profiling.scope(profiling.PHASE_AXPY):
                    _, _, rr_new = self._update_recompute(alpha, x, self.r, p)
            self.rr_prev.copy_(rr)
        rr.copy_(rr_new)
        self.k.add_(1)

    def _structure(self, node, step):
        """The loop: a WHILE node whose body runs ``unroll`` iterations (``step(parity)``),
        each after the first under an IF node (the first too with ``guard_first``, whose
        condition then holds already).  ``node(kind, body)`` makes ``body`` the body of a
        node of ``kind``: captured on the card, run on the host's reading of the condition
        on the CPU."""
        def body():
            for j in range(self.unroll):
                if j or self.guard_first:
                    node(graph_kernels.IF, functools.partial(step, j % 2))
                else:
                    step(0)

        node(graph_kernels.WHILE, body)

    def _cond_state(self):
        """(k, max_iters, rr, tol²): what the loop's condition reads."""
        return self.k, self.max_iters, self.rr, self.tol2

    def _run_host(self, x):
        def cond():
            return graph_kernels.cond_plain(*self._cond_state())

        def node(kind, body):
            if kind == graph_kernels.WHILE:
                while cond():
                    body()
            elif cond():
                body()

        self._structure(node, functools.partial(self._iteration, x))

    # -- capture ------------------------------------------------------------------------

    def _slot(self):
        for slot in self.slots:
            if slot.free():
                return slot
        slot = _Slot.of(self._new_x())
        if self.graphed:
            slot.graph = self._capture(slot.x)
        self.slots.append(slot)
        return slot

    def _capture(self, x):
        """The graph of the loop on the solution field x.  The first capture loads the
        condition kernel and records the workspace with one eager iteration on the state
        (whatever it holds: the next start overwrites it), which also loads the
        iteration's kernels; every captured iteration then takes the same buffers, since
        they run one after another.  The capture is set-up, not a solve: the wrappers'
        counts are put back as they were before it, warm-up included, and one captured
        iteration's share is kept in ``per_iteration``.  Counted in ``COUNTS``, inside a
        ``CG_Capture`` span."""
        COUNTS["captures"] += 1
        with profiling.scope(profiling.PHASE_CAPTURE):
            return self._capture_graph(x)

    def _capture_graph(self, x):
        if self.workspace is None:
            graph_kernels.preload(self.device)
            self.workspace = _launch.Workspace(self.device)
            with _launch.set_apart(), _launch.use(self.workspace):
                self._iteration(x, 0)

        def step(parity):
            self.workspace.rewind()
            self._iteration(x, parity)

        g = torch.cuda.CUDAGraph()
        with _launch.set_apart() as captured, \
                torch.cuda.graph(g, stream=self.capture_stream,
                                 capture_error_mode=self.capture_mode), \
                _launch.use(self.workspace):
            allocs = _allocations(self.device)
            self._structure(self._capture_node, step)
            made = _allocations(self.device) - allocs
        if made:
            raise RuntimeError(f"the captured CG loop allocated {made} buffers: its body "
                               "must allocate nothing")
        self.per_iteration = self._per_iteration(captured)
        return g

    def _capture_node(self, kind, body):
        state = self._cond_state()
        with graph_kernels.conditional(kind, *state) as handle:
            body()
            if kind == graph_kernels.WHILE:
                graph_kernels.set_cond(handle, *state)

    def _per_iteration(self, captured):
        """{wrapper: launches of one iteration} from a capture's counts (``unroll``
        iterations and their condition kernels, which it leaves out)."""
        per = {}
        for name, n in captured.items():
            if name == "cg_cond":
                continue
            if n % self.unroll:
                raise RuntimeError(f"{name}: {n} launches captured for {self.unroll} "
                                   "iterations")
            per[name] = n // self.unroll
        return per

    def _count_replay(self, k):
        """Add a replay's launches to ``LAUNCHES``: k iterations, and the condition kernel
        once before the WHILE node and ``unroll`` (``guard_first``: ``unroll`` + 1) times
        in each body that ran."""
        _launch.count_replay(self.per_iteration, k)
        bodies = -(-k // self.unroll)
        _launch.count_replay({"cg_cond": 1 + (self.unroll + self.guard_first) * bodies})


def _allocations(device) -> int:
    """The caching allocator's count of allocations made on ``device`` so far."""
    return torch.cuda.memory_stats(device).get("allocation.all.allocated", 0)


def _dot(kernels):
    return blas1.dot if kernels else blas1.dot_plain


def _start_from(x0, b, spmv, kernels):
    """(x, r, <r, r>, <b, b>) for a nonzero x0: x a copy of x0 on b's device, r0 = b - A·x0
    with <r0, r0> in one pass (K7, or plain ops); the criterion is relative to ‖b‖, not
    ‖r0‖, hence <b, b>.  The dots are 0-d tensors."""
    x = x0.to(device=b.device, dtype=b.dtype).clone()
    ax0 = spmv(x)
    if kernels:
        r, rr = blas1.axpby_dot(1.0, b, -1.0, ax0)
    else:
        r = b - ax0
        rr = _dot(kernels)(r, r)
    del ax0
    return x, r, rr, _dot(kernels)(b, b)


def cg_solve_stepped(spmv_dot, b, x0=None, *, config: Optional[CGConfig] = None,
                     spmv=None, use_pallas_blas1: Optional[bool] = None):
    """Host-stepped classic CG with wall time per phase: the CLI's ``--timers`` and
    ``--host`` loop, counterpart of ``tpusparse.solvers.cg.cg_solve_stepped``.  Returns
    (x, CGStats) with the ``spmv``, ``blas1`` and ``reduction`` buckets filled.

    The reference's opt-in detailed timers (cg_solver.h:25, cg_solver.cu:543-547): each
    phase ends in ``torch.cuda.synchronize()`` (on a card; on the CPU every op has finished
    when it returns), so the split costs a sync per phase and this is a diagnostic loop,
    not the fast one.  An iteration is the SpMV with its dot (``spmv_dot``, the operator's
    ``run_device_dot``: K3, K8, K11 or the ELL kernel) in ``spmv``; reading <p, Ap> to the
    host in ``reduction``; K4 (x, r and <r, r>) in ``blas1``; reading <r, r> in
    ``reduction``; and, unless the iteration converged, K5 (p = r + β·p) in ``blas1``.
    α and β are formed on the host in double precision.

    Args:
      spmv_dot: ``p -> (A·p, <p, A·p>)``.
      b: right-hand side field; the solve never writes into it.
      x0: initial guess (default zeros); a nonzero x0 needs ``spmv`` (``x -> A·x``), and
        r0 = b - A·x0 comes with <r0, r0> from K7.
      use_pallas_blas1: True or None runs K4-K7 (and <b, b> through K6), False their
        steps as plain PyTorch ops, as in ``cg_solve``.

    Convergence follows the JAX stepped loop: ‖r‖ < tol·‖b‖ with ‖b‖ from <b, b> (not
    ‖r0‖), and a zero residual at the start runs no iteration."""
    config = config or CGConfig()
    kernels = use_pallas_blas1 is not False
    cg_update = blas1.cg_update if kernels else blas1.cg_update_plain
    p_update = blas1.p_update if kernels else blas1.p_update_plain
    if x0 is None:
        x = torch.zeros_like(b)
        r = b.clone()  # the loop updates r in place
        rr = bb = float(_dot(kernels)(r, r))
    else:
        if spmv is None:
            raise ValueError("nonzero x0 requires the plain spmv callable")
        x, r, rr, bb = _start_from(x0, b, spmv, kernels)
        rr, bb = float(rr), float(bb)
    b_norm = bb ** 0.5
    # its own buffer: K4 updates r in place while it reads p (in the JAX loop p *is* r on
    # the first iteration)
    p = r.clone()

    def sync():
        if b.is_cuda:
            torch.cuda.synchronize(b.device)

    stats = CGStats()
    t_solve = time.perf_counter()
    k = 0
    done = rr == 0.0  # a zero residual: x0 is the solution, 0 iterations
    while k < config.max_iters and not done:
        t0 = time.perf_counter()
        with profiling.scope(profiling.PHASE_SPMV):
            ap, pap = spmv_dot(p)
            sync()
        t1 = time.perf_counter()
        with profiling.annotate(profiling.PHASE_DOT):
            pap = pap.item()
        t2 = time.perf_counter()
        with profiling.scope(profiling.PHASE_AXPY):
            x, r, rr_new = cg_update(rr / pap, x, r, p, ap)
            sync()
        t3 = time.perf_counter()
        with profiling.annotate(profiling.PHASE_DOT):
            rr_new = rr_new.item()
        t4 = time.perf_counter()
        del ap
        stats.spmv_time_ms += (t1 - t0) * 1e3
        stats.reduction_time_ms += ((t2 - t1) + (t4 - t3)) * 1e3
        stats.blas1_time_ms += (t3 - t2) * 1e3
        k += 1
        if config.verbose >= 2:
            print(f"[CG] Iter {k:3d}: residual = {rr_new ** 0.5:e} "
                  f"(rel = {rr_new ** 0.5 / b_norm:e})")
        if rr_new == 0 or rr_new ** 0.5 < config.tolerance * b_norm:
            done = True  # at tolerance 0 too: the next step would divide 0 by 0
        else:
            t0 = time.perf_counter()
            with profiling.scope(profiling.PHASE_UPDATE_P):
                p_update(rr_new / rr, r, p)
                sync()
            stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        rr = rr_new
    stats.total_time_ms = (time.perf_counter() - t_solve) * 1e3
    stats.iterations = k
    stats.converged = done or converged(rr ** 0.5, b_norm, config.tolerance, k,
                                        config.max_iters)
    stats.residual_norm = rr ** 0.5
    stats.relative_residual = rr ** 0.5 / b_norm if b_norm > 0 else 0.0
    return x, stats
