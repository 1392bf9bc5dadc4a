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
through a device pointer.  The host reads one flag per iteration, the convergence test
rr > tol², which is the reference's own per-iteration poll (cg_solver.cu:598-599); the
JAX package instead ran the whole loop on the device under ``lax.while_loop``.  A CUDA
graph of the iteration is later work.

``cg_solve_stepped`` is the host-stepped classic loop of the CLI's ``--timers`` and
``--host``: every phase ends in a sync, and its wall time goes to the ``spmv``, ``blas1``
or ``reduction`` bucket of ``CGStats``.  Every loop marks its phases with
``bench.profiling.scope`` (``SpMV``, ``BLAS_AXPY``, ``BLAS_Update_P``), which a trace shows
as ranges; the stepped loop also marks its reads of the dots to the host
(``bench.profiling.annotate``, ``Dot_Product``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from ..bench import profiling
from ..kernels import blas1


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
             use_pallas_blas1: Optional[bool] = None, fused_pupdate: Optional[bool] = None):
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

    A bf16 state (``op.dtype``) runs the classic loop only: the recompute loop, also when
    None picks it, and the fused loop raise ValueError (``check_loop``).  Its dots, rr and
    <b, b> are f32; α and β are rounded to bf16 where the kernels take them.
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
    check_loop(op.dtype, "fused" if fused else "recompute" if recompute else "classic")
    cg_update = blas1.cg_update if kernels else blas1.cg_update_plain

    t0 = time.perf_counter()
    if not b_is_ones:
        if b is None or tuple(b.shape) != tuple(op.field_shape):
            raise ValueError(f"b must be a field of shape {op.field_shape}")
        b = b.to(device=op.device, dtype=op.dtype)
    if x0 is None:
        r = op.ones_b() if b_is_ones else b.clone()  # the loops update r in place
        x = torch.zeros_like(r)
        rr = bb = _dot(kernels)(r, r)
    else:
        x, r, rr, bb = _start_from(x0, b, op.run_device, kernels)
    tol2 = (config.tolerance * config.tolerance) * bb

    k = 0
    if recompute or fused:
        p_prev = torch.zeros_like(r)
        p_buf = torch.empty_like(r)
        rr_prev = torch.ones_like(rr)
        zero = torch.zeros_like(rr)
        # strict >: a zero right-hand side (rr0 = 0 = tol2) runs no 0/0 step
        while k < config.max_iters and bool(rr > tol2):
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
        while k < config.max_iters and bool(rr > tol2):
            with profiling.scope(profiling.PHASE_SPMV):
                ap, pap = op.run_device_dot(p)
            with profiling.scope(profiling.PHASE_AXPY):
                x, r, rr_new = cg_update(rr / pap, x, r, p, ap)
            del ap
            with profiling.scope(profiling.PHASE_UPDATE_P):
                p_update(rr_new / rr, r, p)  # p = r + β·p
            rr = rr_new
            k += 1

    rr_f, bb_f = torch.stack([rr, bb]).tolist()  # one device->host read; also the sync
    total_ms = (time.perf_counter() - t0) * 1e3
    res = rr_f ** 0.5
    b_norm = bb_f ** 0.5
    stats = CGStats(
        iterations=k,
        converged=bool(res < config.tolerance * b_norm) if b_norm > 0 else True,
        residual_norm=res,
        relative_residual=res / b_norm if b_norm > 0 else 0.0,
        total_time_ms=total_ms,
    )
    return x, stats


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
    converged = rr == 0.0  # a zero residual: x0 is the solution, 0 iterations
    while k < config.max_iters and not converged:
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
        if rr_new ** 0.5 < config.tolerance * b_norm:
            converged = True
        else:
            t0 = time.perf_counter()
            with profiling.scope(profiling.PHASE_UPDATE_P):
                p_update(rr_new / rr, r, p)
                sync()
            stats.blas1_time_ms += (time.perf_counter() - t0) * 1e3
        rr = rr_new
    stats.total_time_ms = (time.perf_counter() - t_solve) * 1e3
    stats.iterations = k
    stats.converged = converged
    stats.residual_norm = rr ** 0.5
    stats.relative_residual = rr ** 0.5 / b_norm if b_norm > 0 else 0.0
    return x, stats
