"""The port's top-level entry points: the counterpart of the repo's ``__graft_entry__.py``.

``entry(device="cuda")``  returns ``fwd, (planes, x)``: one launch of K8 with its dot
                          (``kernels.stencil5.spmv_stencil5(planes, x, with_dot=True)``)
                          at g = 256 in f32, the planes made on the device, x = ones.
``dryrun_multichip(n)``   solves small grids to convergence through the sharded CG on an
                          n-shard mesh that this process drives (``dist.make_band_mesh``,
                          as the repo's entry builds its n-device mesh in one process; on
                          one card the shards share it) and asserts parity with the solves
                          on one device: identical iteration counts and Sum(x)/Norm2(x),
                          the reference's deterministic multi-GPU validation (its
                          README.md:62).

The dryrun's legs, as in the JAX function: (a) ``cg_solve_sharded`` at g = 8n (one 8-row
band a shard) against the single-device ``cg.cg_solve``; (b) g = 512 (64n when n does not
divide 512) on n shards against one; (c) ``cg_solve_sharded_stepped`` at g = 8n, its
``halo``/``spmv``/``allreduce``/``blas1`` buckets printed; (d) for even n >= 4,
``cg_solve_sharded_2d`` on a (2, n/2) mesh against the single-device solve.  f64 on the
card as on the CPU (the kernels have native f64), so every gate is exact: iterations
equal, Sum and Norm2 to 1e-12 relative.  A broken gate raises AssertionError.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dist, generate, ops
from ._device import host_numpy, resolve_device
from .kernels import blas1
from .kernels import stencil5 as st5
from .solvers import cg, cg_sharded

ENTRY_GRID = 256
DIAG, OFFDIAG = 5.0, -1.0
TOLERANCE = 1e-6
MAX_ITERS = 200
PARITY_TOL = 1e-12
DTYPE = torch.float64


def entry(device="cuda"):
    """(fwd, (planes, x)) with fwd(planes, x) = (y, <x, y>), y = A·x through K8."""
    dev = resolve_device(device)
    planes = generate.make_stencil5_planes_device(ENTRY_GRID, DIAG, OFFDIAG,
                                                  dtype=torch.float32, device=dev)
    x = torch.ones((ENTRY_GRID, ENTRY_GRID), dtype=torch.float32, device=dev)

    def fwd(planes, x):
        return st5.spmv_stencil5(planes, x, with_dot=True)

    return fwd, (planes, x)


def _solve_kw(device):
    return dict(mode="stencil5", diag=DIAG, offdiag=OFFDIAG, tolerance=TOLERANCE,
                max_iters=MAX_ITERS, dtype=DTYPE, device=device)


def _legs(n, device, g, g_large, mesh2):
    """Legs (a)-(d) on an n-shard mesh of ``device``'s kind, in order: the solutions (on
    the host), the stats, and the launches (eager and replayed) and halo counts over the
    legs."""
    for counter in (st5, blas1, cg):
        counter.reset_launches()
    cg_sharded.reset_halo_calls()
    mesh = dist.make_band_mesh(n, devices=device.type)
    kw = _solve_kw(device)
    del kw["device"]
    out = {}
    for leg, grid in (("sharded", g), ("large", g_large)):
        x, s = cg_sharded.cg_solve_sharded(grid, mesh=mesh, **kw)
        out[leg] = (host_numpy(x), s)
    _x, out["stepped"] = cg_sharded.cg_solve_sharded_stepped(g, mesh=mesh, **kw)
    if mesh2 is not None:
        x, s = cg_sharded.cg_solve_sharded_2d(
            dist.make_mesh(mesh2, devices=device.type), g, **kw)
        out["2d"] = (host_numpy(x), s)
    out["launches"] = {n: v for c in (st5, blas1) for n, v in c.LAUNCHES.items() if v}
    for name, v in cg.LAUNCHES.items():
        out["launches"][name] = out["launches"].get(name, 0) + v
    out["halo_calls"] = dict(cg_sharded.HALO_CALLS)
    cg_sharded.clear_caches()
    return out


def _single_device(g, device):
    """The single-device oracle: ``cg.cg_solve`` on the ``stencil5`` operator of the same
    grid, b = ones.  Returns (x on the host, CGStats)."""
    op = ops.get_operator("stencil5", generate.make_stencil5(g, DIAG, OFFDIAG), dtype=DTYPE,
                          device=device)
    x, s = cg.cg_solve(op, b_is_ones=True,
                       config=cg.CGConfig(tolerance=TOLERANCE, max_iters=MAX_ITERS))
    x = x.cpu().numpy()
    op.free()
    return x, s


def _one_shard(g, device):
    """The sharded solve on a mesh of one shard."""
    kw = _solve_kw(device)
    del kw["device"]
    x, s = cg_sharded.cg_solve_sharded(g, mesh=dist.make_band_mesh(1, devices=device.type),
                                       **kw)
    x = host_numpy(x)
    cg_sharded.clear_caches()
    return x, s


def _check(ok: bool, n: int, what) -> None:
    if not ok:
        raise AssertionError(f"[dryrun_multichip] n={n}: {what}")


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= PARITY_TOL * max(1.0, abs(b))


def dryrun_grids(n: int):
    """(g, g_large, mesh2) of the dryrun on n shards: leg (a)'s grid, one 8-row band a
    shard; leg (b)'s, 512 (64n when n does not divide 512); leg (d)'s (2, n/2) mesh, or
    None when n is odd or under 4."""
    g_large = 512 if 512 % n == 0 else 64 * n
    return 8 * n, g_large, ((2, n // 2) if n >= 4 and n % 2 == 0 else None)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Legs (a)-(d) on an n_devices-shard mesh, each gate asserted (AssertionError), one
    ``[dryrun_multichip]`` line a leg.  Returns the legs' iterations and differences, and
    the launch counts (``launches``: each wrapper's eager launches and its graph replays')
    and the halo counts (``halo_calls``, summed over the shards) over them."""
    n = int(n_devices)
    dev = resolve_device(device)
    g, g_large, mesh2 = dryrun_grids(n)
    legs = _legs(n, dev, g, g_large, mesh2)

    xn, sn = legs["sharded"]
    _check(xn.shape == (g, g), n, f"sharded x of shape {xn.shape}")
    _check(sn.converged, n, f"sharded solve did not converge: {sn}")
    x1, s1 = _single_device(g, dev)
    _check(s1.converged, n, f"single-device solve did not converge: {s1}")
    _check(sn.iterations == s1.iterations, n, f"iteration parity broken: {n}-device "
           f"{sn.iterations} vs 1-device {s1.iterations}")
    sum_n, sum_1 = float(xn.sum()), float(x1.sum())
    nrm_n, nrm_1 = float(np.linalg.norm(xn)), float(np.linalg.norm(x1))
    _check(_close(sum_n, sum_1), n, f"Sum(x) {sum_n!r} vs {sum_1!r}")
    _check(_close(nrm_n, nrm_1), n, f"Norm2(x) {nrm_n!r} vs {nrm_1!r}")
    print(f"[dryrun_multichip] n={n}: converged in {sn.iterations} iterations "
          f"(parity ASSERTED vs 1-device solve: iterations {s1.iterations} == "
          f"{sn.iterations}, |ΔSum|={abs(sum_n - sum_1):.3e}, "
          f"|ΔNorm2|={abs(nrm_n - nrm_1):.3e} ≤ {PARITY_TOL:g} rel)", flush=True)

    xl_n, sl_n = legs["large"]
    xl_1, sl_1 = _one_shard(g_large, dev)
    _check(sl_n.converged and sl_1.converged, n, f"large-grid leg: {sl_n}, {sl_1}")
    _check(sl_n.iterations == sl_1.iterations, n,
           f"large-grid leg iterations {sl_n.iterations} vs {sl_1.iterations}")
    sum_ln, sum_l1 = float(xl_n.sum()), float(xl_1.sum())
    _check(_close(sum_ln, sum_l1), n, f"large-grid leg Sum(x) {sum_ln!r} vs {sum_l1!r}")
    print(f"[dryrun_multichip] large-grid leg g={g_large}: {sl_n.iterations} iterations "
          f"on {n} and 1 device(s), |ΔSum|={abs(sum_ln - sum_l1):.3e} — "
          "determinism-across-device-counts ASSERTED (14-iter regime needs g≳10⁴: "
          "chip_smoke.py solves 20480² on 1, 2 and 4 shards)", flush=True)

    st = legs["stepped"]
    _check(st.converged and st.iterations == sn.iterations, n,
           f"stepped solve {st.iterations} iterations vs {sn.iterations}")
    print(f"[dryrun_multichip] stepped buckets ({st.iterations} iters): "
          f"halo={st.halo_time_ms:.2f} ms, spmv={st.spmv_time_ms:.2f} ms, "
          f"allreduce={st.allreduce_time_ms:.2f} ms, blas1={st.blas1_time_ms:.2f} ms",
          flush=True)

    summary = {"n": n, "grid": g, "iterations": sn.iterations, "sum_diff": sum_n - sum_1,
               "norm2_diff": nrm_n - nrm_1, "large_grid": g_large,
               "large_iterations": sl_n.iterations, "large_sum_diff": sum_ln - sum_l1,
               "stepped": {k: getattr(st, f"{k}_time_ms")
                           for k in ("halo", "spmv", "allreduce", "blas1")}}
    if mesh2 is not None:
        x2, s2 = legs["2d"]
        _check(s2.converged and s2.iterations == s1.iterations, n,
               f"2-D mesh {mesh2}: {s2.iterations} iterations vs {s1.iterations}")
        d2 = abs(float(x2.sum()) - sum_1)
        _check(_close(float(x2.sum()), sum_1), n,
               f"2-D mesh {mesh2}: Sum(x) {float(x2.sum())!r} vs {sum_1!r}")
        print(f"[dryrun_multichip] 2-D mesh (2, {n // 2}): {s2.iterations} iterations, "
              f"|ΔSum|={d2:.3e} — 2-D parity ASSERTED", flush=True)
        summary.update(mesh2d=list(mesh2), mesh2d_iterations=s2.iterations,
                       mesh2d_sum_diff=float(x2.sum()) - sum_1)
    summary.update(launches=legs["launches"], halo_calls=legs["halo_calls"])
    return summary
