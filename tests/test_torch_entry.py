"""The port's top-level entry points (tpusparse_torch.entry) against the repo's
``__graft_entry__.py``, on the CPU.

- ``entry(device="cpu")``: the same planes and x as ``__graft_entry__.entry()`` (bit for
  bit), and its ``fwd`` on those inputs against the JAX ``fwd`` (K8 with its dot, Pallas
  in interpret mode): y to 1e-5 and the dot to 1e-4, f32;
- ``dryrun_multichip(n, device="cpu")`` on meshes of 2 and 4 CPU shards in this process:
  every leg passes and prints its line, the iteration count equal to the JAX
  single-device solve's at g = 8n;
- a planted fault (the single-device oracle reporting one more iteration) raises
  AssertionError; without a card, nothing runs unless the CPU is asked for.
"""

import numpy as np
import pytest
import torch

from tpusparse_torch import entry

SOLVE_LINES = ("[dryrun_multichip] n={n}: converged in",
               "[dryrun_multichip] large-grid leg g=512:",
               "[dryrun_multichip] stepped buckets")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_entry_matches_graft_entry():
    import __graft_entry__ as graft

    jfwd, (jplanes, jx) = graft.entry()
    fwd, (planes, x) = entry.entry(device="cpu")
    assert planes.dtype == x.dtype == torch.float32
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jplanes))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    # a random x as well: ones give a y of few distinct values
    xr = np.random.RandomState(3).randn(*x.shape).astype(np.float32)
    for xin in (np.asarray(jx), xr):
        jy, jdot = jfwd(jplanes, xin)
        y, dot = fwd(torch.from_numpy(np.array(jplanes)), torch.from_numpy(np.array(xin)))
        assert y.shape == (entry.ENTRY_GRID, entry.ENTRY_GRID)
        assert _rel(y.numpy(), jy) <= 1e-5
        assert _rel(float(dot), float(jdot)) <= 1e-4


def _jax_single_device_iterations(g):
    import jax.numpy as jnp

    from tpusparse import generate as jgenerate
    from tpusparse import ops as jops
    from tpusparse.solvers import cg as jcg

    op = jops.get_operator("stencil5", jgenerate.make_stencil5(g), dtype=jnp.float64)
    _x, s = jcg.cg_solve(op, jnp.ones((g, g), jnp.float64),
                         config=jcg.CGConfig(tolerance=1e-6, max_iters=200))
    return s.iterations


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(capsys, n):
    res = entry.dryrun_multichip(n, device="cpu")
    out = capsys.readouterr().out
    for line in SOLVE_LINES:
        assert line.format(n=n) in out
    assert ("[dryrun_multichip] 2-D mesh (2, 2):" in out) == (n == 4)
    assert res["grid"] == 8 * n and res["large_grid"] == 512
    assert res["iterations"] == _jax_single_device_iterations(8 * n)
    assert abs(res["sum_diff"]) <= 1e-12 * 8 * n * 8 * n
    assert min(res["stepped"].values()) > 0
    # the shards exchanged halo rows and gave them to the SpMV (the twins count no launch)
    halo = res["halo_calls"]
    assert res["launches"] == {} and 0 < halo["exchange"] <= halo["spmv_stencil5"]
    if n == 4:
        assert res["mesh2d"] == [2, 2] and res["mesh2d_iterations"] == res["iterations"]


def test_dryrun_planted_fault_raises(monkeypatch):
    real = entry._single_device

    def one_more(g, device):
        x, s = real(g, device)
        s.iterations += 1
        return x, s

    monkeypatch.setattr(entry, "_single_device", one_more)
    with pytest.raises(AssertionError, match="iteration parity broken"):
        entry.dryrun_multichip(2, device="cpu")


def test_no_card_no_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(2)
