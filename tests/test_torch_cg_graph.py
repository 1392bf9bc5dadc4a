"""The graph loop of the port's CG solver (``tpusparse_torch.solvers.cg.DeviceLoop``) on the
CPU, against the JAX package's ``lax.while_loop`` solve and the port's eager loop.

On a card ``cg_solve`` captures the loop into a CUDA graph: a WHILE node whose body runs
``unroll`` iterations, each after the first under an IF node, the condition
k < max_iters and rr > tol² set on the card.  Here there is no card: ``DeviceLoop.solve``
runs the same Python, the loop's structure and its iterations, with each node's
condition read on the host (``graph.cond_plain``), on the plain twins.  The JAX solver
runs its Pallas kernels in interpret mode, as tests/test_cg.py runs them.

Bars: iteration counts identical to the JAX solve's; x within 1e-12 of JAX's in f64 and
1e-5 in f32 (relative to the largest magnitude); x bit for bit the port's eager loop's
(``graph=False``: the same calls in the same order).  A bf16 state (classic loop only):
iterations within one of JAX's, Sum(x) and Norm2(x) within 1e-2 of JAX's (the two
packages' bf16 dots sum in other orders), x bit for bit the eager loop's.  The JAX loop's
edge cases: a zero b runs 0 iterations, ``max_iters`` cuts the loop in the middle of a
body, the criterion is relative to ‖b‖ from a seeded x0; bodies of 2 and 4 iterations
with the solve ending on and off a body's end.  The card's own checks (graph against
eager bit for bit, reads, memory, launches) are in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_host import carry
from tpusparse import formats
from tpusparse import ops as jops
from tpusparse.solvers import cg as jcg
from tpusparse_torch import convert, ops
from tpusparse_torch.kernels import _launch, dia, ell
from tpusparse_torch.kernels import graph as graph_kernels
from tpusparse_torch.kernels import stencil5 as st5
from tpusparse_torch.solvers import cg

TOL = {"f64": 1e-12, "f32": 1e-5}
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
JAX_LOOP = {"recompute": {"recompute_ap": True}, "classic": {"recompute_ap": False},
            "fused": {"fused_pupdate": True}}
# (mode, loop): every loop of every operator that captures
CASES = [("stencil5-const", "recompute"), ("stencil5-const", "classic"),
         ("stencil5", "classic"), ("stencil5-bf16c", "classic"), ("csr", "classic"),
         ("dia", "classic"), ("stencil5-const", "fused"), ("stencil5", "fused")]


def _stencil(g):
    return formats.Stencil5(grid_size=g, planes=None, constant=(5.0, -1.0))


def _jax_kwargs(mode, loop):
    """The JAX solver's loop options: the generic modes take no recompute_ap."""
    if loop == "classic" and mode != "stencil5-const":
        return {}
    return JAX_LOOP[loop]


def _jax_solve(mode, loop, dt, g, b=None, x0=None, config=None):
    jop = jops.get_operator(mode, _stencil(g), dtype=DTYPES[dt][0])
    b = jop.ones_b(DTYPES[dt][0]) if b is None else jop.as_field(b).astype(DTYPES[dt][0])
    x0 = None if x0 is None else jop.as_field(x0).astype(DTYPES[dt][0])
    x, s = jcg.cg_solve(jop, b, x0, config=config, **_jax_kwargs(mode, loop))
    return np.asarray(jop.from_field(x), np.float64), s


def _port_op(mode, dt, g):
    return ops.get_operator(mode, carry(_stencil(g)), dtype=DTYPES[dt][1], device="cpu")


def _graph_solve(op, loop, b=None, x0=None, config=None, unroll=cg.UNROLL):
    """The graph loop's solve on the CPU: (x, iterations, rr, <b, b>)."""
    config = config or cg.CGConfig()
    loop_obj = cg.DeviceLoop(op, loop, config.max_iters, config.tolerance, unroll=unroll)
    return loop_obj.solve(b, x0, b is None and x0 is None)


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("g", [16, 64])
@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("mode,loop", CASES)
def test_graph_loop_matches_jax_and_eager(mode, loop, dt, g):
    """b = ones, x0 = 0: identical iterations to JAX's, x to JAX's within the dtype's
    tolerance and bit for bit the eager loop's, one body of UNROLL iterations at a time."""
    xj, sj = _jax_solve(mode, loop, dt, g)
    op = _port_op(mode, dt, g)
    x, k, rr, bb = _graph_solve(op, loop)
    x_e, s_e = cg.cg_solve(op, b_is_ones=True, graph=False, **JAX_LOOP[loop])
    assert sj.converged and s_e.converged
    assert k == sj.iterations == s_e.iterations, (k, sj.iterations, s_e.iterations)
    assert _rel(op.from_field(x).numpy(), xj) <= TOL[dt]
    assert torch.equal(x, x_e)
    assert (rr ** 0.5) / (bb ** 0.5) == s_e.relative_residual


@pytest.mark.parametrize("mode", ["stencil5", "stencil5-bf16c", "stencil5-const", "csr",
                                  "dia"])
def test_graph_loop_bf16_classic(mode):
    """A bf16 state's classic loop at g = 32: iterations within one of JAX's, Sum(x) and
    Norm2(x) within 1e-2 of JAX's, x bit for bit the eager loop's."""
    g = 32
    xj, sj = _jax_solve(mode, "classic", "bf16", g)
    op = _port_op(mode, "bf16", g)
    x, k, _, _ = _graph_solve(op, "classic")
    x_e, s_e = cg.cg_solve(op, b_is_ones=True, graph=False, recompute_ap=False)
    assert sj.converged and s_e.converged
    assert k == s_e.iterations and abs(k - sj.iterations) <= 1
    assert torch.equal(x, x_e)
    xh = op.from_field(x).double().numpy()
    np.testing.assert_allclose([xh.sum(), np.linalg.norm(xh)],
                               [xj.sum(), np.linalg.norm(xj)], rtol=1e-2)


@pytest.mark.parametrize("loop", ["recompute", "classic", "fused"])
@pytest.mark.parametrize("case", ["zero b", "max_iters 5", "seeded x0", "given b"])
def test_graph_loop_edge_cases_match_jax(case, loop):
    """The JAX loop's edge cases through bodies of 16 iterations: a zero b runs 0
    iterations (strict >), max_iters = 5 stops in the middle of the first body, a seeded
    x0 converges relative to ‖b‖, and a given b; iterations, convergence and x as JAX's,
    x bit for bit the eager loop's."""
    g = 24
    rng = np.random.RandomState(11)
    b, x0, config = np.ones(g * g), None, cg.CGConfig()
    if case == "zero b":
        b = np.zeros(g * g)
    elif case == "max_iters 5":
        config = cg.CGConfig(max_iters=5)
    elif case == "seeded x0":
        x0 = rng.randn(g * g)
    else:
        b = rng.rand(g * g)
    xj, sj = _jax_solve("stencil5-const", loop, "f64", g, b, x0,
                        config=jcg.CGConfig(max_iters=config.max_iters))
    op = _port_op("stencil5-const", "f64", g)
    bt = op.as_field(b)
    x0t = None if x0 is None else convert.fields_from_numpy(x0.reshape(g, g), "cpu")
    x, k, rr, bb = _graph_solve(op, loop, bt, x0t, config, unroll=16)
    x_e, s_e = cg.cg_solve(op, bt, x0t, config=config, graph=False, **JAX_LOOP[loop])
    assert k == sj.iterations == s_e.iterations
    assert sj.converged == s_e.converged
    assert torch.equal(x, x_e)
    if case == "zero b":
        assert k == 0 and not x.any() and bb == 0.0
    else:
        assert _rel(op.from_field(x).numpy(), xj) <= TOL["f64"]
    if case == "max_iters 5":
        assert k == 5 and not s_e.converged


@pytest.mark.parametrize("unroll", [2, 4])
@pytest.mark.parametrize("g,iterations", [(16, 16), (20, 17), (24, 18)])
@pytest.mark.parametrize("loop", ["recompute", "classic", "fused"])
def test_graph_loop_ends_on_and_off_a_body(loop, g, iterations, unroll):
    """Bodies of 2 and 4 iterations with solves of 16 (a whole number of bodies), 17 (one
    iteration into a body) and 18 (two into a body of 4) iterations: JAX's count and x."""
    xj, sj = _jax_solve("stencil5-const", loop, "f64", g)
    op = _port_op("stencil5-const", "f64", g)
    x, k, _, _ = _graph_solve(op, loop, unroll=unroll)
    assert k == sj.iterations == iterations
    assert _rel(op.from_field(x).numpy(), xj) <= TOL["f64"]


def test_graph_loop_refuses_an_odd_or_short_body_and_bf16_recompute():
    op = _port_op("stencil5-const", "f64", 8)
    for unroll in (1, 3):
        with pytest.raises(ValueError, match="even"):
            cg.DeviceLoop(op, "classic", 10, 1e-6, unroll=unroll)
    with pytest.raises(ValueError, match="bf16"):
        cg.DeviceLoop(_port_op("stencil5-const", "bf16", 8), "recompute", 10, 1e-6)


def test_graph_loop_never_overwrites_a_returned_x():
    """A returned x that the caller still holds (or a view of it) keeps its slot: the next
    solve takes another, and a slot is reused once its x is dropped."""
    g = 16
    op = _port_op("stencil5", "f64", g)
    loop = cg.DeviceLoop(op, "classic", 1000, 1e-6)
    x1 = loop.solve(None, None, True)[0]
    keep = x1.clone()
    b = op.as_field(np.random.RandomState(1).rand(g * g))
    x2 = loop.solve(b, None, False)[0]
    assert torch.equal(x1, keep) and not torch.equal(x2, keep) and len(loop.slots) == 2
    view = x1.reshape(-1)[3:]
    del x1
    loop.solve(b, None, False)
    assert len(loop.slots) == 3 and torch.equal(view, keep.reshape(-1)[3:])
    del view, x2
    x4 = loop.solve(None, None, True)[0]
    assert len(loop.slots) == 3 and torch.equal(x4, keep)


def test_cg_solve_picks_its_loop_on_the_cpu():
    """On the CPU the default is the eager loop (graph=True raises: no card to capture
    on); it reads rr > tol² once an iteration and once more at the end."""
    op = _port_op("stencil5-const", "f64", 16)
    cg.reset_counts()
    x, s = cg.cg_solve(op, b_is_ones=True)
    assert cg.COUNTS == {"host_reads": s.iterations + 2, "replays": 0, "solves": 1,
                         "captures": 0} and not op.graphs
    with pytest.raises(ValueError, match="graph=True"):
        cg.cg_solve(op, b_is_ones=True, graph=True)
    assert torch.equal(x, _graph_solve(op, "recompute")[0])


def test_device_loops_are_cached_per_key_and_freed_with_the_operator():
    """``DeviceLoop.of`` makes one loop per (loop, dtype, shape, max_iters, tolerance) and
    keeps it in ``op.graphs``; ``op.free()`` drops them."""
    op = _port_op("stencil5-const", "f64", 8)
    a = cg.DeviceLoop.of(op, "recompute", cg.CGConfig())
    assert cg.DeviceLoop.of(op, "recompute", cg.CGConfig()) is a
    b = cg.DeviceLoop.of(op, "recompute", cg.CGConfig(tolerance=1e-8))
    c = cg.DeviceLoop.of(op, "classic", cg.CGConfig())
    assert len({id(a), id(b), id(c)}) == 3 and len(op.graphs) == 3
    op.free()
    assert op.graphs == {}


def test_workspace_hands_out_its_recorded_buffers_in_order():
    """The buffers an eager pass records are handed out again in the same order after
    ``rewind``; a call that asks for another shape or more buffers raises.  Outside a
    workspace the wrappers allocate as before."""
    like = torch.zeros(4, 4, dtype=torch.bfloat16)
    ws = _launch.Workspace("cpu")
    with _launch.use(ws):
        d, part = _launch.dot_buffers(like, 7)
        s = _launch.scalar(torch.tensor(0.3), like)
        assert _launch.dot_tickets(like, 0) is ws.tickets
    assert s.dtype == torch.bfloat16 and float(s) == float(torch.tensor(0.3).to(s.dtype))
    ws.rewind()
    with _launch.use(ws):
        assert _launch.dot_buffers(like, 7)[1] is part
        assert _launch.scalar(0.5, like) is s and float(s) == 0.5
        with pytest.raises(RuntimeError, match="more buffers"):
            _launch.dot_buffers(like, 7)
    ws.rewind()
    with _launch.use(ws), pytest.raises(RuntimeError, match="recorded pass had"):
        _launch.dot_buffers(like, 8)
    assert _launch.dot_buffers(like, 7)[1] is not part


def test_set_apart_takes_a_capture_out_of_the_counts_and_replays_count_apart():
    """The one counting rule of a captured graph (``_launch``), which the graph loop, the
    probe chains and the iteration audit share: the launches counted inside
    ``set_apart`` leave the wrappers' counts for its dict, every count put back, also
    when the block raises, a counter registered inside it from 0; ``count_replay`` adds a
    replay's launches to ``REPLAYED`` (``cg.LAUNCHES``), never to a wrapper's count.
    Every kernel module's counter is registered."""
    assert cg.LAUNCHES is _launch.REPLAYED
    for c in (st5.LAUNCHES, ell.LAUNCHES, dia.LAUNCHES, graph_kernels.LAUNCHES):
        assert any(c is r for r in _launch.COUNTERS)
    for counter in (st5, graph_kernels, cg):
        counter.reset_launches()
    st5.LAUNCHES["spmv_stencil5"] = 2
    with _launch.set_apart() as launches:
        st5.LAUNCHES["spmv_stencil5"] += 3
        graph_kernels.LAUNCHES["cg_cond"] += 1
        late = _launch.counter(("late",))
        late["late"] += 1
    _launch.COUNTERS.remove(late)
    assert launches == {"spmv_stencil5": 3, "cg_cond": 1, "late": 1}
    assert (st5.LAUNCHES["spmv_stencil5"], graph_kernels.LAUNCHES["cg_cond"],
            late["late"]) == (2, 0, 0)
    del launches["late"]
    _launch.count_replay(launches)
    _launch.count_replay(launches, 4)
    assert cg.LAUNCHES == {"spmv_stencil5": 15, "cg_cond": 5}
    assert st5.LAUNCHES["spmv_stencil5"] == 2
    with pytest.raises(ValueError), _launch.set_apart():
        st5.LAUNCHES["spmv_stencil5"] += 1
        raise ValueError
    assert st5.LAUNCHES["spmv_stencil5"] == 2
    for counter in (st5, graph_kernels, cg):
        counter.reset_launches()


def test_out_arguments_write_the_twins_results_into_given_fields():
    """The fields the graph loop hands the wrappers: ELL's and DIA's ``out=``, K9's and
    K10's ``y_out=``; the same values as without them, in the given tensors."""
    g = 12
    rng = np.random.RandomState(4)
    op_ell = _port_op("csr", "f64", g)
    op_dia = _port_op("dia", "f64", g)
    x = torch.from_numpy(rng.randn(g * g))
    for op, fn, operand in ((op_ell, ell.spmv_ell, ("vals", "cols")),
                            (op_dia, dia.spmv_dia, ("data", "offsets"))):
        args = [op.operand[k] for k in operand]
        y, d = fn(*args, x, with_dot=True)
        out = torch.empty_like(x)
        y2, d2 = fn(*args, x, with_dot=True, out=out)
        assert y2 is out and torch.equal(out, y) and torch.equal(d, d2)
    r, p = (torch.from_numpy(rng.randn(g, g)) for _ in range(2))
    planes = _port_op("stencil5", "f64", g).planes
    for fused in (lambda **kw: st5.spmv_stencil5_pupdate(planes, 0.3, r, p, **kw),
                  lambda **kw: st5.spmv_stencil5_const_pupdate(0.3, r, p, diag=5.0,
                                                               offdiag=-1.0, **kw)):
        pn, y, d = fused()
        out, y_out = torch.empty_like(r), torch.empty_like(r)
        pn2, y2, d2 = fused(out=out, y_out=y_out)
        assert pn2 is out and y2 is y_out
        assert torch.equal(pn2, pn) and torch.equal(y2, y) and torch.equal(d2, d)
        with pytest.raises(ValueError, match="y_out must not overlap"):
            fused(out=out, y_out=r)


def test_cond_twin_is_strict_and_stops_on_nan():
    """The condition's twin: k < max_iters and rr > tol², strict, false for a NaN."""
    t = torch.tensor
    assert graph_kernels.cond_plain(t(0), 5, t(1.0), t(0.5))
    assert not graph_kernels.cond_plain(t(5), 5, t(1.0), t(0.5))
    assert not graph_kernels.cond_plain(t(0), 5, t(0.0), t(0.0))
    assert not graph_kernels.cond_plain(t(0), 5, t(float("nan")), t(0.5))
