"""A graph a rank (``cg_sharded.MeshLoop`` with a rank link, ``graphed=True``): the ranks'
sharded CG run from one CUDA graph a rank with the exchanges and sums inside it, the
counterpart of the JAX package's multi-host solve, one compiled ``while_loop`` a process.

Here, on the CPU, 2 gloo ranks (``dist.launch_local``) run the graph's structure with each
node's condition read on the host (``graph.cond_plain``): a WHILE node whose body runs two
iterations, the second under an IF node, each iteration making the calls the captured body
makes (``_RankLink``'s exchange, ``_allsum``'s gather and ordered sum).  One group of ranks
runs every case of the file (the ``ranks`` fixture).  Bars:

- parity, for 2 ranks × 1 band (``cg_sharded.rank_mesh`` of a rank's one band), 2 ranks × 2
  bands and 2 ranks × 2 blocks of a (2, 2) mesh (``dist.make_rank_mesh``), in the recompute
  loop (bands) and the classic loop, f64 and f32: x and k bit for bit the eager rank
  loop's (``cg_solve_sharded`` / ``MeshOperator.solve(graph=False)``) and the one-process
  mesh's; f64 within 1e-12 of the JAX package's ``cg_solve_sharded`` /
  ``cg_solve_sharded_2d`` on as many CPU devices (f32: the same iterations);
- every rank makes the same sequence of exchanges and sums, in the number the iterations
  give, with k odd (tol 1e-3: 9 iterations at g = 16), k even (tol 1e-6: 16) and k
  stopped by ``max_iters`` (5);
- the allocation-free forms: ``sum_in_shard_order(flat, out=)`` and the device form of
  ``_allsum`` (the NCCL one, here over the gloo group, which gathers CPU tensors into one
  as NCCL does on a card) give the old forms' bits on seeded partials of 2, 4 and 8
  shards, and under a rewound ``_launch.Workspace`` hand out the recorded buffers;
- refusals: ``graph=True`` on gloo ranks raises ValueError naming the transport, for a
  rank's one band and for a mesh across ranks; ``per_shard=True`` on a rank's one band.

The spawned ranks import this module, so it imports JAX and the JAX package only inside
its tests.
"""

import functools
import operator

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from tpusparse_torch import dist
from tpusparse_torch.kernels import _launch
from tpusparse_torch.solvers import cg_sharded

RANKS, G = 2, 16
# name -> (rank mesh: None for one band a rank, N bands or (R, C) blocks; mode, dtype)
CASES = {f"{split} {loop} {dt}": (shape, mode, dt)
         for split, shape in (("1 band", None), ("2 bands", 4), ("2x2 blocks", (2, 2)))
         for loop, mode in (("classic", "stencil5"), ("recompute", "stencil5-const"))
         for dt in ("float64", "float32")
         if not (shape == (2, 2) and loop == "recompute")}
# the solves whose calls every rank must make alike: name -> (tolerance, max_iters, k)
STOPS = {"k odd": (1e-3, 1000, 9), "k even": (1e-6, 1000, 16), "max_iters": (1e-6, 5, 5)}
SUMS = [(dtype, n) for dtype in ("float64", "float32") for n in (2, 4, 8)]


def _operator(shape, mode, dtype):
    """This rank's operator of a case, and the rank mesh that its graph runs on."""
    if shape is None:
        op = cg_sharded.make_sharded_operator(G, mode=mode, dtype=dtype, device="cpu")
        return op, cg_sharded.rank_mesh(op)
    mop = cg_sharded.make_mesh_operator(G, dist.make_rank_mesh(shape, devices="cpu"),
                                        mode=mode, dtype=dtype)
    return mop, mop


def _gather(shape, xs):
    """The rank's fields of a solve (a tuple, shard order) gathered to rank 0's host."""
    if isinstance(shape, tuple):
        return dist.gather_blocks_to_host(list(xs), shape)
    return dist.gather_to_host(torch.cat(list(xs)), rows=G)


def _graph_solve(mop, tolerance=1e-6, max_iters=1000):
    loop = cg_sharded.MeshLoop(mop, cg_sharded._pick_loop(mop, None), max_iters, tolerance,
                               graphed=True)
    xs, k, _rr, _bb = loop.solve()
    return xs, k


def _logged(calls):
    """Wrap ``_allsum`` and ``_RankLink.start`` to append what each call passes."""
    allsum, start = cg_sharded._allsum, cg_sharded._RankLink.start

    def logged_allsum(*parts, group=None):
        calls.append(("sum", len(parts), str(parts[0].dtype)))
        return allsum(*parts, group=group)

    def logged_start(self, firsts, lasts, fields=None):
        calls.append(("exchange", len(self.pieces)))
        return start(self, firsts, lasts, fields)

    cg_sharded._allsum, cg_sharded._RankLink.start = logged_allsum, logged_start
    return lambda: (setattr(cg_sharded, "_allsum", allsum),
                    setattr(cg_sharded._RankLink, "start", start))


def _partials(dtype, n):
    rng = np.random.default_rng(2000 + n)
    return torch.from_numpy(rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).to(
        getattr(torch, dtype))


def _old_allsum(*parts):
    """``_allsum``'s form before it took a workspace's buffers: stacked, gathered by
    gloo, concatenated, summed from a clone."""
    local = torch.stack([t.reshape(()) for t in parts])
    every = [torch.empty_like(local) for _ in range(dist.world_size())]
    tdist.all_gather(every, local)
    flat = torch.cat(every)
    total = flat[0].clone()
    for t in flat[1:]:
        total += t
    return total


def _rank(device):
    del device
    out = {"cases": {}, "calls": {}, "sums": {}, "refusals": {}}
    for name, (shape, mode, dt) in CASES.items():
        dtype = getattr(torch, dt)
        op, mop = _operator(shape, mode, dtype)
        xs, k = _graph_solve(mop)
        if shape is None:
            x_e, s_e = cg_sharded.cg_solve_sharded(G, operator=op)
            xs_e = (x_e,)
        else:
            xs_e, s_e = op.solve(graph=False)
        out["cases"][name] = (_gather(shape, xs), k, _gather(shape, xs_e), s_e.iterations)
        cg_sharded.clear_caches()
    for name, (tol, max_iters, _k) in STOPS.items():
        for split, shape in (("1 band", None), ("2x2 blocks", (2, 2))):
            _op, mop = _operator(shape, "stencil5", torch.float64)
            calls = []
            restore = _logged(calls)
            try:
                _xs, k = _graph_solve(mop, tol, max_iters)
            finally:
                restore()
            out["calls"][(name, split)] = dist._all_objects((k, calls))
            cg_sharded.clear_caches()
    for dtype, n in SUMS:
        flat = _partials(dtype, n)
        per = n // dist.world_size()
        mine = list(flat[dist.rank() * per:(dist.rank() + 1) * per])
        ws = _launch.Workspace("cpu")
        with _launch.use(ws):
            recorded = cg_sharded._allsum(*mine, group=tdist.group.WORLD)
        ws.rewind()
        with _launch.use(ws):
            again = cg_sharded._allsum(*mine, group=tdist.group.WORLD)
        out["sums"][(dtype, n)] = dist._all_objects(
            (recorded.item(), again.item(), again.data_ptr() == recorded.data_ptr(),
             len(ws.buffers), _old_allsum(*mine).item(),
             cg_sharded._allsum(*mine).item()))
    op, mop = _operator(None, "stencil5", torch.float64)
    rmesh = cg_sharded.make_mesh_operator(G, dist.make_rank_mesh(4, devices="cpu"))
    for what, call in (("band graph=True", lambda: cg_sharded.cg_solve_sharded(
                            G, operator=op, graph=True)),
                       ("band per_shard=True", lambda: cg_sharded.cg_solve_sharded(
                           G, operator=op, per_shard=True)),
                       ("mesh graph=True", lambda: rmesh.solve(graph=True))):
        try:
            call()
            out["refusals"][what] = None
        except ValueError as e:
            out["refusals"][what] = str(e)
    cg_sharded.clear_caches()
    return out if dist.rank() == 0 else None


@pytest.fixture(scope="module")
def ranks():
    return dist.launch_local(_rank, RANKS, device="cpu")


def _one_process(shape, mode, dtype):
    mesh = (dist.make_mesh(shape, devices="cpu") if isinstance(shape, tuple)
            else dist.make_band_mesh(shape, devices="cpu"))
    op = cg_sharded.make_mesh_operator(G, mesh, mode=mode, dtype=getattr(torch, dtype))
    xs, s = op.solve()
    x = op.assemble(xs).numpy()
    cg_sharded.clear_caches()
    return x, s.iterations


def _jax(shape, mode, dtype):
    import jax
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded as jcs

    dt = {"float64": jnp.float64, "float32": jnp.float32}[dtype]
    if isinstance(shape, tuple):
        mesh = jax.make_mesh(shape, ("x", "y"), devices=jax.devices()[:int(np.prod(shape))])
        x, s = jcs.cg_solve_sharded_2d(mesh, G, mode=mode, dtype=dt)
    else:
        n = RANKS if shape is None else shape
        mesh = jax.make_mesh((n,), ("x",), devices=jax.devices()[:n])
        x, s = jcs.cg_solve_sharded(mesh, G, mode=mode, dtype=dt)
    return np.asarray(x, np.float64), s


@pytest.mark.parametrize("name", list(CASES))
def test_rank_graph_equals_eager_ranks(ranks, name):
    x, k, x_eager, k_eager = ranks["cases"][name]
    assert k == k_eager and x.shape == (G, G)
    np.testing.assert_array_equal(x, x_eager)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_graph_equals_one_process_mesh(ranks, name):
    x, k, _x_eager, _k_eager = ranks["cases"][name]
    shape, mode, dtype = CASES[name]
    if shape is None:  # one band a rank: the one-process mesh of as many bands
        shape = RANKS
    want, k_want = _one_process(shape, mode, dtype)
    assert k == k_want
    np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_graph_matches_jax(ranks, name):
    x, k, _x_eager, _k_eager = ranks["cases"][name]
    shape, mode, dtype = CASES[name]
    xj, sj = _jax(shape, mode, dtype)
    assert sj.converged and k == sj.iterations
    if dtype == "float64":
        np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("split", ["1 band", "2x2 blocks"])
@pytest.mark.parametrize("stop", list(STOPS))
def test_every_rank_makes_the_same_calls(ranks, stop, split):
    """One exchange and two sums an iteration, one sum at the start (<r0, r0>), on every
    rank in one order; a k the IF node cuts short (odd) included."""
    every = ranks["calls"][(stop, split)]
    (k, calls), = set((k, tuple(c)) for k, c in every)
    assert k == STOPS[stop][2]
    assert sum(c[0] == "exchange" for c in calls) == k
    assert sum(c[0] == "sum" for c in calls) == 2 * k + 1
    assert calls[0][0] == "sum" and calls[1][0] == "exchange"


@pytest.mark.parametrize("dtype,n", SUMS)
def test_allocation_free_sums_give_the_old_bits(ranks, dtype, n):
    flat = _partials(dtype, n)
    left_to_right = functools.reduce(operator.add, flat.numpy())
    out = torch.empty((), dtype=flat.dtype)
    assert cg_sharded.sum_in_shard_order(flat, out=out) is out
    assert out.item() == float(left_to_right) == cg_sharded.sum_in_shard_order(flat).item()
    for recorded, again, same_buffer, buffers, old, gloo in ranks["sums"][(dtype, n)]:
        assert recorded == again == old == gloo == out.item()
        assert same_buffer and buffers == 3  # the gather buffers and the sum, once


@pytest.mark.parametrize("what", ["band graph=True", "band per_shard=True",
                                  "mesh graph=True"])
def test_rank_graph_refusals(ranks, what):
    msg = ranks["refusals"][what]
    assert msg is not None
    if "graph=True" in what:
        assert "over gloo" in msg and "NCCL" in msg
    else:
        assert "per-card loop" in msg


class _Clock:
    """A clock that moves ``tick`` seconds each time it is read."""

    def __init__(self, tick):
        self.now, self.tick = 0.0, tick

    def __call__(self):
        self.now += self.tick
        return self.now


# name -> (k at each poll; the watch's answer): a bound of 1 s, a poll a tick of 0.01 s
WATCHES = {
    # 20 s of iterations, one each 0.5 s: a solve twenty bounds long that never stalls
    "long solve": ([i // 50 for i in range(2000)], True),
    # no read has come yet at some polls: only a new value counts as an iteration's end
    "reads in flight": ([None if i % 3 else i // 30 for i in range(1500)], True),
    "stall at the start": ([0] * 2000, False),
    "stall midway": ([min(i // 20, 7) for i in range(2000)], False),
}


@pytest.mark.parametrize("name", list(WATCHES))
def test_watch_bounds_a_stall_not_a_solve(name):
    """``cg_sharded._watch``, the wait of a rank's replay: a solve of any length passes
    while k advances within the bound; k that stays put for the bound fails the wait,
    within a poll of it."""
    ks, want = WATCHES[name]
    clock, polls, changed = _Clock(0.01), iter(ks), []

    def progress():
        k = next(polls)
        if k is not None and (not changed or k != changed[-1][0]):
            changed.append((k, clock.now))
        return k

    done = iter([False] * (len(ks) - 1) + [True]).__next__
    assert cg_sharded._watch(done, progress, 1.0, poll_s=0.0, clock=clock) is want
    if not want:  # it gave up a bound after k last changed, within a tick
        assert 1.0 < clock.now - changed[-1][1] <= 1.0 + 0.01 + 1e-9


@pytest.mark.parametrize("where", ["outside a group", "off the cards"])
def test_nccl_transport_refusals(where):
    """``transport="nccl"`` (the one-rank NCCL group a single card runs a graph a rank
    in) raises ValueError off the cards or outside a group, before any group is made."""
    if where == "outside a group":
        assert not tdist.is_initialized()
        device = "cuda:0"
    else:
        device = "cpu"
    with pytest.raises(ValueError, match="transport='nccl'"):
        dist.device_group(device, "nccl")
    with pytest.raises(ValueError, match="'nccl'"):
        dist.device_group("cpu", "mpi")
