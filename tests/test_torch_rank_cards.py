"""A graph a card for ranks that drive several cards (``cg_sharded.RankCardLoop``): a mesh
across ranks whose rank holds shards on cards of its own, each card replaying its own CUDA
graph, the rank's cards meeting through ``kernels/mesh_sync.py`` and the ranks through
the link's calls in the home card's graph only (the JAX package's multi-host solve, one
compiled ``while_loop`` a process over its local devices).

Here, on the CPU, 2 gloo ranks (``dist.launch_local``) each drive 2 model cards (one
shard a card, ``loop.card_of``): each card's program is a coroutine stopped at its sync
ops, interleaved on its rank (``CardLoop._run_host``), and the home card's program makes
the link's gloo calls (its exchange, its all-gather and ordered sum) where the card makes
NCCL's.  One group of ranks runs every case of the file (the ``ranks`` fixture).  Bars:

- parity, for 4 bands (the classic and the recompute loop) and 2 × 2 blocks (classic),
  f64 and f32, at g = 16 and 24: x and k bit for bit the eager rank loop's
  (``MeshOperator.solve(graph=False)``) and the one-process mesh's; f64 within 1e-12 of
  the JAX package's ``cg_solve_sharded`` / ``cg_solve_sharded_2d`` on as many CPU devices
  (f32: the same iterations); one read a solve (``cg.COUNTS``) and the eager loop's halo
  counts (``HALO_CALLS``);
- every rank makes the same link calls, from its home card only: one exchange and two
  sums an iteration, with k odd (tol 1e-3: 9 iterations at g = 16), k even (tol 1e-6:
  16) and k stopped by ``max_iters`` (5);
- the protocol under SEEDS seeded random schedules of each rank's model cards (bands
  classic and recompute, 2 × 2 blocks, and both shards on one model card): every read of a
  halo row and every wait checks its epoch (a flag beyond it, or short of it where data
  is read, raises), x bit for bit the eager loop's under every schedule;
- a withheld card (rank 0's off-home shard): rank 0 raises naming the waits that passed
  their bound, rank 1 raises on the NaN sums its gather brought, both at once (the model's
  bound passes when every card waits); a withheld rank (rank 1 runs no program): rank 0
  raises within the timeout of the group its link calls go through (BOUND_S) plus a
  second, rank 1 returns having run no iteration;
- refusals: ``graph=True`` on the gloo ranks (the host steps them) and ``per_shard=True``.

The spawned ranks import this module, so it imports JAX and the JAX package only inside
its tests.
"""

import datetime
import random
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from tpusparse_torch import dist
from tpusparse_torch.solvers import cg, cg_sharded

RANKS = 2
SEEDS = 50
BOUND_S = 2.0
# name -> (grid, rank mesh: N bands or (R, C) blocks, mode, dtype)
CASES = {f"g{g} {split} {loop} {dt}": (g, shape, mode, dt)
         for g in (16, 24)
         for split, shape in (("4 bands", 4), ("2x2 blocks", (2, 2)))
         for loop, mode in (("classic", "stencil5"), ("recompute", "stencil5-const"))
         for dt in ("float64", "float32")
         if not (shape == (2, 2) and loop == "recompute")}
# the solves whose link calls every rank must make alike: name -> (tolerance, max_iters, k)
STOPS = {"k odd": (1e-3, 1000, 9), "k even": (1e-6, 1000, 16), "max_iters": (1e-6, 5, 5)}
SPLITS = {"4 bands": 4, "2x2 blocks": (2, 2)}
# schedules: name -> (rank mesh, mode, model cards of the rank's two shards)
SCHEDULES = {
    "bands classic": (4, "stencil5", (0, 1)),
    "bands recompute": (4, "stencil5-const", (0, 1)),
    "2x2 blocks": ((2, 2), "stencil5", (0, 1)),
    "bands on one card": (4, "stencil5", (0, 0)),
}
SCHEDULE_ITERS = 4


def _mesh_operator(g, shape, mode, dtype):
    return cg_sharded.make_mesh_operator(g, dist.make_rank_mesh(shape, devices="cpu"),
                                         mode=mode, dtype=getattr(torch, dtype))


def _loop(mop, tolerance=1e-6, max_iters=1000):
    return cg_sharded.RankCardLoop(mop, cg_sharded._pick_loop(mop, None), max_iters,
                                   tolerance)


def _gather(shape, xs):
    """The rank's fields of a solve (shard order) gathered to rank 0's host."""
    if isinstance(shape, tuple):
        return dist.gather_blocks_to_host(list(xs), shape)
    return dist.gather_to_host(torch.cat(list(xs)), rows=0)


def _counted(fn):
    """fn()'s result, the cg.COUNTS and HALO_CALLS it made."""
    cg.reset_counts()
    cg_sharded.reset_halo_calls()
    out = fn()
    return out, dict(cg.COUNTS), dict(cg_sharded.HALO_CALLS)


def _cases():
    out = {}
    for name, (g, shape, mode, dt) in CASES.items():
        mop = _mesh_operator(g, shape, mode, dt)
        (xs_e, s_e), _c, halo_e = _counted(lambda: mop.solve(graph=False))
        (xs, k, _rr, _bb), counts, halo = _counted(lambda: _loop(mop).solve())
        out[name] = (_gather(shape, xs), k, _gather(shape, xs_e), s_e.iterations,
                     dist._all_objects((counts, halo == halo_e)))
        cg_sharded.clear_caches()
    return out


def _calls():
    """Each stop's iterations, the link calls of every rank in order, and the model cards
    whose programs made link calls."""
    out = {}
    cls = cg_sharded.RankCardLoop
    rows, total, between = cls._link_rows, cls._link_sum, cls._between
    for stop, (tol, max_iters, _k) in STOPS.items():
        for split, shape in SPLITS.items():
            loop = _loop(_mesh_operator(16, shape, "stencil5", "float64"), tol, max_iters)
            calls, cards = [], set()

            def on(kind, fn):
                def logged(self, *args):
                    calls.append(kind)
                    return fn(self, *args)
                return logged

            def linked(self, members, point):
                ops = list(between(self, members, point))
                if ops:
                    cards.add(self.card_of[members[0].index])
                return ops

            cls._link_rows, cls._link_sum = on("exchange", rows), on("sum", total)
            cls._between = linked
            try:
                _xs, k, _rr, _bb = loop.solve()
            finally:
                cls._link_rows, cls._link_sum, cls._between = rows, total, between
            out[(stop, split)] = dist._all_objects((k, calls, sorted(cards)))
            cg_sharded.clear_caches()
    return out


def _schedules():
    out = {}
    for name, (shape, mode, cards) in SCHEDULES.items():
        mop = _mesh_operator(16, shape, mode, "float64")
        want, s0 = mop.solve(graph=False, max_iters=SCHEDULE_ITERS)
        loop = _loop(mop, max_iters=SCHEDULE_ITERS)
        loop.card_of = cards
        same, ks = [], set()
        for seed in range(SEEDS):
            loop.schedule = random.Random(1000 * dist.rank() + seed)
            xs, k, _rr, _bb = loop.solve()
            same.append(all(torch.equal(a, b) for a, b in zip(xs, want)))
            ks.add(k)
        errors = [int(p.ctl[1]) for p in loop.parts] + [int(loop.lctl[1])]
        epochs = {int(p.ctl[0]) for p in loop.parts} | {int(loop.lctl[0])}
        out[name] = dist._all_objects((all(same), sorted(ks), s0.iterations, errors,
                                       sorted(epochs), len(loop.cards())))
        cg_sharded.clear_caches()
    return out


def _withheld():
    """A withheld card on rank 0, then a withheld rank (rank 1), on 4 bands: each rank's
    (error or None, seconds, iterations), and a later solve of a fresh loop."""
    mop = _mesh_operator(16, 4, "stencil5", "float64")
    out = {}
    for what in ("card", "rank"):
        loop = _loop(mop)
        loop.solve()  # a first solve, every card and rank in it
        if what == "card":
            loop.withheld = 1 if dist.rank() == 0 else None  # rank 0's off-home card
        else:
            loop.group = tdist.new_group(backend="gloo",
                                         timeout=datetime.timedelta(seconds=BOUND_S))
            loop.rank_withheld = dist.rank() == 1
        dist.barrier()
        t0 = time.perf_counter()
        try:
            _xs, k, _rr, _bb = loop.solve()
            err = None
        except RuntimeError as e:
            err, k = str(e), None
        out[what] = dist._all_objects((err, time.perf_counter() - t0, k))
        dist.barrier()
    out["after"] = dist._all_objects(_loop(mop).solve()[1])
    cg_sharded.clear_caches()
    return out


def _refusals():
    out = {}
    mop = _mesh_operator(16, 4, "stencil5", "float64")
    for what, call in (("graph=True", lambda: mop.solve(graph=True)),
                       ("per_shard=True", lambda: mop.solve(per_shard=True))):
        try:
            call()
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    cg_sharded.clear_caches()
    return out


def _rank(device):
    del device
    out = {"cases": _cases(), "calls": _calls(), "schedules": _schedules(),
           "withheld": _withheld(), "refusals": _refusals()}
    return out if dist.rank() == 0 else None


@pytest.fixture(scope="module")
def ranks():
    return dist.launch_local(_rank, RANKS, device="cpu")


def _one_process(g, shape, mode, dtype):
    mesh = (dist.make_mesh(shape, devices="cpu") if isinstance(shape, tuple)
            else dist.make_band_mesh(shape, devices="cpu"))
    op = cg_sharded.make_mesh_operator(g, mesh, mode=mode, dtype=getattr(torch, dtype))
    xs, s = op.solve()
    x = op.assemble(xs).numpy()
    cg_sharded.clear_caches()
    return x, s.iterations


def _jax(g, shape, mode, dtype):
    import jax
    import jax.numpy as jnp

    from tpusparse.solvers import cg_sharded as jcs

    dt = {"float64": jnp.float64, "float32": jnp.float32}[dtype]
    if isinstance(shape, tuple):
        mesh = jax.make_mesh(shape, ("x", "y"), devices=jax.devices()[:int(np.prod(shape))])
        x, s = jcs.cg_solve_sharded_2d(mesh, g, mode=mode, dtype=dt)
    else:
        mesh = jax.make_mesh((shape,), ("x",), devices=jax.devices()[:shape])
        x, s = jcs.cg_solve_sharded(mesh, g, mode=mode, dtype=dt)
    return np.asarray(x, np.float64), s


@pytest.mark.parametrize("name", list(CASES))
def test_rank_cards_equal_eager_ranks(ranks, name):
    """x and k bit for bit the eager rank loop's; one read a solve on every rank and the
    eager loop's halo counts."""
    x, k, x_eager, k_eager, every = ranks["cases"][name]
    g = CASES[name][0]
    assert k == k_eager and x.shape == (g, g)
    np.testing.assert_array_equal(x, x_eager)
    # the loop called itself: no solver opened a solve (``cg.solve_scope``)
    assert every == [({"host_reads": 1, "replays": 0, "solves": 0, "captures": 0}, True)] * RANKS


@pytest.mark.parametrize("name", list(CASES))
def test_rank_cards_equal_one_process_mesh(ranks, name):
    x, k, _x_eager, _k_eager, _every = ranks["cases"][name]
    want, k_want = _one_process(*CASES[name])
    assert k == k_want
    np.testing.assert_array_equal(x, want)


@pytest.mark.parametrize("name", list(CASES))
def test_rank_cards_match_jax(ranks, name):
    """f64 within 1e-12 (relative, 1e-14 absolute) of the JAX package's sharded solver on
    as many CPU devices; f32 in the same iterations."""
    x, k, _x_eager, _k_eager, _every = ranks["cases"][name]
    xj, sj = _jax(*CASES[name])
    assert sj.converged and k == sj.iterations
    if CASES[name][3] == "float64":
        np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("stop", list(STOPS))
def test_link_calls_alike_on_every_rank_from_the_home_card(ranks, stop, split):
    """One exchange and two sums an iteration, in that order, all made by the home card
    (model card 0), the same on every rank; a k the IF node cuts short (odd) included."""
    every = ranks["calls"][(stop, split)]
    (k, calls, cards), = set((k, tuple(c), tuple(h)) for k, c, h in every)
    assert k == STOPS[stop][2]
    assert calls == ("exchange", "sum", "sum") * k and cards == (0,)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_protocol_holds_under_random_schedules(ranks, name):
    """Each rank's model cards interleaved by a seeded random scheduler, SEEDS seeds: no
    wait or halo read sees another epoch than its own (they raise if one does), x is the
    eager loop's bit for bit under every schedule, no error word is set, and every shard's
    epoch and the link's end equal."""
    cards = len(set(SCHEDULES[name][2]))
    for same, ks, k_eager, errors, epochs, n_cards in ranks["schedules"][name]:
        assert same and ks == [k_eager] == [SCHEDULE_ITERS]
        assert not any(errors) and len(epochs) == 1 and n_cards == cards


def test_withheld_card_makes_every_rank_raise(ranks):
    (err0, s0, _k0), (err1, s1, _k1) = ranks["withheld"]["card"]
    assert "passed its bound" in err0 and "shard 1" not in err0
    assert "NaN" in err1 and "rank 1" in err1
    assert s0 < 5 and s1 < 5
    assert ranks["withheld"]["after"] == [16] * RANKS


def test_withheld_rank_makes_the_other_raise_within_its_bound(ranks):
    (err0, s0, _k0), (err1, _s1, k1) = ranks["withheld"]["rank"]
    assert "rank 0" in err0 and "never came" in err0
    assert BOUND_S <= s0 < BOUND_S + 1
    assert err1 is None and k1 == 0


@pytest.mark.parametrize("what", ["graph=True", "per_shard=True"])
def test_rank_cards_refusals(ranks, what):
    msg = ranks["refusals"][what]
    assert msg is not None
    if what == "graph=True":
        assert "over gloo" in msg and "NCCL" in msg
    else:
        assert "per-card loop" in msg
