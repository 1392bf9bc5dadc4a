"""The transport between ranks (``dist.device_group``): NCCL card to card where every rank
has cards of its own, gloo through the host elsewhere.

On the CPU (here): ranks on the CPU get no device group and report ``gloo``, and the one
ordered sum that both transports call (``cg_sharded.sum_in_shard_order``) gives
``_allsum``'s bits, the partials added left to right in global shard order, on seeded f64
and f32 partials of 2, 4 and 8 shards across 2 ranks.

On two cards or more (``cuda``-marked; they skip below two cards, and need no JAX): 2
ranks, each on a card of its own, solve at g = 256 over NCCL and over gloo (``transport=
"gloo"``) on the same cards, one band a rank (the classic and the recompute loop), a 2 × 2
mesh as a rank mesh (2 blocks a rank, rows crossing the ranks) and 4 bands as a rank mesh
(2 a rank): transport ``nccl``, and x and the iterations bit for bit the gloo transport's.
The graph a rank (NCCL's calls captured into each rank's CUDA graph, ``cg_sharded.
MeshLoop``), one band a rank in both loops and the 2 × 2 rank mesh: x and the iterations
bit for bit the eager NCCL loop's (``graph=False``), one replay and one host read a rank
a solve (``cg.COUNTS``); a rank that never replays its graph (``withheld``) makes the
other raise RuntimeError within its bound (``RANK_WAIT_BOUND_S``, 3 s here); and a solve
LONG_ITERS iterations long passes with the bound a quarter of its time, since the bound is
on the time between iterations' ends, not on the solve's.

A graph a card for ranks that drive several cards (``cg_sharded.RankCardLoop``, NCCL's
calls in the home card's graph only): on two cards one rank drives both in a one-rank
NCCL group (``transport="nccl"``), 2 bands; on four cards 2 ranks drive 2 cards each, 4
bands (the classic and the recompute loop) and a 2 × 2 mesh.  x and the iterations bit for
bit the eager NCCL loop's and the gloo ranks' (one rank: the eager NCCL loop's and the
one-process mesh's), the eager loop's halo counts, one replay a card and one read a rank
a solve; and on four cards a rank that replays nothing (``rank_withheld``) makes the other
raise within its bound (3 s) with no hang.

The spawned ranks import this module, so it imports no JAX.
"""

import functools
import operator
import time

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.solvers import cg, cg_sharded

SUM_CASES = [(dtype, n) for dtype in ("float64", "float32") for n in (2, 4, 8)]
SUM_RANKS = 2


def _partials(dtype, n):
    rng = np.random.default_rng(1000 + n)
    return torch.from_numpy(rng.standard_normal(n) * 10.0 ** rng.integers(-6, 6, n)).to(
        getattr(torch, dtype))


def _cpu_rank(device, cases):
    """On each CPU rank: the device group, the transports a rank's operators report, and
    ``_allsum`` of this rank's share of each case's partials; rank 0 returns them."""
    mesh = dist.make_rank_mesh(4, devices="cpu")
    out = {
        "device_group": dist._all_objects(dist.device_group(device) is None),
        "halo": dist._all_objects(cg_sharded.make_sharded_operator(
            16, device=device, dtype=torch.float64).halo.transport),
        "link": dist._all_objects(cg_sharded.make_mesh_operator(
            16, mesh, dtype=torch.float64).link.transport),
        "sums": {},
    }
    cg_sharded.clear_caches()
    for dtype, n in cases:
        flat = _partials(dtype, n)
        per = n // dist.world_size()
        mine = flat[dist.rank() * per:(dist.rank() + 1) * per]
        out["sums"][(dtype, n)] = dist._all_objects(cg_sharded._allsum(*mine).item())
    return out if dist.rank() == 0 else None


@pytest.fixture(scope="module")
def cpu_ranks():
    return dist.launch_local(_cpu_rank, SUM_RANKS, SUM_CASES, device="cpu")


def test_device_group_is_none_on_cpu_ranks(cpu_ranks):
    assert cpu_ranks["device_group"] == [True] * SUM_RANKS
    assert cpu_ranks["halo"] == cpu_ranks["link"] == ["gloo"] * SUM_RANKS


def test_device_group_outside_a_group_and_its_refusal():
    assert dist.device_group("cpu") is None
    assert dist.device_group("cpu", "gloo") is None
    with pytest.raises(ValueError, match="transport is None or 'gloo'"):
        dist.device_group("cpu", "mpi")


@pytest.mark.parametrize("dtype,n", SUM_CASES)
def test_ordered_sum_gives_allsum_bits(cpu_ranks, dtype, n):
    """Every rank's ``_allsum`` of its share, the shared ordered sum of all partials, and
    numpy's left-to-right sum in the same dtype: one value, bit for bit."""
    flat = _partials(dtype, n)
    ordered = cg_sharded.sum_in_shard_order(flat)
    assert ordered.dtype == flat.dtype and ordered.shape == ()
    left_to_right = functools.reduce(operator.add, flat.numpy())
    assert ordered.item() == float(left_to_right)
    assert cpu_ranks["sums"][(dtype, n)] == [ordered.item()] * SUM_RANKS
    assert cg_sharded._allsum(*flat).item() == ordered.item()  # one rank, every partial


# --------------------------------------------------------------------------- the cards

G = 256
# name -> (rank mesh shape or None for one band a rank, mode, dtype)
CARD_CASES = {
    "bands": (None, "stencil5", "float64"),
    "bands recompute": (None, "stencil5-const", "float32"),
    "2x2 rank mesh": ((2, 2), "stencil5", "float64"),
    "4 bands rank mesh": (4, "stencil5", "float64"),
}


def _card_rank(device, case):
    """One case on this rank's card, over NCCL then over gloo: rank 0 returns ({transport:
    (x gathered, iterations)}, every rank's transports)."""
    shape, mode, dtype = CARD_CASES[case]
    dtype = getattr(torch, dtype)
    out, transports = {}, []
    for transport in (None, "gloo"):
        if shape is None:
            op = cg_sharded.make_sharded_operator(G, mode=mode, dtype=dtype, device=device,
                                                  transport=transport)
            x, s = cg_sharded.cg_solve_sharded(G, mode=mode, dtype=dtype, operator=op)
            x = dist.gather_to_host(x, rows=G)
            transports.append(op.halo.transport)
        else:
            n = int(np.prod(shape))
            per = n // dist.world_size()
            mesh = dist.make_rank_mesh(shape, devices=[f"cuda:{i // per}" for i in range(n)])
            op = cg_sharded.make_mesh_operator(G, mesh, mode=mode, dtype=dtype,
                                               transport=transport)
            xs, s = op.solve()
            x = op.assemble(xs)
            x = (dist.gather_blocks_to_host(x, shape) if isinstance(shape, tuple)
                 else dist.gather_to_host(x, rows=G))
            transports.append(op.link.transport)
        out[transport or "nccl"] = (x, s.iterations)
        cg_sharded.clear_caches()
    every = dist._all_objects(transports)
    return (out, every) if dist.rank() == 0 else None


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available() or torch.cuda.device_count() < 2,
                    reason="NCCL between ranks needs two cards, a rank on each")
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_nccl_ranks_equal_gloo_ranks(case):
    out, transports = dist.launch_local(_card_rank, 2, case, device="cuda")
    assert transports == [["nccl", "gloo"]] * 2
    (x, k), (x_gloo, k_gloo) = out["nccl"], out["gloo"]
    assert k == k_gloo and x.shape == (G, G)
    np.testing.assert_array_equal(x, x_gloo)


# name -> (rank mesh shape or None for one band a rank, mode, dtype)
GRAPH_CASES = {
    "band classic": (None, "stencil5", "float64"),
    "band recompute": (None, "stencil5-const", "float32"),
    "2x2 rank mesh": ((2, 2), "stencil5", "float64"),
}
BOUND_S = 3.0
LONG_ITERS = 3000  # tolerance 0: max_iters ends the solve


def _graph_rank(device, case):
    """One case on this rank's card over NCCL, from the graph a rank and eagerly: rank 0
    returns ({loop: (x gathered, iterations)}, every rank's cg.COUNTS a graph solve)."""
    shape, mode, dtype = GRAPH_CASES[case]
    dtype = getattr(torch, dtype)
    if shape is None:
        op = cg_sharded.make_sharded_operator(G, mode=mode, dtype=dtype, device=device)

        def solve(graph):
            x, s = cg_sharded.cg_solve_sharded(G, operator=op, graph=graph)
            return dist.gather_to_host(x, rows=G), s.iterations
    else:
        per = int(np.prod(shape)) // dist.world_size()
        mesh = dist.make_rank_mesh(shape, devices=[f"cuda:{i // per}"
                                                   for i in range(int(np.prod(shape)))])
        op = cg_sharded.make_mesh_operator(G, mesh, mode=mode, dtype=dtype)

        def solve(graph):
            xs, s = op.solve(graph=graph)
            return dist.gather_blocks_to_host(op.assemble(xs), shape), s.iterations
    out = {"eager": solve(False)}
    solve(None)  # the first graph solve captures
    cg.reset_counts()
    out["graph"] = solve(None)
    counts = dist._all_objects(dict(cg.COUNTS))
    cg_sharded.clear_caches()
    return (out, counts) if dist.rank() == 0 else None


def _withheld_rank(device):
    """Two graph solves, the second without rank 1's replay: rank 0 returns (its error,
    the seconds it waited), rank 1 having stayed out."""
    cg_sharded.RANK_WAIT_BOUND_S = BOUND_S
    op = cg_sharded.make_sharded_operator(G, mode="stencil5", dtype=torch.float64,
                                          device=device)
    cg_sharded.cg_solve_sharded(G, operator=op)  # both ranks: the capture and a replay
    (loop,) = cg_sharded.rank_mesh(op).graphs.values()
    loop.withheld = dist.rank() == 1
    t0 = time.perf_counter()
    try:
        cg_sharded.cg_solve_sharded(G, operator=op)
        err = None
    except RuntimeError as e:
        err = str(e)
    waited = time.perf_counter() - t0
    every = dist._all_objects((err, waited))
    del op, loop
    cg_sharded.clear_caches()  # the captured graphs go before the group does
    return every if dist.rank() == 0 else None


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_rank_graph_equals_eager_nccl_ranks(case):
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("a graph a rank over NCCL needs two cards, a rank on each")
    out, counts = dist.launch_local(_graph_rank, 2, case, device="cuda")
    (x, k), (x_eager, k_eager) = out["graph"], out["eager"]
    assert k == k_eager and x.shape == (G, G)
    np.testing.assert_array_equal(x, x_eager)
    assert counts == [{"host_reads": 1, "replays": 1, "solves": 1, "captures": 0}] * 2


@pytest.mark.cuda
def test_rank_that_never_replays_makes_the_other_raise():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("a graph a rank over NCCL needs two cards, a rank on each")
    (err, waited), (err1, _w1) = dist.launch_local(_withheld_rank, 2, device="cuda")
    assert err is not None and "rank 0" in err and "bound" in err and err1 is None
    assert BOUND_S <= waited < BOUND_S + 10


def _long_rank(device):
    """A graph solve of LONG_ITERS iterations, then again with each rank's bound a quarter
    of that solve's time: rank 0 returns every rank's (error or None, the solve's seconds,
    the bound, both iteration counts, x bit for bit the same)."""
    op = cg_sharded.make_sharded_operator(G, mode="stencil5", dtype=torch.float64,
                                          device=device)

    def solve():
        return cg_sharded.cg_solve_sharded(G, operator=op, tolerance=0.0,
                                           max_iters=LONG_ITERS)

    solve()  # the capture
    (loop,) = cg_sharded.rank_mesh(op).graphs.values()
    dist.barrier()
    t0 = time.perf_counter()
    x, s = solve()
    took = time.perf_counter() - t0
    x, loop.bound_s = x.cpu(), took / 4
    dist.barrier()
    try:
        x2, s2 = solve()
        err, k2, same = None, s2.iterations, bool(torch.equal(x2.cpu(), x))
    except RuntimeError as e:
        err, k2, same = str(e), None, False
    every = dist._all_objects((err, took, loop.bound_s, s.iterations, k2, same))
    del op, loop
    cg_sharded.clear_caches()
    return every if dist.rank() == 0 else None


@pytest.mark.cuda
def test_long_rank_graph_solve_passes_a_bound_shorter_than_it():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("a graph a rank over NCCL needs two cards, a rank on each")
    for err, took, bound, k, k2, same in dist.launch_local(_long_rank, 2, device="cuda"):
        assert err is None and same and k == k2 >= 1000
        assert took > 2 * bound > 0


# a graph a card for ranks that drive several cards: name -> (ranks, rank mesh: N bands or
# (R, C) blocks, shard i on card i; mode, dtype)
RANK_CARD_CASES = {
    "1 rank x 2 cards, 2 bands": (1, 2, "stencil5", "float64"),
    "2 ranks x 2 cards, 4 bands": (2, 4, "stencil5", "float64"),
    "2 ranks x 2 cards, 4 bands recompute": (2, 4, "stencil5-const", "float32"),
    "2 ranks x 2 cards, 2x2": (2, (2, 2), "stencil5", "float64"),
}


def _rank_cards_rank(device, case):
    """One case of RANK_CARD_CASES on this rank's cards: the eager NCCL loop, then the
    gloo ranks (one rank: the one-process mesh's per-card loop), then the graph a card
    (a first solve capturing, then one counted).  Rank 0 returns ({leg: (x gathered,
    iterations)}, every rank's (cg.COUNTS of the counted graph solve, the graph's halo
    counts equal to the eager loop's, whether a ``RankCardLoop`` ran it))."""
    del device
    _w, shape, mode, dtype = RANK_CARD_CASES[case]
    n = int(np.prod(shape))
    mesh = dist.make_rank_mesh(shape, devices=[f"cuda:{i}" for i in range(n)])
    one = dist.world_size() == 1

    def solve(transport, **kw):
        op = cg_sharded.make_mesh_operator(G, mesh, mode=mode, dtype=getattr(torch, dtype),
                                           transport=transport)
        cg_sharded.reset_halo_calls()
        xs, s = op.solve(**kw)
        x = op.assemble(xs)
        x = (dist.gather_blocks_to_host(x, shape) if isinstance(shape, tuple)
             else dist.gather_to_host(x, rows=G))
        return op, (x, s.iterations), dict(cg_sharded.HALO_CALLS)

    out = {}
    _op, out["eager"], halo_eager = solve("nccl", graph=False)
    _op, out["gloo"], _h = solve(None if one else "gloo",
                                 **({"per_shard": True} if one else {"graph": False}))
    op, _first, _h = solve("nccl")  # the capture
    cg.reset_counts()
    _op, out["graph"], halo = solve("nccl")
    every = dist._all_objects((dict(cg.COUNTS), halo == halo_eager,
                               any(isinstance(lp, cg_sharded.RankCardLoop)
                                   for lp in op.graphs.values())))
    del op, _op
    cg_sharded.clear_caches()
    return (out, every) if dist.rank() == 0 else None


def _rank_cards_withheld(device):
    """2 ranks x 2 cards, 4 bands: two graph solves, the second without rank 1's replays:
    every rank's (its error, the seconds it waited)."""
    del device
    cg_sharded.RANK_WAIT_BOUND_S = BOUND_S
    mesh = dist.make_rank_mesh(4, devices=[f"cuda:{i}" for i in range(4)])
    op = cg_sharded.make_mesh_operator(G, mesh, mode="stencil5", dtype=torch.float64)
    op.solve()  # both ranks: the capture and a replay
    (loop,) = op.graphs.values()
    loop.rank_withheld = dist.rank() == 1
    t0 = time.perf_counter()
    try:
        op.solve()
        err = None
    except RuntimeError as e:
        err = str(e)
    waited = time.perf_counter() - t0
    every = dist._all_objects((err, waited))
    del op, loop
    cg_sharded.clear_caches()  # the captured graphs go before the group does
    return every if dist.rank() == 0 else None


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RANK_CARD_CASES))
def test_rank_cards_graph_equals_eager_nccl_and_gloo(case):
    ranks, shape, _mode, _dtype = RANK_CARD_CASES[case]
    cards = int(np.prod(shape))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        pytest.skip(f"{ranks} rank(s) driving 2 cards each need {cards} cards")
    out, every = dist.launch_local(_rank_cards_rank, ranks, case, device="cuda")
    (x, k), (x_eager, k_eager), (x_gloo, k_gloo) = out["graph"], out["eager"], out["gloo"]
    assert k == k_eager == k_gloo and x.shape == (G, G)
    np.testing.assert_array_equal(x, x_eager)
    np.testing.assert_array_equal(x, x_gloo)
    assert every == [({"host_reads": 1, "replays": cards // ranks, "solves": 1,
                       "captures": 0}, True, True)] * ranks


@pytest.mark.cuda
def test_rank_cards_withheld_rank_makes_the_other_raise():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("2 ranks driving 2 cards each need four cards")
    (err, waited), (err1, _w1) = dist.launch_local(_rank_cards_withheld, 2, device="cuda")
    assert err is not None and "rank 0" in err and "bound" in err and err1 is None
    assert BOUND_S <= waited < BOUND_S + 10
