"""The per-card sharded CG loop (``cg_sharded.CardLoop``: a CUDA graph a card, the shards
meeting through ``kernels/mesh_sync.py``) on the CPU, against the JAX package's sharded
CG on the conftest's virtual CPU mesh and against the port's own eager mesh loop.

On the CPU the loop runs on the kernels' twins: each model card's program (its shards in
lockstep) is a coroutine that stops at every sync op, and the loop interleaves them, each
node's condition read on the host (``cg.DeviceLoop``'s structure).  ``loop.card_of`` puts
the shards on model cards (one a shard unless a test says otherwise).  f64 unless a case
says otherwise.  Bars:

- the sync twins: a publish of every shard's partial and each shard's wait sum the
  partials to ``_mesh_sum``'s bits, for 1 to 8 shards and f64, f32 and bf16-state (f32)
  partials from numpy seeds; a publish of rows and of a strided column copies them and
  raises the neighbour's flags to the epoch; a wait whose flags are short returns False
  with its bound left, and takes the error path (its code, NaN) once the bound passed;
- the protocol model: the real loop's shards interleaved by a seeded random scheduler,
  200 seeds a decomposition (bands classic, recompute and ``csr``, a 2 x 2 mesh), every
  read of a halo row or a slot checked against the epoch it expects (a flag beyond it, or
  short of it where data is read, raises), x bit for bit the same under every schedule;
  a withheld shard ends every other shard's loop in the error path, not a hang;
- the same with 4 and 8 shards on 2 model cards and 8 on 4, placed as the mesh places
  them (shard i on card i % cards), over the cards' programs (bands classic, recompute, a
  2-D mesh); a card whose shards run strictly one after another (every shard on one model
  card) finishes with no wait ever finding a flag short, where one model card a shard
  has to interleave them; a withheld shard on a shared card still ends the others' loops
  in the error path;
- the loop against JAX's ``cg_solve_sharded`` and ``cg_solve_sharded_2d`` on 1, 2 and 4
  bands (classic and recompute) and a 2 x 2 mesh: equal iterations, x to 1e-12; and bit
  for bit against the eager mesh loop there and in more cases (``csr``, const classic, a
  bf16 state, 2-D const, 1 x 4), with one read a solve and the eager loop's halo counts;
- the refusals: a pair of cards without peer access, ``per_shard`` with ``graph=False``,
  with ``use_pallas_blas1=False`` or on a gloo rank, ``graph=True`` on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.kernels import blas1, mesh_sync
from tpusparse_torch.solvers import cg, cg_sharded

F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16
SEEDS = 200


def _mesh(shape):
    return dist.make_mesh(shape, ("x", "y")[:len(shape)], devices="cpu")


# --------------------------------------------------------------------------- twins


def _partials(n, kind, seed):
    """n partials as the shards' dots make them: f64 or f32, or a bf16 state's (f32 dots
    of bf16 fields)."""
    rng = np.random.default_rng(seed)
    if kind == "bf16-state":
        fields = torch.from_numpy(rng.standard_normal((n, 2, 64))).to(BF16)
        return [blas1.dot_plain(f[0], f[1]) for f in fields]
    return list(torch.from_numpy(rng.standard_normal(n)).to(
        F64 if kind == "f64" else F32).unbind())


@pytest.mark.parametrize("kind", ["f64", "f32", "bf16-state"])
@pytest.mark.parametrize("n", range(1, 9))
def test_sum_twins_equal_mesh_sum(n, kind):
    """Every shard publishes its partial into every shard's slots; every shard's wait sums
    them in shard order: each gets ``_mesh_sum``'s bits."""
    parts = _partials(n, kind, seed=100 * n + len(kind))
    acc = parts[0].dtype
    ctls = [torch.tensor([7, 0]) for _ in range(n)]
    flags = torch.zeros((n, n), dtype=torch.int64)
    slots = torch.zeros((n, n), dtype=acc)
    for i, part in enumerate(parts):
        links = mesh_sync.partial_links([(slots[j, i], flags[j, i]) for j in range(n)], "cpu")
        assert mesh_sync.publish_partial(ctls[i], part, links)
        if i < n - 1:  # until the last partial is there, every wait finds a flag short
            assert not mesh_sync.wait(ctls[0], flags[0], (1 << n) - 1, 18, 10 ** 9,
                                      slots=slots[0], out=torch.empty((), dtype=acc))
    want = cg_sharded._mesh_sum(parts, torch.device("cpu"))
    for j in range(n):
        out = torch.empty((), dtype=acc)
        assert mesh_sync.wait(ctls[j], flags[j], (1 << n) - 1, 16 * (j + 1) + 2, 10 ** 9,
                              slots=slots[j], out=out)
        assert torch.equal(out, want) and ctls[j].tolist() == [8, 0]


@pytest.mark.parametrize("dtype", [F64, F32, BF16])
def test_row_twins_copy_rows_and_columns(dtype):
    """A publish of a row and a strided column: the neighbour's halo buffers hold them and
    its flags the epoch; its wait goes through, one for a flag that is not there waits
    while its bound lasts and then takes the error path."""
    rng = np.random.default_rng(3)
    field = torch.from_numpy(rng.standard_normal((6, 5))).to(dtype)
    row, col = torch.zeros(5, dtype=dtype), torch.zeros(6, dtype=dtype)
    flags, ctl = torch.zeros(4, dtype=torch.int64), torch.tensor([11, 0])
    links = mesh_sync.row_links([(field[-1], row, flags[0]), (field[:, 0], col, flags[3])],
                                "cpu")
    assert mesh_sync.publish_rows(ctl, links)
    assert torch.equal(row, field[-1]) and torch.equal(col, field[:, 0])
    assert flags.tolist() == [12, 0, 0, 12]
    reader = torch.tensor([11, 0])
    assert mesh_sync.wait(reader, flags, 0b1001, 17, 10 ** 9)
    mesh_sync.check_epochs(flags, 0b1001, 12)
    assert reader.tolist() == [12, 0]
    assert not mesh_sync.wait(reader, flags, 0b1001, 17, 10 ** 9)  # epoch 13 is not there
    assert reader.tolist() == [12, 0]
    out = torch.zeros((), dtype=F32)
    assert mesh_sync.wait(reader, flags, 0b1001, 17, 0, slots=torch.ones(4, dtype=F32),
                          out=out)
    assert reader.tolist() == [13, 17] and torch.isnan(out)
    with pytest.raises(RuntimeError, match="do not hold epoch"):
        mesh_sync.check_epochs(flags, 0b1001, 13)
    flags[0] = 99  # a writer ahead of its reader
    with pytest.raises(RuntimeError, match="ran ahead"):
        mesh_sync.wait(torch.tensor([11, 0]), flags, 0b0001, 17, 10 ** 9)


# --------------------------------------------------------------------------- the model

# decompositions of the protocol model: name -> (mesh shape, grid, solver arguments)
MODEL = {
    "bands classic x4": ((4,), 16, dict(mode="stencil5")),
    "bands recompute x4": ((4,), 16, dict(mode="stencil5-const")),
    "csr x3": ((3,), 12, dict(mode="csr")),
    "blocks 2x2": ((2, 2), 16, dict(mode="stencil5")),
}
MODEL_ITERS = 4


def _card_loop(op, **kw):
    """The operator's per-card loop, made by a first solve (round-robin order)."""
    op.solve(per_shard=True, max_iters=MODEL_ITERS, **kw)
    (loop,) = [lp for lp in op.graphs.values() if isinstance(lp, cg_sharded.CardLoop)]
    return loop


@pytest.mark.parametrize("name", list(MODEL))
def test_protocol_holds_under_random_schedules(name):
    """The loop's shards interleaved by a seeded random scheduler, SEEDS seeds: no read
    sees another epoch than its own (``check_epochs`` and the waits raise if one does),
    and x is the same bit for bit under every schedule."""
    shape, g, kw = MODEL[name]
    op = cg_sharded.make_mesh_operator(g, _mesh(shape), dtype=F64, **kw)
    want, s0 = op.solve(graph=False, max_iters=MODEL_ITERS)
    loop = _card_loop(op)
    for seed in range(SEEDS):
        loop.schedule = random.Random(seed)
        xs, s = op.solve(per_shard=True, max_iters=MODEL_ITERS)
        assert s.iterations == s0.iterations == MODEL_ITERS
        assert all(torch.equal(a, b) for a, b in zip(xs, want)), seed
    assert all(int(p.ctl[1]) == 0 for p in loop.parts)
    cg_sharded.clear_caches()


@pytest.mark.parametrize("name", list(MODEL))
def test_withheld_shard_ends_in_the_error_path(name):
    """A shard whose program never runs: every other shard's loop ends in the error path
    (its waits give up, NaN stops its condition) and the solve raises; the operator then
    makes a new loop, which solves."""
    shape, g, kw = MODEL[name]
    op = cg_sharded.make_mesh_operator(g, _mesh(shape), dtype=F64, **kw)
    n = op.mesh.size
    for withheld in (0, n - 1):
        loop = _card_loop(op)
        loop.withheld = withheld
        loop.schedule = random.Random(withheld)
        with pytest.raises(RuntimeError, match="passed its bound"):
            op.solve(per_shard=True, max_iters=MODEL_ITERS)
        stopped = [int(p.ctl[1]) for i, p in enumerate(loop.parts) if i != withheld]
        assert all(stopped) and int(loop.parts[withheld].ctl[1]) == 0
        assert all(c % 16 in cg_sharded.SYNC_POINTS for c in stopped)
        assert loop not in op.graphs.values()
    _xs, s = op.solve(per_shard=True, max_iters=MODEL_ITERS)
    assert s.iterations == MODEL_ITERS
    cg_sharded.clear_caches()


# shards on shared model cards: name -> (mesh shape, grid, solver arguments, model cards)
SHARED = {f"{name} on {cards}": (shape, g, kw, cards)
          for cards, cases in (
              (2, {"bands classic x4": ((4,), 16, dict(mode="stencil5")),
                   "bands recompute x4": ((4,), 16, dict(mode="stencil5-const")),
                   "blocks 2x2": ((2, 2), 16, dict(mode="stencil5")),
                   "bands classic x8": ((8,), 16, dict(mode="stencil5")),
                   "bands recompute x8": ((8,), 16, dict(mode="stencil5-const")),
                   "blocks 2x4": ((2, 4), 16, dict(mode="stencil5"))}),
              (4, {"bands classic x8": ((8,), 16, dict(mode="stencil5")),
                   "bands recompute x8": ((8,), 16, dict(mode="stencil5-const")),
                   "blocks 2x4": ((2, 4), 16, dict(mode="stencil5"))}))
          for name, (shape, g, kw) in cases.items()}


def _on_cards(loop, cards):
    """Shard i on model card i % cards, as ``dist.make_mesh`` places shards on cards."""
    loop.card_of = tuple(i % cards for i in range(len(loop.parts)))


@pytest.mark.parametrize("name", list(SHARED))
def test_protocol_holds_on_shared_cards(name):
    """Shards sharing model cards, each card's shards in lockstep, the cards' programs
    interleaved by a seeded random scheduler, SEEDS seeds: every read sees its own epoch,
    and x is the eager mesh's bit for bit in as many iterations."""
    shape, g, kw, cards = SHARED[name]
    op = cg_sharded.make_mesh_operator(g, _mesh(shape), dtype=F64, **kw)
    want, s0 = op.solve(graph=False, max_iters=MODEL_ITERS)
    loop = _card_loop(op)
    _on_cards(loop, cards)
    assert [len(c.members) for c in loop.cards()] == [op.mesh.size // cards] * cards
    for seed in range(SEEDS):
        loop.schedule = random.Random(seed)
        xs, s = op.solve(per_shard=True, max_iters=MODEL_ITERS)
        assert s.iterations == s0.iterations == MODEL_ITERS
        assert all(torch.equal(a, b) for a, b in zip(xs, want)), seed
    assert all(int(p.ctl[1]) == 0 for p in loop.parts)
    assert {int(p.ctl[0]) for p in loop.parts} == {int(loop.parts[0].ctl[0])}
    cg_sharded.clear_caches()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shards_of_a_card_need_not_run_at_once(monkeypatch, n):
    """Every shard on one model card, run strictly in order (one program, nothing to
    interleave): it finishes, x the eager mesh's bit for bit, and no wait ever finds a
    flag short.  With one model card a shard the same solve has waits that do, which
    shards sharing a card could only pass by running side by side."""
    short = []
    wait = mesh_sync.wait

    def counted(*args, **kw):
        went = wait(*args, **kw)
        short.append(not went)
        return went

    monkeypatch.setattr(mesh_sync, "wait", counted)
    op = cg_sharded.make_mesh_operator(16, _mesh((n,)), mode="stencil5", dtype=F64)
    want, s0 = op.solve(graph=False, max_iters=MODEL_ITERS)
    loop = _card_loop(op)
    for cards, blocked in ((1, False), (n, True)):
        _on_cards(loop, cards)
        short.clear()
        xs, s = op.solve(per_shard=True, max_iters=MODEL_ITERS)
        assert s.iterations == s0.iterations == MODEL_ITERS
        assert all(torch.equal(a, b) for a, b in zip(xs, want))
        assert short.count(False) == 3 * n * MODEL_ITERS and any(short) == blocked
        del xs
    cg_sharded.clear_caches()


@pytest.mark.parametrize("name", ["bands classic x4 on 2", "bands recompute x8 on 4"])
def test_withheld_shard_on_a_shared_card_ends_in_the_error_path(name):
    """A shard left out of a shared model card's program: the other shards' loops, on its
    card and on the others, end in the error path and the solve raises; a new loop then
    solves."""
    shape, g, kw, cards = SHARED[name]
    op = cg_sharded.make_mesh_operator(g, _mesh(shape), dtype=F64, **kw)
    loop = _card_loop(op)
    _on_cards(loop, cards)
    loop.withheld = 2
    with pytest.raises(RuntimeError, match="passed its bound"):
        op.solve(per_shard=True, max_iters=MODEL_ITERS)
    stopped = [int(p.ctl[1]) for i, p in enumerate(loop.parts) if i != 2]
    assert all(stopped) and int(loop.parts[2].ctl[1]) == 0
    assert loop not in op.graphs.values()
    _xs, s = op.solve(per_shard=True, max_iters=MODEL_ITERS)
    assert s.iterations == MODEL_ITERS
    cg_sharded.clear_caches()


# --------------------------------------------------------------------------- the loop


def _solve(shape, g, **kw):
    """The per-card loop and the eager mesh loop on the same operator: (x of each as
    numpy, their CGStats, the per-card loop's cg.COUNTS, both solves' HALO_CALLS)."""
    kw.setdefault("dtype", F64)
    loop_kw = {k: kw.pop(k) for k in ("recompute_ap",) if k in kw}
    op = cg_sharded.make_mesh_operator(g, _mesh(shape), **kw)
    out = {}
    for name, extra in (("eager", dict(graph=False)), ("cards", dict(per_shard=True))):
        cg.reset_counts()
        cg_sharded.reset_halo_calls()
        xs, s = op.solve(**extra, **loop_kw)
        x = op.assemble(xs)
        x = x.float().numpy().astype(np.float64) if x.dtype == BF16 else x.numpy()
        out[name] = (x, s, dict(cg.COUNTS), dict(cg_sharded.HALO_CALLS))
    cg_sharded.clear_caches()
    return out


def _jax(shape, g, **kw):
    import jax

    from tpusparse.solvers import cg_sharded as jcs

    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, ("x", "y")[:len(shape)], devices=jax.devices()[:n])
    if len(shape) == 2:
        x, s = jcs.cg_solve_sharded_2d(mesh, g, dtype=np.float64, **kw)
    else:
        x, s = jcs.cg_solve_sharded(mesh, g, dtype=np.float64, **kw)
    return np.asarray(x, np.float64), s


def _same_as_eager(out):
    x, s, counts, halo = out["cards"]
    xe, se, _, halo_e = out["eager"]
    assert s.converged and s.iterations == se.iterations
    np.testing.assert_array_equal(x, xe)
    assert counts == {"host_reads": 1, "replays": 0, "solves": 1, "captures": 0}
    assert halo == halo_e
    return x, s


# JAX parity cases: name -> (mesh shape, grid, solver arguments)
JAX_CASES = {
    "stencil5 x1": ((1,), 16, dict(mode="stencil5")),
    "stencil5 x2": ((2,), 16, dict(mode="stencil5")),
    "stencil5 x4": ((4,), 16, dict(mode="stencil5")),
    "const recompute x1": ((1,), 16, dict(mode="stencil5-const")),
    "const recompute x2": ((2,), 16, dict(mode="stencil5-const")),
    "const recompute x4": ((4,), 16, dict(mode="stencil5-const")),
    "stencil5 2x2": ((2, 2), 24, dict(mode="stencil5")),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_per_card_loop_matches_jax(name):
    shape, g, kw = JAX_CASES[name]
    x, s = _same_as_eager(_solve(shape, g, **kw))
    xj, sj = _jax(shape, g, **kw)
    assert sj.converged and s.iterations == sj.iterations
    assert x.shape == (g, g)
    np.testing.assert_allclose(x, xj, rtol=1e-12, atol=1e-14)


# bit-for-bit cases against the eager mesh loop only: name -> (mesh shape, grid, arguments)
EAGER_CASES = {
    "csr x4": ((4,), 32, dict(mode="csr")),
    "const classic x4": ((4,), 16, dict(mode="stencil5-const", recompute_ap=False)),
    "padded stencil5 x4": ((4,), 30, dict(mode="stencil5")),
    "bf16 stencil5 x2": ((2,), 32, dict(mode="stencil5", dtype=BF16)),
    "const f32 recompute x4": ((4,), 16, dict(mode="stencil5-const", dtype=F32)),
    "const 2x2": ((2, 2), 24, dict(mode="stencil5-const")),
    "stencil5 1x4": ((1, 4), 24, dict(mode="stencil5")),
    "bf16 2x2": ((2, 2), 32, dict(mode="stencil5", dtype=BF16)),
}


@pytest.mark.parametrize("name", list(EAGER_CASES))
def test_per_card_loop_equals_eager_mesh(name):
    shape, g, kw = EAGER_CASES[name]
    _same_as_eager(_solve(shape, g, **dict(kw)))


def test_solvers_take_per_shard():
    """``cg_solve_sharded`` and ``cg_solve_sharded_2d`` pass ``per_shard`` to the mesh:
    the global field, bit for bit the eager loop's."""
    m = _mesh((2,))
    cg.reset_counts()
    x, s = cg_sharded.cg_solve_sharded(16, mode="stencil5", dtype=F64, mesh=m,
                                       per_shard=True)
    assert cg.COUNTS == {"host_reads": 1, "replays": 0, "solves": 1, "captures": 0}
    xe, se = cg_sharded.cg_solve_sharded(16, mode="stencil5", dtype=F64, mesh=m, graph=False)
    assert s.iterations == se.iterations and torch.equal(x, xe)
    x2, _ = cg_sharded.cg_solve_sharded_2d(_mesh((2, 2)), 16, dtype=F64, per_shard=True)
    x2e, _ = cg_sharded.cg_solve_sharded_2d(_mesh((2, 2)), 16, dtype=F64, graph=False)
    assert torch.equal(x2, x2e)
    cg_sharded.clear_caches()


def test_mesh_scaling_runs_two_shards_a_card(tmp_path):
    """``bench.mesh_scaling --per-card 2`` on the CPU: the row-band cases with twice the
    shards, x bit for bit in all three loops."""
    import json

    from tpusparse_torch.bench import mesh_scaling

    out = tmp_path / "scaling.json"
    assert mesh_scaling.main(["--grid=16", "--runs=1", "--platform=cpu", "--per-card=2",
                              f"--json={out}"]) == 0
    rows = json.loads(out.read_text())
    bands = [c for c in mesh_scaling.CASES if len(c[0]) == 1]
    assert [r["mesh"] for r in rows] == [[2 * c[0][0]] for c in bands]
    assert all(r["x_equal"] for r in rows)


# --------------------------------------------------------------------------- refusals


def test_cards_without_peer_access_refuse(monkeypatch):
    """One pair without peer access: ValueError naming it, before any access is
    enabled."""
    enabled = []
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: (a, b) != (2, 1))
    monkeypatch.setattr(mesh_sync, "enable_peer", lambda a, b: enabled.append((a, b)))
    devices = [torch.device("cuda", i) for i in (0, 1, 2, 1)]
    with pytest.raises(ValueError, match="from cuda:2 to cuda:1"):
        cg_sharded._enable_peers(devices)
    assert enabled == []
    cg_sharded._enable_peers(devices[:2])
    assert enabled == [(0, 1), (1, 0)]


REFUSALS = {
    "per_shard with graph=False": ("graph=False", lambda: cg_sharded.cg_solve_sharded(
        16, mode="stencil5", mesh=_mesh((2,)), per_shard=True, graph=False)),
    "per_shard without the BLAS1 kernels": ("BLAS1", lambda: cg_sharded.cg_solve_sharded(
        16, mode="stencil5", mesh=_mesh((2,)), per_shard=True, use_pallas_blas1=False)),
    "per_shard on a gloo rank": ("pass a mesh", lambda: cg_sharded.cg_solve_sharded(
        16, mode="stencil5", device="cpu", per_shard=True)),
    "graph=True per_shard on the CPU": ("graph=True", lambda: cg_sharded.cg_solve_sharded(
        16, mode="stencil5", mesh=_mesh((2,)), per_shard=True, graph=True)),
}


@pytest.mark.parametrize("why", list(REFUSALS))
def test_per_card_loop_refusals(why):
    words, call = REFUSALS[why]
    with pytest.raises(ValueError, match=words):
        call()
    cg_sharded.clear_caches()
