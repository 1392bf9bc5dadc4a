"""A configuration names its sparse problem (``problems/<name>.py``): ``lap5``, the problem
of every configuration that names none, is the 5-point stencil the harness ran before
problems were files, bit for bit; a problem added as new files of a copy of the benchmark
runs through the unchanged harness, and is judged by its own reference; a problem without
a sharded operator is refused for ranks before any rank is spawned."""

from __future__ import annotations

import dataclasses
import functools
import json
import shutil
import time

import pytest
import torch

from cgbench import check, harness, inputs, launch, readings, single, spec
from cgbench.reference import cg as reference

CONFIGS = [c["name"] for c in spec.load_benchmark()["configs"]]
SEED = 2 ** 32 + 2 ** 31 + 5

# a 3-D 7-point stencil, given to the program as a CSR matrix (mode csr), whose operand's
# diagonal is off by SHIFT from the configuration's: 0 for a sound program
LAP7 = '''"""lap7: the 3-D 7-point stencil on an n x n x n grid with Dirichlet edges (a test's)."""

import numpy as np
import torch

SHIFT = {shift!r}


def shape(config, grid=None):
    n = grid or config["grid_size"]
    return (n, n, n)


def operand(config, grid=None):
    from tpusparse_torch.formats import CSRMatrix

    n = shape(config, grid)[0]
    idx = np.arange(n ** 3).reshape(n, n, n)
    rows, cols = [idx.ravel()], [idx.ravel()]
    vals = [np.full(n ** 3, config["diag"] + SHIFT)]
    for axis in range(3):
        lo = np.take(idx, range(n - 1), axis=axis).ravel()
        hi = np.take(idx, range(1, n), axis=axis).ravel()
        rows += [lo, hi]
        cols += [hi, lo]
        vals += [np.full(2 * lo.size, config["offdiag"])]
    row, col, val = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    order = np.lexsort((col, row))
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n ** 3))])
    return CSRMatrix(n ** 3, n ** 3, row_ptr.astype(np.int64), col[order].astype(np.int64),
                     val[order].astype(np.float64))


def apply(x, config, out=None):
    d, o = config["diag"], config["offdiag"]
    y = torch.mul(x, d, out=out) if out is not None else x * d
    for axis in range(x.dim()):
        m = x.shape[axis] - 1
        y.narrow(axis, 1, m).add_(x.narrow(axis, 0, m), alpha=o)
        y.narrow(axis, 0, m).add_(x.narrow(axis, 1, m), alpha=o)
    return y
'''
LAP7_CONFIG = {
    "name": "lap7-8-f64", "source": "https://en.wikipedia.org/wiki/Seven-point_stencil",
    "problem": "lap7", "grid_size": 8, "diag": 6.0, "offdiag": -1.0, "dtype": "f64",
    "tolerance": 1e-06, "max_iters": 1000, "reduced": [], "control_dtype": "f32",
    "limits": {"x_err": 1e-09, "iters_gap": 0},
}


def _files(root) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark, its files as they were, and a BENCHMARK.json to extend."""
    root = tmp_path / "cgbench"
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    return root, _files(root), json.loads(json.dumps(spec.load_benchmark()))


def _add_lap7(root, bench, shift=0.0, traffic="cg-csr", ranks=1) -> spec.Cell:
    """lap7's problem, configuration and a traffic of ``ranks`` on it (the cg-csr mix under
    a name of its own) added as new files of the copy, and its cell."""
    (root / "problems" / "lap7.py").write_text(LAP7.format(shift=shift))
    spec.config_path("lap7-8-f64", root).write_text(json.dumps(LAP7_CONFIG))
    mix = json.loads(spec.traffic_path(traffic).read_text())
    mix.update(name=f"{traffic}-lap7", ranks=ranks)
    spec.traffic_path(mix["name"], root).write_text(json.dumps(mix))
    name = f"lap7-8-f64.{mix['name']}"
    bench["configs"].append({"name": "lap7-8-f64", "source": LAP7_CONFIG["source"],
                             "file": "cgbench/configs/lap7-8-f64.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": name, "config": "lap7-8-f64", "traffic": mix["name"],
                               "chips": max(1, ranks), "why": "a test"})
    return spec.cell(name, bench, root)


@pytest.mark.parametrize("config", CONFIGS)
def test_lap5_is_the_stencil_the_harness_ran(config):
    """lap5 gives Stencil5(g, None, (diag, offdiag)) and stencil_apply; b is
    torch.randn((g, g)) of one generator seeded with the seed; reference.cg is
    reference.solve on lap5's apply: each bit for bit."""
    from tpusparse_torch.formats import Stencil5

    c = json.loads(spec.config_path(config).read_text())
    assert "problem" not in c  # the default
    cell = spec.cell(f"{config}.cg-const-recompute")
    lap5 = cell.problem()
    assert cell.problem_file == spec.problem_path("lap5")
    assert lap5.shape(c) == (c["grid_size"], c["grid_size"])
    g = 24
    assert lap5.shape(c, g) == (g, g)
    assert lap5.operand(c, g) == Stencil5(g, None, (c["diag"], c["offdiag"]))
    dtype = inputs.DTYPES[c["dtype"]]
    b = inputs.right_hand_side(lap5.shape(c, g), SEED, dtype, "cpu", cell.traffic["b"])
    today = torch.randn((g, g), generator=torch.Generator().manual_seed(SEED % 2 ** 64),
                        dtype=dtype)
    assert torch.equal(b, today)
    x = b.to(torch.float64)
    assert torch.equal(lap5.apply(x, c), reference.stencil_apply(x, c["diag"], c["offdiag"]))
    x_cg, k_cg = reference.cg(b, c["diag"], c["offdiag"], c["tolerance"], c["max_iters"])
    x_solve, k_solve = reference.solve(b, functools.partial(lap5.apply, config=c),
                                       c["tolerance"], c["max_iters"])
    assert k_cg == k_solve > 0 and torch.equal(x_cg, x_solve)


@pytest.mark.parametrize("shift, correct", [(0.0, True), (1e-3, False)],
                         ids=["sound", "diagonal-off"])
def test_a_problem_added_as_files_runs_without_an_edit(copy, shift, correct):
    """A 3-D 7-point stencil added as a problem module, a configuration and a traffic of a
    copy runs through ``single.run`` at n = 8 (512 unknowns) and reads correct, with the
    reference's iteration count; with the program's diagonal off by 1e-3 it reads not
    correct.  No file of the copy that was there changes."""
    root, before, bench = copy
    cell = _add_lap7(root, bench, shift)
    assert cell.problem_file == root / "problems" / "lap7.py"
    record = single.run(cell, SEED, 0.2, False, time.time(), device="cpu")
    line = harness.result(cell, record, False, record["kind"], "cpu")
    assert record["points"] == [512] and line["attempted"] > 0
    assert line["correct"] is correct, line["checks"]
    if correct:
        assert line["checks"]["iters_gap"]["value"] == 0
        (sound,) = readings.collect(cell, [SEED + 1], device="cpu")
        assert sound["x_err"] <= LAP7_CONFIG["limits"]["x_err"]
        assert sound["iterations"] == sound["ref_iterations"] > 0
    else:
        assert line["checks"]["x_err"]["value"] > line["checks"]["x_err"]["limit"]
    after = {p: data for p, data in _files(root).items() if p in before}
    assert after == before


def test_ranks_refuse_a_problem_without_a_sharded_operator(copy, monkeypatch):
    """A problem with no ``sharded_operator`` under a traffic of ranks: the cell is refused
    with ValueError when it is resolved, which a run does before it starts any rank, and
    ``RankProgram`` refuses it before it builds anything; no rank is spawned."""
    from cgbench import ranks

    def spawned(*args, **kwargs):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(launch.Ranks, "__init__", spawned)
    root, _, bench = copy
    one = _add_lap7(root, bench)
    with pytest.raises(ValueError, match="sharded operator"):
        _add_lap7(root, json.loads(json.dumps(bench)), traffic="cg-stencil5-4ranks",
                  ranks=4)
    four = dataclasses.replace(one, traffic={**one.traffic, "ranks": 4}, chips=4)
    with pytest.raises(ValueError, match="sharded operator"):
        ranks.RankProgram(four, torch.device("cpu"))
    # lap5 has one
    spec.require_sharded(spec.problem_path("lap5"))
    assert callable(spec.problem("lap5").sharded_operator)


def test_field_gap_on_a_field_of_three_axes(monkeypatch):
    """x of a 3-D problem, flat or shaped, against the reference's (n, n, n) field, a block
    of rows (n² points each) at a time, also from a row other than the first."""
    n = 6
    ref = torch.randn((n, n, n), dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    x = ref.clone().reshape(-1)
    x[(n - 1) * n * n + 7] += 0.5
    for points in (check.BLOCK_POINTS, 1, 2 * n * n):
        monkeypatch.setattr(check, "BLOCK_POINTS", points)
        assert check.field_gap(x, ref) == pytest.approx(0.5)
        assert check.field_gap(x.reshape(n, n, n), ref) == pytest.approx(0.5)
        assert check.field_gap(x[2 * n * n:4 * n * n], ref, (2, 4)) == 0.0
        assert check.field_gap(x[4 * n * n:], ref, (4, n)) == pytest.approx(0.5)
