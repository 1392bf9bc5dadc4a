"""The port's headline benchmark (tpusparse_torch.bench.headline) against the repo's
``bench.py`` and the JAX package's solver, on the CPU at 64².

- ``bench_cg`` solves in exactly as many iterations as the JAX ``cg.cg_solve`` takes for
  ``stencil5-const`` f32 in each loop (and ``stencil5-bf16c``, the companion), Pallas in
  interpret mode; its dict holds every key of ``bench.py``'s (read from its source with
  ``ast``, never imported) and ``device``;
- a wrong iteration count raises, a failing companion makes ``main`` raise and print no
  line, a failing run exits non-zero and prints nothing on stdout, a good one prints one
  JSON line; without a card, nothing runs unless the CPU is asked for;
- the SpMV metric: K8's checksum gate (and a planted fault it catches), its byte count
  7·g²·4 (the JAX byte model's), its keys with a peak planted for the CPU, and its refusal
  on the CPU without one.
"""

import ast
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from tpusparse import formats as jformats
from tpusparse import ops as jops
from tpusparse.bench import metrics as jmetrics
from tpusparse.solvers import cg as jcg
from tpusparse_torch import generate
from tpusparse_torch.bench import headline

ROOT = pathlib.Path(__file__).resolve().parent.parent
G = 64
CPU_ARGS = [f"--grid={G}", "--platform=cpu", "--warmup=1", "--runs=3"]


def _jax_iterations(mode, recompute_ap=None, g=G):
    op = jops.get_operator(mode, jformats.Stencil5(g, None, (5.0, -1.0)), dtype=jnp.float32)
    _x, s = jcg.cg_solve(op, jnp.ones((g, g), jnp.float32),
                         config=jcg.CGConfig(max_iters=100, tolerance=1e-6),
                         recompute_ap=recompute_ap)
    assert s.converged
    return s.iterations


@pytest.fixture(scope="module")
def iterations():
    """JAX's iteration count at 64² f32, the same in the recompute loop, the classic loop
    and the bf16c companion."""
    counts = {"recompute": _jax_iterations("stencil5-const", True),
              "classic": _jax_iterations("stencil5-const", False),
              "bf16c": _jax_iterations("stencil5-bf16c")}
    assert len(set(counts.values())) == 1, counts
    return counts["classic"]


@pytest.fixture(scope="module")
def result(iterations):
    return headline.bench_cg(grid=G, device="cpu", warmup=1, runs=3,
                             expect_iterations=iterations)


def _returned_keys(func_name):
    """The keys of the dict ``bench.py``'s ``func_name`` returns, ``**{...}`` parts too."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    func = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func_name)
    ret = next(n for n in ast.walk(func) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    keys = {}
    for d in ast.walk(ret.value):
        if isinstance(d, ast.Dict):
            keys.update({k.value: v for k, v in zip(d.keys, d.values)
                         if isinstance(k, ast.Constant)})
    return keys


def test_bench_cg_matches_jax_iterations(result, iterations):
    assert result["iterations"] == iterations
    assert result["loop"] in ("recompute-ap", "classic")
    best = min(result["classic_loop_ms"], result["value"])
    assert result["value"] == best
    if result["loop"] == "classic":
        assert result["value"] == result["classic_loop_ms"]
    assert result["total_runs"] == 3 and 1 <= result["valid_runs"] <= 3
    assert result["vs_baseline"] == pytest.approx(headline.REF_20K_MS / result["value"])
    assert result["vs_baseline_bf16c"] == pytest.approx(
        headline.REF_20K_MS / result["values_carrying_bf16c_ms"])
    assert result["device"] == "cpu"
    assert result["mode"] == "stencil5-const" and result["dtype"] == "float32"


def test_bench_cg_keys_are_bench_py_keys(result):
    keys = _returned_keys("bench_cg_20k")
    assert {"metric", "value", "unit", "vs_baseline", "values_carrying_bf16c_ms",
            "vs_baseline_bf16c"} <= set(keys)
    assert set(keys) <= set(result), set(keys) - set(result)
    assert "device" in result
    # the same metric and unit strings as bench.py's at 20480²
    assert headline.cg_metric(20480) == keys["metric"].value
    assert headline.CG_UNIT == keys["unit"].value
    assert headline.REF_20K_MS == 531.4 and headline.REF_ITERS == 14
    assert result["metric"] == headline.cg_metric(G)


def test_wrong_iteration_count_raises(iterations):
    with pytest.raises(RuntimeError, match="iteration-count parity broken"):
        headline.bench_cg(grid=G, device="cpu", warmup=0, runs=3,
                          expect_iterations=iterations + 1)


def test_failing_companion_is_not_swallowed(monkeypatch, capsys, iterations):
    real = headline.ops.get_operator

    def planted(mode, *a, **k):
        if mode == "stencil5-bf16c":
            raise RuntimeError("planted bf16c failure")
        return real(mode, *a, **k)

    monkeypatch.setattr(headline.ops, "get_operator", planted)
    with pytest.raises(RuntimeError, match="planted bf16c failure"):
        headline.main([*CPU_ARGS, f"--expect-iterations={iterations}"])
    assert capsys.readouterr().out == ""


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "tpusparse_torch.bench.headline", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_cli_prints_one_line_or_fails(iterations):
    good = _cli(*CPU_ARGS, f"--expect-iterations={iterations}")
    assert good.returncode == 0, good.stderr
    lines = good.stdout.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["iterations"] == iterations
    assert "[headline]" in good.stderr
    bad = _cli(*CPU_ARGS, f"--expect-iterations={iterations - 1}")
    assert bad.returncode != 0
    assert bad.stdout == ""
    assert "iteration-count parity broken" in bad.stderr


@pytest.mark.parametrize("metric", ["cg", "spmv"])
def test_no_card_no_run(monkeypatch, metric):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        headline.main([f"--metric={metric}", f"--grid={G}"])
    fn = headline.bench_cg if metric == "cg" else headline.bench_spmv
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(grid=G)


def test_spmv_checksum_gate_and_bytes():
    planes = generate.make_stencil5_planes_device(G, dtype=torch.float32, device="cpu")
    assert headline.check_spmv(planes, G) <= 1e-12
    assert headline.spmv_bytes(G) == 7 * G * G * 4 == jmetrics.bytes_stencil5(G * G, 4)
    planes[2, :4] = 500.0  # four rows of wrong diagonal entries
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        headline.check_spmv(planes, G)


def test_spmv_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="no HBM peak rate"):
        headline.bench_spmv(grid=G, device="cpu")
    with pytest.raises(RuntimeError, match="no HBM peak rate"):
        headline.main(["--metric=spmv", "--platform=cpu", f"--grid={G}"])


def test_spmv_keys_with_a_planted_peak(monkeypatch):
    monkeypatch.setattr(headline.sysinfo, "gpu_peaks", lambda kind: (1e6, None))
    res = headline.bench_spmv(grid=G, device="cpu")
    keys = _returned_keys("bench_spmv_roofline")
    assert set(keys) <= set(res)
    assert res["metric"] == keys["metric"].value
    assert res["unit"] == keys["unit"].value
    assert res["value"] == pytest.approx(
        headline.spmv_bytes(G) / (res["ms_per_apply"] * 1e-3) / 1e9 / 1e6)
    assert res["vs_baseline"] == pytest.approx(res["value"] / 0.95)
