"""The port's scripts (``tpusparse_torch.scripts``) against the JAX package's
(``scripts/*.py``), on the CPU at g <= 64 with ``--platform=cpu``.

- every script returns 0 and writes the JAX script's file names and JSON keys;
- ``run_all --quick``, ``sweep`` and ``sharded_compare``: iterations and Sum/Norm2 of the
  solution equal the JAX CLIs' on the same problem (f64, 1e-12);
- ``audit_cg_iteration`` at g = 32: its JSON's keys are the JAX audit's (the phases
  also carry their bound and their launches), and its iterations equal JAX
  ``cg_solve``'s in both loops;
- ``cg_solve(max_iters=0)``, the audit's fixed-overhead solve, equals JAX's (0
  iterations, unconverged, x = 0) in the eager loop and in the graph loop's structure;
- ``detect_config.max_grid`` keeps each mode's cap and a multiple of 8;
- ``profile_kernel`` returns 2 on an unknown mode before any trace;
- ``format_table`` renders every mode × size, measured or "not measured", from exports
  the port's ``spmv_bench`` wrote; the plots write PNGs (matplotlib only there);
- no script's default path lies under the JAX artifacts (``docs/results``,
  ``docs/figures``), and the device scripts default to the card;
- ``pyproject.toml``'s ``[project.scripts]`` name the port's four CLIs beside JAX's.
"""

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys
import tomllib

import numpy as np
import pytest
import torch

from tpusparse.cli import cg_solver as jax_cg
from tpusparse.cli import cg_solver_multichip as jax_multichip
from tpusparse.cli import spmv_bench as jax_spmv
from tpusparse.formats import Stencil5
from tpusparse.ops import get_operator as jax_get_operator
from tpusparse.solvers import cg as jcg
from tpusparse_torch import ops
from tpusparse_torch.formats import Stencil5 as PortStencil5
from tpusparse_torch.scripts import (audit_cg_iteration, detect_config, format_table,
                                     plot_results, plot_roofline, profile_kernel, run_all,
                                     sharded_compare, sweep)
from tpusparse_torch.solvers import cg

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = ("run_all", "sweep", "audit_cg_iteration", "profile_kernel", "detect_config",
           "sharded_compare", "format_table", "plot_results", "plot_roofline")
DEVICE_SCRIPTS = ("run_all", "sweep", "audit_cg_iteration", "profile_kernel",
                  "detect_config", "sharded_compare")


def _load(path):
    return json.loads(pathlib.Path(path).read_text())


def _same_solution(port, ref, rtol=1e-12):
    assert port["convergence"]["converged"] and ref["convergence"]["converged"]
    assert port["convergence"]["iterations"] == ref["convergence"]["iterations"]
    for key in ("solution_sum", "solution_norm"):
        np.testing.assert_allclose(port["validation"][key], ref["validation"][key],
                                   rtol=rtol)


def _parser_defaults(module):
    """{dest: default} of a script's parser, read by running main with --help patched
    out: the parser is built inside main, so capture it at parse time."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            module.main(["--help"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen


@pytest.mark.parametrize("name", SCRIPTS)
def test_every_script_is_a_module_with_main(name):
    mod = importlib.import_module(f"tpusparse_torch.scripts.{name}")
    assert callable(mod.main)
    assert (ROOT / "scripts" / f"{name}.py").exists()  # the JAX script it ports
    defaults = _parser_defaults(mod)
    assert ("platform" in defaults) == (name in DEVICE_SCRIPTS)
    if name in DEVICE_SCRIPTS:
        assert defaults["platform"] == "cuda"
    for value in defaults.values():
        if isinstance(value, str):
            assert not value.startswith(("docs/results", "docs/figures")), (name, value)
    text = (ROOT / "tpusparse_torch" / "scripts" / f"{name}.py").read_text()
    assert "sys.path.insert" not in text and "\nimport matplotlib" not in text


@pytest.mark.parametrize("name", DEVICE_SCRIPTS)
def test_device_scripts_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"sweep": ["spmv"], "profile_kernel": ["gen:8"]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(f"tpusparse_torch.scripts.{name}").main(argv)


def test_run_all_quick_matches_the_jax_clis(tmp_path, capsys):
    g = 32
    assert run_all.main(["--quick", f"--size={g}", "--dtype=f64", "--platform=cpu",
                         f"--outdir={tmp_path}"]) == 0
    jdir = tmp_path / "json"
    modes = ["stencil5", "stencil5-bf16c", "stencil5-const", "csr", "bcoo"]
    assert sorted(p.name for p in jdir.iterdir()) == sorted(
        [f"spmv_{m}.json" for m in modes] + ["cg_single.json", "cg_baseline_bcoo.json",
                                             "cg_baseline_csr.json", "cg_sharded_1chip.json"])
    out = capsys.readouterr().out
    assert "SUMMARY" in out and "iterations match" in out
    common = [f"gen:{g}", "--dtype=f64", "--runs=3", "--warmup=1", "--verbose=0"]
    for name, extra in (("cg_single", []), ("cg_baseline_bcoo", ["--mode=bcoo"]),
                        ("cg_baseline_csr", ["--mode=csr"])):
        ref_path = tmp_path / f"jax_{name}.json"
        assert jax_cg.main([*common, *extra, f"--json={ref_path}"]) == 0
        port, ref = _load(jdir / f"{name}.json"), _load(ref_path)
        _same_solution(port, ref)
        assert set(ref) <= set(port)
    ref_path = tmp_path / "jax_sharded.json"
    assert jax_multichip.main([f"gen:{g}", "--chips=1", "--dtype=f64", "--runs=3",
                               "--warmup=1", f"--json={ref_path}"]) == 0
    _same_solution(_load(jdir / "cg_sharded_1chip.json"), _load(ref_path))
    ref_spmv = tmp_path / "jax_spmv.json"
    assert jax_spmv.main([f"gen:{g}", "--mode=stencil5,csr", "--dtype=f64", "--runs=3",
                          f"--json={ref_spmv}"]) == 0
    for mode in ("stencil5", "csr"):
        port = _load(jdir / f"spmv_{mode}.json")["benchmark"]["validation"]
        ref = _load(tmp_path / f"jax_spmv_{mode}.json")["benchmark"]["validation"]
        assert port == pytest.approx(ref, rel=1e-12)


def test_sweep_matches_the_jax_clis(tmp_path):
    assert sweep.main(["strong", "--sizes=32", "--dtype=f64", "--platform=cpu",
                       f"--outdir={tmp_path}"]) == 0
    assert sweep.main(["weak", "--configs=1:40,2:48", "--dtype=f64", "--platform=cpu",
                       f"--outdir={tmp_path}"]) == 0
    assert sweep.main(["spmv", "--sizes=16,24", "--dtype=f64", "--platform=cpu",
                       f"--outdir={tmp_path}"]) == 0
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted([
        "sweep_strong_32_1chip.json", "sweep_strong.csv",  # one rank on the CPU
        "sweep_weak_1chip_40.json", "sweep_weak.csv",
        "sweep_spmv_16_stencil5.json", "sweep_spmv_16_csr.json",
        "sweep_spmv_24_stencil5.json", "sweep_spmv_24_csr.json", "sweep_spmv.csv"])
    for port_name, g in (("sweep_strong_32_1chip.json", 32), ("sweep_weak_1chip_40.json", 40)):
        ref_path = tmp_path / f"jax_{g}.json"
        assert jax_multichip.main([f"gen:{g}", "--chips=1", "--dtype=f64", "--runs=3",
                                   "--warmup=1", f"--json={ref_path}"]) == 0
        port, ref = _load(tmp_path / port_name), _load(ref_path)
        _same_solution(port, ref)
        assert set(ref) <= set(port)
    for g in (16, 24):
        ref_path = tmp_path / f"jax_spmv_{g}.json"
        assert jax_spmv.main([f"gen:{g}", "--mode=stencil5,csr", "--dtype=f64", "--runs=3",
                              f"--json={ref_path}"]) == 0
        for mode in ("stencil5", "csr"):
            port = _load(tmp_path / f"sweep_spmv_{g}_{mode}.json")
            ref = _load(tmp_path / f"jax_spmv_{g}_{mode}.json")
            assert port["benchmark"]["validation"] == pytest.approx(
                ref["benchmark"]["validation"], rel=1e-12)


def test_sharded_compare_matches_the_jax_cli(tmp_path, capfd):
    g, n = 32, 2
    modes = ("csr", "stencil5", "stencil5-const")
    assert sharded_compare.main([f"--grid={g}", f"--devices={n}", "--runs=3", "--warmup=1",
                                 "--dtype=f64", "--platform=cpu",
                                 f"--outdir={tmp_path}"]) == 0
    out = capfd.readouterr().out
    assert f"| sharded CG @ {g}² on {n} shards (mesh) |" in out and "†" not in out
    for mode in modes:
        port = _load(tmp_path / f"cg_sharded_compare_{g}_{mode}_{n}dev.json")
        assert port["loop"] == "host-stepped"
        ref_path = tmp_path / f"jax_{mode}.json"
        assert jax_multichip.main([f"gen:{g}", f"--chips={n}", f"--mode={mode}", "--timers",
                                   "--runs=3", "--warmup=1", "--dtype=f64",
                                   f"--json={ref_path}"]) == 0
        _same_solution(port, _load(ref_path))
        assert out.count(f"| {mode}") >= 1


def _jax_audit(tmp_path, g):
    """The JAX audit (scripts/audit_cg_iteration.py) at g, its compilation cache left
    off, as a dict."""
    spec = importlib.util.spec_from_file_location(
        "jax_audit_cg_iteration", ROOT / "scripts" / "audit_cg_iteration.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.enable_compilation_cache = lambda: None
    out = tmp_path / "jax_audit.json"
    argv = sys.argv
    sys.argv = ["audit_cg_iteration.py", f"--grid={g}", "--reps=1", "--runs=1", f"--out={out}"]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return _load(out)


def test_audit_matches_the_jax_audit(tmp_path):
    g = 32
    out = tmp_path / "audit.json"
    assert audit_cg_iteration.main([f"--grid={g}", "--reps=1", "--runs=1", "--platform=cpu",
                                    f"--out={out}"]) == 0
    port, ref = _load(out), _jax_audit(tmp_path, g)
    assert set(port) == set(ref)
    assert set(port["phases"]) == set(ref["phases"])
    for name, phase in port["phases"].items():
        assert set(ref["phases"][name]) <= set(phase)
        assert phase["words_pt"] == ref["phases"][name]["words_pt"]
        assert phase["launches"] == 0  # the twins run on the CPU: no kernel launched
        assert phase["bound_share"] is None  # the CPU has no data-sheet rate
    for loop, recompute in (("classic_loop", False), ("recompute_loop", True)):
        assert set(port[loop]) == set(ref[loop])
        jop = jax_get_operator("stencil5-const", Stencil5(grid_size=g, planes=None,
                                                          constant=(5.0, -1.0)),
                               dtype=np.float32)
        _, s = jcg.cg_solve(jop, jop.ones_b(np.float32), config=jcg.CGConfig(max_iters=100),
                            recompute_ap=recompute)
        assert port[loop]["iterations"] == ref[loop]["iterations"] == s.iterations
    assert port["grid"] == g and port["dtype"] == "float32"
    assert port["device"]["device_kind"] == "cpu"
    assert audit_cg_iteration.device_tag({"device_kind": "NVIDIA H100 80GB HBM3"}) == "h100"


@pytest.mark.parametrize("loop", ["recompute", "classic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cg_solve_max_iters_0_equals_jax(loop, dtype):
    """The audit's fixed-overhead solve: 0 iterations, unconverged, Sum(x) = 0, in JAX's
    solve, the port's eager loop and the graph loop's structure run on the host."""
    g = 32
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    jop = jax_get_operator("stencil5-const", Stencil5(grid_size=g, planes=None,
                                                      constant=(5.0, -1.0)), dtype=np_dtype)
    jx, js = jcg.cg_solve(jop, jop.ones_b(np_dtype), config=jcg.CGConfig(max_iters=0),
                          recompute_ap=loop == "recompute")
    op = ops.get_operator("stencil5-const", PortStencil5(grid_size=g, planes=None,
                                                        constant=(5.0, -1.0)),
                          dtype=dtype, device="cpu")
    config = cg.CGConfig(max_iters=0)
    x, s = cg.cg_solve(op, b_is_ones=True, config=config, recompute_ap=loop == "recompute",
                       graph=False)
    gx, gk, grr, gbb = cg.DeviceLoop(op, loop, 0, config.tolerance).solve(None, None, True)
    assert js.iterations == s.iterations == gk == 0
    assert not js.converged and not s.converged
    assert float(np.asarray(jx).sum()) == float(x.sum()) == float(gx.sum()) == 0.0
    np.testing.assert_allclose(s.residual_norm, js.residual_norm, rtol=1e-6)
    assert grr == gbb == pytest.approx(g * g)


@pytest.mark.parametrize("g", [3, 8, 16, 32, 64])
def test_exact_cg_iterations_match_the_solvers(g):
    """chip_smoke.py's oracle of the iteration count (CG in exact arithmetic, from the
    stencil's spectrum) against the JAX f64 solve and the port's: the same count, the
    last relative residual to 1e-6; at 20480² it gives the 14 every chip run measured."""
    import chip_smoke

    its, res = chip_smoke.exact_cg_iterations(g)
    jop = jax_get_operator("stencil5-const", Stencil5(grid_size=g, planes=None,
                                                      constant=(5.0, -1.0)),
                           dtype=np.float64)
    _, js = jcg.cg_solve(jop, jop.ones_b(np.float64))
    op = ops.get_operator("stencil5-const", PortStencil5(grid_size=g, planes=None,
                                                        constant=(5.0, -1.0)),
                          dtype=torch.float64, device="cpu")
    _, s = cg.cg_solve(op, b_is_ones=True)
    assert its == js.iterations == s.iterations
    if res[-1] > 1e-12:  # a solve that ends on a residual of round-off has no digits here
        np.testing.assert_allclose(s.relative_residual, res[-1], rtol=1e-6)
    assert chip_smoke.exact_cg_iterations(20480)[0] == 14


@pytest.mark.parametrize("label", list(detect_config.MODES))
def test_detect_config_max_grid_keeps_the_caps(label):
    mode, dtype, _loop = detect_config.MODES[label]
    item, wpp, cap = detect_config.ITEMSIZE[dtype], detect_config.WORDS_PER_POINT[label], \
        detect_config.cap(mode)
    for mem in (1e6, 16e9, 85e9, 1e13, 1e15):
        g = detect_config.max_grid(mem, item, wpp, cap)
        assert g % 8 == 0 and 0 <= g <= cap
        assert g * g * wpp * item <= mem * detect_config.SAFETY
        # the next multiple of 8 breaks the budget or the cap
        assert (g + 8) > cap or (g + 8) ** 2 * wpp * item > mem * detect_config.SAFETY
    assert detect_config.grids(85e9)[label][0] == detect_config.max_grid(85e9, item, wpp, cap)


def test_detect_config_caps_are_the_kernels():
    csr, bcoo = detect_config.cap("csr"), detect_config.cap("bcoo")
    assert csr * csr + csr < 2 ** 31 <= (csr + 1) ** 2 + csr + 1  # the ELL kernel's int32
    assert 5 * bcoo ** 2 - 4 * bcoo < 2 ** 31 <= 5 * (bcoo + 1) ** 2 - 4 * (bcoo + 1)
    assert detect_config.cap("stencil5-const") == 65535 * 32 == detect_config.cap("stencil5")
    assert detect_config.max_grid(1e15, 4, 1.0, csr) == csr - csr % 8
    # at 80 GB the constant stencil's recompute solve passes 2^31 elements a field
    g = detect_config.grids(85e9)["stencil5-const f32 recompute"][0]
    assert g * g > 2 ** 31


def test_detect_config_runs_on_the_cpu(capsys):
    assert detect_config.main(["--platform=cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("max grid ") == len(detect_config.MODES)
    assert "host RAM" in out
    assert detect_config.main(["--platform=cpu", "--calibrate=16"]) == 2


def test_profile_kernel_refuses_an_unknown_mode_before_any_trace(tmp_path, capsys):
    assert profile_kernel.main(["gen:16", "--mode=stencil5,nope", "--platform=cpu",
                                f"--outdir={tmp_path}"]) == 2
    assert "unknown mode 'nope'" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
    assert profile_kernel.main(["gen:16", "--mode=stencil5,stencil5-const", "--reps=2",
                                "--platform=cpu", f"--outdir={tmp_path}"]) == 0
    for mode in ("stencil5", "stencil5-const"):
        (trace,) = (tmp_path / f"stencil5-16x16_{mode}").glob("*.pt.trace.json")
        assert json.loads(trace.read_text())["traceEvents"]


def _spmv_exports(tmp_path, sizes, modes):
    from tpusparse_torch.cli import spmv_bench

    for g in sizes:
        assert spmv_bench.main([f"gen:{g}", f"--mode={','.join(modes)}", "--runs=3",
                                "--warmup=1", "--platform=cpu",
                                f"--json={tmp_path}/spmv_{g}_h100.json"]) == 0


def test_format_table_renders_every_mode_and_size(tmp_path, capsys):
    measured = {16: ["stencil5", "csr", "bcoo"], 24: ["stencil5-const", "dia-xla"]}
    for g, modes in measured.items():
        _spmv_exports(tmp_path, [g], modes)
    sizes = [16, 24, 32]
    csv_path, doc = tmp_path / "table.csv", tmp_path / "GENERIC_COMPARISON.md"
    assert format_table.main([f"--dir={tmp_path}", "--sizes=16,24,32", f"--csv={csv_path}",
                              f"--write-doc={doc}"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rows = {ln.split(" | ")[0].strip("| "): ln.split(" | ")[1:] for ln in lines
            if ln.startswith("| ") and not ln.startswith("| mode")}
    assert set(rows) == set(format_table.MODES)
    for mode, cells in rows.items():
        assert len(cells) == len(sizes)
        for g, text in zip(sizes, cells):
            want_measured = mode in measured.get(g, [])
            assert ("not measured" not in text) == want_measured, (mode, g, text)
            assert (" ms" in text or "µs" in text) == want_measured
    table_rows = format_table.load_rows(tmp_path)
    assert set(table_rows) == {(m, g) for g, ms in measured.items() for m in ms}
    assert len(csv_path.read_text().splitlines()) == 1 + len(table_rows)
    text = doc.read_text()
    assert "| **16²**" in text and "`bcoo`" in text


def test_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    from tpusparse_torch.bench import probes

    jdir = tmp_path / "json"
    assert run_all.main(["--quick", "--size=16", "--platform=cpu",
                         f"--outdir={tmp_path}"]) == 0
    assert sweep.main(["strong", "--sizes=24", "--platform=cpu", f"--outdir={jdir}"]) == 0
    assert plot_results.main([f"--indir={jdir}", f"--outdir={tmp_path / 'plots'}"]) == 0
    made = sorted(p.name for p in (tmp_path / "plots").iterdir())
    assert made == ["cg_problem_size.png", "cg_scaling.png", "spmv_comparison.png"]
    (jdir / "probe_ceiling.json").write_text(json.dumps(
        probes.measure_achievable_bw(n_elems=2 ** 12, device="cpu", include_mixes=False)))
    roof = tmp_path / "fig" / "roofline.png"
    assert plot_roofline.main([f"--indir={jdir}", f"--out={roof}"]) == 0
    for png in [roof, *(tmp_path / "plots").iterdir()]:
        assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert plot_results.main([f"--indir={tmp_path / 'none'}",
                              f"--outdir={tmp_path / 'p2'}"]) == 1


def test_plots_without_matplotlib_return_1(monkeypatch, capsys, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plot_results.main([f"--outdir={tmp_path}"]) == 1
    assert plot_roofline.main([f"--out={tmp_path / 'r.png'}"]) == 1
    assert capsys.readouterr().err.count("[ERROR] matplotlib not available") == 2


def test_pyproject_names_the_port_clis():
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    want = {"tpusparse-spmv-bench": "spmv_bench", "tpusparse-cg": "cg_solver",
            "tpusparse-cg-multichip": "cg_solver_multichip",
            "tpusparse-generate": "generate_matrix"}
    for name, cli in want.items():
        assert scripts[name] == f"tpusparse.cli.{cli}:main"
        port = name.replace("tpusparse-", "tpusparse-torch-")
        assert scripts[port] == f"tpusparse_torch.cli.{cli}:main"
    assert len(scripts) == 8
    for target in scripts.values():
        module, func = target.split(":")
        assert callable(getattr(importlib.import_module(module), func))
