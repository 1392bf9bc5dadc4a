"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's root, a
configuration in ``configs/<config>.json``, the sparse problem it names in
``problems/<problem>.py``, a traffic mix in ``traffic/<traffic>.json`` and a metric's
reader in ``metrics/<metric>.py`` (a ``<metric>.ranks`` with no file of its own reads by
``<metric>``'s).  A cell, or workload, is one entry of ``BENCHMARK.json``'s
``workloads``: a configuration under a traffic mix.  Adding any of them is adding files
and entries; nothing here names one but the problem of a configuration that names none
(``DEFAULT_PROBLEM``)."""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")

# the problem of a configuration without a "problem" key: the 2-D 5-point stencil
DEFAULT_PROBLEM = "lap5"
# what a problem module defines for cells of several ranks
SHARDED = "sharded_operator"


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload with everything the harness reads for it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple  # the BENCHMARK.json entries of the metrics this cell reports
    per_layer: tuple
    problem_file: pathlib.Path  # problems/<the configuration's problem>.py

    def problem(self):
        """The module of the configuration's sparse problem (``problem``)."""
        return _load(self.problem_file, "cgbench_problem_")


def load_benchmark(path: pathlib.Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_path(name: str, root: pathlib.Path = HERE) -> pathlib.Path:
    return root / "configs" / f"{name}.json"


def traffic_path(name: str, root: pathlib.Path = HERE) -> pathlib.Path:
    return root / "traffic" / f"{name}.json"


def metric_path(name: str, root: pathlib.Path = HERE) -> pathlib.Path:
    return root / "metrics" / f"{name}.py"


def problem_path(name: str, root: pathlib.Path = HERE) -> pathlib.Path:
    return root / "problems" / f"{name}.py"


def _load(path: pathlib.Path, prefix: str):
    """The module of the file ``path``, loaded by its path: a name may hold a dot or a
    hyphen, so it is not imported by a module name."""
    spec = importlib.util.spec_from_file_location(prefix + path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def problem(name: str, root: pathlib.Path = HERE):
    """The module of the sparse problem ``name`` (``problems/<name>.py``).  It defines
    ``shape(config, grid=None)``, the field b and x live in; ``operand(config,
    grid=None)``, the matrix handed to ``tpusparse_torch.ops.get_operator``; ``apply(x,
    config, out=None)``, A·x in plain float64 torch on a field of that shape, the
    reference's operator; and, for cells of several ranks, ``sharded_operator(config,
    grid, mode, dtype, device)``, a rank's operator.  ``grid`` stands in for the
    configuration's own size (tests)."""
    return _load(problem_path(name, root), "cgbench_problem_")


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric entry is reported in ``workload``: every cell where it lists
    none."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench: dict | None = None, root: pathlib.Path = HERE) -> Cell:
    """The cell named ``workload``; KeyError when BENCHMARK.json has no such workload,
    ValueError when its traffic runs several ranks and its problem has no
    ``sharded_operator``."""
    bench = load_benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"({[w['name'] for w in bench['workloads']]})")
    config = _load_json(config_path(entry["config"], root))
    traffic = _load_json(traffic_path(entry["traffic"], root))
    problem_file = problem_path(config.get("problem", DEFAULT_PROBLEM), root)
    if traffic["ranks"] > 1:
        require_sharded(problem_file)
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if reports(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"] if reports(m, workload)),
        problem_file=problem_file,
    )


def require_sharded(problem_file: pathlib.Path) -> None:
    """ValueError unless the problem module defines ``sharded_operator`` at its top
    level: read from its source without running it, so that the process that starts the
    ranks asks before it imports torch."""
    tree = ast.parse(problem_file.read_text())
    if not any(isinstance(node, ast.FunctionDef) and node.name == SHARDED
               for node in tree.body):
        raise ValueError(f"four-rank cells run only problems with a sharded operator: "
                         f"{problem_file.name} defines no {SHARDED}")


def reader_path(name: str, root: pathlib.Path = HERE) -> pathlib.Path:
    """The file of a metric's reader: ``metrics/<name>.py``, or, for a metric of several
    ranks (``<base>.ranks``) with no reader of its own, its base metric's, which reads
    rank 0's window the same way."""
    path = metric_path(name, root)
    base, _, suffix = name.rpartition(".")
    if not path.is_file() and suffix == "ranks" and base:
        return metric_path(base, root)
    return path


def reader(name: str, root: pathlib.Path = HERE):
    """The ``read(run)`` function of the metric's reader (``reader_path``).  A metric's
    name may hold a dot, so the file is loaded by its path, not imported by a module
    name."""
    return _load(reader_path(name, root), "cgbench_metric_").read
