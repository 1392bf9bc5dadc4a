"""The control of every cell comes out not correct: the program run in the nearest
precision below the configuration's (``control_dtype``: f32 for f64, a bf16 state for
f32, the program's own paths) reads ``x_err`` above the configuration's limit, and the
program as the configuration states it reads below it, with the reference's iteration
count, on three seeds each.

Here at g = 24 on the CPU, the kernels' plain twins; ``-m cuda`` runs the same at the
cells' own size on the cards, where they are: a run's ``python3 -m cgbench.readings``."""

from __future__ import annotations

import pytest
import torch

from cgbench import readings, spec

WORKLOADS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEEDS = [3141592653, 2 ** 33 + 1, 7]


def _check(workload, device, grid):
    cell = spec.cell(workload)
    limit = cell.config["limits"]["x_err"]
    sound = readings.collect(cell, SEEDS, device=device, grid=grid)
    control = readings.collect(cell, SEEDS, cell.config["control_dtype"], device, grid)
    assert all(r["x_err"] <= limit for r in sound), sound
    assert all(r["iterations"] == r["ref_iterations"] for r in sound), sound
    assert all(r["x_err"] > limit for r in control), control


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_and_the_program_passes(workload):
    _check(workload, "cpu", 24)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cells_size(workload):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < spec.cell(workload).chips:
        pytest.skip(f"needs {spec.cell(workload).chips} CUDA card(s), {cards} visible")
    _check(workload, "cuda", None)
