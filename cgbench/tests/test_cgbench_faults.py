"""A run with its timed path broken underneath comes out not correct: the harness's look
for a card is skipped and the rest of a run is driven on the CPU at g = 24, once for each
fault the cell can have (``faults``); ``-m cuda`` drives the same on the cards at g = 256,
where the ranks run the graph a rank over NCCL that the timed path runs."""

from __future__ import annotations

import time

import pytest
import torch

from cgbench import harness, spec
from cgbench.tests import faults

ONE_CARD = [w["name"] for w in spec.load_benchmark()["workloads"] if w["chips"] == 1]
RANKS = [w["name"] for w in spec.load_benchmark()["workloads"] if w["chips"] > 1]
FAULTS = [faults.unchanged, faults.half_left_out, faults.altered, faults.early_stop]
CARD_GRID = 256


def _correct(workload, wrap, traced=False, device="cpu", grid=24):
    cell = spec.cell(workload)
    record = harness.execute(cell, 2 ** 31 + 11, 0.2, traced, time.time(), device=device,
                             grid=grid, wrap=wrap)
    return harness.result(cell, record, traced, record["kind"], device)


def _on_cards(workload):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < spec.cell(workload).chips:
        pytest.skip(f"needs {spec.cell(workload).chips} CUDA card(s), {cards} visible")


@pytest.mark.parametrize("workload", ONE_CARD + RANKS)
def test_a_sound_run_is_correct(workload):
    line = _correct(workload, None)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert line["checks"]["x_err"]["value"] <= line["checks"]["x_err"]["limit"]
    assert line["checks"]["iters_gap"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ONE_CARD + RANKS)
def test_a_broken_solve_is_not_correct(workload, fault):
    assert not _correct(workload, fault)["correct"]


def test_an_early_stop_is_caught_by_the_iteration_count():
    """Three iterations short: in f32 its x stays within x_err's limit, so only the
    iteration count tells it from a faster solve."""
    workload = next(w for w in ONE_CARD if spec.cell(w).config["dtype"] == "f32")
    checks = _correct(workload, faults.early_stop)["checks"]
    assert checks["iters_gap"]["value"] == 3 and checks["iters_gap"]["limit"] == 0
    assert checks["x_err"]["value"] <= checks["x_err"]["limit"]


@pytest.mark.parametrize("workload", RANKS)
def test_ranks_without_their_exchange_are_not_correct(workload):
    assert not _correct(workload, faults.no_exchange)["correct"]


def test_a_traced_run_is_correct_and_reads_no_device_on_the_cpu():
    line = _correct(ONE_CARD[0], None, traced=True)
    assert line["correct"] and "breakdown" in line
    assert "hbm_roofline_pct" not in line["metrics"]  # no device time on the CPU
    assert line["checks"]["iters_gap"]["value"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ONE_CARD + RANKS)
def test_a_sound_run_on_the_cards_is_correct(workload):
    _on_cards(workload)
    line = _correct(workload, None, device="cuda", grid=CARD_GRID)
    assert line["correct"], line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload, fault",
                         [(w, f) for w in ONE_CARD + RANKS for f in FAULTS]
                         + [(w, faults.no_exchange) for w in RANKS],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_solve_on_the_cards_is_not_correct(workload, fault):
    _on_cards(workload)
    assert not _correct(workload, fault, device="cuda", grid=CARD_GRID)["correct"]
