"""The comparison that decides ``correct``: the program's x of a solve the window ran, and
the iteration count of every solve it ran, against the plain reference's
(``reference.solve`` on the problem's ``apply``) on the same b.

``x_err`` is the largest gap between the two fields over every grid point, over the
largest magnitude of the reference's field: max|x − x_ref| / max|x_ref|.  ``iters_gap``
is the largest gap between a solve's iteration count and the reference's, over every
solve of the window (on several ranks, every rank's): a solve that stops early, by a
looser test of convergence, lands within ``x_err``'s limit in f32 and would read as a
faster solve.  Each limit is the configuration's (``limits``), set from the readings of
sound runs and of the control and faults that ``PERF.md`` lists.  A field holding a NaN
or an infinity fails.
"""

from __future__ import annotations

import math

import torch

# the points compared at once: a block of whole rows, at least one
BLOCK_POINTS = 1 << 24


def field_gap(x: torch.Tensor, x_ref: torch.Tensor, rows: tuple | None = None) -> float:
    """max|x − x_ref[rows]| over the field x, in float64, a block of rows at a time.  A row
    is what follows the first index of the reference's field, of any shape
    (``x_ref.reshape(x_ref.shape[0], -1)``); x holds the reference's rows from
    ``rows[0]``, all of them by default, and may be flat, as a generic operator's field
    is."""
    lo = 0 if rows is None else rows[0]
    ref = x_ref.reshape(x_ref.shape[0], -1)
    x = x.reshape(-1, ref.shape[1])
    step = max(1, BLOCK_POINTS // ref.shape[1])
    gap = 0.0
    for i in range(0, x.shape[0], step):
        part = x[i:i + step].to(torch.float64)
        d = float((part - ref[lo + i:lo + i + part.shape[0]]).abs().max())
        if not math.isfinite(d):
            return math.inf
        gap = max(gap, d)
    return gap


def iters_gap(iterations, ref_iterations: int) -> int:
    """max|k − k_ref| over the iteration counts of the window's solves."""
    return max(abs(k - ref_iterations) for k in iterations)


def scale(x_ref: torch.Tensor) -> float:
    """max|x_ref|, the denominator of ``x_err``."""
    return float(x_ref.abs().max())


def judge(checks: dict) -> bool:
    """Whether every compared number (name -> (value, limit)) is finite and within its
    limit."""
    return all(math.isfinite(v) and v <= limit for v, limit in checks.values())


def as_json(checks: dict) -> dict:
    """The checks for the result line: a non-finite value as a string, since JSON has no
    NaN or infinity."""
    return {name: {"value": v if math.isfinite(v) else str(v), "limit": limit}
            for name, (v, limit) in checks.items()}


def lines(checks: dict) -> list:
    return [f"check {name} {v!r} limit {limit!r}" for name, (v, limit) in checks.items()]
