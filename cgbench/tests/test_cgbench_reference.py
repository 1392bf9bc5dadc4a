"""The plain reference against a dense solve at g = 8."""

from __future__ import annotations

import pytest
import torch

from cgbench import check
from cgbench.reference import cg as reference


def test_stencil_apply_is_the_dense_matrix():
    g = 8
    a = reference.dense_matrix(g, 5.0, -1.0)
    assert torch.equal(a, a.T)
    x = torch.randn((g, g), dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    assert torch.allclose(reference.stencil_apply(x, 5.0, -1.0).reshape(-1), a @ x.reshape(-1),
                          rtol=0, atol=1e-13)
    eig = torch.linalg.eigvalsh(a)
    assert 1.0 < float(eig.min()) and float(eig.max()) < 9.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_reaches_the_dense_solution(dtype):
    g = 8
    b = torch.randn((g, g), dtype=dtype, generator=torch.Generator().manual_seed(2))
    exact = torch.linalg.solve(reference.dense_matrix(g, 5.0, -1.0),
                               b.to(torch.float64).reshape(-1)).reshape(g, g)
    x, k = reference.cg(b, 5.0, -1.0, 1e-12, 1000)
    assert x.dtype == torch.float64 and 0 < k < 64
    assert check.field_gap(x, exact) / check.scale(exact) < 1e-11
    # tol 1e-6 stops on the relative residual: rr <= tol² <b, b>
    x6, k6 = reference.cg(b, 5.0, -1.0, 1e-6, 1000)
    r = b.to(torch.float64) - reference.stencil_apply(x6, 5.0, -1.0)
    assert k6 < k and float(r.norm()) <= 1e-6 * float(b.to(torch.float64).norm()) * 1.0001
    x1, k1 = reference.cg(b, 5.0, -1.0, 1e-6, 1)
    assert k1 == 1


def test_cg_of_zero_runs_no_iteration():
    x, k = reference.cg(torch.zeros((4, 4), dtype=torch.float64), 5.0, -1.0, 1e-6, 10)
    assert k == 0 and not x.any()


def test_field_gap_blocks_and_faults():
    ref = torch.arange(3000 * 3, dtype=torch.float64).reshape(3000, 3)
    x = ref.clone().float()
    x[2500, 1] += 4
    assert check.field_gap(x, ref) == pytest.approx(4, rel=1e-6)
    assert check.field_gap(x[1000:2000], ref, (1000, 2000)) == pytest.approx(0, abs=1e-3)
    x[5, 0] = float("nan")
    assert check.field_gap(x, ref) == float("inf")
    assert not check.judge({"x_err": (float("inf"), 1.0)})
    assert check.as_json({"x_err": (float("nan"), 1.0)}) == {
        "x_err": {"value": "nan", "limit": 1.0}}
