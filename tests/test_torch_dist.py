"""The port's process-group runtime (tpusparse_torch.dist) against the JAX package's
tpusparse/dist.py.

The multi-rank checks run in one group of four gloo ranks on the CPU, spawned once for
the file by ``dist.launch_local`` (the ``group`` fixture): ``describe_group``,
``gather_to_host`` (rank 0 gets the field, the other ranks None; equal, unequal and padded
bands), ``barrier``, ``rank_time_stats`` on planted durations, the solver's staged halo
exchange (each rank's halo rows are its neighbours' boundary rows, zero rows, None, at the
grid's edges) and its rank-ordered dot (the same bits on every rank).  Each rank checks
what it sees and rank 0 reports what all saw.  The spawned ranks import this module, so
it imports JAX and the JAX package only inside its tests.
"""

import time

import numpy as np
import pytest
import torch

from tpusparse_torch import dist
from tpusparse_torch.solvers import cg_sharded

NRANKS = 4
PLANTED_S = (0.010, 0.0125, 0.011, 0.013)  # each rank's planted solve duration


def _field(rows, cols, base=0.0):
    return np.arange(rows * cols, dtype=np.float64).reshape(rows, cols) + base


def _group_checks(device):
    """Runs on every rank of the group; returns rank 0's report."""
    r, n = dist.rank(), dist.world_size()
    report = {"world": n, "describe": dist.describe_group(device),
              "ranks_per_card": dist.ranks_per_card(device)}

    # gather_to_host: equal bands (g = 8), the partition's unequal bands (g = 10) and the
    # solver's padded bands (g = 10 as 4 bands of 3 rows, the last two rows zero)
    lo, hi = dist.local_band_rows(8, n, r)
    gathers = {"equal": dist.gather_to_host(torch.tensor(_field(8, 5)[lo:hi]))}
    lo, hi = dist.local_band_rows(10, n, r)
    gathers["unequal"] = dist.gather_to_host(torch.tensor(_field(10, 5)[lo:hi]))
    padded = np.concatenate([_field(10, 5), np.zeros((2, 5))])
    gathers["padded"] = dist.gather_to_host(torch.tensor(padded[3 * r:3 * r + 3]), rows=10)
    report["gathers"] = gathers
    report["others_got_none"] = dist._all_objects(all(v is None for v in gathers.values()))

    # barrier: rank 0 arrives late; nobody leaves before it arrived
    if r == 0:
        time.sleep(0.3)
    arrived = time.time()
    dist.barrier()
    left = time.time()
    report["barrier"] = dist._all_objects((arrived, left))

    report["rank_times"] = dist.rank_time_stats(PLANTED_S[r])

    # the staged halo exchange of one (3, 6) band per rank
    halo = cg_sharded._HaloExchange(6, torch.float64, device)
    band = torch.tensor(_field(3, 6, 1000.0 * (r + 1)))
    hp, hn = halo.exchange(band)
    want_prev = None if r == 0 else _field(3, 6, 1000.0 * r)[-1:]
    want_next = None if r == n - 1 else _field(3, 6, 1000.0 * (r + 2))[:1]
    ok = all((h is None and w is None) or (h is not None and w is not None
                                          and np.array_equal(h.numpy(), w))
             for h, w in ((hp, want_prev), (hn, want_next)))
    report["halo_ok"] = dist._all_objects(ok)

    # the rank-ordered dot: partials that a different order would round differently
    partial = torch.tensor(np.random.RandomState(r).randn() * 10.0 ** (4 * r),
                           dtype=torch.float64)
    total = cg_sharded._allsum(partial)
    report["partials"] = dist._all_objects(partial.item())
    report["sums"] = dist._all_objects(total.item().hex())
    return report


def _raise_on_rank_one(device):
    if dist.rank() == 1:
        raise ZeroDivisionError("planted failure")
    dist.barrier()  # rank 0 waits here for a peer that never comes
    return "unreachable"


@pytest.fixture(scope="module")
def group():
    return dist.launch_local(_group_checks, NRANKS, device="cpu")


@pytest.mark.parametrize("g", [7, 16, 30, 513])
def test_local_band_rows_matches_jax(g):
    from tpusparse import dist as jdist

    for n in (1, 2, 3, 4, 8):
        rows = [dist.local_band_rows(g, n, i) for i in range(n)]
        assert rows == [jdist.local_band_rows(g, n, i) for i in range(n)]
        assert rows[0][0] == 0 and rows[-1][1] == g
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


def test_env_flag_matches_jax(monkeypatch):
    from tpusparse import dist as jdist

    for value in (None, "0", "false", "False", "", "1", "yes"):
        if value is None:
            monkeypatch.delenv("TPUSPARSE_TEST_FLAG", raising=False)
        else:
            monkeypatch.setenv("TPUSPARSE_TEST_FLAG", value)
        for default in (False, True):
            assert (dist.env_flag("TPUSPARSE_TEST_FLAG", default)
                    == jdist.env_flag("TPUSPARSE_TEST_FLAG", default))


def test_one_rank_without_a_group():
    """Outside a process group every helper sees rank 0 of 1, as the JAX helpers see one
    process: no imbalance to report, the field as it is, a barrier that returns."""
    import jax

    from tpusparse import dist as jdist

    assert (dist.rank(), dist.world_size(), dist.is_multihost()) == (0, 1, False)
    assert dist.rank_time_stats(1.0) is None and jdist.rank_time_stats(1.0) is None
    x = _field(6, 4)
    np.testing.assert_array_equal(dist.gather_to_host(torch.tensor(x), rows=5), x[:5])
    dist.barrier()
    got = dist.describe_group("cpu")
    want = jdist.describe_mesh(jdist.make_band_mesh(1))
    assert set(got) == set(want)
    assert got["axes"] == want["axes"] == {"x": 1}
    assert got["num_devices"] == want["num_devices"] == 1
    assert got["process_of_device"] == want["process_of_device"] == [0]
    assert got["device_kinds"] == ["cpu"] and jax.process_count() == 1


def test_describe_group_on_four_ranks(group):
    from tpusparse import dist as jdist

    got = group["describe"]
    assert group["world"] == NRANKS
    assert set(got) == set(jdist.describe_mesh(jdist.make_band_mesh(1)))
    assert got == {"axes": {"x": NRANKS}, "num_devices": NRANKS, "num_processes": NRANKS,
                   "device_kinds": ["cpu"], "process_of_device": list(range(NRANKS))}
    assert group["ranks_per_card"] == 0  # no card is shared: they are CPU ranks


@pytest.mark.parametrize("case", ["equal", "unequal", "padded"])
def test_gather_to_host_on_four_ranks(group, case):
    want = _field(8, 5) if case == "equal" else _field(10, 5)
    np.testing.assert_array_equal(group["gathers"][case], want)
    assert group["others_got_none"] == [False, True, True, True]


def test_barrier_on_four_ranks(group):
    arrived0 = group["barrier"][0][0]
    assert all(left >= arrived0 for _arrived, left in group["barrier"])


def test_rank_time_stats_matches_jax(group, monkeypatch):
    """The JAX helper on the same planted durations, its process allgather replaced by
    the planted array."""
    import jax
    from jax.experimental import multihost_utils

    from tpusparse import dist as jdist

    monkeypatch.setattr(jax, "process_count", lambda: NRANKS)
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda _x: np.asarray(PLANTED_S, np.float64))
    want = jdist.rank_time_stats(PLANTED_S[0])
    got = group["rank_times"]
    assert got["per_process_ms"] == want["per_process_ms"]
    for key in ("solve_time_max_ms", "solve_time_min_ms", "load_imbalance_pct"):
        assert got[key] == pytest.approx(want[key], rel=1e-15)


def test_halo_exchange_on_four_ranks(group):
    assert group["halo_ok"] == [True] * NRANKS


def test_rank_ordered_dot_is_the_same_bits_on_every_rank(group):
    total = 0.0
    for p in group["partials"]:  # rank order, in f64
        total += p
    assert group["sums"] == [total.hex()] * NRANKS


def test_launch_local_raises_a_ranks_error():
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed:(.|\n)*planted failure"):
        dist.launch_local(_raise_on_rank_one, 2, device="cpu")
    with pytest.raises(ValueError, match="nranks"):
        dist.launch_local(_raise_on_rank_one, 0, device="cpu")
