"""The port's probes (tpusparse_torch.bench.probes) against the JAX package's, on the CPU.

- ``slope_seconds`` equals JAX's on a grid of timings, noise-guard cases included (exact).
- ``measure_achievable_bw`` returns positive readings under JAX's keys, the probe set in
  ``probes``, and an achievable ceiling that is the largest reading under the peak.
- A reading above the peak is kept under its own name, left out of ``achievable_gbs`` and
  named in ``probes_over_peak``.
- ``measure_onchip_knee`` gives points with JAX's keys, plus the time of one pass.
- No pass writes a temporary field: the byte count of each pass is what its one call
  moves.
- The streaming kernels' wrappers (``kernels.stream_probe``) run their twins on the CPU and
  count no launch there.
"""

import itertools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpusparse.bench import probes as jax_probes
from tpusparse_torch.bench import probes
from tpusparse_torch.kernels import stream_probe

JAX_KEYS = ("read_gbs", "copy_gbs", "triad_gbs", "mix7_gbs", "read6_gbs", "achievable_gbs")


@pytest.mark.parametrize("k_lo,k_hi", [(2, 8), (6, 24), (1, 64)])
def test_slope_seconds_equals_jax(k_lo, k_hi):
    times = (0.0, 1e-6, 0.2, 0.4, 0.5, 0.5001, 0.8, 3.0)
    for t_lo, t_hi in itertools.product(times, repeat=2):
        if t_hi == 0.0:
            continue
        assert probes.slope_seconds(t_lo, t_hi, k_lo, k_hi) == \
            jax_probes.slope_seconds(t_lo, t_hi, k_lo, k_hi), (t_lo, t_hi)
    assert probes.slope_seconds(0.5, 0.4, 2, 8) == 0.4 / 8  # a negative slope
    assert probes.slope_seconds(0.5, 0.5001, 2, 8) == 0.5001 / 8  # a slope near zero
    assert probes.slope_seconds(0.2, 0.8, 2, 8) == pytest.approx(0.1)


def test_achievable_bw_keys_and_ceiling():
    r = probes.measure_achievable_bw(n_elems=2 ** 16, k_lo=2, k_hi=6, reps=2, device="cpu")
    ref = jax_probes.measure_achievable_bw(n_elems=2 ** 16, k_lo=2, k_hi=6, reps=2)
    assert set(ref) <= set(r)
    for key in JAX_KEYS:
        assert r[key] > 0.0, (key, r)
    assert r["probes"] == ["read", "copy", "triad", "mix7", "read6", "read_kernel",
                           "copy_kernel"] == list(probes.PROBES)
    assert r["probe_elems"] == ref["probe_elems"] == 2 ** 16
    assert r["peak_gbs"] is None and r["probes_over_peak"] == []  # the CPU has no peak
    assert r["achievable_gbs"] == max(r[f"{p}_gbs"] for p in r["probes"])
    assert "k=2/6, best of 2" in r["probe_protocol"]
    json.dumps(r)  # the probe JSON is plain data
    small = probes.measure_achievable_bw(n_elems=2 ** 12, k_lo=1, k_hi=3, reps=1,
                                         include_mixes=False, device="cpu")
    assert small["probes"] == ["read", "copy", "triad", "read_kernel", "copy_kernel"]
    assert "mix7_gbs" not in small


def test_a_reading_over_the_peak_is_left_out(monkeypatch):
    """An injected mix7 reading above the peak stays under its name, out of the max."""
    readings = iter([700.0, 900.0, 1200.0, 5000.0, 1500.0, 1600.0, 1400.0])
    monkeypatch.setattr(probes, "measure_probe_slope", lambda *a, **k: next(readings))
    r = probes.measure_achievable_bw(n_elems=256, device="cpu", peak_gbs=3350.0)
    assert r["mix7_gbs"] == 5000.0 and r["probes_over_peak"] == ["mix7"]
    assert r["achievable_gbs"] == 1600.0 and r["peak_gbs"] == 3350.0
    assert probes.achievable({"read": 10.0, "copy": 20.0}, None) == (20.0, [])
    assert probes.achievable({"read": 10.0, "copy": 20.0}, 5.0) == (None, ["read", "copy"])


def test_onchip_knee_points():
    """JAX's point keys (tpusparse/bench/probes.py:244-245; its own knee runs 200,000
    passes on the CPU, so it is not run here) and the time of one pass."""
    r = probes.measure_onchip_knee(sizes_mib=(1,), reps=1, device="cpu")
    (pt,) = r["points"]
    assert {"footprint_mib", "copy_chain_gbs", "k_lo", "k_hi"} <= set(pt)
    assert pt["footprint_mib"] == 1 and r["probe_protocol"].startswith("copy chain")
    assert pt["copy_chain_gbs"] > 0 and pt["k_lo"] < pt["k_hi"] <= probes.KNEE_MAX_PASSES
    assert pt["per_pass_us"] == pytest.approx(2 * 2 ** 20 / pt["copy_chain_gbs"] / 1e3)
    # 0.05 s at 4 TB/s over 3/4 of k_hi: a few hundred passes of 512 MiB, ~16k of 8 MiB,
    # and no more than a graph may hold below that
    assert probes.knee_passes(2 * 512 * 2 ** 20) == (62, 248)
    assert probes.knee_passes(2 * 8 * 2 ** 20) == (3973, 15894)
    assert probes.knee_passes(2 * 2 ** 20) == (4096, probes.KNEE_MAX_PASSES)


def test_no_pass_writes_a_temporary_field():
    """Each pass is one call into buffers made beforehand: the profiler sees no
    allocation of a field (a CPU reduction's per-thread partials, 32 bytes, are not one),
    and the copy and triad chains carry their value through their own buffer."""
    n = 2 ** 16
    x = torch.ones(n)
    stack = torch.stack([torch.full((n // 2,), 1.0 + i) for i in range(6)])
    passes = {"read": probes._read_probe(x), "copy": probes._copy_probe(x),
              "triad": probes._triad_probe(x, torch.full_like(x, 0.5)),
              "mix7": probes._mix7_probe(stack), "read6": probes._read6_probe(stack),
              "read_kernel": probes._read_kernel_probe(x),
              "copy_kernel": probes._copy_kernel_probe(x)}
    for name, one_pass in passes.items():
        one_pass()
        with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
            for _ in range(3):
                out = one_pass()
        allocated = max((e.cpu_memory_usage for e in prof.key_averages()), default=0)
        assert allocated < 1024, (name, allocated)
        assert out.data_ptr() == one_pass().data_ptr(), name
    assert torch.equal(x, torch.ones(n))  # the chains work on their own copies
    np.testing.assert_allclose(passes["read6"]().numpy(),
                               [(1.0 + i) * n // 2 for i in range(6)])


def test_stream_probe_twins_on_the_cpu():
    """The streaming kernels' twins: the field's sum in one word (exact for these
    integers), dst = src bit for bit; no launch is counted and ``read_partials`` is 1."""
    stream_probe.reset_launches()
    x = torch.from_numpy(np.random.RandomState(4).randint(-8, 9, 4096).astype(np.float32))
    part = torch.empty(stream_probe.read_partials(x))
    assert part.numel() == 1
    assert stream_probe.read(x, part) is part and float(part[0]) == float(x.sum())
    dst = torch.empty_like(x)
    assert stream_probe.copy(x, dst) is dst and torch.equal(dst, x)
    assert stream_probe.LAUNCHES == {"probe_read": 0, "probe_copy": 0}
