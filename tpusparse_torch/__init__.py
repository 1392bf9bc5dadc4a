"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper (H100).

The JAX package ``tpusparse`` beside it is the reference: every module here has its
counterpart at the same path there, and the tests hold the two against each other.  The
port imports ``torch`` and never ``jax``, and nothing of ``tpusparse``: it keeps its own
copies of the host code it needs (operand formats, the stencil generator and checksums,
Matrix Market I/O with its native reader, benchmark statistics, metrics and exports).

Ported so far: every Pallas kernel of the JAX package as a hand-written CUDA kernel
(``csrc/``: the stencil kernels K1–K3 and K8–K10, the BLAS1 kernels K4–K7, DIA K11 and one
ELL kernel for K12/K13); every SpMV mode of its registry (``ops``); the single-device CG
solver's loops (recompute, classic, fused, host-stepped; ``solvers/cg``); the sharded CG
on ``torch.distributed``, over row bands and over the 2-D block decomposition (``dist``,
``solvers/cg_sharded``: ``cg_solve_sharded``, ``cg_solve_sharded_2d`` and their stepped
twins); the benchmark harness, probes and profiling (``bench/``); and the CLIs (``cli/``:
CG, SpMV, the matrix generator, the multichip CG with ``--mesh2d``).  ``PERF.md`` and
``ROADMAP.md`` say what is measured and what is still to come (a bf16 state, a CUDA graph
of the iteration).
"""

__version__ = "0.1.0"


def clear_caches() -> None:
    """Drop every cached operator and the device memory it pins: the sharded solver's
    operators of synthesized operands, row bands and 2-D blocks.  (The single-device
    solver's captured loops live on their operator, and ``op.free()`` drops them.)  Sweeps
    over grid sizes call this between points."""
    from .solvers import cg_sharded

    cg_sharded.clear_caches()
