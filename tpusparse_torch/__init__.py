"""tpusparse_torch — the PyTorch/CUDA port of tpusparse for NVIDIA Hopper (H100).

The JAX package ``tpusparse`` beside it is the reference: every module here has its
counterpart at the same path there, and the tests hold the two against each other.  The
port imports ``torch`` and never ``jax``.  Host code without JAX (operand formats, the
stencil generator and checksums, Matrix Market I/O, benchmark statistics, metrics and
exports) is shared with ``tpusparse`` rather than copied.

Ported so far: CG on the constant-coefficient 5-point stencil (``stencil5-const``,
``csrc/stencil5_const.cu``) and on the values-carrying stencil with f32/f64 or bf16
coefficient planes (``stencil5``, ``stencil5-bf16c``, ``csrc/stencil5.cu``), the classic
loop's BLAS1 kernels (``csrc/blas1.cu``), and the CG and SpMV CLIs; see ``PERF.md`` and
``ROADMAP.md`` for what is ported and what is still to come.
"""

__version__ = "0.1.0"
