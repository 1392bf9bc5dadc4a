"""SpMV operator registry of the port.

Counterpart of ``tpusparse/ops.py``: ``get_operator(mode, matrix)`` returns a
``DeviceOperator`` whose callables the CG solver and the CLI drive.  Modes ported so far:

  - ``"stencil5-const"``     values-free constant-coefficient stencil through the CUDA
                             kernels K1-K3 (``kernels/stencil5.py``), with the two
                             recompute-CG passes;
  - ``"stencil5-const-xla"`` the same operator in plain PyTorch, as the JAX package left it
                             to XLA: the oracle and the baseline the kernels are timed
                             against.

Every other mode of the JAX registry raises ``NotImplementedError`` naming the ROADMAP
queue item that ports it.  PyTorch runs eagerly, so the JAX package's explicit-operand
machinery for ``jax.jit`` (``operands``, ``_wrap_ops``) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from tpusparse import formats
from tpusparse.formats import Stencil5

from . import convert
from ._device import resolve_device, resolve_dtype
from .generate import ones_field
from .kernels import stencil5 as _st5


@dataclasses.dataclass
class DeviceOperator:
    """Operator contract (reference ``SpmvOperator``, include/spmv.h:125-134):

    - ``run_device(x) -> y``; ``run_device_dot(x) -> (y, <x, y>)``;
    - optional recompute-Ap CG passes (8 words/point/iteration, Ap never stored):
      ``run_pupdate_dot_op(beta, r, p, out=None) -> (p', <p', A·p'>)`` and
      ``run_update_recompute_op(alpha, x, r, p) -> (x, r, <r, r>)`` (x, r in place);
    - ``free()`` drops the operator's callables."""

    name: str
    num_rows: int
    num_cols: int
    nnz: int
    grid_size: int
    field_shape: tuple  # (rows, cols) 2-D view of the vector space
    device: torch.device
    dtype: torch.dtype
    run_device: Callable
    run_device_dot: Callable
    run_pupdate_dot_op: Optional[Callable] = None
    run_update_recompute_op: Optional[Callable] = None

    @property
    def field_elems(self) -> int:
        return self.field_shape[0] * self.field_shape[1]

    def as_field(self, x_flat):
        """A length-num_cols vector (numpy or tensor) as the operator's field on its
        device, in the operator's dtype."""
        x = torch.as_tensor(x_flat).reshape(-1)
        if x.numel() != self.field_elems:
            raise ValueError(f"vector of length {x.numel()} does not match the operator "
                             f"field {self.field_shape}")
        return x.to(device=self.device, dtype=self.dtype).reshape(self.field_shape)

    def from_field(self, x_field):
        """Flatten a field back to the length-num_rows vector."""
        return x_field.reshape(-1)[: self.num_rows]

    def ones_b(self, dtype=None):
        """The canonical b = ones right-hand side, made on the device."""
        return ones_field(self.grid_size, dtype or self.dtype, self.device)

    def kernel_time_ms(self, chain: int = 24, reps: int = 3) -> float:
        """Time of one ``run_device`` apply: a chain of ``chain`` applies (each output is
        the next input) on x = ones, best of ``reps``.  On CUDA the window is a pair of
        CUDA events around the chain (the reference's cudaEvent window,
        spmv_cusparse_csr.cu:247-253); on the CPU it is the host clock."""
        x = self.ones_b()
        self.run_device(x)  # warm-up: builds the kernels on first use
        best = float("inf")
        for _ in range(reps):
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                v = x
                for _ in range(chain):
                    v = self.run_device(v)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                v = x
                for _ in range(chain):
                    v = self.run_device(v)
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms / chain)
        return best

    def free(self):
        """Drop the operator's callables; it is unusable afterwards."""
        def _freed(*_a, **_k):
            raise RuntimeError("operator was freed; re-create it with get_operator()")

        self.run_device = _freed
        self.run_device_dot = _freed
        self.run_pupdate_dot_op = None
        self.run_update_recompute_op = None


def _as_stencil5(mat) -> Stencil5:
    if isinstance(mat, Stencil5):
        return mat
    if isinstance(mat, formats.COOMatrix):
        mat = formats.coo_to_csr(mat)
    if isinstance(mat, formats.CSRMatrix):
        return formats.csr_to_stencil5(mat)
    raise TypeError(f"cannot interpret {type(mat)} as a 5-point stencil")


def _init_stencil5_const(st: Stencil5, dtype, device) -> DeviceOperator:
    diag, offdiag = convert.operand_from_stencil5(st)
    g = st.grid_size

    def run_device(x):
        return _st5.spmv_stencil5_const(x, diag=diag, offdiag=offdiag)

    def run_device_dot(x):
        return _st5.spmv_stencil5_const(x, diag=diag, offdiag=offdiag, with_dot=True)

    def run_pupdate_dot_op(beta, r, p, out=None):
        """Pass A of the recompute-Ap iteration: (p', <p', A·p'>) (kernel K1)."""
        return _st5.spmv_stencil5_const_pupdate_dot(beta, r, p, diag=diag, offdiag=offdiag,
                                                    out=out)

    def run_update_recompute_op(alpha, x, r, p):
        """Pass B: (x', r', <r', r'>) with A·p recomputed from p (kernel K2)."""
        return _st5.cg_const_update_recompute(alpha, x, r, p, diag=diag, offdiag=offdiag)

    return DeviceOperator(
        name="stencil5-const", num_rows=g * g, num_cols=g * g, nnz=st.nnz, grid_size=g,
        field_shape=(g, g), device=device, dtype=dtype, run_device=run_device,
        run_device_dot=run_device_dot, run_pupdate_dot_op=run_pupdate_dot_op,
        run_update_recompute_op=run_update_recompute_op,
    )


def _init_stencil5_const_xla(st: Stencil5, dtype, device) -> DeviceOperator:
    diag, offdiag = convert.operand_from_stencil5(st)
    g = st.grid_size

    def run_device(x):
        return _st5.spmv_stencil5_const_plain(x, diag=diag, offdiag=offdiag)

    def run_device_dot(x):
        return _st5.spmv_stencil5_const_plain(x, diag=diag, offdiag=offdiag, with_dot=True)

    return DeviceOperator(
        name="stencil5-const-xla", num_rows=g * g, num_cols=g * g, nnz=st.nnz, grid_size=g,
        field_shape=(g, g), device=device, dtype=dtype, run_device=run_device,
        run_device_dot=run_device_dot,
    )


_REGISTRY = {
    "stencil5-const": _init_stencil5_const,
    "stencil5-const-xla": _init_stencil5_const_xla,
}

# modes of the JAX registry still to be ported -> their ROADMAP Queue 1 item
_NOT_PORTED = {
    **dict.fromkeys(("stencil5", "stencil5-bf16c", "stencil5-xla", "stencil5-csr"),
                    "ROADMAP Queue 1 item 8 (values-carrying stencil, kernels K8-K10)"),
    **dict.fromkeys(("csr", "csr-xla", "ell", "cusparse-csr", "dia", "dia-xla", "bcoo"),
                    "ROADMAP Queue 1 item 9 (generic operators, kernels K11-K13)"),
}


def available_modes():
    return sorted(_REGISTRY)


def get_operator(mode: str, mat, dtype=torch.float32, device="cuda") -> DeviceOperator:
    """Build a device operator (reference get_operator + op->init in one step)."""
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"mode '{mode}' is not ported yet: {_NOT_PORTED[mode]}")
    if mode not in _REGISTRY:
        raise ValueError(f"unknown SpMV mode '{mode}'; available: {available_modes()}")
    return _REGISTRY[mode](_as_stencil5(mat), resolve_dtype(dtype), resolve_device(device))
