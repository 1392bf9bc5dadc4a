"""SpMV operator registry of the port.

Counterpart of ``tpusparse/ops.py``: ``get_operator(mode, matrix)`` returns a
``DeviceOperator`` whose callables the CG solver and the CLIs drive.  Modes ported so far:

  - ``"stencil5"``           values-carrying stencil: five coefficient planes on the
                             device, SpMV through the CUDA kernel K8 (``kernels/stencil5.py``);
                             ``"stencil5-csr"`` is the reference's alias for it;
  - ``"stencil5-bf16c"``     the same with bfloat16 planes and f32/f64 state: plane traffic
                             halves (28 -> 18 B/pt in f32), bit-identical results for
                             coefficients exact in bf16 (5, -1 and 0 are);
  - ``"stencil5-xla"``       the planes operator in plain PyTorch (K8's twin), as the JAX
                             package left it to XLA: oracle and baseline;
  - ``"stencil5-const"``     values-free constant-coefficient stencil through the CUDA
                             kernels K1-K3, with the two recompute-CG passes;
  - ``"stencil5-const-xla"`` the same operator in plain PyTorch.

Every other mode of the JAX registry raises ``NotImplementedError`` naming the ROADMAP
queue item that ports it.  PyTorch runs eagerly, so the JAX package's explicit-operand
machinery for ``jax.jit`` (``operands``, ``_wrap_ops``) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpusparse import formats
from tpusparse.formats import Stencil5

from . import convert
from ._device import resolve_device, resolve_dtype
from .generate import make_stencil5_planes_device, ones_field
from .kernels import stencil5 as _st5


@dataclasses.dataclass
class DeviceOperator:
    """Operator contract (reference ``SpmvOperator``, include/spmv.h:125-134):

    - ``run_device(x) -> y``; ``run_device_dot(x) -> (y, <x, y>)``;
    - ``run_timed(x_host) -> (y_host, ms)`` and ``run_timed_resident(x) -> (y, ms)``;
    - optional recompute-Ap CG passes (8 words/point/iteration, Ap never stored):
      ``run_pupdate_dot_op(beta, r, p, out=None) -> (p', <p', A·p'>)`` and
      ``run_update_recompute_op(alpha, x, r, p) -> (x, r, <r, r>)`` (x, r in place);
    - ``planes``: the coefficient planes of the values-carrying modes, else None;
    - ``free()`` drops the operator's callables and planes."""

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
    planes: Optional[torch.Tensor] = None

    @property
    def field_elems(self) -> int:
        return self.field_shape[0] * self.field_shape[1]

    @property
    def numpy_dtype(self):
        """The state's dtype in numpy: a host vector is cast to it before its upload."""
        return _NUMPY_DTYPE[self.dtype]

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

    def run_timed(self, x_flat_host):
        """The reference's run_timed (spmv_cusparse_csr.cu:234-264): the upload of x, one
        apply and the download of y, on the host clock.  x is cast to the operator's dtype
        on the host, before the upload.  Returns (y as numpy, ms)."""
        t0 = time.perf_counter()
        x = self.as_field(np.asarray(x_flat_host, dtype=self.numpy_dtype))
        y = self.run_device(x)
        y_host = self.from_field(y).cpu().numpy()  # the download is also the sync
        return y_host, (time.perf_counter() - t0) * 1e3

    def run_timed_resident(self, x_field):
        """One apply on a field already on the device, to its completion, on the host
        clock: the reference's timed region with x uploaded once before the run loop.
        Returns (y, ms)."""
        t0 = time.perf_counter()
        y = self.run_device(x_field)
        if y.is_cuda:
            torch.cuda.synchronize(y.device)
        return y, (time.perf_counter() - t0) * 1e3

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
        """Drop the operator's callables and planes (the callables hold the planes too); it
        is unusable afterwards."""
        def _freed(*_a, **_k):
            raise RuntimeError("operator was freed; re-create it with get_operator()")

        self.run_device = _freed
        self.run_device_dot = _freed
        self.run_pupdate_dot_op = None
        self.run_update_recompute_op = None
        self.planes = None


_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _as_stencil5(mat) -> Stencil5:
    if isinstance(mat, Stencil5):
        return mat
    if isinstance(mat, formats.COOMatrix):
        mat = formats.coo_to_csr(mat)
    if isinstance(mat, formats.CSRMatrix):
        return formats.csr_to_stencil5(mat)
    raise TypeError(f"cannot interpret {type(mat)} as a 5-point stencil")


def _planes_device(st: Stencil5, dtype, device):
    """Device coefficient planes for a Stencil5: synthesized on the device when
    ``st.planes`` is None (from ``st.constant``, bit-identical to the host generator's),
    else the host planes carried across."""
    if st.planes is None:
        if st.constant is None:
            raise ValueError("Stencil5 needs planes or constant coefficients")
        return make_stencil5_planes_device(st.grid_size, *st.constant, dtype=dtype,
                                           device=device)
    return convert.planes_from_numpy(st.planes, dtype, device)


def _init_stencil5(st: Stencil5, dtype, device, coeff_dtype=None, name="stencil5",
                   spmv=_st5.spmv_stencil5) -> DeviceOperator:
    """Values-carrying stencil through K8.  ``coeff_dtype`` (mode ``stencil5-bf16c``):
    bfloat16 planes while the state stays ``dtype``.  Mode ``stencil5-xla`` passes K8's
    plain twin as ``spmv``: the port of the JAX package's pure-XLA operator, the kernel's
    oracle and baseline."""
    g = st.grid_size
    planes = _planes_device(st, coeff_dtype or dtype, device)

    def run_device(x):
        return spmv(planes, x)

    def run_device_dot(x):
        return spmv(planes, x, with_dot=True)

    return DeviceOperator(
        name=name, num_rows=g * g, num_cols=g * g, nnz=st.nnz, grid_size=g,
        field_shape=(g, g), device=device, dtype=dtype, run_device=run_device,
        run_device_dot=run_device_dot, planes=planes,
    )


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
    "stencil5": _init_stencil5,
    "stencil5-bf16c": lambda st, dtype, device: _init_stencil5(
        st, dtype, device, coeff_dtype=torch.bfloat16, name="stencil5-bf16c"),
    "stencil5-xla": lambda st, dtype, device: _init_stencil5(
        st, dtype, device, name="stencil5-xla", spmv=_st5.spmv_stencil5_plain),
    "stencil5-const": _init_stencil5_const,
    "stencil5-const-xla": _init_stencil5_const_xla,
    # the reference's alias (src/spmv/spmv.cu:12-15)
    "stencil5-csr": _init_stencil5,
}

# modes of the JAX registry still to be ported -> their ROADMAP Queue 1 item
_NOT_PORTED = dict.fromkeys(
    ("csr", "csr-xla", "ell", "cusparse-csr", "dia", "dia-xla", "bcoo"),
    "ROADMAP Queue 1 item 9 (generic operators, kernels K11-K13)")


def available_modes():
    return sorted(_REGISTRY)


def get_operator(mode: str, mat, dtype=torch.float32, device="cuda") -> DeviceOperator:
    """Build a device operator (reference get_operator + op->init in one step)."""
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"mode '{mode}' is not ported yet: {_NOT_PORTED[mode]}")
    if mode not in _REGISTRY:
        raise ValueError(f"unknown SpMV mode '{mode}'; available: {available_modes()}")
    return _REGISTRY[mode](_as_stencil5(mat), resolve_dtype(dtype), resolve_device(device))
