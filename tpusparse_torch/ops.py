"""SpMV operator registry of the port.

Counterpart of ``tpusparse/ops.py``: ``get_operator(mode, matrix)`` returns a
``DeviceOperator`` whose callables the CG solver and the CLIs drive.  Every mode of the JAX
registry is ported.  The stencil modes take a ``Stencil5`` (a CSR or COO matrix is read as
one, ``formats.csr_to_stencil5``):

  - ``"stencil5"``           values-carrying stencil: five coefficient planes on the
                             device, SpMV through the CUDA kernel K8 and the fused
                             p-update pass through K9 (``kernels/stencil5.py``);
                             ``"stencil5-csr"`` is the reference's alias for it;
  - ``"stencil5-bf16c"``     the same with bfloat16 planes and f32/f64 state: plane traffic
                             halves (28 -> 18 B/pt in f32), bit-identical results for
                             coefficients exact in bf16 (5, -1 and 0 are);
  - ``"stencil5-xla"``       the planes operator in plain PyTorch (K8's twin), as the JAX
                             package left it to XLA: oracle and baseline;
  - ``"stencil5-const"``     values-free constant-coefficient stencil through the CUDA
                             kernels K1-K3, with the two recompute-CG passes, and the
                             fused p-update pass through K10;
  - ``"stencil5-const-xla"`` the same operator in plain PyTorch.

The generic modes take any square ``CSRMatrix``, ``COOMatrix`` or ``Stencil5``:

  - ``"csr"``                the slot-major ELL pack through the CUDA kernel that replaces
                             K12/K13 (``kernels/ell.py``); ``"cusparse-csr"`` is the
                             reference's alias for it;
  - ``"csr-xla"``, ``"ell"`` the same operand through the kernel's plain twin, the port of
                             the JAX package's XLA gather;
  - ``"dia"``                diagonal-offset storage through the CUDA kernel K11
                             (``kernels/dia.py``); ``"dia-xla"`` is its plain twin;
  - ``"bcoo"``               a matvec on ``torch.sparse_csr_tensor`` (cuSPARSE on a card, the
                             reference's own baseline), the port of ``jax.experimental.sparse``,
                             in row bands of at most ``BCOO_BAND_ENTRIES`` entries.

A generic operator's field is the vector itself, ``num_rows`` elements: the JAX package's
128-lane padding is a TPU answer and has no counterpart.  x and y share that field, so a
non-square matrix raises ``ValueError``.  A planes-free constant ``Stencil5`` (``gen:<g>``)
gets its ELL, DIA and CSR operands made on the device (``generate.make_stencil5_ell_device``,
``make_stencil5_dia_device``, ``make_stencil5_csr_device``), and HPCG's ``Stencil27``
(``gen27:<n>``) its ELL operand (``generate.make_stencil27_ell_device``), which only the
ELL modes take (``STENCIL27_MODES``; the others raise ``ValueError``); every other matrix goes
through the host packs (``formats.csr_to_ell``/``stencil5_to_ell``,
``csr_to_dia``/``stencil5_to_dia``, ``stencil5_to_csr``).  The
matrices are the port's own classes (``formats``); ``convert.stencil5_from_numpy`` and
``csr_from_numpy`` carry another package's in.  PyTorch
runs eagerly, so the JAX package's explicit-operand machinery for ``jax.jit``
(``operands``, ``_wrap_ops``) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from . import convert, formats
from ._device import acc_dtype, host_numpy, resolve_device, resolve_dtype
from .bench import profiling
from .formats import CSRMatrix, Stencil5, Stencil27
from .generate import (make_stencil5_csr_device, make_stencil5_dia_device,
                       make_stencil5_ell_device, make_stencil5_planes_device,
                       make_stencil27_ell_device, stencil5_dia_device_ok,
                       stencil5_ell_device_ok)
from .kernels import blas1 as _blas1
from .kernels import dia as _dia
from .kernels import ell as _ell
from .kernels import stencil5 as _st5


@dataclasses.dataclass
class DeviceOperator:
    """Operator contract (reference ``SpmvOperator``, include/spmv.h:125-134):

    - ``run_device(x) -> y``; ``run_device_dot(x) -> (y, <x, y>)``, and for the operators
      that ``captures`` ``run_device_dot(x, out=y)``, y written into the field given;
    - ``run_timed(x_host) -> (y_host, ms)`` and ``run_timed_resident(x) -> (y, ms)``;
    - optional recompute-Ap CG passes (8 words/point/iteration, Ap never stored):
      ``run_pupdate_dot_op(beta, r, p, out=None) -> (p', <p', A·p'>)`` and
      ``run_update_recompute_op(alpha, x, r, p) -> (x, r, <r, r>)`` (x, r in place);
    - optional fused p-update pass of ``cg_solve(fused_pupdate=True)``:
      ``run_fused_pupdate_op(beta, r, p, out=None, y_out=None) -> (p', A·p', <p', A·p'>)``
      with p' = r + β·p (K9 on ``stencil5``/``stencil5-bf16c``, K10 on ``stencil5-const``);
    - ``planes``: the coefficient planes of the values-carrying modes, else None;
    - ``operand``: the generic modes' device operand by name (ELL ``vals``/``cols``, DIA
      ``data``/``offsets``, the ``bcoo`` CSR ``row_ptr``/``col``/``val`` and its row
      ``bands``, ``(r0, r1, sparse CSR tensor)`` each), else None;
    - ``captures``: every callable runs a port kernel and takes the buffers it writes, so
      ``cg_solve`` may capture its loop into a CUDA graph (``solvers/cg.DeviceLoop``); the
      plain twins' modes and ``bcoo`` do not;
    - ``graphs``: the captured loops, by ``DeviceLoop.key``;
    - ``free()`` drops the operator's callables, planes, operand and captured loops."""

    name: str
    num_rows: int
    num_cols: int
    nnz: int
    grid_size: int  # 0 for a matrix that is not a g×g stencil
    field_shape: tuple  # the vector as the kernels see it: (g, g) stencil, (n,) generic
    device: torch.device
    dtype: torch.dtype
    run_device: Callable
    run_device_dot: Callable
    run_pupdate_dot_op: Optional[Callable] = None
    run_update_recompute_op: Optional[Callable] = None
    run_fused_pupdate_op: Optional[Callable] = None
    planes: Optional[torch.Tensor] = None
    operand: Optional[dict] = None
    captures: bool = False
    graphs: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def field_elems(self) -> int:
        return math.prod(self.field_shape)

    @property
    def numpy_dtype(self):
        """The state's dtype in numpy (f32 for a bf16 state, which numpy lacks): a host
        vector is cast to it before its upload."""
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
        """The canonical b = ones right-hand side (length num_cols), made on the device."""
        return torch.ones(self.field_shape, dtype=dtype or self.dtype, device=self.device)

    def run_timed(self, x_flat_host):
        """The reference's run_timed (spmv_cusparse_csr.cu:234-264): the upload of x, one
        apply and the download of y, on the host clock.  x is cast to the operator's dtype
        on the host, before the upload.  Returns (y as numpy, ms)."""
        t0 = time.perf_counter()
        x = self.as_field(np.asarray(x_flat_host, dtype=self.numpy_dtype))
        y = self.run_device(x)
        y_host = host_numpy(self.from_field(y))  # the download is also the sync
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
        """Drop the operator's callables, planes, operand and captured loops (the callables
        hold them too; each loop its graphs, their memory pools and its fields); it is
        unusable afterwards."""
        def _freed(*_a, **_k):
            raise RuntimeError("operator was freed; re-create it with get_operator()")

        self.run_device = _freed
        self.run_device_dot = _freed
        self.run_pupdate_dot_op = None
        self.run_update_recompute_op = None
        self.run_fused_pupdate_op = None
        self.planes = None
        self.operand = None
        self.graphs.clear()


# numpy has no bfloat16: a bf16 state's host vector is f32, cast on the device
_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64,
                torch.bfloat16: np.float32}


def _as_csr(mat) -> CSRMatrix:
    if isinstance(mat, CSRMatrix):
        return mat
    if isinstance(mat, formats.COOMatrix):
        return formats.coo_to_csr(mat)
    if isinstance(mat, Stencil5):
        return formats.stencil5_to_csr(mat)
    raise TypeError(f"cannot interpret {type(mat)} as a matrix")


def _as_stencil5(mat) -> Stencil5:
    if isinstance(mat, Stencil5):
        return mat
    return formats.csr_to_stencil5(_as_csr(mat))


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
                   spmv=_st5.spmv_stencil5, fused=_st5.spmv_stencil5_pupdate) -> DeviceOperator:
    """Values-carrying stencil through K8, with the fused p-update pass through K9.
    ``coeff_dtype`` (mode ``stencil5-bf16c``): bfloat16 planes while the state stays
    ``dtype``.  Mode ``stencil5-xla`` passes K8's plain twin as ``spmv`` and no fused pass,
    as the JAX package's pure-XLA operator has none: the kernel's oracle and baseline."""
    g = st.grid_size
    planes = _planes_device(st, coeff_dtype or dtype, device)

    def run_device(x):
        return spmv(planes, x)

    def run_device_dot(x, out=None):
        return spmv(planes, x, with_dot=True, out=out)

    def run_fused_pupdate_op(beta, r, p, out=None, y_out=None):
        """(p', A·p', <p', A·p'>) with p' = r + β·p in one pass (kernel K9)."""
        return fused(planes, beta, r, p, out=out, y_out=y_out)

    return DeviceOperator(
        name=name, num_rows=g * g, num_cols=g * g, nnz=st.nnz, grid_size=g,
        field_shape=(g, g), device=device, dtype=dtype, run_device=run_device,
        run_device_dot=run_device_dot,
        run_fused_pupdate_op=run_fused_pupdate_op if fused is not None else None,
        planes=planes, captures=spmv is _st5.spmv_stencil5,
    )


def _init_stencil5_const(st: Stencil5, dtype, device) -> DeviceOperator:
    diag, offdiag = convert.operand_from_stencil5(st)
    g = st.grid_size

    def run_device(x):
        return _st5.spmv_stencil5_const(x, diag=diag, offdiag=offdiag)

    def run_device_dot(x, out=None):
        return _st5.spmv_stencil5_const(x, diag=diag, offdiag=offdiag, with_dot=True,
                                        out=out)

    def run_pupdate_dot_op(beta, r, p, out=None):
        """Pass A of the recompute-Ap iteration: (p', <p', A·p'>) (kernel K1)."""
        return _st5.spmv_stencil5_const_pupdate_dot(beta, r, p, diag=diag, offdiag=offdiag,
                                                    out=out)

    def run_update_recompute_op(alpha, x, r, p):
        """Pass B: (x', r', <r', r'>) with A·p recomputed from p (kernel K2)."""
        return _st5.cg_const_update_recompute(alpha, x, r, p, diag=diag, offdiag=offdiag)

    def run_fused_pupdate_op(beta, r, p, out=None, y_out=None):
        """(p', A·p', <p', A·p'>) with p' = r + β·p in one pass (kernel K10)."""
        return _st5.spmv_stencil5_const_pupdate(beta, r, p, diag=diag, offdiag=offdiag,
                                                out=out, y_out=y_out)

    return DeviceOperator(
        name="stencil5-const", num_rows=g * g, num_cols=g * g, nnz=st.nnz, grid_size=g,
        field_shape=(g, g), device=device, dtype=dtype, run_device=run_device,
        run_device_dot=run_device_dot, run_pupdate_dot_op=run_pupdate_dot_op,
        run_update_recompute_op=run_update_recompute_op,
        run_fused_pupdate_op=run_fused_pupdate_op, captures=True,
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


# ---------------------------------------------------------------------------
# Generic operators
# ---------------------------------------------------------------------------


def _square(mat, mode):
    """The size n of a square matrix; ValueError for any other."""
    if mat.num_rows != mat.num_cols:
        raise ValueError(f"mode '{mode}' needs a square matrix, got {mat.num_rows} x "
                         f"{mat.num_cols}: x and y share one field")
    return mat.num_rows


def _const_stencil(mat):
    """(g, diag, offdiag) of a planes-free constant Stencil5 (``gen:<g>``), else None."""
    if isinstance(mat, Stencil5) and mat.planes is None and mat.constant is not None:
        return (mat.grid_size, *mat.constant)
    return None


def _ell_operand(mat, mode, dtype, device):
    """(vals, cols, nnz, grid_size): the slot-major ELL operand on the device and its nnz,
    counted as the JAX package counts it (a Stencil5's stored nonzeros; a Stencil27's
    matrix entries, not its 27 slots a row)."""
    if isinstance(mat, Stencil27):
        itemsize = torch.finfo(dtype).bits // 8
        slots = 27 * mat.num_rows
        with profiling.scope(profiling.PHASE_STENCIL27_BUILD, nx=mat.nx, ny=mat.ny,
                             nz=mat.nz, width=27, slots=slots,
                             bytes=slots * (itemsize + 4)):
            vals, cols = make_stencil27_ell_device(mat.nx, mat.ny, mat.nz, *mat.constant,
                                                   dtype=dtype, device=device)
        return vals, cols, mat.nnz, 0
    const = _const_stencil(mat)
    if const is not None and stencil5_ell_device_ok(*const):
        vals, cols = make_stencil5_ell_device(*const, dtype=dtype, device=device)
        return vals, cols, mat.nnz, mat.grid_size
    if isinstance(mat, Stencil5):
        ell = formats.stencil5_to_ell(mat)
        nnz = int(np.count_nonzero(ell.val))
    else:
        csr = _as_csr(mat)
        _square(csr, mode)
        ell = formats.csr_to_ell(csr)
        nnz = csr.nnz
    vals, cols = convert.ell_from_numpy(ell.col, ell.val, dtype, device)
    return vals, cols, nnz, ell.grid_size


def _dia_operand(mat, mode, dtype, device):
    """(data, offsets, nnz, grid_size): the DIA operand on the device and the matrix's
    nnz."""
    const = _const_stencil(mat)
    if const is not None and stencil5_dia_device_ok(const[0]):
        data, offsets = make_stencil5_dia_device(*const, dtype=dtype, device=device)
        return data, offsets, mat.nnz, mat.grid_size
    if isinstance(mat, Stencil5):
        dia, nnz = formats.stencil5_to_dia(mat), mat.nnz
    else:
        csr = _as_csr(mat)
        _square(csr, mode)
        dia, nnz = formats.csr_to_dia(csr), csr.nnz
    data, offsets = convert.dia_from_numpy(dia.data, dia.offsets, dtype, device)
    return data, offsets, nnz, dia.grid_size


def _init_ell(mat, dtype, device, name="csr", spmv=_ell.spmv_ell) -> DeviceOperator:
    """General sparsity through the ELL kernel (modes ``csr``, ``cusparse-csr``) or, with
    ``spmv=spmv_ell_plain``, through its twin (``csr-xla``, ``ell``)."""
    vals, cols, nnz, g = _ell_operand(mat, name, dtype, device)
    n = vals.shape[1]

    def run_device(x):
        return spmv(vals, cols, x)

    def run_device_dot(x, out=None):
        return spmv(vals, cols, x, with_dot=True, out=out)

    return DeviceOperator(
        name=name, num_rows=n, num_cols=n, nnz=nnz, grid_size=g, field_shape=(n,),
        device=device, dtype=dtype, run_device=run_device, run_device_dot=run_device_dot,
        operand={"vals": vals, "cols": cols}, captures=spmv is _ell.spmv_ell,
    )


def _init_dia(mat, dtype, device, name="dia", spmv=_dia.spmv_dia) -> DeviceOperator:
    """Diagonal-offset storage through K11 (mode ``dia``) or, with
    ``spmv=spmv_dia_plain``, through its twin (``dia-xla``)."""
    data, offsets, nnz, g = _dia_operand(mat, name, dtype, device)
    n = data.shape[1]

    def run_device(x):
        return spmv(data, offsets, x)

    def run_device_dot(x, out=None):
        return spmv(data, offsets, x, with_dot=True, out=out)

    return DeviceOperator(
        name=name, num_rows=n, num_cols=n, nnz=nnz, grid_size=g, field_shape=(n,),
        device=device, dtype=dtype, run_device=run_device, run_device_dot=run_device_dot,
        operand={"data": data, "offsets": offsets}, captures=spmv is _dia.spmv_dia,
    )


# The most stored entries one ``bcoo`` matvec is handed: torch.sparse_csr_tensor's matvec
# (cuSPARSE) returned a wrong y for the 2.1e9 entries of the 20480² stencil, with int32
# and with int64 indices, and a right one for the 5.2e8 of 10240² (PERF.md §7).
BCOO_BAND_ENTRIES = 2 ** 29


def _row_bands(row_ptr, limit):
    """[(r0, r1), ...]: the rows cut into consecutive bands of at most ``limit`` stored
    entries each; a row is never split, so a row longer than ``limit`` is a band of its
    own.  ``row_ptr`` is a CSR row-pointer tensor on any device."""
    n = row_ptr.numel() - 1
    nnz = int(row_ptr[-1])
    bands, r0 = [], 0
    while r0 < n:
        target = min(int(row_ptr[r0]) + limit, nnz)  # stays within row_ptr's dtype
        r1 = int(torch.searchsorted(row_ptr, row_ptr.new_tensor([target]), right=True)) - 1
        r1 = min(max(r1, r0 + 1), n)
        bands.append((r0, r1))
        r0 = r1
    return bands


def _csr_matvec_plain(a, x):
    """A ``torch.sparse_csr_tensor`` times x in plain PyTorch, each row summed in entry
    order from 0: the CPU's product of ``bcoo``.  MKL's CPU matvec rounds a row
    differently by the matrix it is handed (14 of the first 100 rows of the g = 17 stencil
    differ by an ulp between the whole matrix and those 100 rows alone), so it could not
    show that cutting rows into bands leaves every row's sum as it was."""
    crow, col, val = a.crow_indices(), a.col_indices(), a.values()
    rows = torch.repeat_interleave(torch.arange(a.shape[0]), crow.diff().long())
    return torch.zeros(a.shape[0], dtype=val.dtype).index_add_(0, rows, val * x[col.long()])


def _init_bcoo(mat, dtype, device) -> DeviceOperator:
    """A matvec on ``torch.sparse_csr_tensor``: cuSPARSE on a card, the reference's own
    baseline (spmv_cusparse_csr.cu:182-285), as ``jax.experimental.sparse`` was the JAX
    package's independent cross-check.  Its dot is K6 (``blas1.dot``).  No Pallas kernel
    stood behind it, so no kernel of this package does either.

    The CSR is made on the device for a planes-free constant ``Stencil5``
    (``generate.make_stencil5_csr_device``), else carried from the host CSR.  It is cut
    into row bands of at most ``BCOO_BAND_ENTRIES`` entries (``_row_bands``), each a
    ``torch.sparse_csr_tensor`` of its rows with int32 indices: its own row pointers,
    shifted to start at 0, and views of the full column and value arrays.  Each band's
    matvec writes its own rows of one y, and each row is summed inside one band.  On a card
    the matvec is cuSPARSE's; on the CPU it is ``_csr_matvec_plain``, so there y equals
    the one-band product bit for bit.

    A bf16 state: the values are rounded to bf16 and held in f32 (widened once, exactly;
    the CPU's sparse matvec has no bf16), and each apply widens x to f32, runs the f32
    matvec and rounds y to bf16 once: the same arithmetic on the CPU and the card, and what
    cuSPARSE does with bf16 data and f32 compute.  It is the library baseline, not a port
    kernel."""
    const = _const_stencil(mat)
    if const is not None:
        row_ptr, col, val = make_stencil5_csr_device(*const, dtype=dtype, device=device)
        n, g = const[0] ** 2, mat.grid_size
    else:
        csr = _as_csr(mat)
        n, g = _square(csr, "bcoo"), csr.grid_size
        if n >= 2 ** 31:
            raise ValueError(f"mode 'bcoo' takes fewer than 2^31 rows (int32 columns), "
                             f"got {n}")
        row_ptr = torch.tensor(csr.row_ptr, dtype=torch.int64, device=device)
        col = torch.tensor(csr.col_idx, dtype=torch.int32, device=device)
        val = torch.tensor(csr.val, dtype=dtype, device=device)
    # a bf16 state's values are held in f32, widened once (exactly) from bf16
    val = val.to(acc_dtype(dtype))
    bands = []
    with warnings.catch_warnings():  # torch warns that sparse CSR support is in beta
        warnings.simplefilter("ignore", UserWarning)
        for r0, r1 in _row_bands(row_ptr, BCOO_BAND_ENTRIES):
            s, e = int(row_ptr[r0]), int(row_ptr[r1])
            crow = (row_ptr[r0:r1 + 1] - row_ptr[r0]).to(torch.int32)
            bands.append((r0, r1, torch.sparse_csr_tensor(
                crow, col[s:e], val[s:e], size=(r1 - r0, n), check_invariants=False)))

    def run_device(x):
        xf = x.reshape(-1).to(val.dtype)  # a bf16 x widened once, exactly
        y = torch.empty_like(xf)
        for r0, r1, a in bands:
            if xf.is_cuda:
                torch.mv(a, xf, out=y[r0:r1])
            else:
                y[r0:r1] = _csr_matvec_plain(a, xf)
        return y.to(x.dtype).reshape(x.shape)  # a bf16 y rounded once

    def run_device_dot(x):
        y = run_device(x)
        return y, _blas1.dot(x, y)

    return DeviceOperator(
        name="bcoo", num_rows=n, num_cols=n, nnz=col.numel(), grid_size=g,
        field_shape=(n,), device=device, dtype=dtype, run_device=run_device,
        run_device_dot=run_device_dot,
        operand={"row_ptr": row_ptr, "col": col, "val": val, "bands": bands},
    )


def _stencil(init, **kw):
    """A registry entry of a stencil mode: the matrix read as a Stencil5 first."""
    return lambda mat, dtype, device: init(_as_stencil5(mat), dtype, device, **kw)


_REGISTRY = {
    "stencil5": _stencil(_init_stencil5),
    "stencil5-bf16c": _stencil(_init_stencil5, coeff_dtype=torch.bfloat16,
                               name="stencil5-bf16c"),
    "stencil5-xla": _stencil(_init_stencil5, name="stencil5-xla",
                             spmv=_st5.spmv_stencil5_plain, fused=None),
    "stencil5-const": _stencil(_init_stencil5_const),
    "stencil5-const-xla": _stencil(_init_stencil5_const_xla),
    "csr": _init_ell,
    "csr-xla": lambda mat, dtype, device: _init_ell(mat, dtype, device, name="csr-xla",
                                                    spmv=_ell.spmv_ell_plain),
    "ell": lambda mat, dtype, device: _init_ell(mat, dtype, device, name="ell",
                                                spmv=_ell.spmv_ell_plain),
    "dia": _init_dia,
    "dia-xla": lambda mat, dtype, device: _init_dia(mat, dtype, device, name="dia-xla",
                                                    spmv=_dia.spmv_dia_plain),
    "bcoo": _init_bcoo,
    # the reference's aliases (src/spmv/spmv.cu:12-15)
    "cusparse-csr": _init_ell,
    "stencil5-csr": _stencil(_init_stencil5),
}


def available_modes():
    return sorted(_REGISTRY)


# the modes that take a Stencil27: the ELL kernel and its twin
STENCIL27_MODES = ("csr", "cusparse-csr", "csr-xla", "ell")


def get_operator(mode: str, mat, dtype=torch.float32, device="cuda") -> DeviceOperator:
    """Build a device operator (reference get_operator + op->init in one step), inside an
    ``Operator_Build`` span (``bench.profiling``)."""
    if mode not in _REGISTRY:
        raise ValueError(f"unknown SpMV mode '{mode}'; available: {available_modes()}")
    if isinstance(mat, Stencil27) and mode not in STENCIL27_MODES:
        raise ValueError(f"mode '{mode}' does not take the 27-point stencil: it runs through "
                         f"its ELL operand, mode 'csr' (or {', '.join(STENCIL27_MODES[1:])})")
    with profiling.scope(profiling.PHASE_OPERATOR_BUILD):
        return _REGISTRY[mode](mat, resolve_dtype(dtype), resolve_device(device))
