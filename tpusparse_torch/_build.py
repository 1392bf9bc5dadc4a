"""Build the package's CUDA sources into one shared library and load it with ctypes.

The sources under ``tpusparse_torch/csrc/`` are compiled by ``nvcc`` at first use, for
Hopper only (``sm_90a``): one ``nvcc -c`` per ``.cu`` file, all started together, then one
link into ``tpusparse_torch/build/<hash>/libtpusparse_kernels.so``, where ``<hash>``
covers the sources (headers included) and the compiler flags: an edit to a source builds
anew, an unchanged tree reuses the library.  The library has a plain C interface; every
entry point takes raw device pointers and a ``cudaStream_t`` and returns a CUDA error code.

Any failure to find ``nvcc``, to compile or to load raises ``RuntimeError``: there is no
fallback.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

from .bench import profiling

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
LIB_NAME = "libtpusparse_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
_STATES = ("f32", "f64", "bf16")  # the state dtypes of the kernels that take all three
# name -> (argtypes, restype) of every C function in csrc/: the kernel entry points return
# a CUDA error code, the size queries an int64, tps_error_string a C string
_SIGNATURES = {
    "tps_error_string": ((ctypes.c_int,), ctypes.c_char_p),
    "tps_stencil5_partials": ((_I, _I), _I),
    "tps_stencil5_max_rows": ((), _I),
    **{f"tps_spmv_stencil5_const_{t}": ((_P, _P, _P, _P, _I, _I, _D, _D, _P, _P, _P),
                                        ctypes.c_int) for t in _STATES},
    "tps_spmv_stencil5_const_vec_partials": ((_I, _I, _I, _I), _I),
    **{f"tps_spmv_stencil5_const_vec_{t}": ((_P, _P, _P, _P, _I, _I, _I, _D, _D, _P, _P, _P,
                                            _P), ctypes.c_int) for t in _STATES},
    **{f"tps_stencil5_const_pupdate_dot_{t}": ((_P, _P, _P, _P, _P, _P, _I, _I, _D, _D, _P,
                                                _P, _P), ctypes.c_int) for t in ("f32", "f64")},
    **{f"tps_cg_const_update_recompute_{t}": ((_P, _P, _P, _P, _P, _P, _I, _I, _D, _D, _P,
                                               _P, _P), ctypes.c_int) for t in ("f32", "f64")},
    **{f"tps_{k}_vec_{t}": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _D, _P, _P, _P, _P),
                            ctypes.c_int)
       for k in ("stencil5_const_pupdate_dot", "cg_const_update_recompute")
       for t in ("f32", "f64")},
    **{f"tps_stencil5_const_pupdate_spmv_{t}": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _D, _D,
                                                 _P, _P, _P), ctypes.c_int)
       for t in ("f32", "f64")},
    **{f"tps_spmv_stencil5_{t}": ((_P, _P, _P, _P, _P, _I, _I, _P, _P, _P), ctypes.c_int)
       for t in ("f32", "f64", "bf16_f32", "bf16_f64", "bf16_bf16")},
    **{f"tps_spmv_stencil5_pupdate_{t}": ((_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P),
                                          ctypes.c_int)
       for t in ("f32", "f64", "bf16_f32", "bf16_f64")},
    "tps_blas1_partials": ((_I,), _I),
    "tps_row_partials": ((_I,), _I),
    **{f"tps_cg_update_{t}": ((_P, _P, _P, _P, _P, _I, _P, _P, _P), ctypes.c_int)
       for t in _STATES},
    **{f"tps_p_update_{t}": ((_P, _P, _P, _I, _P), ctypes.c_int) for t in _STATES},
    **{f"tps_dot_{t}": ((_P, _P, _I, _P, _P, _P, _P), ctypes.c_int) for t in _STATES},
    **{f"tps_axpby_dot_{t}": ((_P, _P, _P, _P, _P, _I, _P, _P, _P), ctypes.c_int)
       for t in _STATES},
    **{f"tps_spmv_ell_{t}": ((_P, _P, _P, _P, _I, _I, _I, _P, _P, _P), ctypes.c_int)
       for t in _STATES},
    **{f"tps_spmv_dia_{t}": ((_P, _P, _P, _P, _I, _I, _P, _P, _P), ctypes.c_int)
       for t in _STATES},
    "tps_graph_preload": ((), ctypes.c_int),
    **{f"tps_graph_cond_begin_{t}": ((ctypes.c_int, _P, _I, _P, _P, _P, _P,
                                      ctypes.POINTER(ctypes.c_ulonglong)), ctypes.c_int)
       for t in ("f32", "f64")},
    **{f"tps_graph_cond_set_{t}": ((ctypes.c_ulonglong, _P, _I, _P, _P, _P), ctypes.c_int)
       for t in ("f32", "f64")},
    "tps_graph_cond_end": ((_P,), ctypes.c_int),
    "tps_graph_stream_create": ((ctypes.POINTER(ctypes.c_void_p),), ctypes.c_int),
    "tps_mesh_publish_rows": ((_P, ctypes.c_int, ctypes.c_int, _P, _P), ctypes.c_int),
    **{f"tps_mesh_publish_partial_{t}": ((_P, _P, ctypes.c_int, _P, _P), ctypes.c_int)
       for t in ("f32", "f64")},
    **{f"tps_mesh_wait_{t}": ((_P, _P, ctypes.c_int, ctypes.c_uint64, _P, _P, _I, _I, _P),
                              ctypes.c_int) for t in ("f32", "f64")},
    "tps_mesh_preload": ((), ctypes.c_int),
    "tps_mesh_enable_peer": ((ctypes.c_int, ctypes.c_int), ctypes.c_int),
    "tps_probe_read_partials": ((_I,), _I),
    "tps_probe_read_f32": ((_P, _I, _P, _P), ctypes.c_int),
    "tps_probe_copy_f32": ((_P, _P, _I, _P), ctypes.c_int),
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of that build (ptxas register and spill lines)


def sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
                       "tpusparse_torch can only be built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds):
    """Start every command at once, wait for all; raise on the first that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _compile(out: pathlib.Path) -> str:
    nvcc = nvcc_path()
    cu = [p for p in sources() if p.suffix == ".cu"]
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    work = out.parent / f".objs.{os.getpid()}"  # private to this process until the rename
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = [work / f"{p.stem}.o" for p in cu]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", str(o)]
                    for p, o in zip(cu, objs)])
        tmp = work / LIB_NAME
        log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)  # atomic: a concurrent build never loads a half-written file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return log


def _load(path: pathlib.Path):
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)  # AttributeError names a missing entry point
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def lib():
    """The loaded kernel library, built first if needed, inside a ``Kernel_Load`` span
    (``bench.profiling``; attribute ``built``: whether nvcc ran)."""
    global _lib, build_log
    if _lib is not None:  # the launch path: no lock once the library is loaded
        return _lib
    with _lock:
        if _lib is None:
            with profiling.scope(profiling.PHASE_KERNEL_LOAD) as span:
                out = BUILD / _digest() / LIB_NAME
                span.attrs["built"] = not out.exists()
                log = _compile(out) if span.attrs["built"] else ""
                _lib = _load(out)
            build_log = log
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error (a launch that was refused)."""
    if err != 0:
        msg = lib().tps_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
