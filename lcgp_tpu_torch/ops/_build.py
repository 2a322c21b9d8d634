"""Build and load the port's hand-written CUDA kernels.

Each source under ``lcgp_tpu_torch/csrc/`` is compiled with its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  The library is built on first
use into ``build/lcgp_tpu_torch/<hash of sources and flags>/`` at the root
of the checkout and reused while the sources are unchanged.  Nothing here
runs at import time: the CPU-only test suite imports every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ..utils.profiling import record_compile
from .launch import FAMILIES

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_ROOT = _PKG_DIR.parent / "build" / "lcgp_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# (x1, x2, inv_l, amp, nug, row_scale, diag_vec, same, q, n1, n2, d,
#  out, c0_out, stream) -> cudaError_t
GRAM_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P]
# (x1, x2, inv_l, amp, nug, M, w, alpha, beta, same, q, n1, n2, d,
#  partials, glens, gamp, gnug, stream) -> cudaError_t
VJP_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_double, _I, _I, _I,
                _I, _I, _P, _P, _P, _P, _P]
# (q, n1, n2, d) -> f64 scratch entries for any family's VJP
SCRATCH_ARGTYPES = [_I, _I, _I, _I]
# (x1, x2, inv_l, amp, nug, M, q, n1, n2, d, partials, gx, stream)
#  -> cudaError_t
VJP_X_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
# (n1, n2, d) -> f64 scratch entries for any family's VJP in x
VJP_X_SCRATCH_ARGTYPES = [_I, _I, _I]


class KernelLibrary:
    """The loaded shared library plus how it was built, with the entry
    points of every kernel family of ``ops/launch.py`` bound:
    ``lcgp_<family>_gram_{f64,f32}``, ``lcgp_<family>_gram_vjp_{f64,f32}``,
    ``lcgp_<family>_gram_vjp_x_{f64,f32}`` and the shared scratch sizes
    ``lcgp_matern32_gram_vjp_scratch`` and ``lcgp_gram_vjp_x_scratch``."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for family in FAMILIES:
            for kind, argtypes in (("gram", GRAM_ARGTYPES),
                                   ("gram_vjp", VJP_ARGTYPES),
                                   ("gram_vjp_x", VJP_X_ARGTYPES)):
                for dt in ("f64", "f32"):
                    fn = getattr(self.lib, f"lcgp_{family}_{kind}_{dt}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
        for fn, argtypes in (
                (self.lib.lcgp_matern32_gram_vjp_scratch, SCRATCH_ARGTYPES),
                (self.lib.lcgp_gram_vjp_x_scratch, VJP_X_SCRATCH_ARGTYPES)):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_longlong


_LIBRARY: KernelLibrary | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of lcgp_tpu_torch "
                       "are built from source on first use and need the "
                       "CUDA toolkit (nvcc on PATH or /usr/local/cuda)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile (if needed) and load the kernel library; cached per process."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / "liblcgp_kernels.so"
    log_path = out_dir / "build.log"
    t0 = time.perf_counter()
    log = ""
    built = not lib_path.exists()
    if not built:
        # the compiler's report of the build that made this library
        log = log_path.read_text() if log_path.exists() else ""
    else:
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        # one private work directory per build, renamed into place at the
        # end: concurrent builds never load a half-written library
        work = Path(tempfile.mkdtemp(dir=out_dir))
        try:
            jobs = []
            for src in (s for s in _sources() if s.suffix == ".cu"):
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
                       str(work / (src.stem + ".o")), str(src)]
                jobs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            objs = []
            for cmd, proc in jobs:
                out, _ = proc.communicate()
                log += out
                if proc.returncode != 0:
                    for _, other in jobs:
                        other.kill()
                        other.wait()
                    raise RuntimeError(
                        f"nvcc failed (exit {proc.returncode}): "
                        f"{' '.join(cmd)}\n{out}")
                objs.append(cmd[cmd.index("-o") + 1])
            tmp = work / lib_path.name
            cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed (exit {proc.returncode}): "
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            (work / log_path.name).write_text(log)
            os.replace(work / log_path.name, log_path)
            os.replace(tmp, lib_path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    _LIBRARY = KernelLibrary(lib_path, time.perf_counter() - t0, log)
    record_compile(f"kernel library {lib_path} "
                   f"({'built' if built else 'loaded'})",
                   _LIBRARY.build_seconds)
    return _LIBRARY
