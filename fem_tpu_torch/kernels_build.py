"""Build and load the hand-written CUDA kernels of `fem_tpu_torch/csrc/`.

The sources have a plain C interface. At first use each is compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c -Xcompiler -fPIC`, one
nvcc process per source, all started together; the objects are then linked
into one shared library under `build/kernels/` at the repository root
(listed in .gitignore), named by a hash of the sources and flags so that an
edited source is rebuilt, and loaded with ctypes. Nothing is built or loaded
at import time: the CPU tests import every module of the package.

nvcc is taken from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# C entry point -> argtypes; every entry point returns cudaGetLastError().
SIGNATURES = {
    "hex8_stiffness_f64": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "hex8_stiffness_f32": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    # (coordinates, lam, mu, gradient of the output, out, ne)
    "hex8_stiffness_coord_grad_f64": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                                      _P],
    "hex8_stiffness_coord_grad_f32": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                                      _P],
    # (interior coefficients on the host, class tables, u, out, nx, ny, nz)
    "stencil_matvec_f64": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _P],
    "stencil_matvec_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _P],
    # K2's 2D branch: (interior coefficients on the host, class tables, u,
    # out, n0, n1) on the (n0, n1) = (ny, nx) node grid
    "stencil_matvec2d_f64": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    "stencil_matvec2d_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    # (indptr, indices, data, x, out, n rows, lanes)
    "csr_matvec_f64": [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       _P],
    "csr_matvec_f32": [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       _P],
    # (indptr, indices, x, gradient of the output, out, n rows, lanes)
    "csr_data_grad_f64": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                          ctypes.c_int, _P],
    "csr_data_grad_f32": [_P, _P, _P, _P, _P, ctypes.c_longlong,
                          ctypes.c_int, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfem_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists: one
    nvcc per source, run in parallel, then one link. The compilers' report
    (registers, spills per kernel) is kept beside the library as
    `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = Path(f"{stem}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, ok = "", True
    for cmd, _, proc in jobs:
        report = proc.communicate()[0]
        log += f"$ {' '.join(cmd)}\n{report}[exit {proc.returncode}]\n"
        ok = ok and proc.returncode == 0
    tmp = Path(f"{stem}.tmp")
    if ok:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log += f"$ {' '.join(cmd)}\n{proc.stdout}[exit {proc.returncode}]\n"
        ok = proc.returncode == 0
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    log += f"[{time.perf_counter() - t0:.1f} s]\n"
    out.with_suffix(".so.log").write_text(log)
    if not ok:
        raise RuntimeError(f"nvcc failed building the CUDA kernels:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
