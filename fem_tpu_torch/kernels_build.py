"""Build and load the hand-written native code of `fem_tpu_torch/csrc/`.

The sources have a plain C interface. At first use each CUDA source (`*.cu`)
is compiled with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c
-Xcompiler -fPIC`, one nvcc process per source, all started together; the
objects are then linked into one shared library under `build/kernels/` at
the repository root (listed in .gitignore), named by a hash of the sources
and flags so that an edited source is rebuilt, and loaded with ctypes.

The host sources (`*.cpp`: the VTK text formatter, `vtk_text.cpp`, and the
mesh check's Jacobians, `mesh_check.cpp`) go into a second library
beside it, built by the host compiler alone (`g++ -O3 -std=c++17 -fPIC
-shared -pthread`), so a machine without nvcc builds it too. `library()`
builds and loads it with the CUDA library, its compiler running beside the
nvcc processes, so a run that launches a kernel has it ready before it
writes any output; `host_library()` builds it on first use where nothing
has (`problem.load` on a checkout's first run). Nothing is built or loaded
at import time: the CPU tests import every module of the package.

nvcc is taken from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin; the
host compiler is g++, else c++, from PATH.
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

HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
_LL = ctypes.c_longlong
# host entry point -> (argtypes, restype)
HOST_SIGNATURES = {
    # (coords, stress, disp, nnds, pdim, cpdim, vtk_ids, offsets, nodes, ne,
    #  threads, out, len)
    "fem_vtk_text": ([_P, _P, _P, _LL, ctypes.c_int, ctypes.c_int, _P, _P,
                      _P, _LL, ctypes.c_int, ctypes.POINTER(_P),
                      ctypes.POINTER(_LL)], ctypes.c_int),
    "fem_vtk_free": ([_P], None),
    # (coords, pdim, conn, ne, nn, dN, nip, threads, out) -> elements whose
    # least det J is <= 0, or -1 for a shape the port does not have
    "fem_mesh_min_detj": ([_P, ctypes.c_int, _P, _LL, ctypes.c_int, _P,
                           ctypes.c_int, ctypes.c_int, _P], _LL),
}


def host_threads(items: int, per_thread: int) -> int:
    """Threads for host work on `items` rows or elements: one per CPU this
    process may run on, at most one per `per_thread` items, at least one."""
    return max(1, min(len(os.sched_getaffinity(0)), items // per_thread))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _cxx() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _host_sources():
    return sorted(CSRC.glob("*.cpp"))


def _hashed(stem: str, flags, sources) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _hashed("libfem_kernels", NVCC_FLAGS, _sources())


def host_library_path() -> Path:
    return _hashed("libfem_host", HOST_FLAGS, _host_sources())


def _start_host_build():
    """Start the host compiler on the host sources, unless their library
    exists: (command, temporary output, process), or None."""
    out = host_library_path()
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *HOST_FLAGS, "-o", str(tmp),
           *(str(s) for s in _host_sources())]
    return cmd, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def _finish_host_build(job) -> Path:
    out = host_library_path()
    if job is None:
        return out
    cmd, tmp, proc = job
    report = proc.communicate()[0]
    log = f"$ {' '.join(cmd)}\n{report}[exit {proc.returncode}]\n"
    out.with_suffix(".so.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the host compiler failed:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    return out


def build_host() -> Path:
    """Compile the host sources unless the library for their hash exists."""
    return _finish_host_build(_start_host_build())


def build() -> Path:
    """Compile the sources unless the library for their hash exists: one
    nvcc per source, run in parallel with the host library's compiler where
    that library is missing, then one link. The compilers' report
    (registers, spills per kernel) is kept beside each library as
    `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = out.with_suffix(f".{os.getpid()}")
    nvcc = _nvcc()
    host_job = _start_host_build()
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
    _finish_host_build(host_job)
    if not ok:
        raise RuntimeError(f"nvcc failed building the CUDA kernels:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), and the host
    library loaded beside it."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    host_library()
    return lib


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    lib = ctypes.CDLL(str(build_host()))
    for name, (argtypes, restype) in HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
