"""Build and load the hand-written CUDA kernels of `fem_tpu_torch/csrc/`.

The sources have a plain C interface. At first use they are compiled with
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into one shared library under `build/kernels/` at the repository root (listed
in .gitignore), named by a hash of the sources and flags so that an edited
source is rebuilt, and loaded with ctypes. Nothing is built or loaded at
import time: the CPU tests import every module of the package.

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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# C entry point -> argtypes; every entry point returns cudaGetLastError().
SIGNATURES = {
    "hex8_stiffness_f64": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "hex8_stiffness_f32": [_P, _P, _P, _P, ctypes.c_longlong, _P],
    "stencil_matvec_f64": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, _P],
    "stencil_matvec_f32": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
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
    """Compile the sources unless the library for their hash exists. The
    compiler's report (registers, spills per kernel) is kept beside it as
    `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"\n[{time.perf_counter() - t0:.1f} s, exit {proc.returncode}]\n")
    out.with_suffix(".so.log").write_text(log)
    if proc.returncode != 0:
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
