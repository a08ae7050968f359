"""Build and load the port's CUDA kernels.

Each kernel is one source ``ops/csrc/<name>.cu`` with a plain C interface.
At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``map_oxidize_tpu_torch/_build/`` and loaded with ``ctypes``.  The
library's file name carries a digest of the source and the flags, so an
edited source never loads a stale build.  Nothing here runs at import time:
a machine without a CUDA toolkit imports the package and uses the plain
versions of the kernels on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: every kernel source of the port
KERNELS = ("kmeans_assign_sum", "tokenize_compact")

#: libraries loaded in this process, by kernel name
_loaded: dict[str, ctypes.CDLL] = {}
#: nvcc's resource report (``-Xptxas -v``) of each build made by this process
build_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc`` in the CUDA toolkit that PyTorch's extension builder
    finds (``$CUDA_HOME``, then ``nvcc`` on ``PATH``, then the default
    install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not path.is_file():
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile the named kernels (all of :data:`KERNELS` by default) that
    have no current library, one ``nvcc`` each, all started together.
    Raises with the compiler's output if any build fails."""
    names = names or KERNELS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.is_file():
            continue
        tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed (cached per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)[name]))
    return lib
