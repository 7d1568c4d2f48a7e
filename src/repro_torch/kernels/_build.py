"""Builds the port's CUDA C++ sources into shared libraries, bound with ctypes.

Each kernel's ``csrc/*.cu`` exposes a plain ``extern "C"`` entry; ``nvcc``
compiles it for Hopper (``sm_90a``) into ``build/kernels/`` at the root of
the checkout, at first use, named by a hash of every file under the
source's ``csrc/`` directory (the ``.cu`` and the headers it includes) and
of the flags. A plain C interface builds in seconds, where a source that
includes PyTorch's headers takes minutes. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc`` or ``nvcc`` on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def digest(source: Path) -> str:
    """Hash of the flags and of every file in ``source``'s directory tree,
    by relative path and content: a changed header rebuilds the library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    root = Path(source).resolve().parent
    for f in sorted(p for p in root.rglob("*") if p.is_file()):
        h.update(b"\0" + str(f.relative_to(root)).encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str, source: Path) -> Path:
    """Where :func:`build` puts the library of ``source`` as it is now."""
    return BUILD_DIR / f"{name}-{digest(source)}.so"


def build(name: str, source: Path) -> tuple[Path, str]:
    """Compile ``source`` (once per content) → (library path, compiler log).

    The log holds ``ptxas -v``'s registers and spills per kernel; it is
    empty when the library was already built.
    """
    lib = library_path(name, source)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                         capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def load(name: str, source: Path) -> tuple[ctypes.CDLL, str]:
    """Build (if needed) and load ``source`` → (library, compiler log)."""
    lib, log = build(name, source)
    return ctypes.CDLL(str(lib)), log
