"""nvcc builds of the port's CUDA sources (`csrc/*.cu`), shared by the
kernel wrappers.

Each source compiles on first use into a shared library with a plain C
interface, for `sm_90a`, into the git-ignored `videoyolo_torch/_build/`.  The
library is named after a hash of the source and the flags, so an edited
source builds anew and an unchanged one is not built twice.  The wrappers
bind it with ctypes.  Importing this module needs neither nvcc nor a GPU.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG / "_build"
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def sass(lib: Path) -> str:
    """The SASS of a built library (`cuobjdump -sass`)."""
    proc = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib}:\n{proc.stderr}")
    return proc.stdout


def build(source: Path, flags: Sequence[str] = ()) -> Tuple[Path, str]:
    """Compile `source` with `BASE_FLAGS` + `flags` unless this source was
    built with these flags already.

    Returns the library's path and what ptxas reported (registers, shared
    memory, spills), kept beside the library for later calls."""
    all_flags = (*BASE_FLAGS, *flags)
    key = hashlib.sha256(source.read_bytes() + " ".join(all_flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{key}.so"
    report = lib.with_suffix(".ptxas")
    if lib.exists():
        return lib, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"lib{source.stem}_{key}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_tool("nvcc"), *all_flags, "-Xptxas", "-v", "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    report.write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stderr
