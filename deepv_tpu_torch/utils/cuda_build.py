"""Build a CUDA source of ``deepv_tpu_torch/csrc`` into a shared library.

Each kernel is compiled by ``nvcc`` for ``sm_90a`` into a ``.so`` with a
plain C interface and loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds. Libraries go to ``deepv_tpu_torch/_build``
(git-ignored), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Builds happen at first use,
never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Built:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    seconds: float        # compile time, 0.0 when reused
    log: str              # nvcc's output (register and shared-memory use)


def find_nvcc() -> Optional[str]:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default: the
    toolkit's standard prefix ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def build(source: str, flags: Sequence[str] = NVCC_FLAGS) -> Built:
    """Compile ``csrc/<source>`` (or reuse the cached build) and load it.
    Raises RuntimeError when no ``nvcc`` is found or the build fails."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.is_file():
        return Built(ctypes.CDLL(str(out)), out, 0.0, "")
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {src.name}: no nvcc on PATH or under $CUDA_HOME/bin; "
            "the CUDA kernels of deepv_tpu_torch need the CUDA toolkit")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *flags, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
