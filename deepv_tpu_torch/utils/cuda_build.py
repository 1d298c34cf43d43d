"""Build a CUDA source of ``deepv_tpu_torch/csrc`` into a shared library.

Each kernel is compiled by ``nvcc`` for ``sm_90a`` into a ``.so`` with a
plain C interface and loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds. Libraries go to ``deepv_tpu_torch/_build``
(git-ignored), named by a hash of the source, every header of ``csrc/``
and the flags, so an edited source or header rebuilds and an unchanged one
is reused; after ``utils/aot.configure(dir)`` they go to and come from that
directory instead (``utils/aot.py``). Builds happen at first use, never at
import.
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
from typing import Optional, Sequence, Tuple

from . import aot

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


def source_digest(src: Path, flags: Sequence[str] = NVCC_FLAGS) -> str:
    """Hash of what a build of ``src`` depends on: its bytes, the bytes of
    every header (``*.cuh``, ``*.h``) in its directory, and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(p for p in src.parent.iterdir() if p.suffix in (".cuh", ".h")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def nvcc_version(nvcc: str) -> str:
    """``nvcc --version``'s output: what the AOT cache records of a build."""
    proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{nvcc} --version failed (exit {proc.returncode}): {proc.stderr}")
    return proc.stdout.strip()


def no_nvcc_message(src: Path) -> str:
    return (f"cannot build {src.name}: no nvcc on PATH or under $CUDA_HOME/bin; "
            "the CUDA kernels of deepv_tpu_torch need the CUDA toolkit")


def compile_library(nvcc: str, src: Path, flags: Sequence[str], out: str) -> str:
    """Run ``nvcc`` on ``src`` into ``out``; returns its output (the ptxas
    report). Raises RuntimeError when the build fails."""
    proc = subprocess.run([nvcc, *flags, "-o", out, str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{log}")
    return log


def compile_into(nvcc: str, src: Path, flags: Sequence[str], out: Path) -> Tuple[float, str]:
    """``compile_library`` into a temporary file beside ``out``, renamed over
    it when the build succeeds (so a reader never sees half a library, and
    processes building the same library at once are safe). Returns the
    seconds and the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        log = compile_library(nvcc, src, flags, tmp)
    except BaseException:
        os.unlink(tmp)
        raise
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return seconds, log


def build(source: str, flags: Sequence[str] = NVCC_FLAGS) -> Built:
    """Compile ``csrc/<source>`` (or reuse the cached build) and load it.
    Raises RuntimeError when no ``nvcc`` is found or the build fails."""
    src = CSRC_DIR / source
    digest = source_digest(src, flags)
    if aot.cache_dir() is not None:
        return aot.load_or_build(src, digest, flags)
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.is_file():
        return Built(ctypes.CDLL(str(out)), out, 0.0, "")
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(no_nvcc_message(src))
    seconds, log = compile_into(nvcc, src, flags, out)
    return Built(ctypes.CDLL(str(out)), out, seconds, log)
