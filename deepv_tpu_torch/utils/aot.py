"""AOT cache: persist the port's compiled kernel libraries across processes.

Counterpart of ``deepv_tpu/utils/aot.py``. deepv_tpu persists compiled XLA
executables; the port runs eager PyTorch, and what it compiles are its CUDA
sources (``csrc/*.cu``), which ``utils/cuda_build.build`` turns into ``.so``
libraries with ``nvcc`` at first use. Without ``configure`` those go to the
package's ``_build/`` directory, as before. After ``configure(cache_dir)``
(the ``--aot_cache`` option of ``run.py`` and ``serve.py``) each library is
loaded from ``cache_dir`` when an entry for it is there, else built once
with ``nvcc`` and written there. A process that finds its entries needs no
CUDA toolkit at all: a read-only install, a fresh container or a serving
machine without ``nvcc`` starts from a filled cache.

Keys: an entry is named by a hash of the key version and
``cuda_build.source_digest`` (the source, every header of ``csrc/`` and the
flags), so an edited source or header misses. A JSON sidecar beside the
``.so`` records the ``nvcc --version`` that built it; where the local
``nvcc`` reports another version the entry misses and is rebuilt, and
where no ``nvcc`` is found the entry is loaded as it is. An entry that
``ctypes`` cannot load is rebuilt and counted as compiled. A failed build
raises, as without the cache: nothing falls back to ``_build/``.

Writes are atomic (a temporary file renamed over the entry), so the ranks
of a mesh may build the same entry at once. A library bakes in no device,
unlike deepv_tpu's executables (which its cache skips on a mesh), so one
cache directory serves every rank and every card.

Trust: loading a library runs its initialisers, as ``pickle.load`` runs
code. ``configure`` creates the directory with mode 0o700 and refuses one
owned by another user or writable by group or others; the directory must
be one only trusted users can write.

Call ``configure`` before the first kernel is loaded: each ops module keeps
the library it loaded for the life of the process
(``ops/attention.load_library`` and its siblings), so configuring later
does not move it.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import stat
import threading
from pathlib import Path
from typing import Optional, Sequence

log = logging.getLogger(__name__)

_KEY_VERSION = "aot-so-v1"
_lock = threading.Lock()
_state = {"dir": None, "max_bytes": None, "loaded": 0, "compiled": 0, "loaded_mb": 0.0}


def _check_trusted(path: str) -> None:
    """Raise PermissionError unless ``path`` is owned by this user and
    writable by no one else."""
    st = os.stat(path)
    if st.st_uid != os.geteuid():
        raise PermissionError(
            f"aot cache {path} is owned by uid {st.st_uid}, not by this user "
            f"({os.geteuid()}); loading a cached library runs its code, so the cache "
            "must be a directory of your own")
    if st.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
        raise PermissionError(
            f"aot cache {path} is writable by group or others (mode "
            f"{stat.S_IMODE(st.st_mode):o}); loading a cached library runs its code, so "
            "only its owner may write the cache (chmod go-w)")


def configure(cache_dir: Optional[str], max_bytes: Optional[int] = None) -> None:
    """Enable (or, with ``None``, disable) the on-disk library cache.

    ``cache_dir`` is created with mode 0o700 if it is not there, and
    refused (PermissionError naming it) when another user owns it or group
    or others may write it. ``max_bytes``: after each write, evict the least
    recently used entries past this total size, never the one just
    written. Call before the first kernel is loaded; configuring resets the
    statistics."""
    if cache_dir is not None:
        cache_dir = os.path.abspath(cache_dir)
        os.makedirs(cache_dir, mode=0o700, exist_ok=True)
        _check_trusted(cache_dir)
    with _lock:
        _state.update(dir=cache_dir, max_bytes=max_bytes, loaded=0, compiled=0, loaded_mb=0.0)


def cache_dir() -> Optional[str]:
    return _state["dir"]


def stats() -> dict:
    """This process's cache activity since ``configure``: kernel libraries
    loaded from the cache directory, libraries compiled with ``nvcc`` and
    written there, and the MB loaded."""
    with _lock:
        return {"loaded": _state["loaded"], "compiled": _state["compiled"],
                "loaded_mb": round(_state["loaded_mb"], 1)}


def _entry(src: Path, digest: str) -> Path:
    key = hashlib.sha256(f"{_KEY_VERSION}\0{digest}".encode()).hexdigest()[:20]
    return Path(_state["dir"]) / f"{src.stem}-{key}.so"


def _sidecar(entry: Path) -> Path:
    return entry.with_suffix(".json")


def _recorded_nvcc(entry: Path) -> Optional[str]:
    """The ``nvcc --version`` the entry's sidecar records; None when the
    sidecar is missing or unreadable."""
    try:
        return json.loads(_sidecar(entry).read_text())["nvcc"]
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _write_atomic(path: Path, text: str) -> None:
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    tmp.write_text(text)
    os.replace(tmp, path)


def _evict_to_budget(keep: Path) -> None:
    """Least-recently-used-first eviction past ``max_bytes``. Recency is the
    entry's mtime, which every load touches (``os.utime``): atime is not
    kept under relatime or noatime. ``keep``, the entry just written, is
    never evicted."""
    budget = _state["max_bytes"]
    if not budget:
        return
    entries = []
    for p in Path(_state["dir"]).glob("*.so"):
        if p == keep:
            continue
        try:
            st = p.stat()
        except OSError:
            continue
        entries.append((st.st_mtime_ns, st.st_size, p))
    total = sum(size for _, size, _ in entries) + keep.stat().st_size
    for _, size, p in sorted(entries):
        if total <= budget:
            break
        try:
            p.unlink()
            _sidecar(p).unlink(missing_ok=True)
        except OSError:
            continue
        total -= size
        log.info("aot: evicted %s (%.1f MB, cache over %.0f MB)", p.name, size / 1e6,
                 budget / 1e6)


def load_or_build(src: Path, digest: str, flags: Sequence[str]):
    """``cuda_build.build`` with the cache configured: the library of
    ``src`` (whose ``source_digest`` is ``digest``) from the cache
    directory, or built there with ``nvcc``. Returns a ``cuda_build.Built``."""
    from . import cuda_build

    entry = _entry(src, digest)
    nvcc = cuda_build.find_nvcc()
    local = cuda_build.nvcc_version(nvcc) if nvcc is not None else None
    if entry.is_file():
        recorded = _recorded_nvcc(entry)
        if recorded is None or (local is not None and recorded != local):
            log.info("aot: %s was built by another nvcc (or has no record of it); rebuilding",
                     entry.name)
        else:
            try:
                lib = ctypes.CDLL(str(entry))
            except OSError as e:
                log.warning("aot: loading %s failed (%s); rebuilding", entry, e)
            else:
                os.utime(entry)
                mb = entry.stat().st_size / 1e6
                with _lock:
                    _state["loaded"] += 1
                    _state["loaded_mb"] += mb
                log.info("aot: loaded %s (%.1f MB)", entry.name, mb)
                return cuda_build.Built(lib, entry, 0.0, "")
    if nvcc is None:
        raise RuntimeError(cuda_build.no_nvcc_message(src))
    # the sidecar first: a library in place always has its record beside it
    _write_atomic(_sidecar(entry), json.dumps({"key_version": _KEY_VERSION, "digest": digest,
                                               "source": src.name, "flags": list(flags),
                                               "nvcc": local}))
    seconds, build_log = cuda_build.compile_into(nvcc, src, flags, entry)
    lib = ctypes.CDLL(str(entry))
    with _lock:
        _state["compiled"] += 1
    log.info("aot: compiled %s in %.1f s", entry.name, seconds)
    _evict_to_budget(entry)
    return cuda_build.Built(lib, entry, seconds, build_log)
