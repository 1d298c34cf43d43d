"""utils/aot.py, the port's AOT cache: the kernel libraries that
``utils/cuda_build.build`` compiles, kept in a directory across processes.

The counterparts of tests/test_aot.py's cases, on the CPU: the compile step
(``cuda_build.compile_library``, which runs ``nvcc`` on the card's machine)
is swapped for one that builds a one-function C file with ``cc -shared
-fPIC``, so a hit loads a real library through ``ctypes`` and calls it.
``nvcc`` is a name here: ``find_nvcc`` and ``nvcc_version`` are replaced."""

import ctypes
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

from deepv_tpu_torch import run, serve
from deepv_tpu_torch.utils import aot, cuda_build

ROOT = Path(__file__).resolve().parent.parent
CC = shutil.which("cc") or shutil.which("gcc") or "cc"
NVCC_VERSION = "Cuda compilation tools, release 12.4, V12.4.131"


def fake_compile(nvcc, src, flags, out):
    """The stand-in for nvcc: ``src`` is C; a shared library into ``out``."""
    subprocess.run([CC, "-shared", "-fPIC", "-x", "c", "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    return f"cc {src.name}"


def write_source(directory: Path, name: str, value: int) -> None:
    """A kernel source whose library's ``deepv_probe()`` returns ``value``."""
    (directory / name).write_text(f'#include "shared.cuh"\nint deepv_probe(void) '
                                  f'{{ return {value}; }}\n')


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source directory with three kernels and a shared header, the fake
    compiler, and an ``nvcc`` of NVCC_VERSION. Leaves the cache off."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "shared.cuh").write_text("#define DEEPV_SHARED 1\n")
    for i, name in enumerate(("a.cu", "b.cu", "c.cu")):
        write_source(src, name, 7 + i)
    calls = []
    monkeypatch.setattr(cuda_build, "CSRC_DIR", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "compile_library",
                        lambda *a: calls.append(a[1].name) or fake_compile(*a))
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(cuda_build, "nvcc_version", lambda nvcc: NVCC_VERSION)
    yield src, calls
    aot.configure(None)


def probe(built) -> int:
    fn = built.lib.deepv_probe
    fn.restype = ctypes.c_int
    return fn()


def entries(cache) -> list:
    return sorted(p.name for p in Path(cache).glob("*.so"))


def test_without_configure_build_uses_the_package_build_dir(csrc, tmp_path):
    _, calls = csrc
    assert aot.cache_dir() is None
    built = cuda_build.build("a.cu")
    assert built.path.parent == tmp_path / "_build" and probe(built) == 7
    assert built.path.name == f"a-{cuda_build.source_digest(csrc[0] / 'a.cu')}.so"
    assert cuda_build.build("a.cu").seconds == 0.0 and calls == ["a.cu"]
    assert aot.stats() == {"loaded": 0, "compiled": 0, "loaded_mb": 0.0}


def second_interpreter(src: Path, cache: Path, nvcc: bool) -> dict:
    """``build("a.cu")`` in a fresh interpreter on ``cache``, with nvcc of
    NVCC_VERSION found or none at all; no compiler is available to it."""
    code = (
        "import ctypes, json, sys\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from deepv_tpu_torch.utils import aot, cuda_build\n"
        f"cuda_build.CSRC_DIR = Path({str(src)!r})\n"
        f"cuda_build.find_nvcc = lambda: {'/opt/cuda/bin/nvcc' if nvcc else None!r}\n"
        f"cuda_build.nvcc_version = lambda nvcc: {NVCC_VERSION!r}\n"
        "def no_compiler(*a):\n"
        "    raise AssertionError('compiled on a hit')\n"
        "cuda_build.compile_library = no_compiler\n"
        f"aot.configure({str(cache)!r})\n"
        "b = cuda_build.build('a.cu')\n"
        "b.lib.deepv_probe.restype = ctypes.c_int\n"
        "print(json.dumps(dict(aot.stats(), value=b.lib.deepv_probe(), path=str(b.path))))\n")
    proc = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_miss_then_a_second_interpreter_loads_it(csrc, tmp_path):
    src, calls = csrc
    cache = tmp_path / "aot"
    aot.configure(str(cache))
    built = cuda_build.build("a.cu")
    assert aot.stats()["compiled"] == 1 and aot.stats()["loaded"] == 0
    assert built.path.parent == cache and probe(built) == 7 and calls == ["a.cu"]
    assert not (tmp_path / "_build").exists()
    record = json.loads(built.path.with_suffix(".json").read_text())
    assert record["nvcc"] == NVCC_VERSION and record["source"] == "a.cu"
    for nvcc in (True, False):       # the same nvcc, then none at all
        got = second_interpreter(src, cache, nvcc)
        assert (got["loaded"], got["compiled"], got["value"]) == (1, 0, 7)
        assert got["path"] == str(built.path) and got["loaded_mb"] >= 0.0


def test_edited_header_misses(csrc, tmp_path):
    src, calls = csrc
    cache = tmp_path / "aot"
    aot.configure(str(cache))
    first = cuda_build.build("a.cu")
    with open(src / "shared.cuh", "a") as f:
        f.write("// edited\n")
    second = cuda_build.build("a.cu")
    assert second.path != first.path and calls == ["a.cu", "a.cu"]
    assert aot.stats()["compiled"] == 2 and len(entries(cache)) == 2


def test_other_recorded_nvcc_misses_and_rebuilds(csrc, tmp_path, monkeypatch):
    _, calls = csrc
    cache = tmp_path / "aot"
    aot.configure(str(cache))
    built = cuda_build.build("a.cu")
    newer = "Cuda compilation tools, release 12.6, V12.6.20"
    monkeypatch.setattr(cuda_build, "nvcc_version", lambda nvcc: newer)
    aot.configure(str(cache))
    again = cuda_build.build("a.cu")
    assert again.path == built.path and calls == ["a.cu", "a.cu"]
    assert aot.stats() == {"loaded": 0, "compiled": 1, "loaded_mb": 0.0}
    assert json.loads(built.path.with_suffix(".json").read_text())["nvcc"] == newer


def test_hit_needs_no_nvcc_and_a_miss_without_it_raises(csrc, tmp_path, monkeypatch):
    cache = tmp_path / "aot"
    aot.configure(str(cache))
    cuda_build.build("a.cu")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "nvcc_version", None)    # never asked
    aot.configure(str(cache))
    assert probe(cuda_build.build("a.cu")) == 7
    assert aot.stats()["loaded"] == 1 and aot.stats()["compiled"] == 0
    with pytest.raises(RuntimeError, match="cannot build b.cu: no nvcc"):
        cuda_build.build("b.cu")
    assert entries(cache) == [p.name for p in cache.glob("a-*.so")]


def test_corrupt_entry_is_rebuilt_and_counted(csrc, tmp_path):
    """An entry ctypes cannot load (here: one this process never loaded,
    with a valid record) is rebuilt, counted as compiled, then loaded."""
    src, calls = csrc
    cache = tmp_path / "aot"
    aot.configure(str(cache))
    entry = aot._entry(src / "b.cu", cuda_build.source_digest(src / "b.cu"))
    entry.write_bytes(b"not a shared library")
    entry.with_suffix(".json").write_text(json.dumps({"nvcc": NVCC_VERSION}))
    built = cuda_build.build("b.cu")
    assert built.path == entry and probe(built) == 8 and calls == ["b.cu"]
    assert aot.stats()["compiled"] == 1 and aot.stats()["loaded"] == 0


def test_failed_build_raises_and_leaves_nothing(csrc, tmp_path, monkeypatch):
    cache = tmp_path / "aot"
    aot.configure(str(cache))

    def broken(nvcc, src, flags, out):
        raise RuntimeError(f"nvcc failed on {src.name} (exit 1)")

    monkeypatch.setattr(cuda_build, "compile_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed on a.cu"):
        cuda_build.build("a.cu")
    assert entries(cache) == [] and not (tmp_path / "_build").exists()
    assert [p for p in cache.iterdir() if p.suffix != ".json"] == []
    assert aot.stats()["compiled"] == 0


def test_eviction_keeps_the_new_entry_and_goes_by_touch_order(csrc, tmp_path):
    """max_bytes evicts the least recently loaded entry by mtime, which each
    load touches; an atime that says otherwise does not count, and the entry
    just written is never evicted."""
    src, _ = csrc
    cache = tmp_path / "aot"
    aot.configure(str(cache))
    a, b = cuda_build.build("a.cu").path, cuda_build.build("b.cu").path
    old = a.stat().st_mtime - 100
    os.utime(a, (old, old))
    os.utime(b, (old + 10, old + 10))
    aot.configure(str(cache))
    cuda_build.build("a.cu")                 # a hit touches a: now b is the older
    assert a.stat().st_mtime > b.stat().st_mtime
    os.utime(b, (a.stat().st_mtime + 1000, b.stat().st_mtime))     # b's atime newest
    size = a.stat().st_size
    aot.configure(str(cache), max_bytes=a.stat().st_size + b.stat().st_size + size // 2)
    c = cuda_build.build("c.cu").path
    assert entries(cache) == sorted([a.name, c.name])
    assert not b.with_suffix(".json").exists()
    aot.configure(str(cache), max_bytes=1)
    with open(src / "shared.cuh", "a") as f:
        f.write("// edited\n")
    newest = cuda_build.build("a.cu").path
    assert entries(cache) == [newest.name]


def test_builds_from_threads_count_once_each(csrc, tmp_path):
    """Three threads build three libraries, then 12 threads load 48 hits
    with a short switch interval: every build and load is counted once."""
    cache = tmp_path / "aot"
    aot.configure(str(cache))
    with ThreadPoolExecutor(3) as pool:
        built = list(pool.map(cuda_build.build, ("a.cu", "b.cu", "c.cu")))
    assert [probe(b) for b in built] == [7, 8, 9] and aot.stats()["compiled"] == 3
    aot.configure(str(cache))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(12) as pool:
            loaded = list(pool.map(cuda_build.build, ("a.cu", "b.cu", "c.cu") * 16))
    finally:
        sys.setswitchinterval(interval)
    assert [probe(b) for b in loaded[:3]] == [7, 8, 9]
    s = aot.stats()
    assert (s["loaded"], s["compiled"]) == (48, 0)
    total_mb = 16 * sum((cache / n).stat().st_size for n in entries(cache)) / 1e6
    assert abs(s["loaded_mb"] - total_mb) <= 0.05 + 1e-9   # stats() rounds to 0.1 MB


def test_configure_creates_a_private_dir_and_refuses_untrusted_ones(tmp_path, monkeypatch):
    made = tmp_path / "new" / "aot"
    aot.configure(str(made))
    assert aot.cache_dir() == str(made) and (made.stat().st_mode & 0o777) == 0o700
    for mode in (0o770, 0o702, 0o777):
        shared = tmp_path / f"shared_{mode:o}"
        shared.mkdir()
        shared.chmod(mode)
        with pytest.raises(PermissionError, match="writable by group or others") as err:
            aot.configure(str(shared))
        assert str(shared) in str(err.value)
    assert aot.cache_dir() == str(made)      # a refusal changes nothing
    monkeypatch.setattr(os, "geteuid", lambda: made.stat().st_uid + 1)
    with pytest.raises(PermissionError, match="owned by uid") as err:
        aot.configure(str(made))
    assert str(made) in str(err.value)
    aot.configure(None)
    assert aot.cache_dir() is None


def test_stats_keys_are_deepv_tpus():
    from deepv_tpu.utils import aot as jax_aot
    assert set(aot.stats()) == set(jax_aot.stats())


def test_entry_points_configure_the_cache(tmp_path, monkeypatch):
    """``run.main(aot_cache=...)`` and ``serve.py --aot_cache`` configure the
    cache before the pipeline is built, and no longer refuse the option."""
    class Reached(Exception):
        pass

    def load_pipeline(*a, **k):
        raise Reached(aot.cache_dir())

    cache = tmp_path / "aot"
    monkeypatch.setattr(run, "load_pipeline", load_pipeline)
    try:
        with pytest.raises(Reached, match=str(cache)):
            run.main(str(tmp_path / "absent.png"), "none", random_weights=True, device="cpu",
                     aot_cache=str(cache))
        aot.configure(None)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setenv("DEEPV_TINY", "1")
        monkeypatch.setattr("sys.argv", ["serve", "--model_path", "none", "--random_weights",
                                         "--aot_cache", str(cache / "served")])
        with pytest.raises(Reached, match=str(cache / "served")):
            serve.cli()
    finally:
        aot.configure(None)


def test_prewarm_logs_the_cache_statistics(tmp_path, monkeypatch):
    """``serve.prewarm`` logs the statistics line after warming, as
    deepv_tpu's does, only with the cache configured."""
    class Pipe:
        cfg = type("Cfg", (), {"max_temporal_length": 0})()

    monkeypatch.setattr(serve, "InteractiveSession", lambda pipe, **k: type(
        "S", (), {"start": lambda self, img, seed: None, "_device": torch.device("cpu")})())
    lines = []
    serve.prewarm(Pipe(), 8, 8, log=lines.append)
    assert len(lines) == 1
    aot.configure(str(tmp_path / "aot"))
    try:
        serve.prewarm(Pipe(), 8, 8, log=lines.append)
    finally:
        aot.configure(None)
    assert lines[-1] == (f"[serve] aot cache: 0 kernel libraries loaded (0.0 MB), 0 compiled "
                         f"with nvcc ({tmp_path / 'aot'})")
