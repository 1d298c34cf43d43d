"""The kernel build cache of the port (``utils/cuda_build``): a library is
named by a hash of its source, every header of its directory and the flags,
so an edited shared header rebuilds every library instead of reusing a
stale one. CPU only: no compiler is run."""

import shutil

from deepv_tpu_torch.utils import cuda_build
from deepv_tpu_torch.utils.cuda_build import CSRC_DIR, source_digest


def test_editing_a_header_changes_the_digest(tmp_path):
    src = tmp_path / "kernel.cu"
    src.write_text('#include "shared.cuh"\n__global__ void k() {}\n')
    header = tmp_path / "shared.cuh"
    header.write_text("#pragma once\n")
    before = source_digest(src)
    assert source_digest(src) == before                       # deterministic
    header.write_text("#pragma once\n// edited\n")
    assert source_digest(src) != before
    edited = source_digest(src)
    (tmp_path / "notes.txt").write_text("not a header")       # other files do not count
    assert source_digest(src) == edited
    (tmp_path / "other.h").write_text("")                     # a new header does
    assert source_digest(src) != edited
    assert source_digest(src, flags=("-O0",)) != source_digest(src)


def test_kernel_sources_depend_on_the_shared_header(tmp_path):
    """Both kernel sources include csrc/hopper.cuh; a copy of csrc/ with
    that header edited gives both new digests, so build() would rebuild."""
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC_DIR, copy)
    names = ("attention.cu", "conv_igemm.cu")
    for name in names:
        assert '#include "hopper.cuh"' in (copy / name).read_text()
    before = {n: source_digest(copy / n) for n in names}
    assert before == {n: source_digest(CSRC_DIR / n) for n in names}
    with open(copy / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    for name in names:
        assert source_digest(copy / name) != before[name]


def test_build_names_the_library_by_the_digest(tmp_path, monkeypatch):
    """build() looks for <stem>-<digest>.so: with that file present it is
    loaded and nvcc is never looked for."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    expected = tmp_path / f"attention-{source_digest(CSRC_DIR / 'attention.cu')}.so"
    loaded = []
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: loaded.append(path) or "lib")
    expected.write_bytes(b"")
    built = cuda_build.build("attention.cu")
    assert built.path == expected and built.seconds == 0.0 and loaded == [str(expected)]
