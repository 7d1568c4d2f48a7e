"""The kernel build's cache key: a library is named by a hash of every
file under its source's ``csrc/`` directory and of the compiler flags, so
a changed header rebuilds it. Runs on the CPU: nothing is compiled."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "k.cuh"\nextern "C" int f() { return g(); }\n')
    (d / "k.cuh").write_text("inline int g() { return 1; }\n")
    return d


def test_header_change_changes_the_library_name(csrc):
    src = csrc / "k.cu"
    before = _build.library_path("k", src)
    assert _build.digest(src) == _build.digest(src)          # deterministic
    (csrc / "k.cuh").write_text("inline int g() { return 2; }\n")
    assert _build.library_path("k", src) != before
    assert _build.library_path("k", src).parent == _build.BUILD_DIR


@pytest.mark.parametrize("change", ["new_header", "renamed_header", "flags"])
def test_digest_covers_every_file_and_the_flags(csrc, monkeypatch, change):
    src = csrc / "k.cu"
    before = _build.digest(src)
    if change == "new_header":
        (csrc / "extra.cuh").write_text("// more\n")
    elif change == "renamed_header":
        (csrc / "k.cuh").rename(csrc / "k2.cuh")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.digest(src) != before

