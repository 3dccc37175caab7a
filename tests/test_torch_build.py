"""The port's kernel build (``repro_torch.kernels._build``) on the CPU:
which files a kernel's library is keyed on.  Nothing is compiled here."""
from repro_torch.kernels import _build


def test_sources_follow_quoted_includes():
    """The three tensor-core sources include the shared Hopper header; the
    others stand alone."""
    for name in _build.KERNELS:
        got = [p.name for p in _build.sources(name)]
        assert got[0] == f"{name}.cu"
        want = (["hopper.cuh"] if name in ("flash_attention", "int8_matmul",
                                           "flash_attention_bwd")
                else [])
        assert got[1:] == want, (name, got)


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    """A build is keyed on its source and every header under csrc that it
    includes, directly or through another header: editing any of them
    gives a new library, editing an unrelated file does not."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("// b\n")
    (csrc / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh",
                                                     "b.cuh"]
    first = _build.library_path("k")
    (csrc / "other.cuh").write_text("// edited\n")
    assert _build.library_path("k") == first
    for name in ("b.cuh", "a.cuh", "k.cu"):
        before = _build.library_path("k")
        (csrc / name).write_text((csrc / name).read_text() + "// edit\n")
        assert _build.library_path("k") != before, name
