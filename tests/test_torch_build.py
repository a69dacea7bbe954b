"""The kernel build: ``nvcc`` runs once per source text, the library is
loaded under a name hashed on the source and the headers it includes, and
a failed compile raises with the compiler's output and leaves no library
behind. A stand-in compiler
copies a loadable shared object, so this runs without the CUDA toolkit."""
import stat

import pytest
import torch

from repro_torch.kernels import build


def _fake_nvcc(tmp_path, body: str) -> str:
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def kernel_dir(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "_REPORTS", {})
    return tmp_path


def test_load_compiles_once_per_source(kernel_dir, monkeypatch):
    calls = kernel_dir / "calls"
    nvcc = _fake_nvcc(kernel_dir, f'echo x >> "{calls}"\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      f'cp "{torch._C.__file__}" "$2"\n')
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    build.load("k")
    build.load("k")                      # loaded once per process
    monkeypatch.setattr(build, "_LOADED", {})
    build.load("k")                      # built library found on disk
    built = sorted(p.name for p in (kernel_dir / "out").iterdir())
    assert len(built) == 1 and built[0].startswith("libk-")
    assert calls.read_text().split() == ["x"]

    (kernel_dir / "csrc" / "k.cu").write_text("// v2\n")
    monkeypatch.setattr(build, "_LOADED", {})
    build.load("k")                      # an edited source is rebuilt
    assert calls.read_text().split() == ["x", "x"]
    assert len(list((kernel_dir / "out").iterdir())) == 2


def test_failed_compile_raises_and_leaves_nothing(kernel_dir, monkeypatch):
    nvcc = _fake_nvcc(kernel_dir, 'echo "k.cu(3): error: bad"\nexit 1\n')
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="error: bad"):
        build.load("k")
    assert not any((kernel_dir / "out").iterdir())
    assert "k" not in build._LOADED


def test_load_all_starts_every_build_together(kernel_dir, monkeypatch):
    """Each source gets its own nvcc, all running at once: each stand-in
    compiler waits until the other has started, and fails after 10 s
    (which a build that ran the two one after the other would reach)."""
    (kernel_dir / "csrc" / "j.cu").write_text("// j\n")
    nvcc = _fake_nvcc(kernel_dir, f'touch "{kernel_dir}/started.$$"\n'
                      'i=0\n'
                      f'while [ $(ls "{kernel_dir}" | grep -c started) -lt 2 ];'
                      ' do i=$((i + 1)); [ $i -gt 200 ] && exit 1;'
                      ' sleep 0.05; done\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      f'cp "{torch._C.__file__}" "$2"\n')
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    libs = build.load_all(["k", "j"])
    assert len(libs) == 2 and set(build._LOADED) == {"k", "j"}
    built = sorted(p.name.split("-")[0] for p in (kernel_dir / "out").iterdir())
    assert built == ["libj", "libk"]
    assert build.load("j") is libs[1]


def test_an_edited_included_header_rebuilds(kernel_dir, monkeypatch):
    """The headers a source includes, directly or through another header,
    enter the library's hash: editing one rebuilds, editing a header that
    nothing includes does not. The compiler's report is kept."""
    csrc = kernel_dir / "csrc"
    (csrc / "k.cu").write_text('// v1\n#include "h.cuh"\n#include <cuda.h>\n')
    (csrc / "h.cuh").write_text('#pragma once\n#include "g.cuh"\n// h1\n')
    (csrc / "g.cuh").write_text("// g1\n")
    (csrc / "other.cuh").write_text("// o1\n")
    calls = kernel_dir / "calls"
    nvcc = _fake_nvcc(kernel_dir, f'echo x >> "{calls}"\n'
                      'echo "ptxas info : Used 40 registers" >&2\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      f'cp "{torch._C.__file__}" "$2"\n')
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    assert build.sources("k") == [csrc / "k.cu", csrc / "h.cuh",
                                  csrc / "g.cuh"]
    build.load("k")
    assert "Used 40 registers" in build.report("k")
    for header, builds in (("other.cuh", 1), ("g.cuh", 2), ("h.cuh", 3)):
        (csrc / header).write_text(f"// {header} edited\n")
        monkeypatch.setattr(build, "_LOADED", {})
        build.load("k")
        assert calls.read_text().split() == ["x"] * builds, header
