"""The kernel build: ``nvcc`` runs once per source text, the library is
loaded under a name hashed on the source, and a failed compile raises with
the compiler's output and leaves no library behind. A stand-in compiler
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
def sandbox(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "_LOADED", {})
    return tmp_path


def test_load_compiles_once_per_source(sandbox, monkeypatch):
    calls = sandbox / "calls"
    nvcc = _fake_nvcc(sandbox, f'echo x >> "{calls}"\n'
                      'while [ "$1" != "-o" ]; do shift; done\n'
                      f'cp "{torch._C.__file__}" "$2"\n')
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    build.load("k")
    build.load("k")                      # loaded once per process
    monkeypatch.setattr(build, "_LOADED", {})
    build.load("k")                      # built library found on disk
    built = sorted(p.name for p in (sandbox / "out").iterdir())
    assert len(built) == 1 and built[0].startswith("libk-")
    assert calls.read_text().split() == ["x"]

    (sandbox / "csrc" / "k.cu").write_text("// v2\n")
    monkeypatch.setattr(build, "_LOADED", {})
    build.load("k")                      # an edited source is rebuilt
    assert calls.read_text().split() == ["x", "x"]
    assert len(list((sandbox / "out").iterdir())) == 2


def test_failed_compile_raises_and_leaves_nothing(sandbox, monkeypatch):
    nvcc = _fake_nvcc(sandbox, 'echo "k.cu(3): error: bad"\nexit 1\n')
    monkeypatch.setattr(build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="error: bad"):
        build.load("k")
    assert not any((sandbox / "out").iterdir())
    assert "k" not in build._LOADED
