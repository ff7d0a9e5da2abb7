"""The port's kernel loader (``repro_torch.kernels.build``) on the CPU, with
a stand-in for nvcc: a script that writes an empty library and one ptxas
line. What is checked is the loader's cache: nvcc's log is kept beside the
library and read back when the library is found built, and a library whose
log is missing is built again. Binding (``ctypes``) is stubbed out.
"""
from __future__ import annotations

import importlib
import stat

import pytest

build = importlib.import_module("repro_torch.kernels.build")

FAKE_NVCC = """#!/bin/sh
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo run >> "$(dirname "$0")/calls"
echo "ptxas info    : Used 42 registers, 0 bytes spill stores"
: > "$out"
"""


@pytest.fixture
def loader(tmp_path, monkeypatch):
    """The loader with its build directory under tmp_path, a fake nvcc and
    no ctypes binding; returns (library, count of nvcc runs)."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_bind", lambda library, path, log:
                        build.Built(None, path, log, library))
    monkeypatch.setattr(build, "_BUILT", {})
    library = build.Library("flash_attention", ("-DFA_TEST=1",))
    calls = nvcc.parent / "calls"
    return library, lambda: (len(calls.read_text().splitlines())
                             if calls.exists() else 0)


def test_warm_cache_keeps_the_ptxas_log(loader, monkeypatch):
    library, nvcc_runs = loader
    first = build.load_all([library])[0]
    assert nvcc_runs() == 1
    assert "Used 42 registers" in first.log
    assert first.path.exists()
    assert first.path.with_suffix(".log").read_text() == first.log
    monkeypatch.setattr(build, "_BUILT", {})      # as in a new process
    again = build.load_all([library])[0]
    assert nvcc_runs() == 1                       # no second build
    assert again.path == first.path and again.log == first.log


def test_library_without_its_log_is_built_again(loader, monkeypatch):
    library, nvcc_runs = loader
    first = build.load_all([library])[0]
    first.path.with_suffix(".log").unlink()
    monkeypatch.setattr(build, "_BUILT", {})
    again = build.load_all([library])[0]
    assert nvcc_runs() == 2
    assert "Used 42 registers" in again.log
