"""The port stands alone: importing every ``repro_torch`` module loads
neither jax nor any module of the JAX package, and the entry points refuse
to run quietly on the CPU when no device is named."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.serving import ServingEngine

SRC = Path(repro_torch.__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names))
print(",".join(bad))
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split("\n")[:2]
    expected = {m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")}
    assert int(n) == len(expected) and len(expected) >= 30
    assert bad == "", f"loaded: {bad}"


def test_sources_name_no_jax_import():
    for path in Path(repro_torch.__file__).parent.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import")), (path, s)


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(smoke_config("yi-9b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine([], mode="vliw")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device(None)
    # named explicitly, the CPU is fine
    assert Model(smoke_config("yi-9b"), device="cpu").device.type == "cpu"
    assert ServingEngine([], mode="vliw", device="cpu").device.type == "cpu"


def test_launcher_raises_without_a_device(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        serve.main(["--requests", "1", "--mode", "vliw"])
