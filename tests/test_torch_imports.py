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
ROOT = SRC.parent
# the scripts that drive the port: its examples and the card's smoke run
SCRIPTS = sorted(f"examples/{p.name}"
                 for p in (ROOT / "examples").glob("torch_*.py")) \
    + ["chip_smoke.py"]

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
import torch.distributed as dist
print(len(names))
print(",".join(bad))
print(dist.is_initialized())
"""


def test_every_module_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=SRC,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    n, bad, pg = out.stdout.split("\n")[:3]
    expected = {m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")}
    assert int(n) == len(expected) and len(expected) >= 45
    # the certifier, the mesh, the front door, training, the simulator and
    # the SPMD layer are among them
    assert {"repro_torch.analysis.certify", "repro_torch.analysis.depgraph",
            "repro_torch.analysis.lint", "repro_torch.distributed.placement",
            "repro_torch.serving.admission",
            "repro_torch.serving.frontdoor", "repro_torch.core.simulator",
            "repro_torch.training", "repro_torch.training.optimizer",
            "repro_torch.training.data", "repro_torch.training.checkpoint",
            "repro_torch.training.train_loop", "repro_torch.tree",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.hints", "repro_torch.launch.mesh",
            "repro_torch.launch.train", "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_analysis"} <= expected
    assert bad == "", f"loaded: {bad}"
    # importing launch/mesh.py (or anything else) starts no process group
    assert pg == "False"


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


def test_train_launcher_raises_without_a_device(monkeypatch):
    from repro_torch.launch import mesh, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1", "--production"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.make_host_mesh()


_SCRIPT_PROBE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("script", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(",".join(sorted(m for m in sys.modules
                      if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                      or m == "repro" or m.startswith("repro."))))
"""


def test_the_scripts_are_the_four_examples_and_chip_smoke():
    assert SCRIPTS == ["examples/torch_autotune_blocks.py",
                       "examples/torch_multi_tenant_serving.py",
                       "examples/torch_quickstart.py",
                       "examples/torch_train_tiny.py", "chip_smoke.py"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_loads_neither_jax_nor_the_jax_package(script):
    out = subprocess.run([sys.executable, "-c", _SCRIPT_PROBE,
                          str(ROOT / script)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"loaded: {out.stdout.strip()}"
    for line in (ROOT / script).read_text().splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax", "import repro.",
                                 "from repro.", "from repro import")), s


@pytest.mark.parametrize("script", [s for s in SCRIPTS
                                    if s.startswith("examples/")])
def test_example_raises_without_a_device(script, monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location("example", ROOT / script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])
