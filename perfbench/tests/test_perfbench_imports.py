"""The import rule: the harness loads neither JAX nor the JAX package, and
the reference loads nothing of JAX, the JAX package or the program.
Top-level module names are compared whole (``repro_torch`` begins with
``repro``)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from perfbench.harness import manifest

ROOT = manifest.ROOT
NO_JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def _loaded(code: str):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_perfbench_top_level_names_are_compared_whole():
    """``repro_torch`` and a name that merely begins with ``repro`` pass;
    ``repro`` itself and JAX's names do not."""
    out = _loaded(
        "import json, sys\n"
        "from perfbench import run\n"
        "sys.modules['repro_torch_x'] = object()\n"
        "first = run.forbidden_modules()\n"
        "sys.modules['repro.core'] = object()\n"
        "sys.modules['jaxlib'] = object()\n"
        "print(json.dumps(['first:' + ','.join(first)]"
        " + run.forbidden_modules()))\n")
    assert out == {"first:", "jaxlib", "repro"}


def test_perfbench_harness_loads_no_jax():
    """Every harness module, every reader and the program the harness
    drives, imported in a fresh interpreter: no JAX, no JAX package."""
    readers = sorted(p.stem for p in (ROOT / "perfbench" / "metrics")
                     .glob("*.py"))
    code = (
        "import json, sys\n"
        "import perfbench.run, perfbench.harness.cell\n"
        "import perfbench.harness.serve as s\n"
        "from perfbench.harness import manifest\n"
        f"[manifest.reader(n) for n in {readers!r}]\n"
        "import repro_torch.serving.engine, repro_torch.models.model\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    loaded = _loaded(code)
    assert "repro_torch" in loaded and not (loaded & NO_JAX)
    for path in (ROOT / "perfbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not set(_imports(path)) & NO_JAX, path


def test_perfbench_reference_loads_nothing_of_the_program():
    ref_dir = ROOT / "perfbench" / "reference"
    for path in ref_dir.glob("*.py"):
        names = set(_imports(path))
        assert not names & (NO_JAX | {"repro_torch", "perfbench"}), path
    loaded = _loaded("import json, sys\nimport perfbench.reference.model\n"
                     "print(json.dumps(sorted({m.split('.')[0] "
                     "for m in sys.modules})))\n")
    assert not loaded & (NO_JAX | {"repro_torch"})
