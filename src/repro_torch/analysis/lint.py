"""Cache-key linter: an AST check of the port's plan-cache key functions.

The port's counterpart of the JAX package's ``analysis/lint.py``, rule
TH002 only:

``TH002`` — plan-cache key function omits a field ``bind()`` cannot fix.
    ``ProgramTemplate.bind`` rebinds only per-step env state; everything
    else a template closes over must be captured by its plan-cache key
    or a stale template silently serves the wrong closures. Key
    functions (``*_cache_key``) must reference the known-irreplaceable
    ingredients: object identity (``id(``), dtype (``.dtype``), cache
    geometry (``.shape``) and the emission regime (``"stacked"``).

The JAX package's other two rules police jax tracing and have no torch
counterpart: TH001 (a jitted closure that bakes a captured array in as a
constant) and TH003 (raw glue math called outside a jitted context). The
port runs its glue eagerly and never traces it.

Run as::

    python -m repro_torch.analysis.lint [paths...] [--strict] [--json]

with no paths it lints the whole ``repro_torch`` package. ``--strict``
exits nonzero on any finding; ``--json`` emits machine-readable findings.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

# what a template plan-cache key function must visibly capture (TH002)
CACHE_KEY_INGREDIENTS = (
    ("id(", "object identity (id(...))"),
    (".dtype", "dtype"),
    (".shape", "cache geometry (.shape)"),
    ("stacked", "emission regime (\"stacked\")"),
)


@dataclasses.dataclass
class Finding:
    code: str                      # "TH002" (or "TH000": unparsable file)
    path: str
    line: int
    symbol: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.code} [{self.symbol}] " \
               f"{self.message}"


def _check_th002(path: Path, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or not fn.name.endswith("_cache_key"):
            continue
        src = ast.unparse(fn)
        missing = [label for needle, label in CACHE_KEY_INGREDIENTS
                   if needle not in src]
        if missing:
            findings.append(Finding(
                "TH002", str(path), fn.lineno, fn.name,
                f"plan-cache key function omits field(s) bind() does not "
                f"rebind: {', '.join(missing)} — a stale template would "
                f"silently serve the wrong closures"))
    return findings


def lint_file(path: Path) -> List[Finding]:
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding("TH000", str(path), e.lineno or 0, "<parse>",
                        f"syntax error: {e.msg}")]
    return sorted(_check_th002(path, tree), key=lambda f: f.line)


def lint_paths(paths: Sequence[Path]) -> List[Finding]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        else:
            files.append(p)
    findings: List[Finding] = []
    for f in files:
        findings.extend(lint_file(f))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Cache-key linter (TH002: plan-cache key functions "
                    "must capture identity, dtype, geometry and regime).")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the "
                         "repro_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero if any finding is reported")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable JSON findings")
    args = ap.parse_args(argv)
    paths = [Path(p) for p in args.paths] \
        or [Path(__file__).resolve().parents[1]]
    findings = lint_paths(paths)
    if args.as_json:
        print(json.dumps([dataclasses.asdict(f) for f in findings],
                         indent=2))
    else:
        for f in findings:
            print(f.render())
        print(f"{len(findings)} finding(s)")
    return 1 if (findings and args.strict) else 0


if __name__ == "__main__":
    sys.exit(main())
