"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1]

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration file
and a traffic mix; this builds the tenants with seeded weights, warms the
keys the mix reaches, serves the window through the port's
``ServingEngine.serve_forever`` on one CUDA device, then checks a sample of
what the window served against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, each from
``perfbench/metrics/<name>.py``), ``device`` and, traced, ``breakdown``;
``checks``, the numbers compared beside their limits, comes last, and the
same numbers end standard error. ``--control 1`` adds the fp8 control's
readings of those numbers (calibration, not part of a benchmark run).

Nothing here or in the program it runs may load JAX or the JAX package;
the run refuses to print a result if either is in ``sys.modules`` once
the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / "build" / "perfbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from perfbench.harness import manifest as mf
    manifest = mf.load(ROOT)
    cell = mf.workload(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench.harness.cell import execute
    result, lines = execute(
        cell, mf.config(manifest, cell["config"], ROOT),
        mf.traffic(cell["traffic"]),
        mf.metrics_of(manifest, cell["name"],
                      "per_layer" if args.trace else "end_to_end"),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda", 0), control=bool(args.control),
        t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad} (JAX or the JAX package); no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
