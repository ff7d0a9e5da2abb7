#!/usr/bin/env python3
"""Sweep the geometry of the port's ``coalesced_gemv`` kernel on one card.

    python3 experiments/torch_gemv_sweep.py [--out build/gemv_sweep.json]

Run from the root of a checkout on a machine with a CUDA card and ``nvcc``.
It imports nothing of JAX. Each variant is one build of
``src/repro_torch/kernels/csrc/coalesced_gemv.cu`` with its own ``-D``
defines (threads a block, loads of w in flight a thread), all built at
once. The k rows of one cluster rank set the K split, which the sweep
computes as the wrapper's ``k_split`` does and passes to the library's C
entry point itself: the wrapper and its module state are not touched.
Every (variant, rows a rank) is held against the plain version, then timed
at chip_smoke.py's eight ``kernel-gemv`` rows (CUDA-event median of 25
calls, L2 flushed before each; ``torch.bmm`` first, the same way), in two
passes, the second in reverse order, so a drift of the card shows as a gap
between the passes. Prints one line per (variant, rows a rank, row) and
writes them all as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (threads, loads in flight a thread): the wrapper's geometry first
VARIANTS = [(256, 4), (256, 8), (128, 4), (128, 8), (512, 2), (512, 4)]
RANK_ROWS = [256, 384, 448, 512, 1024, 2048, 4096]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "gemv_sweep.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gemv_sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    build = importlib.import_module("repro_torch.kernels.build")
    gv = importlib.import_module("repro_torch.kernels.coalesced_gemv")
    from repro_torch.kernels.ref import coalesced_gemv_ref as ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)

    libs = build.load_all([dataclasses.replace(gv.LIBRARY, defines=(
        f"-DGV_THREADS={threads}", f"-DGV_ROW_LANES={gv.ROW_LANES}",
        f"-DGV_UNROLL={unroll}", f"-DGV_MAX_CLUSTER={gv.MAX_CLUSTER}"))
        for threads, unroll in VARIANTS])
    for (threads, unroll), built in zip(VARIANTS, libs):
        regs = cs._ptxas_per_instance(built.log, "gemv_kernel")
        print(f"[variant] threads={threads} unroll={unroll} "
              f"registers/spill={regs}", flush=True)

    def split(K, threads, rank_rows):
        """The wrapper's k_split for another geometry."""
        rounds = -(-K // (threads // gv.ROW_LANES))
        return min(gv.MAX_CLUSTER, -(-K // rank_rows), rounds)

    def launcher(built, x, w, out, cluster):
        G, K = x.shape
        N = w.shape[-1]
        code = gv.DTYPE_CODES[x.dtype]
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            built.check(built.lib.coalesced_gemv_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), G, K, N, code,
                cluster, stream))
            return out
        return call

    flush = torch.zeros(64 << 20, device="cuda")
    inputs = {}
    for label, G, K, N, dtypes in cs.GEMV_SHAPES:
        for dname in dtypes:
            g = torch.Generator(device="cuda").manual_seed(G * K + N)
            dtype = getattr(torch, dname)
            x = torch.randn(G, K, device="cuda", generator=g).to(dtype)
            w = (torch.randn(G, K, N, device="cuda", generator=g)
                 / math.sqrt(K)).to(dtype)
            inputs[(label, dname)] = (x, w, ref(x, w))
    rows = []
    # the library call the kernel is held against (chip_smoke.py's)
    for (label, dname), (x, w, _) in inputs.items():
        x3 = x[:, None]
        ms, lo, hi = cs.time_spread(lambda: torch.bmm(x3, w), reps=25,
                                    flush=flush)
        row = dict(library="torch.bmm", shape=label, dtype=dname, ms=ms,
                   ms_min=lo, ms_max=hi)
        rows.append(row)
        print("[library] " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)
    configs = [(v, built, r) for v, built in zip(VARIANTS, libs)
               for r in RANK_ROWS]
    for pas, order in enumerate((configs, configs[::-1])):
        for (threads, unroll), built, rank_rows in order:
            for (label, dname), (x, w, want) in inputs.items():
                G, K = x.shape
                N = w.shape[-1]
                cluster = split(K, threads, rank_rows)
                out = torch.empty(G, N, dtype=x.dtype, device="cuda")
                call = launcher(built, x, w, out, cluster)
                call()
                torch.cuda.synchronize()
                rtol, atol = cs.TOL[dname]
                torch.testing.assert_close(out.float(), want.float(),
                                           rtol=rtol, atol=atol)
                ms, lo, hi = cs.time_spread(call, reps=25, flush=flush)
                row = dict(pass_=pas, threads=threads, unroll=unroll,
                           rank_rows=rank_rows, shape=label, dtype=dname,
                           cluster=cluster,
                           blocks=cluster * (N // gv.tile_n(x.dtype)) * G,
                           ms=ms, ms_min=lo, ms_max=hi)
                rows.append(row)
                print("[sweep] " + " ".join(f"{k}={v}" for k, v in
                                            row.items()), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": smi, "rows": rows}, indent=1))
    # per (variant, rows a rank): the sum over the eight rows of the two
    # passes' mean time, lowest first
    total = {}
    for r in rows:
        if "library" in r:
            continue
        key = (r["threads"], r["unroll"], r["rank_rows"])
        total[key] = total.get(key, 0.0) + r["ms"] / 2
    for key, t in sorted(total.items(), key=lambda kv: kv[1]):
        print(f"[total] threads={key[0]} unroll={key[1]} rank_rows={key[2]} "
              f"sum_ms={t:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
