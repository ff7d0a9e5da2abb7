"""The dry-run's records as a table: per (architecture, input shape), the
collective bytes a chip moves (GB, single / multi pod), its
``useful_flops_ratio`` (single / multi where they differ) and its peak
live bytes (GB, single / multi), from the JSON lines that
``python -m repro_torch.launch.dryrun --all --out FILE`` writes. With
``--before`` another run's records, each cell is "before → after".

Usage:
  python experiments/torch_dryrun_table.py build/dryrun.jsonl
  python experiments/torch_dryrun_table.py after.jsonl --before before.jsonl
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(path: str) -> Dict[Tuple[str, str, str], dict]:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def _g(x: float) -> str:
    """Three significant figures, as GB."""
    return f"{x / 1e9:.3g}"


def _pair(recs, arch, shape, value) -> Optional[List[str]]:
    """``value`` of the single and the multi-pod record, formatted."""
    got = [recs.get((arch, shape, m)) for m in ("single", "multi")]
    if not all(got):
        return None
    return [value(r) for r in got]


def cell(recs, arch, shape) -> Optional[Tuple[str, str, str]]:
    coll = _pair(recs, arch, shape,
                 lambda r: _g(sum(r["collectives"].values())))
    if coll is None:
        return None
    ratio = _pair(recs, arch, shape,
                  lambda r: f"{r['roofline']['useful_flops_ratio']:.3f}")
    peak = _pair(recs, arch, shape,
                 lambda r: _g(r["memory"]["peak_bytes"]))
    ratio_text = ratio[0] if ratio[0] == ratio[1] else " / ".join(ratio)
    return " / ".join(coll), ratio_text, " / ".join(peak)


def table(after, before=None) -> str:
    archs = list(dict.fromkeys(a for a, _, _ in after))
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "| --- |" + " --- |" * len(SHAPES)]
    for arch in archs:
        row = []
        for shape in SHAPES:
            new = cell(after, arch, shape)
            if new is None:
                row.append("—")
                continue
            old = cell(before, arch, shape) if before else None
            parts = [f"{o} → {n}" if old else n
                     for o, n in zip(old or (None,) * 3, new)]
            row.append("; ".join(parts))
        lines.append(f"| {arch} | " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("records")
    ap.add_argument("--before", default="")
    args = ap.parse_args(argv)
    out = table(load(args.records),
                load(args.before) if args.before else None)
    print("cells: collective GB a chip (single / multi); "
          "useful_flops_ratio; peak GB a chip (single / multi)")
    print(out)
    return out


if __name__ == "__main__":
    main()
