"""Multi-pod dry-run without XLA: the counterpart of the JAX package's
``launch/dryrun.py``.

For each supported (architecture × input shape × mesh) it builds params,
optimizer state (train), the batch and the decode cache (decode) as
meta-device tensors (no allocation), applies the sharding specs of the
production mesh (``launch/mesh.py``, described: 16×16, or 2×16×16
multi-pod) and writes a per-chip record: the bytes of params, optimizer
state, batch and cache one chip holds, the model FLOPs a chip does, and
roofline terms at the ``H100``'s spec-sheet rates (``launch/
hlo_analysis.py``) with the step's input bytes read once as the memory
term.

The reference lowers and compiles each step for 512 host devices and
reads XLA's memory and cost analyses and the HLO's collectives
(``launch/hlo_parse.py``). The port compiles no XLA program: there is no
lowering and no compile here, the FLOPs are the model's (6·N·D / 2·N·D),
and collective bytes are not modelled (0 in the record, named so).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 pair_is_supported)
from repro_torch.distributed.sharding import (batch_shardings,
                                              opt_state_shardings,
                                              param_shardings)
from repro_torch.launch.hlo_analysis import model_flops_for, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.training.optimizer import init_opt_state
from repro_torch.tree import leaves


def per_chip_bytes(tree: Any, shardings: Any) -> int:
    """Bytes one chip holds of ``tree`` placed by ``shardings`` (matching
    trees of tensors and ``NamedSharding``)."""
    total = 0
    for t, s in zip(leaves(tree), leaves(shardings)):
        total += math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
    return total


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True) -> Dict[str, Any]:
    """Shard one (arch, shape, mesh) on the meta device; return its
    per-chip record."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    model = Model(cfg, param_dtype=torch.bfloat16, device="meta",
                  remat=(shape.kind == "train"))
    p_shape = model.abstract_params()
    p_sh = param_shardings(model, mesh)
    in_specs = model.input_specs(shape)
    b_sh = batch_shardings(model, shape, mesh)
    nbytes = {"params": per_chip_bytes(p_shape, p_sh), "opt_state": 0,
              "batch": per_chip_bytes(
                  {k: v for k, v in in_specs.items() if k != "cache"},
                  {k: v for k, v in b_sh.items() if k != "cache"}),
              "cache": 0}
    if shape.kind == "train":
        nbytes["opt_state"] = per_chip_bytes(init_opt_state(p_shape),
                                             opt_state_shardings(p_sh, mesh))
    if "cache" in in_specs:
        nbytes["cache"] = per_chip_bytes(in_specs["cache"], b_sh["cache"])
    nbytes["total"] = sum(nbytes.values())
    mf = model_flops_for(cfg, shape) / chips      # per-chip useful flops
    terms = roofline(mf, nbytes["total"], 0.0, chips, model_flops=mf)
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single", "chips": chips,
        "kind": shape.kind, "bytes_per_chip": nbytes,
        "model_flops_per_chip": mf, "roofline": terms.as_dict(),
        "roofline_device": "H100 spec sheet",
        "collectives": "not modelled (no compiled program)",
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {record['mesh']}] "
              f"params/chip={nbytes['params']:.4e}B "
              f"opt/chip={nbytes['opt_state']:.4e}B "
              f"cache/chip={nbytes['cache']:.4e}B "
              f"flops/chip={mf:.4e} dominant={terms.dominant}")
    return record


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="sweep every supported (arch, shape, mesh)")
    ap.add_argument("--out", default="",
                    help="write the records as JSON lines to this file")
    args = ap.parse_args(argv)
    if args.all:
        combos = [(a, s, m) for a in ARCH_IDS for s in INPUT_SHAPES
                  for m in ("single", "multi") if pair_is_supported(a, s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        combos = [(args.arch, args.shape, m) for m in meshes]
    records = [dryrun_one(a, s, m == "multi") for a, s, m in combos]
    if args.out:
        with open(args.out, "w") as f:
            for r in records:
                f.write(json.dumps(r) + "\n")
    return records


if __name__ == "__main__":
    main()
