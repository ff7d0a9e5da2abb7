"""Multi-pod dry-run: the counterpart of the JAX package's
``launch/dryrun.py``.

For each supported (architecture × input shape × mesh) it runs the port's
real production step, on meta tensors (no allocation), as rank 0 of a
fake process group of the production mesh's size (``launch/mesh.py``:
``fake_world``; 16×16, or 2×16×16 multi-pod), and writes that chip's
record:

  * train: ``make_train_step`` on params and optimizer state placed by the
    sharding rules (``production_state``), under the reference's hints;
  * prefill / decode: ``Model.prefill`` / ``Model.decode_step`` on the
    rank's block of the batch and of the cache (``batch_shardings``,
    ``cache_shardings``; the prefill keeps the rank's sequence block of
    the cache it writes, the decode reads it as DTensors), each weight
    gathered at use over its FSDP axes, a layer's where the layer runs.

Every step runs the port's compute over "model" as the reference's GSPMD
step does (``distributed/sharding.py``): the FFN, the MoE experts' d_ff
and the vocabulary (embedding, logits, the cross-entropy) tensor-parallel,
the experts parallel over the data axes where they divide them (tokens
traded by all-to-all), and a decode on a sequence-sharded cache combining
its softmax across the sequence's ranks.

The record keeps the bytes of params, optimizer state, batch and cache a
chip holds (``bytes_per_chip``) and the model FLOPs a chip does
(``model_flops_per_chip``), and adds what the trace counts
(``launch/step_cost.py``, the counterpart of ``launch/hlo_parse.py``):
``flops`` (dot FLOPs), ``bytes`` (eager traffic: no fusion, an upper bound
on the reference's fusion-aware bytes), ``collectives`` (operand bytes of
each kind that occurs), ``memory`` (arguments, outputs, temporaries and
the peak of live storage) and ``roofline`` at the ``H100``'s spec-sheet
rates (``launch/hlo_analysis.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, get_config,
                                 pair_is_supported)
from repro_torch.configs.base import InputShape
from repro_torch.distributed.hints import activation_sharding
from repro_torch.distributed.sharding import (batch_shardings, distribute,
                                              opt_state_shardings,
                                              param_shardings)
from repro_torch.launch.hlo_analysis import model_flops_for, roofline
from repro_torch.launch.mesh import (fake_world, make_mesh,
                                     make_production_mesh, production_hints,
                                     production_state)
from repro_torch.launch.step_cost import CostTotals, count_step
from repro_torch.models import Model
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import leaves, tree_map


def per_chip_bytes(tree: Any, shardings: Any) -> int:
    """Bytes one chip holds of ``tree`` placed by ``shardings`` (matching
    trees of tensors and ``NamedSharding``)."""
    total = 0
    for t, s in zip(leaves(tree), leaves(shardings)):
        total += math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
    return total


def shard_bytes(model: Model, shape, mesh) -> Dict[str, int]:
    """Bytes of params, optimizer state (train), batch and decode cache
    one chip holds under the sharding rules on ``mesh`` (a described mesh
    will do), and their total."""
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
        nbytes["opt_state"] = per_chip_bytes(
            init_opt_state(p_shape), opt_state_shardings(p_sh, mesh))
    if "cache" in in_specs:
        nbytes["cache"] = per_chip_bytes(in_specs["cache"], b_sh["cache"])
    nbytes["total"] = sum(nbytes.values())
    return nbytes


def _block(tree: Any, shardings: Any) -> Any:
    """One rank's block of each meta tensor of ``tree``: a new meta tensor
    of its shard's shape."""
    return tree_map(lambda t, s: torch.empty(s.shard_shape(tuple(t.shape)),
                                             dtype=t.dtype, device="meta"),
                    tree, shardings)


def trace_step(model: Model, shape, mesh
               ) -> Tuple[CostTotals, Dict[str, int]]:
    """Run the step of ``shape.kind`` as rank 0 of ``mesh`` on meta
    tensors under a ``StepCounter``; return (``CostTotals``, memory)."""
    p_shape = model.abstract_params()
    in_specs = model.input_specs(shape)
    B = shape.global_batch
    if shape.kind == "train":
        params, opt, hints = production_state(model, p_shape, mesh, B)
        step = make_train_step(model, OptimizerConfig())
        with activation_sharding(hints):
            _, totals, memory = count_step(step, params, opt, in_specs)
        return totals, memory
    params = distribute(p_shape, param_shardings(model, mesh))
    b_sh = batch_shardings(model, shape, mesh)
    block = _block({k: v for k, v in in_specs.items() if k != "cache"},
                   {k: v for k, v in b_sh.items() if k != "cache"})
    with activation_sharding(production_hints(model, mesh, B)):
        if shape.kind == "prefill":
            decode = InputShape(shape.name, shape.seq_len, B, "decode")
            c_sh = batch_shardings(model, decode, mesh)["cache"]
            _, totals, memory = count_step(
                lambda p, b: model.prefill(p, b, cache_len=shape.seq_len,
                                           cache_shardings=c_sh),
                params, block)
        else:
            cache = distribute(in_specs["cache"], b_sh["cache"])
            _, totals, memory = count_step(model.decode_step, params,
                                           block["tokens"], cache)
    return totals, memory


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               verbose: bool = True) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) on the meta device over a fake world
    of the mesh's size; return rank 0's per-chip record."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    described = make_production_mesh(multi_pod=multi_pod)
    chips = described.size
    model = Model(cfg, param_dtype=torch.bfloat16, device="meta",
                  remat=(shape.kind == "train"))
    nbytes = shard_bytes(model, shape, described)
    mf = model_flops_for(cfg, shape) / chips      # per-chip useful flops

    t0 = time.perf_counter()
    with fake_world(chips):
        totals, memory = trace_step(model, shape,
                                    make_mesh(described.shape, "cpu"))
    trace_s = time.perf_counter() - t0
    terms = roofline(totals.flops, totals.bytes, totals.collective_bytes,
                     chips, model_flops=mf)
    coll = {k: v for k, v in totals.per_collective.items() if v}
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single", "chips": chips,
        "kind": shape.kind, "bytes_per_chip": nbytes,
        "model_flops_per_chip": mf,
        "flops": totals.flops, "bytes": totals.bytes,
        "bytes_counted": "eager traffic (no fusion): an upper bound on "
                         "the reference's fusion-aware bytes",
        "collectives": coll, "memory": memory,
        "roofline": terms.as_dict(),
        "roofline_device": "H100 spec sheet",
        "trace_s": trace_s,
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {record['mesh']}] "
              f"trace={trace_s:.1f}s flops/chip={totals.flops:.4e} "
              f"bytes/chip={totals.bytes:.4e} "
              f"coll={totals.collective_bytes:.4e}B "
              f"peak={memory['peak_bytes']:.4e}B "
              f"dominant={terms.dominant}", flush=True)
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
