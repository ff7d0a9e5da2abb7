"""Roofline terms and model FLOPs: the counterpart of the JAX package's
``launch/hlo_analysis.py``, without its HLO parser.

The reference reads collective bytes from the optimized XLA HLO text
(``collective_bytes``) and the rest of a step's cost from it too
(``launch/hlo_parse.py``); the port counts them by tracing the step as it
runs, in ``launch/step_cost.py``. ``RooflineTerms``, ``roofline`` and
``model_flops_for`` are copies; the peak rates are the port's ``H100``
``Device`` (NVIDIA's spec sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
450 GB/s NVLink each way), not the reference's TPU v5e constants.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.costmodel import H100

PEAK_FLOPS = H100.peak_flops
HBM_BW = H100.hbm_bw
ICI_BW = H100.ici_bw


@dataclasses.dataclass
class RooflineTerms:
    """Per-step execution-time lower bounds (seconds), per chip."""
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    chips: int
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much of the compute is useful."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def roofline(hlo_flops: float, hlo_bytes: float, coll_bytes: float,
             chips: int, model_flops: float = 0.0) -> RooflineTerms:
    """The reference's formulas at the H100's spec-sheet rates; flops and
    bytes are per chip."""
    return RooflineTerms(
        compute_s=hlo_flops / PEAK_FLOPS,
        memory_s=hlo_bytes / HBM_BW,
        collective_s=coll_bytes / ICI_BW,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes, coll_bytes=coll_bytes,
        chips=chips, model_flops=model_flops)


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference forward),
    N = active params (MoE: top-k), D = tokens processed in the step."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch * 1  # decode: one token per sequence
    return 2.0 * n * d


__all__ = ["HBM_BW", "ICI_BW", "PEAK_FLOPS", "RooflineTerms",
           "model_flops_for", "roofline"]
