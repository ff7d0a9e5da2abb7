"""Hand-written Hopper kernels, their plain versions and the packing layer."""
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.ops import (envelope_bucket, execute_superkernel,
                                     pack_problems)
from repro_torch.kernels.ref import coalesced_gemm_ref

__all__ = ["coalesced_gemm", "coalesced_gemm_ref", "envelope_bucket",
           "execute_superkernel", "pack_problems"]
