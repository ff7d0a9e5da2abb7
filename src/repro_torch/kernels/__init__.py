"""Hand-written Hopper kernels, their plain versions and the packing layer."""
from repro_torch.kernels.coalesced_gemm import coalesced_gemm
from repro_torch.kernels.coalesced_gemv import coalesced_gemv
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ops import (coalesced_matvec, envelope_bucket,
                                     execute_superkernel, pack_problems,
                                     windowed_attention)
from repro_torch.kernels.ref import (coalesced_gemm_ref, coalesced_gemv_ref,
                                     flash_attention_ref)

__all__ = ["coalesced_gemm", "coalesced_gemm_ref", "coalesced_gemv",
           "coalesced_gemv_ref", "coalesced_matvec", "envelope_bucket",
           "execute_superkernel", "flash_attention", "flash_attention_ref",
           "pack_problems", "windowed_attention"]
