"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version (the CPU path and the on-card reference)."""

from .ldpc_bp import bp_decode_pallas
