"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version (the CPU path and the on-card reference)."""
from .viterbi import viterbi_decode_soft_pallas, viterbi_chunks_pallas
from .ldpc_bp import bp_decode_pallas
