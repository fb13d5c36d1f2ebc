"""The JAX package's own tier-1 test files on the card: every case of the
files ``torch_contracts.FILES`` names that ``torch_contracts.EXCLUDED`` does
not leave out, and the twins of its reason-(c) cases, run on the port with
its own defaults, so host data goes to the card as a user's would and the
JAX assertions drive the hand-written kernels. The lines that import
``jax`` are dropped (the card machine has no JAX) and the cases that name
``jax`` or ``jnp`` are left out (reason (a)). numpy reads a CUDA tensor as
it reads a JAX device array (``torch_contracts.card_arrays``).

Opt-in, on a card only:

    python -m pytest --noconftest -m gpu tests/test_torch_contracts_gpu.py

(no JAX here; the repository's conftest pins it). Without a card every
case skips.
"""

import pytest

import torch_contracts as C

pytestmark = pytest.mark.gpu

C.card_module(globals())
