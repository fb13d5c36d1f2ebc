"""The JAX package's own tier-1 test files of the streams area
(``torch_contracts.AREAS["streams"]``) on the port, on the CPU: each JAX test
under its file's prefix, the twins of its reason-(c) cases, less what
``torch_contracts.EXCLUDED`` leaves out."""

import torch

import torch_contracts as C

torch.set_num_threads(1)

C.tier1_module(globals(), "streams")
