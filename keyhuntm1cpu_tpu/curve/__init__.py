"""Batched secp256k1 curve operations.

- ``points``: PointBatch container + general batched affine add/double and
  GTable-windowed batched scalar multiplication (capability of reference
  secp256k1/SECP256K1.cpp ComputePublicKey/AddDirect/DoubleDirect).
- ``tables``: host-side exact precomputation of stride tables (i*S) and the
  windowed generator table (reference GTable, SECP256K1.cpp:29-56).
- ``walk``: the universal "group walk" — X-only one-to-many point addition
  with a single batched inversion and ± symmetry, the batched re-design of the
  reference's single hot loop (keyhunt.cpp:3873-3999 and 10+ clones).
- ``pwalk``: the BSGS walk chunk as two CUDA kernels (native/) called
  through the XLA foreign function interface, with its plain twin.
- ``pbrute``: the fused brute-mode chunk (walk + hash + compare).
"""

from .points import PointBatch, add, double, scalar_mult_batch, point_batch_from_ints  # noqa: F401
from . import tables, walk  # noqa: F401
