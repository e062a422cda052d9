"""keyhuntm1cpu_tpu — a secp256k1 key-search framework for NVIDIA GPUs.

A from-scratch JAX/XLA re-design (with CUDA walk kernels) of the capabilities of
consigcody94/keyhuntM1CPU (CPU/NEON keyhunt fork):

- ``field``   : 256-bit modular arithmetic as vectorized 8x32-bit limb
                kernels (mod p and mod n), batched Montgomery-trick inverse.
- ``curve``   : batched affine secp256k1 point ops, the universal
                "group walk" (the reference's single hot loop,
                reference keyhunt.cpp:3873-3999), scalar multiplication.
- ``hash``    : batch-vectorized SHA-256 / RIPEMD-160 / Keccak-256 and the
                fused hash160 pipeline (reference hash/, sha3/).
- ``filter``  : membership structures — sorted-table binary search (the
                device-idiomatic replacement for the reference's bPtable,
                keyhunt.cpp:3748-3775) and a bloom-filter cascade
                (reference bloom/bloom.cpp).
- ``engine``  : search engines — BSGS, address, rmd160, xpoint, eth,
                minikeys, vanity (reference keyhunt.cpp thread_process*).
- ``parallel``: mesh sharding of key ranges and tables across GPUs
                and hosts (replaces the reference's pthread+mutex range
                claiming, keyhunt.cpp:3824-3841).
- ``ref``     : pure-Python golden reference used for tests and for exact
                host-side verification of device candidates.
"""

__version__ = "0.1.0"
