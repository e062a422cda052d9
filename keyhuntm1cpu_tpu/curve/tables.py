"""Host-side exact precomputation of curve constant tables.

Tables are built once with exact python-int arithmetic (ref/ecref.py) and
uploaded to the device as uint32 limb constants — the device analog of the
reference's GTable build at startup (secp256k1/SECP256K1.cpp:29-56) and
the Gn/GSn/AMP stride tables (keyhunt.cpp:4386-4399, 1320-1364).

Caching: in-process memo keyed by the defining python ints, so repeated
engine constructions don't redo the point walks.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from ..field import fe
from ..ref import ecref


@lru_cache(maxsize=32)
def _step_table_np(px: int, py: int, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """Entries i * (px, py) for i = 1..count, as (count, 8) uint32 pairs."""
    xs = np.empty((count, fe.LIMBS), dtype=np.uint32)
    ys = np.empty((count, fe.LIMBS), dtype=np.uint32)
    cur = (px, py)
    for i in range(count):
        xs[i] = fe.int_to_limbs(cur[0])
        ys[i] = fe.int_to_limbs(cur[1])
        cur = ecref.point_add(cur, (px, py))
        if cur is None and i != count - 1:
            raise ValueError("step table hit infinity — count exceeds point order")
    return xs, ys


def step_table(point: Tuple[int, int], count: int) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) numpy limb tables of i*point for i = 1..count."""
    return _step_table_np(point[0], point[1], count)


@lru_cache(maxsize=1)
def gtable_np() -> Tuple[np.ndarray, np.ndarray]:
    """Windowed generator table: [w, b] = (b * 2^(8w)) * G, b = 0..255.

    b == 0 entries are zero-filled; scalar_mult_batch masks them as
    infinity. Shape (32, 256, 8) x2.
    """
    xs = np.zeros((32, 256, fe.LIMBS), dtype=np.uint32)
    ys = np.zeros((32, 256, fe.LIMBS), dtype=np.uint32)
    base = ecref.G
    for w in range(32):
        cur = base
        for b in range(1, 256):
            xs[w, b] = fe.int_to_limbs(cur[0])
            ys[w, b] = fe.int_to_limbs(cur[1])
            cur = ecref.point_add(cur, base)
        # base for next window = 256 * previous base ( = cur at b=256 )
        base = cur
    return xs, ys
