"""Vectorised 3-D Morton (Z-order) coding.

Equivalent of the reference MortonCoder
(include/tree/Octree.hpp:82-188): 10 bits per axis interleaved into a
30-bit code.  The reference spreads bits scalar-at-a-time; here the same
magic-mask spreading runs vectorised over whole numpy arrays.
Codes are kept in int64 so arithmetic on prefixes never overflows.
"""

from __future__ import annotations

import numpy as np

#: bits per axis — 10 levels of octree refinement (ref Octree.hpp:87-89)
LEVELS = 10
CELLS_PER_SIDE = 1 << LEVELS


def _spread_bits(x):
    """Spread the low 10 bits of ``x`` with two zeros between each bit.

    Same magic masks as the reference scalar version (Octree.hpp:143-150),
    applied to whole arrays.
    """
    x = np.asarray(x, dtype=np.int64)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact_bits(x):
    """Inverse of :func:`_spread_bits` (ref Octree.hpp:166-172)."""
    x = np.asarray(x, dtype=np.int64) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def interleave(ix, iy, iz):
    """Morton code from integer cell coordinates (ref Octree.hpp:157-159)."""
    return _spread_bits(ix) | (_spread_bits(iy) << 1) | (_spread_bits(iz) << 2)


def deinterleave(code):
    """Integer cell coordinates from a Morton code (ref Octree.hpp:178-184)."""
    code = np.asarray(code, dtype=np.int64)
    return _compact_bits(code), _compact_bits(code >> 1), _compact_bits(code >> 2)


def morton_encode(points, pmin, cell_size):
    """Full-depth Morton codes of ``points`` relative to a cubic bbox.

    ``cell_size`` is the side of a level-10 cell.  Mirrors
    MortonCoder::code (Octree.hpp:118-129) vectorised.
    """
    s = np.floor((np.asarray(points) - pmin) / cell_size).astype(np.int64)
    s = np.clip(s, 0, CELLS_PER_SIDE - 1)
    return interleave(s[..., 0], s[..., 1], s[..., 2])


def morton_decode(codes):
    """Cell integer coordinates (ix, iy, iz) of full-depth codes."""
    return deinterleave(codes)
