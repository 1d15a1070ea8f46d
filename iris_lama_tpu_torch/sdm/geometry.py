"""Map geometry: the sparse-dense coordinate algebra on int32/float32 tensors.

World coordinates are scaled to cells in float32 and the origin offset
(``CENTER_PATCH`` patches) is added in int32 afterwards, so float32 keeps
sub-cell precision. Patch keys pack ``(px << 15) | py`` into an int32.
Rounding rules the oracle tests depend on: ``w2m`` rounds half up,
``w2m_frac`` floors.

All functions broadcast over leading batch dimensions and keep the device
of their input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Patch-coordinate packing: 15 bits per axis -> key fits in int32.
PKEY_BITS = 15
CENTER_PATCH = 1 << (PKEY_BITS - 1)  # patch-coordinate origin offset


def f32(x: float) -> float:
    """``x`` rounded to the nearest float32, as a Python float: a tensor op
    with this constant gives the float32 result whether the scalar is
    applied in float32 or float64."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class MapGeometry:
    """Static geometry of a sparse-dense map."""

    resolution: float = 0.05
    log2dim: int = 5          # patch_length = 2**log2dim
    is_3d: bool = False

    @property
    def patch_length(self) -> int:
        return 1 << self.log2dim

    @property
    def scale(self) -> float:
        return 1.0 / self.resolution

    @property
    def cell_offset(self) -> int:
        """Integer cell coordinate of the world origin."""
        return CENTER_PATCH * self.patch_length

    # world <-> map ---------------------------------------------------------
    def w2m_f(self, world):
        """World -> continuous cell coords without the origin offset (f32)."""
        return world.to(torch.float32) * f32(self.scale)

    def w2m(self, world):
        """World -> discrete cell coords (round half up), int32."""
        mf = self.w2m_f(world)
        return torch.floor(mf + 0.5).to(torch.int32) + self.cell_offset

    def w2m_frac(self, world):
        """World -> (floor cell coords int32 with offset, fractional part)."""
        mf = self.w2m_f(world)
        fl = torch.floor(mf)
        return fl.to(torch.int32) + self.cell_offset, mf - fl

    def np_w2m(self, world):
        """:meth:`w2m` on the host: float64 numpy in, int32 numpy out."""
        mf = np.asarray(world, np.float64) * self.scale
        return (np.floor(mf + 0.5).astype(np.int32)
                + np.int32(self.cell_offset))

    def np_m2w(self, cells):
        """:meth:`m2w` on the host, in float64."""
        return ((np.asarray(cells, np.int64) - self.cell_offset)
                * self.resolution)

    def m2w(self, cells):
        """Discrete cell coords -> world coords of the cell origin."""
        rel = cells.to(torch.int32) - self.cell_offset
        return rel.to(torch.float32) * f32(self.resolution)

    # map <-> patch ---------------------------------------------------------
    def m2patch(self, cells):
        return cells.to(torch.int32) >> self.log2dim

    def patch_key(self, pcoords):
        p = pcoords.to(torch.int32)
        return (p[..., 0] << PKEY_BITS) | p[..., 1]

    def m2p(self, cells):
        return self.patch_key(self.m2patch(cells))

    def p2anchor(self, keys):
        k = keys.to(torch.int32)
        px = k >> PKEY_BITS
        py = k & ((1 << PKEY_BITS) - 1)
        return torch.stack([px << self.log2dim, py << self.log2dim], dim=-1)

    def m2local(self, cells):
        return cells.to(torch.int32) & (self.patch_length - 1)
