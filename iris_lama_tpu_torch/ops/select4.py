"""B2: the four bilinear corners of a squared-distance grid.

From grid ``[H, W]`` (indexed [y, x]) and int32 cell indices ``ly, lx [B]``
(clipped into the grid) returns int32 ``[4, B]``:
``(v00, v10, v01, v11)`` with v10 = (lx+1, ly) and v01 = (lx, ly+1).

The TPU version (iris_lama_tpu/ops/select4.py) selected rows with an s8
one-hot matrix product because the TPU has no fast gather (and took other
widths through an XLA gather). On the GPU it is a plain gather kernel
(``csrc/select4.cu``), one instantiation for each squared-distance width
``DistanceConfig.sq_dtype`` returns (int8, uint8, int16, int32), that
reads the indices through their strides, so the columns of a ``[B, 2]``
cell tensor pass as views; :func:`select4_sq` uses
:func:`select4_sq_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda


def select4_sq_plain(grid, ly, lx):
    """Plain PyTorch version: four clipped advanced-index reads (any
    integer grid). A grid ``[P, H, W]`` with indices ``[P, B]`` gives
    ``[4, P, B]``, particle ``p`` reading its own grid."""
    h, w = grid.shape[-2:]
    ly0 = ly.clamp(0, h - 1).long()
    ly1 = (ly + 1).clamp(0, h - 1).long()
    lx0 = lx.clamp(0, w - 1).long()
    lx1 = (lx + 1).clamp(0, w - 1).long()
    if grid.dim() == 3:
        p = torch.arange(grid.shape[0], device=grid.device)[:, None]
        return torch.stack([grid[p, ly0, lx0], grid[p, ly0, lx1],
                            grid[p, ly1, lx0],
                            grid[p, ly1, lx1]]).to(torch.int32)
    return torch.stack([grid[ly0, lx0], grid[ly0, lx1],
                        grid[ly1, lx0], grid[ly1, lx1]]).to(torch.int32)


def select4_sq(grid, ly, lx):
    """int32[4, B] corners of ``grid`` at (``ly``, ``lx``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous int8, uint8, int16 or int32 grid, 1-D int32 indices in any
    layout) or raise.
    """
    if grid.device.type == "cpu":
        return select4_sq_plain(grid, ly, lx)
    dev = grid.device
    _cuda.require(grid, "grid", None, 2, dev)
    code = _cuda.sq_code(grid, "grid")
    (sly,) = _cuda.require_strided(ly, "ly", torch.int32, 1, dev)
    (slx,) = _cuda.require_strided(lx, "lx", torch.int32, 1, dev)
    if ly.shape != lx.shape:
        raise ValueError(f"ly {tuple(ly.shape)} and lx {tuple(lx.shape)} "
                         "differ in length")
    h, w = grid.shape
    b = ly.numel()
    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    lib = _cuda.library("select4")
    _cuda.check(lib.select4_sq(grid.data_ptr(), code, h, w, ly.data_ptr(),
                               sly, lx.data_ptr(), slx, b, out.data_ptr(),
                               _cuda.stream_handle(dev)),
                "select4_sq")
    return out
