"""B8: packed 0/1 updates summed into a dense grid.

Each update packs into one int32 (:func:`pack_updates`):
``tile_y << 20 | tile_x << 11 | (y % 8) << 8 | (x % 128) << 1 | v`` for
the (8, 128) tile ``(tile_y, tile_x)`` of cell ``(y, x)`` and a value ``v``
in {0, 1}. ``scatter_add_sorted(packed, shape)`` adds every ``v`` at its
cell of an int32 grid ``shape = (H, W)``, ``H % 8 == 0`` and
``W % 128 == 0``.

The TPU kernel (iris_lama_tpu/ops/scatter_sorted.py:_kernel) took the
words sorted, accumulated one (8, 128) tile in a register and flushed it
once per tile change. The sort and the flush were TPU scheduling: the
function is the same for any order. On the GPU it is B7's cooperative
launch (``csrc/deposit.cu``, :func:`scatter_pallas.launch_blocks`) on
decoded words: the kernel zeroes the grid, one grid barrier, then int32
atomics, the lanes of a warp holding a run of one cell summed first (a
sorted run costs one atomic a warp); exact in any order
(:func:`scatter_add_2d_sorted` sorts as the JAX pipeline does; the result
is the same unsorted). :func:`scatter_add_sorted` launches the kernel for
CUDA tensors and uses :func:`scatter_add_sorted_plain` for CPU tensors.
Nothing in the JAX package calls it outside its own module and tests.
"""

from __future__ import annotations

import torch

from . import _cuda
from .scatter_pallas import launch_blocks


def pack_updates(ly, lx, val):
    """int32 [N] packed updates of int32 cells (``ly``, ``lx``) and values
    ``val`` in {0, 1} (an invalid row carries ``val = 0``)."""
    ly, lx, val = (t.to(torch.int32) for t in (ly, lx, val))
    tile_y = ly >> 3
    tile_x = lx >> 7
    return (((tile_y << 20) | (tile_x << 11))
            | ((ly & 7) << 8) | ((lx & 127) << 1) | (val & 1))


def _check_shape(shape) -> tuple:
    h, w = shape
    if h % 8 or w % 128:
        raise ValueError(f"scatter_add_sorted: shape {tuple(shape)} must be "
                         "a multiple of (8, 128)")
    return h, w


def scatter_add_sorted_plain(packed, shape):
    """Plain PyTorch version: decode, then ``index_put_(accumulate=True)``
    of the values."""
    h, w = _check_shape(shape)
    packed = packed.to(torch.int32)
    ly = (packed >> 20) * 8 + ((packed >> 8) & 7)
    lx = ((packed >> 11) & 511) * 128 + ((packed >> 1) & 127)
    out = torch.zeros((h, w), dtype=torch.int32, device=packed.device)
    return out.index_put_((ly.long(), lx.long()), packed & 1,
                          accumulate=True)


def scatter_add_sorted(packed, shape):
    """int32 grid ``shape`` holding the sum of the packed updates.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (a contiguous int32 stream) or raise.
    """
    if packed.device.type == "cpu":
        return scatter_add_sorted_plain(packed, shape)
    h, w = _check_shape(shape)
    dev = packed.device
    _cuda.require(packed, "packed", torch.int32, 1, dev)
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    lib = _cuda.library("deposit")
    _cuda.check(lib.scatter_add_sorted(packed.data_ptr(), packed.numel(), h,
                                       w, launch_blocks(packed.numel()),
                                       out.data_ptr(),
                                       _cuda.stream_handle(dev)),
                "scatter_add_sorted")
    return out


def scatter_add_2d_sorted(ly, lx, val, shape):
    """The JAX pipeline: pack -> sort -> :func:`scatter_add_sorted`, for
    values in {0, 1} and in-grid cells."""
    packed = pack_updates(ly, lx, val)
    return scatter_add_sorted(torch.sort(packed).values, shape)
