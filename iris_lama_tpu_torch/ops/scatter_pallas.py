"""B7: int32 value scatter-add into a dense grid.

``scatter_add_2d(ly, lx, val, shape)``: ``out[ly[t], lx[t]] += val[t]``
over int32 streams ``[N]`` into an int32 grid ``shape = (H, W)``; the
indices must lie in the grid, as the JAX function requires.

The TPU kernel (iris_lama_tpu/ops/scatter_pallas.py:_scatter_kernel) kept
the grid in VMEM and did one aligned (8, 128) tile read-modify-write per
element. On the GPU (``csrc/deposit.cu``, beside B1's deposit) it is one
cooperative launch that zeroes the grid itself, meets at one grid barrier
and adds with int32 atomics, a warp's runs of equal cells combined first;
exact in any order. :func:`launch_blocks` sizes the launch; B8
(``scatter_sorted.py``) takes the same. :func:`scatter_add_2d` launches
the kernel for CUDA tensors and uses :func:`scatter_add_2d_plain` for CPU
tensors. Nothing in the JAX package calls it outside its own module and
tests.
"""

from __future__ import annotations

import torch

from . import _cuda

SMS = 132       # the H100 SXM's streaming multiprocessors
THREADS = 256   # threads a block (csrc/deposit.cu: kScatterThreads)
PER = 2         # elements a thread loads before the barrier (kScatterPer)


def launch_blocks(n: int) -> int:
    """Blocks of B7's and B8's cooperative launch for ``n`` elements: one
    a streaming multiprocessor while one round of ``THREADS * PER``
    elements a block holds the stream (its loads all in flight across the
    barrier; fastest of 66-528 blocks on 38 k elements), four beyond
    (fastest on 2.4 M; PERF.md's kernel table, B7). Every block must be
    resident at once: the card holds 8 a multiprocessor at this size."""
    return SMS if n <= SMS * THREADS * PER else 4 * SMS


def scatter_add_2d_plain(ly, lx, val, shape):
    """Plain PyTorch version: ``zeros`` + ``index_put_(accumulate=True)``."""
    out = torch.zeros(tuple(shape), dtype=torch.int32, device=ly.device)
    return out.index_put_((ly.long(), lx.long()), val.to(torch.int32),
                          accumulate=True)


def scatter_add_2d(ly, lx, val, shape):
    """int32 grid ``shape`` with ``val[t]`` added at (``ly[t]``,
    ``lx[t]``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous int32 streams of one length, a grid below 2**31 cells) or
    raise.
    """
    if ly.device.type == "cpu":
        return scatter_add_2d_plain(ly, lx, val, shape)
    dev = ly.device
    for name, t in (("ly", ly), ("lx", lx), ("val", val)):
        _cuda.require(t, name, torch.int32, 1, dev)
    if not ly.shape == lx.shape == val.shape:
        raise ValueError(f"ly {tuple(ly.shape)}, lx {tuple(lx.shape)} and "
                         f"val {tuple(val.shape)} differ in length")
    h, w = shape
    out = torch.empty((h, w), dtype=torch.int32, device=dev)
    lib = _cuda.library("deposit")
    _cuda.check(lib.scatter_add_2d(ly.data_ptr(), lx.data_ptr(),
                                   val.data_ptr(), ly.numel(), h, w,
                                   launch_blocks(ly.numel()), out.data_ptr(),
                                   _cuda.stream_handle(dev)),
                "scatter_add_2d")
    return out
