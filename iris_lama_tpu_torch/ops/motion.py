"""PFSlam2D's motion step: a queue of K odometry packets applied to every
particle in one launch.

From poses ``[N, 4]``, packets ``[K, 4]`` (x, y, cos, sin odometry
increments, in queue order) and standard normal draws ``[K, N, 3]`` (one
``[N, 3]`` draw a packet) returns the poses ``[N, 4]`` that K calls of
``algos.pf_slam2d.draw_from_motion`` give, bit for bit. That function,
applied packet by packet, is the plain version: ``PFSlam2D._flush_motion``
takes it on the CPU.

The JAX package has no kernel here (XLA fuses its motion step). On the GPU
it is ``csrc/motion.cu``: one thread a particle runs the packets' float32
chain in the eager ops' order, built without FMA contraction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sdm.geometry import f32
from . import _cuda


def apply_queue(opts, eps, packets, poses):
    """Every particle moved by every packet, one launch.

    ``opts`` carries the noise parameters ``srr``, ``srt``, ``str_`` and
    ``stt`` (``PFSlam2DOptions``); eps f32 [K, N, 3], packets f32 [K, 4]
    and poses f32 [N, 4], contiguous CUDA tensors on one device. Returns
    fresh poses f32 [N, 4]; raises on other operands.
    """
    dev = poses.device
    _cuda.require(poses, "poses", torch.float32, 2, dev)
    _cuda.require(packets, "packets", torch.float32, 2, dev)
    _cuda.require(eps, "eps", torch.float32, 3, dev)
    n, k = poses.shape[0], packets.shape[0]
    if poses.shape[1] != 4 or packets.shape[1] != 4 \
            or tuple(eps.shape) != (k, n, 3):
        raise ValueError(f"motion: poses {tuple(poses.shape)}, packets "
                         f"{tuple(packets.shape)}, eps {tuple(eps.shape)}: "
                         "expected [N, 4], [K, 4], [K, N, 3]")
    out = torch.empty_like(poses)
    lib = _cuda.library("motion")
    _cuda.check(lib.motion_apply(
        poses.data_ptr(), packets.data_ptr(), eps.data_ptr(), k, n,
        f32(opts.stt), f32(opts.str_), f32(opts.srr), f32(opts.srt),
        f32(0.3 * opts.stt), f32(np.pi), f32(2 * np.pi), out.data_ptr(),
        _cuda.stream_handle(dev)), "motion_apply")
    apply_queue.launches += 1
    return out


apply_queue.launches = 0
