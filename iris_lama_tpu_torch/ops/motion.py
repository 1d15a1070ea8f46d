"""PFSlam2D's motion step: a queue of K odometry packets applied to every
particle in one launch.

From poses ``[N, 4]``, packets ``[K, 4]`` (x, y, cos, sin odometry
increments, in queue order) and standard normal draws ``[K, N, 3]`` (one
``[N, 3]`` draw a packet) :func:`apply_queue` returns the poses ``[N, 4]``
that K calls of :func:`draw_from_motion` give, bit for bit. Its plain
version, :func:`apply_queue_plain`, makes those K calls and serves CPU
tensors.

The JAX package has no kernel here (XLA fuses its motion step). On the GPU
it is ``csrc/motion.cu``: one thread a particle runs the packets' float32
chain in the eager ops' order, built without FMA contraction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import lie
from ..sdm.geometry import f32
from . import _cuda


def draw_from_motion(opts, eps, odelta, poses):
    """Per-particle motion noise (pf_slam2d.cpp:365-391): ``eps`` f32
    [N, 3] standard normal draws, ``odelta`` the odometry increment f32
    SE(2) [4], ``poses`` [N, 4]."""
    dx, dy = odelta[0], odelta[1]
    drot = torch.atan2(odelta[3], odelta[2])
    stt, str_ = f32(opts.stt), f32(opts.str_)
    srr, srt = f32(opts.srr), f32(opts.srt)
    sxy = f32(0.3 * opts.stt)
    sig_x = stt * torch.abs(dx) + str_ * torch.abs(drot) + sxy * torch.abs(dy)
    sig_y = stt * torch.abs(dy) + str_ * torch.abs(drot) + sxy * torch.abs(dx)
    sig_r = srr * torch.abs(drot) + srt * torch.sqrt(dx * dx + dy * dy)
    x = dx + eps[:, 0] * sig_x
    y = dy + eps[:, 1] * sig_y
    yaw = drot + eps[:, 2] * sig_r
    two_pi = f32(2 * np.pi)
    yaw = torch.remainder(yaw, two_pi)
    yaw = torch.where(yaw > f32(np.pi), yaw - two_pi, yaw)
    return lie.se2_compose(poses, lie.se2(x, y, yaw, device=poses.device))


def apply_queue_plain(opts, eps, packets, poses):
    """Plain PyTorch version: K calls of :func:`draw_from_motion` in queue
    order."""
    for j in range(packets.shape[0]):
        poses = draw_from_motion(opts, eps[j], packets[j], poses)
    return poses


def apply_queue(opts, eps, packets, poses):
    """Every particle moved by every packet, one launch.

    ``opts`` carries the noise parameters ``srr``, ``srt``, ``str_`` and
    ``stt`` (``PFSlam2DOptions``); eps f32 [K, N, 3], packets f32 [K, 4]
    and poses f32 [N, 4] on one device. Returns fresh poses f32 [N, 4].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (contiguous operands of these dtypes and shapes) or raise.
    """
    if poses.device.type == "cpu":
        return apply_queue_plain(opts, eps, packets, poses)
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
    return out
