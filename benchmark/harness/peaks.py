"""The chip's peaks and the roofline bound of one kernel call.

NVIDIA H100 SXM, NVIDIA's data sheet (dense rates, at the 700 W limit):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores,
which the port's kernels (integer and float32 arithmetic) are held to,
integer operations alike. The convention is the port's kernel table's: a
call's bound is the larger of its bytes over the bandwidth and its
operations over the float32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_us(nbytes: float, nops: float) -> float:
    """The least µs a call of ``nbytes`` bytes and ``nops`` operations can
    take on the chip."""
    return max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e6
