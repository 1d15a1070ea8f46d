"""B6, ``csrc/gn_solve.cu:gn_solve_kernel`` at scan stride 0: every
particle's whole Gauss-Newton IRLS scan match in one launch, each against
its own squared-distance window ``[h, w]`` staged in shared memory, with
the likelihood's residual sum.

Bytes: every window read once (staged whole: within 1.5x of the 32-byte
sectors its corners touch at the start and the solved poses, which PR
12's convention counts for windows read from global memory), the scan
read (two float32 coordinates and the mask byte a valid beam), a
particle's origin, start state and result (8 + 16 + 32 bytes). Operations: about 60 a beam and
evaluation, over the evaluations these inputs needed (``evals`` a call:
each particle's start, its steps and its likelihood). The port's kernel
table's convention (its "B6" rows).
"""


def counts(call: dict) -> tuple:
    p = call["particles"]
    windows = p * call["h"] * call["w"] * call["itemsize"]
    nbytes = windows + p * (8 + 16 + 32) + call["beams"] * 9
    return nbytes, 60 * call["beams"] * call["evals"]
