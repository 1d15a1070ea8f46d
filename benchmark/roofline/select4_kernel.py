"""B2, ``csrc/select4.cu:select4_kernel``: the four clipped corners of each
beam's cell in a squared-distance window.

Bytes: two int32 indices read and four int32 corners written a valid
beam, and the four corners' cells read (``itemsize`` bytes each).
Operations: eight a beam (four clips and four index computations). The
port's kernel table's convention (its "B2" row), over the valid beams.
"""


def counts(call: dict) -> tuple:
    b = call["beams"]
    return b * (8 + 4 * call["itemsize"] + 16), b * 8
