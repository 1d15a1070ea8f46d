"""B3, ``csrc/edt.cu:edt_tile``: the exact squared distance transform of a
bool obstacle grid, capped at radius ``R`` cells, ``[P, h, w]``.

Bytes: the obstacle mask read (one byte a cell) and the int32 result
written once. Operations: four a cell for each of the ``2R + 1`` offsets of
the two separable passes. The port's kernel table's convention (its "B3"
rows).
"""


def counts(call: dict) -> tuple:
    cells = call["particles"] * call["h"] * call["w"]
    return cells * (1 + 4), cells * 4 * (2 * call["radius"] + 1)
