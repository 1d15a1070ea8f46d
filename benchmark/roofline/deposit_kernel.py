"""B1, ``csrc/deposit.cu:deposit_kernel``, as the map update calls it
(``deposit_pair``): a scan's hit and free-cell index streams deposited as
unit counts into two int32 grids ``[2, h, w]`` a particle.

Bytes: the two int32 indices of every cell the scan needs (its valid
hits and the cells their rays pass, ``hits`` and ``free`` a particle, as
the driver counts them for the traced scans) read once, both grids
written once. Operations: one count for each free cell, two for each hit
(the hit and the visit). The port's kernel table's convention (its "B1
pair" rows), except that the table counted the padded streams whole.
"""


def counts(call: dict) -> tuple:
    p, hits, free = call["particles"], call["hits"], call["free"]
    grids = 2 * call["h"] * call["w"] * 4
    return p * ((hits + free) * 8 + grids), p * (2 * hits + free)
