"""Marching cubes with programmatically derived case tables.

reference: src/sdm/marching_cubes.cpp (classic 256-entry triangle table,
OpenChisel-derived). This build does NOT copy the table: it *derives* an
equivalent one at import time by running marching squares on each cube face
with an inside-on-the-left orientation rule, chaining the face segments into
closed loops per configuration, and fan-triangulating each loop. The result
is a [256, 16] edge-index table with the classic layout (-1 terminated),
equivalent to the canonical table up to triangulation of the polygons.

Corner numbering (matches the reference toMesh order,
truncated_signed_distance_map.cpp:221-224):
    0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
    4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
Edge numbering: 0:(0,1) 1:(1,2) 2:(2,3) 3:(3,0) 4:(4,5) 5:(5,6) 6:(6,7)
    7:(7,4) 8:(0,4) 9:(1,5) 10:(2,6) 11:(3,7).
A corner is "inside" when its SDF value < 0.
"""

from __future__ import annotations

import numpy as np

CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], np.int32)

EDGES = np.array([
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7],
], np.int32)

# Each face: corner loop in counter-clockwise order viewed from OUTSIDE.
_FACES = [
    [0, 3, 2, 1],   # z = 0 (viewed from -z)
    [4, 5, 6, 7],   # z = 1
    [0, 1, 5, 4],   # y = 0
    [2, 3, 7, 6],   # y = 1
    [0, 4, 7, 3],   # x = 0
    [1, 2, 6, 5],   # x = 1
]

_EDGE_OF = {}
for _e, (_a, _b) in enumerate(EDGES):
    _EDGE_OF[(_a, _b)] = _e
    _EDGE_OF[(_b, _a)] = _e


def _face_segments(config: int, face):
    """Directed isosurface segments on one face (marching squares).

    Returns [(edge_in, edge_out)] with inside kept on the LEFT when viewed
    from outside the cube — this orients loops consistently.
    """
    inside = [(config >> c) & 1 for c in face]
    segs = []
    # walk the face boundary; a segment starts on a boundary edge where we
    # leave the inside region and ends where we re-enter it.
    crossings = []
    for i in range(4):
        a, b = face[i], face[(i + 1) % 4]
        if inside[i] != inside[(i + 1) % 4]:
            crossings.append((i, _EDGE_OF[(a, b)],
                              inside[i]))  # leaving inside if inside[i]
    if not crossings:
        return segs
    # pair crossings: walking CCW (inside on left of travel... we need the
    # segment direction such that inside is left when seen from outside).
    # A crossing where we exit the inside region starts a segment.
    exits = [c for c in crossings if c[2] == 1]
    entries = [c for c in crossings if c[2] == 0]
    # order both lists by boundary position and match each exit with the
    # next entry CCW after it.
    exits.sort()
    entries.sort()
    for ex in exits:
        # first entry after this exit (cyclic)
        cand = [en for en in entries if en[0] > ex[0]] or entries
        en = cand[0]
        entries.remove(en)
        # direction chosen so that (viewed from outside, CCW boundary) the
        # inside region lies to the LEFT of edge_exit -> edge_entry
        segs.append((ex[1], en[1]))
    return segs


def _loops_for_config(config: int):
    """Closed, consistently oriented edge loops for a cube configuration."""
    nxt = {}
    for face in _FACES:
        for a, b in _face_segments(config, face):
            nxt.setdefault(a, []).append(b)
    loops = []
    seen = set()
    for start in list(nxt):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        cur = start
        while True:
            candidates = nxt.get(cur, [])
            candidates = [c for c in candidates if c == start or c not in seen]
            if not candidates:
                break
            cur = candidates[0]
            if cur == start:
                break
            loop.append(cur)
            seen.add(cur)
        if len(loop) >= 3:
            loops.append(loop)
    return loops


def _build_tri_table():
    table = np.full((256, 16), -1, np.int32)
    for config in range(256):
        tris = []
        for loop in _loops_for_config(config):
            for k in range(1, len(loop) - 1):
                tris += [loop[0], loop[k], loop[k + 1]]
        table[config, :len(tris)] = tris[:16]
    return table


TRI_TABLE = _build_tri_table()


def polygonize_cell(corner_pos, sdf, iso: float = 0.0):
    """Triangles for one cell. corner_pos f[8, 3], sdf f[8] -> [T, 3, 3].

    Vertexes are interpolated along cut edges like the reference
    (marching_cubes.cpp InterpolateEdge).
    """
    config = 0
    for i in range(8):
        if sdf[i] < iso:
            config |= 1 << i
    entry = TRI_TABLE[config]
    out = []
    k = 0
    while k + 2 < 16 and entry[k] >= 0:
        tri = []
        for j in range(3):
            e = entry[k + j]
            a, b = EDGES[e]
            va, vb = sdf[a], sdf[b]
            t = (iso - va) / (vb - va) if vb != va else 0.5
            tri.append(corner_pos[a] + t * (corner_pos[b] - corner_pos[a]))
        out.append(tri)
        k += 3
    return np.asarray(out, np.float64).reshape(-1, 3, 3)


def marching_cubes_dense(sdf_grid, mask_grid, origin, resolution,
                         iso: float = 0.0):
    """Mesh a dense SDF grid [Z, Y, X] (mask marks observed cells).

    Returns (vertices [V, 3], triangles [T, 3] int). Vectorized over cells.
    """
    sg = np.asarray(sdf_grid)
    mg = np.asarray(mask_grid, bool)
    nz, ny, nx = sg.shape
    if min(nz, ny, nx) < 2:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    # corner stacks for every cell
    def corner(c):
        dx, dy, dz = CORNERS[c]
        return sg[dz:nz - 1 + dz, dy:ny - 1 + dy, dx:nx - 1 + dx]

    def cmask(c):
        dx, dy, dz = CORNERS[c]
        return mg[dz:nz - 1 + dz, dy:ny - 1 + dy, dx:nx - 1 + dx]

    vals = np.stack([corner(c) for c in range(8)], -1)      # [Z-1,Y-1,X-1,8]
    ok = np.all(np.stack([cmask(c) for c in range(8)], -1), -1)
    config = ((vals < iso) << np.arange(8)).sum(-1)
    active = ok & (config > 0) & (config < 255)

    zz, yy, xx = np.nonzero(active)
    verts = []
    tris = []
    base = 0
    for z, y, x in zip(zz, yy, xx):
        pos = (np.array([x, y, z]) + CORNERS) * resolution + origin
        cell_tris = polygonize_cell(pos, vals[z, y, x], iso)
        for t in cell_tris:
            verts.extend(t)
            tris.append([base, base + 1, base + 2])
            base += 3
    if not verts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    return np.asarray(verts), np.asarray(tris, np.int64)
