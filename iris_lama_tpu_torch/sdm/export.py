"""Map export: occupancy and distance maps to 8-bit images and PNG files,
meshes to PLY.

reference: include/lama/sdm/export.h:44-47, src/sdm/export.cpp — occupancy
gray levels occupied 0, free 255, unknown 127 (export.cpp:45-77); distance
maps scaled to 0-255 (:80-99); meshes as ASCII PLY (:135-176).

Host-side, no image library: 8-bit grayscale PNG files are written and
read with ``zlib`` and ``struct``. The image arrays equal the JAX
package's.
"""

from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

from . import pool as pool_mod
from .geometry import PKEY_BITS, MapGeometry

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class PolygonMesh(NamedTuple):
    """Vertices + triangle indices (reference: types.h PolygonMesh)."""

    vertices: np.ndarray    # f64[V, 3]
    triangles: np.ndarray   # i64[T, 3]


def _dense_from_pool(table, arrays, geo: MapGeometry, defaults):
    """Pool arrays -> dense [H, W] numpy grids over the allocated patches'
    bounding box (row 0 is min-y), each array copied to the host once (its
    allocated slots). Returns (grids, origin cell (x, y))."""
    keys, mask = pool_mod.active_keys(table)
    slots = torch.nonzero(mask).reshape(-1)
    keys = keys[slots].cpu().numpy().astype(np.int64)
    blocks = [a[slots].cpu().numpy() for a in arrays]
    length = geo.patch_length
    if len(keys) == 0:
        return ([np.full((length, length), d, b.dtype)
                 for b, d in zip(blocks, defaults)], (0, 0))
    px = keys >> PKEY_BITS
    py = keys & ((1 << PKEY_BITS) - 1)
    ox, oy = px.min(), py.min()
    nx, ny = px.max() - ox + 1, py.max() - oy + 1
    grids = []
    for b, d in zip(blocks, defaults):
        grid = np.full((ny * length, nx * length), d, b.dtype)
        for blk, x, y in zip(b, px - ox, py - oy):
            grid[y * length:(y + 1) * length,
                 x * length:(x + 1) * length] = blk
        grids.append(grid)
    return grids, (int(ox) << geo.log2dim, int(oy) << geo.log2dim)


def occupancy_to_image(state, geo: MapGeometry) -> np.ndarray:
    """Fused or frequency map -> uint8 image (export.cpp:45-77: occupied 0,
    free 255, unknown 127). Row 0 is min-y (flip for display)."""
    (occ, vis), _ = _dense_from_pool(state.table,
                                     (state.occupied, state.visited), geo,
                                     (0, 0))
    occ = occ.astype(np.int64)
    vis = vis.astype(np.int64)
    img = np.full(occ.shape, 127, np.uint8)
    img[(vis > 0) & (4 * occ <= vis)] = 255
    img[4 * occ > vis] = 0
    return img


def simple_occupancy_to_image(state, geo: MapGeometry) -> np.ndarray:
    (cells,), _ = _dense_from_pool(state.table, (state.cells,), geo, (0,))
    img = np.full(cells.shape, 127, np.uint8)
    img[cells == -1] = 255
    img[cells == 1] = 0
    return img


def distance_to_image(state, geo: MapGeometry, max_dist: float) -> np.ndarray:
    """Distance field scaled to 0-255 (export.cpp:80-99)."""
    (dist,), _ = _dense_from_pool(state.table, (state.dist,), geo,
                                  (np.float32(max_dist),))
    return np.clip(dist / max_dist * 255.0, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def export_to_png(img: np.ndarray, path: str) -> None:
    """An 8-bit grayscale PNG of ``img`` [H, W], flipped so that +y is up
    (the reference writes with stb, src/image_io.cpp:45-68)."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8)[::-1])
    if img.ndim != 2:
        raise ValueError(f"export_to_png: a 2D uint8 image expected, got "
                         f"shape {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int) -> np.ndarray:
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth) of
    an 8-bit gray image."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (w + 1):
        raise ValueError("PNG: image data does not match its header")
    data = data.reshape(h, w + 1).astype(np.int32)
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.int32)
    for y in range(h):
        ftype, line = data[y, 0], data[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            cur = np.zeros(w, np.int32)
            a = c = 0
            for x in range(w):
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                a = cur[x] = (line[x] + pred) & 0xFF
                c = b
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur.astype(np.int32)
    return out


def read_image(path: str) -> np.ndarray:
    """An 8-bit grayscale, non-interlaced PNG as uint8 [H, W] (reference:
    image_io.h, src/image_io.cpp:45-56), rows as stored (the first row is
    the top of the image). Other PNG kinds raise ValueError."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype != 0 or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grayscale PNGs "
                         f"are read (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w)


def export_mesh_to_ply(vertices, triangles, path: str) -> None:
    """ASCII PLY (export.cpp:135-176)."""
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(triangles)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
