"""Binary sparse-dense map IO: the reference's versioned ``.smd`` format, 2D.

reference: include/lama/sdm/map.h:95-103 (IOHeader), src/sdm/map.cpp:490-575
(write/read), src/sdm/container.cpp:139-175 (per-patch payload: raw cells +
allocation bitmask). A map written here parses with LaMa's ``Map::read``
and with the JAX package's readers, and vice versa; for the same state both
packages write the same bytes.

Layout (little-endian):

* header (32 B with C padding): u32 magic '.smd', u16 version 0x0103, pad2,
  u32 cell_size, u32 patch_length, u64 num_patches, f32 resolution,
  u8 is_3d, pad3;
* subclass parameters (``writeParameters``: the distance map writes u32
  max_sqdist, src/sdm/dynamic_distance_map.cpp:200-208; occupancy maps
  write nothing);
* per patch, in pool-slot order: u64 patch id (UNIVERSAL_CONSTANT
  coordinates) + raw cells (patch_length**2 * cell_size, y-major) +
  occupancy bitmask (max(volume/64, 1) u64 words).

Patch ids: the reference centres map coordinates at ``(UNIVERSAL_CONSTANT
/ 2) * patch_length`` (map.cpp:55-58), this build at ``CENTER_PATCH *
patch_length`` (sdm/geometry.py); ids are translated on write and read.

Cell structs (numpy dtypes of the reference layouts):

* SimpleOccupancyMap: int8;
* FrequencyOccupancyMap: {u16 occupied, u16 visited};
* ProbabilisticOccupancyMap: f32 log-odds (the mask: cells ever touched);
* DynamicDistanceMap: {3 x i16 obstacle offset, u16 sqdist, u8
  valid_obstacle, u8 is_queued} (10 B). This build keeps distances only:
  the writer reconstructs the offsets from the obstacle mask with an exact
  EDT (scipy) over a halo window per patch.

The files are written on the host: a writer copies each array it needs
from the device once (the allocated slots only). A reader parses on the
host, inserts the patch keys with :func:`pool.table_insert` and returns
tensors on the caller's device (CUDA unless ``device="cpu"``).

3D maps (``is_3d`` = 1) use the same wire format with patch volume L^3;
the patch id is ``(x*UC + y)*UC + z`` (map.cpp:578-585) and the cells run
x fastest (map.h:182-189), which is C-order ``[z][y][x]``: the 3D pool
arrays' layout. Their readers insert the file's keys with
:func:`pool.table_insert_ordered` (the sequential insert's table, in
vectorised rounds).
"""

from __future__ import annotations

import struct

import numpy as np
import torch
from scipy import ndimage

from . import distance as dist_mod
from . import occupancy as occ_mod
from . import pool as pool_mod
from .geometry import CENTER_PATCH, PKEY_BITS, MapGeometry

MAGIC = 0x6D64732E       # '.smd' (map.h:72)
IO_VERSION = 0x0103      # map.h:75
UNIVERSAL_CONSTANT = 2642244  # map.h:68

_HEADER = struct.Struct("<IH2xIIQf?3x")

FREQ_DTYPE = np.dtype([("occupied", "<u2"), ("visited", "<u2")])
DIST_DTYPE = np.dtype([("ox", "<i2"), ("oy", "<i2"), ("oz", "<i2"),
                       ("sqdist", "<u2"), ("valid", "u1"), ("queued", "u1")])

_KEY_MASK = (1 << PKEY_BITS) - 1


def _device(device):
    from ..algos.slam2d import resolve_device
    return resolve_device(device)


def _active_patches(table: pool_mod.PatchTable):
    """(keys int64 [n], slots tensor int64 [n] on the table's device): the
    allocated patches in slot order, read to the host once."""
    keys, mask = pool_mod.active_keys(table)
    slots = torch.nonzero(mask).reshape(-1)
    return keys[slots].cpu().numpy().astype(np.int64), slots


def _host(arr, slots) -> np.ndarray:
    """The allocated slots' cells of pool array ``arr``, on the host."""
    return arr[slots].cpu().numpy()


def _key_to_ref_id(key: int) -> int:
    rpx = (key >> PKEY_BITS) - CENTER_PATCH + (UNIVERSAL_CONSTANT >> 1)
    rpy = (key & _KEY_MASK) - CENTER_PATCH + (UNIVERSAL_CONSTANT >> 1)
    return rpx * UNIVERSAL_CONSTANT + rpy


def _ref_id_to_key(idx: int) -> int:
    rpx, rpy = divmod(idx, UNIVERSAL_CONSTANT)
    px = rpx - (UNIVERSAL_CONSTANT >> 1) + CENTER_PATCH
    py = rpy - (UNIVERSAL_CONSTANT >> 1) + CENTER_PATCH
    if not (0 <= px < (1 << PKEY_BITS) and 0 <= py < (1 << PKEY_BITS)):
        raise ValueError(f"patch id {idx} outside this build's world range")
    return (px << PKEY_BITS) | py


def _mask_bytes(bits, volume: int) -> bytes:
    """A patch's allocation bitmask: bool cells (y-major) packed
    little-endian into max(volume/64, 1) u64 words."""
    words = max(volume >> 6, 1)
    packed = np.packbits(np.asarray(bits, bool).reshape(-1),
                         bitorder="little")
    return np.pad(packed, (0, words * 8 - len(packed))).tobytes()


def _write_map(path: str, geo, cell_size: int, keys, cell_bytes, masks,
               params: bytes = b"", is_3d: bool = False) -> None:
    """Header, parameters, then per patch its id, ``cell_bytes[i]`` and the
    bitmask of ``masks[i]`` (``geo``: a MapGeometry, or a MapGeometry3
    with ``is_3d``)."""
    volume = geo.patch_length ** (3 if is_3d else 2)
    ref_id = _key3_to_ref_id if is_3d else _key_to_ref_id
    with open(path, "wb") as f:
        f.write(_HEADER.pack(MAGIC, IO_VERSION, cell_size, geo.patch_length,
                             len(keys), geo.resolution, is_3d))
        f.write(params)
        for i, key in enumerate(keys):
            f.write(struct.pack("<Q", ref_id(int(key))))
            f.write(cell_bytes[i])
            f.write(_mask_bytes(masks[i], volume))


def _read_exact(f, n: int) -> bytes:
    """Read exactly n bytes or raise (truncated-file guard)."""
    buf = f.read(n)
    if len(buf) != n:
        raise ValueError(
            f"truncated .smd: wanted {n} bytes, got {len(buf)}")
    return buf


def _parse_header(f, expect_cell_size: int, expect_3d: bool,
                  params_size: int = 0):
    """Parse and validate the IOHeader (map.h:95-103): (patch_length, n,
    resolution). Truncated, corrupt or absurd headers, and a file of the
    other dimensionality, raise ValueError."""
    magic, version, cell_size, patch_length, n, resolution, is_3d = \
        _HEADER.unpack(_read_exact(f, _HEADER.size))
    if magic != MAGIC or version != IO_VERSION:
        raise ValueError("not a .smd map or unsupported version")
    if cell_size != expect_cell_size:
        raise ValueError(
            f"cell size mismatch: {cell_size} != {expect_cell_size}")
    if bool(is_3d) != expect_3d:
        raise ValueError(f"dimensionality mismatch: file is_3d={bool(is_3d)}")
    if not (1 <= patch_length <= 256) or (patch_length & (patch_length - 1)):
        raise ValueError(f"invalid patch_length {patch_length} "
                         "(power of two in [1, 256] expected)")
    if not np.isfinite(resolution) or resolution <= 0.0:
        raise ValueError(f"invalid resolution {resolution}")
    # patch-count sanity: the payload must fit in the file
    volume = patch_length ** (3 if expect_3d else 2)
    per_patch = 8 + volume * cell_size + max(volume >> 6, 1) * 8
    pos = f.tell()
    f.seek(0, 2)
    remaining = f.tell() - pos - params_size
    f.seek(pos)
    if n * per_patch > remaining:
        raise ValueError(
            f"corrupt .smd: header claims {n} patches "
            f"({n * per_patch} B) but only {max(remaining, 0)} B remain")
    return patch_length, n, resolution


def _read_header(f, expect_cell_size: int, params_size: int = 0):
    """The header of a 2D map: (MapGeometry, patch count)."""
    patch_length, n, resolution = _parse_header(f, expect_cell_size, False,
                                                params_size)
    geo = MapGeometry(resolution, int(np.log2(patch_length)), False)
    return geo, n


def _read_patches(f, length: int, n: int, cell_dtype, is_3d: bool = False):
    """(keys int32 [n], cells [n, L, L(, L)] of ``cell_dtype``, masks bool
    of the same shape) of the n patch records."""
    dims = 3 if is_3d else 2
    volume = length ** dims
    words = max(volume >> 6, 1)
    to_key = _ref_id_to_key3 if is_3d else _ref_id_to_key
    keys, cells, masks = [], [], []
    for _ in range(n):
        (idx,) = struct.unpack("<Q", _read_exact(f, 8))
        keys.append(to_key(idx))
        cells.append(np.frombuffer(
            _read_exact(f, volume * cell_dtype.itemsize), cell_dtype))
        bits = np.unpackbits(np.frombuffer(_read_exact(f, words * 8),
                                           np.uint8), bitorder="little")
        masks.append(bits[:volume].astype(bool))
    shape = (n,) + (length,) * dims
    return (np.asarray(keys, np.int32),
            np.asarray(cells, cell_dtype).reshape(shape),
            np.asarray(masks, bool).reshape(shape))


def _insert(table, keys: np.ndarray) -> np.ndarray:
    """Insert the file's patch keys in file order; returns (table, slots
    on the host). A full pool gives slot -1: numpy then writes the trash
    slot, as the JAX package's reader does."""
    if not len(keys):
        return table, np.zeros(0, np.int64)
    dev = table.keys.device
    table, slots = pool_mod.table_insert(table, torch.as_tensor(keys,
                                                                device=dev))
    return table, slots.cpu().numpy().astype(np.int64)


def _pool_array(shape, fill, dtype, slots, blocks) -> np.ndarray:
    arr = np.full(shape, fill, dtype)
    for s, b in zip(slots, blocks):
        arr[s] = b
    return arr


# ---------------------------------------------------------------------------
# SimpleOccupancyMap
# ---------------------------------------------------------------------------

def write_simple_occupancy(state: occ_mod.SimpleOccupancyState,
                           geo: MapGeometry, path: str) -> None:
    keys, slots = _active_patches(state.table)
    cells = _host(state.cells, slots).astype(np.int8)
    _write_map(path, geo, 1, keys, [c.tobytes() for c in cells], cells != 0)


def read_simple_occupancy(path: str, capacity: int = 4096, device=None):
    """(SimpleOccupancyState on ``device``, MapGeometry)."""
    dev = _device(device)
    with open(path, "rb") as f:
        geo, n = _read_header(f, 1)
        keys, blocks, _ = _read_patches(f, geo.patch_length, n, np.dtype(np.int8))
    state = occ_mod.simple_init(occ_mod.OccupancyConfig(geo, capacity), dev)
    table, slots = _insert(state.table, keys)
    cells = _pool_array(state.cells.shape, 0, np.int8, slots, blocks)
    return occ_mod.SimpleOccupancyState(
        table, torch.as_tensor(cells, device=dev)), geo


# ---------------------------------------------------------------------------
# FrequencyOccupancyMap
# ---------------------------------------------------------------------------

def write_frequency_occupancy(state, geo: MapGeometry, path: str) -> None:
    """Accepts a FrequencyOccupancyState or the fused SlamMapState (its
    counts)."""
    keys, slots = _active_patches(state.table)
    rec = np.zeros(_host(state.visited, slots).shape, FREQ_DTYPE)
    rec["occupied"] = _host(state.occupied, slots)
    rec["visited"] = _host(state.visited, slots)
    _write_map(path, geo, FREQ_DTYPE.itemsize, keys,
               [r.tobytes() for r in rec], rec["visited"] > 0)


def read_frequency_occupancy(path: str, capacity: int = 4096, device=None):
    """(FrequencyOccupancyState on ``device``, MapGeometry)."""
    dev = _device(device)
    with open(path, "rb") as f:
        geo, n = _read_header(f, FREQ_DTYPE.itemsize)
        keys, rec, _ = _read_patches(f, geo.patch_length, n, FREQ_DTYPE)
    state = occ_mod.frequency_init(occ_mod.OccupancyConfig(geo, capacity),
                                   dev)
    table, slots = _insert(state.table, keys)
    shape = state.occupied.shape
    occ = _pool_array(shape, 0, np.int32, slots, rec["occupied"])
    vis = _pool_array(shape, 0, np.int32, slots, rec["visited"])
    return occ_mod.FrequencyOccupancyState(
        table, torch.as_tensor(occ, device=dev),
        torch.as_tensor(vis, device=dev)), geo


# ---------------------------------------------------------------------------
# DynamicDistanceMap
# ---------------------------------------------------------------------------

def _obstacle(state):
    """A distance map's obstacle mask; the fused SlamMapState derives it
    (an obstacle iff its stored distance is exactly 0)."""
    obst = getattr(state, "obstacle", None)
    return state.dist == 0.0 if obst is None else obst


def _distance_records(obstacle: np.ndarray, keys: np.ndarray,
                      geo: MapGeometry, max_sqdist: int) -> np.ndarray:
    """Cell records of every patch: the nearest-obstacle offsets from an
    exact EDT over the patch and ``halo_p`` neighbour patches per side
    (a cell is ``valid`` only when an obstacle lies within the cap radius
    R = ceil(sqrt(max_sqdist)), dynamic_distance_map.h:47-52, so the
    window sees every obstacle that matters). Memory is O(patches), not
    O(bounding-box area)."""
    length = geo.patch_length
    radius = int(np.ceil(np.sqrt(float(max_sqdist))))
    halo_p = (radius + length - 1) // length
    side = 1 + 2 * halo_p
    index_of = {(int(k) >> PKEY_BITS, int(k) & _KEY_MASK): i
                for i, k in enumerate(keys)}
    yy, xx = np.mgrid[0:length, 0:length]
    c0 = halo_p * length
    centre = np.s_[c0:c0 + length, c0:c0 + length]
    out = np.zeros((len(keys), length * length), DIST_DTYPE)
    for i, key in enumerate(keys):
        px, py = int(key) >> PKEY_BITS, int(key) & _KEY_MASK
        win = np.zeros((side * length, side * length), bool)   # [y, x]
        for dy in range(-halo_p, halo_p + 1):
            for dx in range(-halo_p, halo_p + 1):
                j = index_of.get((px + dx, py + dy))
                if j is not None:
                    y0 = (dy + halo_p) * length
                    x0 = (dx + halo_p) * length
                    win[y0:y0 + length, x0:x0 + length] = obstacle[j]
        if not win.any():
            continue
        ind = ndimage.distance_transform_edt(~win, return_indices=True)[1]
        iy, ix = ind[0][centre], ind[1][centre]
        off_y = iy - (yy + c0)
        off_x = ix - (xx + c0)
        sq = off_x * off_x + off_y * off_y
        # the index is only a real obstacle when one exists in-window
        valid = ((sq < max_sqdist) & win[iy, ix]).reshape(-1)
        rec = out[i]
        rec["ox"] = np.where(valid, off_x.reshape(-1), 0)
        rec["oy"] = np.where(valid, off_y.reshape(-1), 0)
        rec["sqdist"] = np.where(valid, sq.reshape(-1), 0)
        rec["valid"] = valid
    return out


def write_distance_map(state, geo: MapGeometry, l2_max: float,
                       path: str) -> None:
    """Accepts a DistanceMapState or the fused SlamMapState."""
    max_sqdist = dist_mod.DistanceConfig(geo, l2_max).max_sqdist
    keys, slots = _active_patches(state.table)
    obstacle = _host(_obstacle(state), slots).astype(bool)
    rec = _distance_records(obstacle, keys, geo, max_sqdist)
    ones = np.ones((len(keys), geo.patch_length ** 2), bool)
    _write_map(path, geo, DIST_DTYPE.itemsize, keys,
               [r.tobytes() for r in rec], ones,
               params=struct.pack("<I", max_sqdist))


def read_distance_map(path: str, capacity: int = 4096, device=None):
    """(DistanceMapState on ``device``, DistanceConfig)."""
    dev = _device(device)
    with open(path, "rb") as f:
        geo, n = _read_header(f, DIST_DTYPE.itemsize, params_size=4)
        (max_sqdist,) = struct.unpack("<I", _read_exact(f, 4))
        keys, rec, _ = _read_patches(f, geo.patch_length, n, DIST_DTYPE)
    l2_max = np.sqrt(max_sqdist) * geo.resolution
    dcfg = dist_mod.DistanceConfig(geo, float(l2_max))
    state = dist_mod.distance_map_init(dcfg, capacity, dev)
    table, slots = _insert(state.table, keys)
    valid = rec["valid"] > 0
    sq = np.where(valid, rec["sqdist"], max_sqdist).astype(np.float64)
    dist_b = np.sqrt(np.minimum(sq, max_sqdist)) * geo.resolution
    shape = state.dist.shape
    dist = _pool_array(shape, dcfg.max_dist, np.float32, slots, dist_b)
    obst = _pool_array(shape, False, bool, slots,
                       valid & (rec["sqdist"] == 0))
    return dist_mod.DistanceMapState(
        table, torch.as_tensor(obst, device=dev),
        torch.as_tensor(dist, device=dev)), dcfg


# ---------------------------------------------------------------------------
# ProbabilisticOccupancyMap (cell = {float prob} storing log-odds,
# probabilistic_occupancy_map.h:43-45; writeParameters writes nothing)
# ---------------------------------------------------------------------------

def write_probabilistic_occupancy(state: occ_mod.ProbabilisticOccupancyState,
                                  geo: MapGeometry, path: str) -> None:
    keys, slots = _active_patches(state.table)
    lo = _host(state.logodds, slots).astype("<f4")
    _write_map(path, geo, 4, keys, [c.tobytes() for c in lo],
               _host(state.touched, slots))


def read_probabilistic_occupancy(path: str, capacity: int = 4096,
                                 device=None):
    """(ProbabilisticOccupancyState on ``device``, MapGeometry)."""
    dev = _device(device)
    with open(path, "rb") as f:
        geo, n = _read_header(f, 4)
        keys, lo_b, masks = _read_patches(f, geo.patch_length, n, np.dtype("<f4"))
    state = occ_mod.probabilistic_init(
        occ_mod.OccupancyConfig(geo, capacity), dev)
    table, slots = _insert(state.table, keys)
    shape = state.logodds.shape
    lo = _pool_array(shape, 0.0, np.float32, slots, lo_b)
    touched = _pool_array(shape, False, bool, slots, masks)
    return occ_mod.ProbabilisticOccupancyState(
        table, torch.as_tensor(lo, device=dev),
        torch.as_tensor(touched, device=dev)), geo


# ---------------------------------------------------------------------------
# 3D maps (is_3d = 1)
# ---------------------------------------------------------------------------

def _key3_to_ref_id(key: int) -> int:
    from .occupancy3d import CENTER_PATCH3, PKEY3_BITS
    m = (1 << PKEY3_BITS) - 1
    px, py, pz = key >> (2 * PKEY3_BITS), (key >> PKEY3_BITS) & m, key & m
    half = UNIVERSAL_CONSTANT >> 1
    rx = px - CENTER_PATCH3 + half
    ry = py - CENTER_PATCH3 + half
    rz = pz - CENTER_PATCH3 + half
    return (rx * UNIVERSAL_CONSTANT + ry) * UNIVERSAL_CONSTANT + rz


def _ref_id_to_key3(idx: int) -> int:
    from .occupancy3d import CENTER_PATCH3, PKEY3_BITS
    half = UNIVERSAL_CONSTANT >> 1
    rx, rem = divmod(idx, UNIVERSAL_CONSTANT * UNIVERSAL_CONSTANT)
    ry, rz = divmod(rem, UNIVERSAL_CONSTANT)
    px = rx - half + CENTER_PATCH3
    py = ry - half + CENTER_PATCH3
    pz = rz - half + CENTER_PATCH3
    lim = 1 << PKEY3_BITS
    if not (0 <= px < lim and 0 <= py < lim and 0 <= pz < lim):
        raise ValueError(f"3D patch id {idx} outside this build's range")
    return (px << (2 * PKEY3_BITS)) | (py << PKEY3_BITS) | pz


def _read_smd3(path: str, cell_dtype):
    """(MapGeometry3, keys, cells, masks) of a 3D map file."""
    from .occupancy3d import MapGeometry3
    with open(path, "rb") as f:
        length, n, resolution = _parse_header(f, cell_dtype.itemsize, True)
        keys, cells, masks = _read_patches(f, length, n, cell_dtype, True)
    return MapGeometry3(resolution, int(np.log2(length))), keys, cells, masks


def _insert3(table, keys: np.ndarray):
    """:func:`_insert` for a 3D file: the sequential insert's table, from
    :func:`pool.table_insert_ordered` when the file's keys are unique."""
    if not len(keys) or len(np.unique(keys)) < len(keys):
        return _insert(table, keys)
    table, slots = pool_mod.table_insert_ordered(
        table, torch.as_tensor(keys, device=table.keys.device))
    return table, slots.cpu().numpy().astype(np.int64)


def write_simple3(state, geo3, path: str) -> None:
    keys, slots = _active_patches(state.table)
    cells = _host(state.cells, slots).astype(np.int8)
    _write_map(path, geo3, 1, keys, [c.tobytes() for c in cells], cells != 0,
               is_3d=True)


def read_simple3(path: str, capacity: int = 4096, device=None):
    """(Simple3State on ``device``, MapGeometry3)."""
    from . import occupancy3d as o3
    dev = _device(device)
    geo3, keys, blocks, _ = _read_smd3(path, np.dtype(np.int8))
    state = o3.simple3_init(geo3, capacity, dev)
    table, slots = _insert3(state.table, keys)
    cells = _pool_array(state.cells.shape, 0, np.int8, slots, blocks)
    return o3.Simple3State(table, torch.as_tensor(cells, device=dev)), geo3


def write_frequency3(state, geo3, path: str) -> None:
    keys, slots = _active_patches(state.table)
    vis = _host(state.visited, slots)
    rec = np.zeros(vis.shape, FREQ_DTYPE)
    rec["occupied"] = _host(state.occupied, slots)
    rec["visited"] = vis
    _write_map(path, geo3, FREQ_DTYPE.itemsize, keys,
               [r.tobytes() for r in rec], vis > 0, is_3d=True)


def read_frequency3(path: str, capacity: int = 4096, device=None):
    """(Frequency3State on ``device``, MapGeometry3)."""
    from . import occupancy3d as o3
    dev = _device(device)
    geo3, keys, rec, _ = _read_smd3(path, FREQ_DTYPE)
    state = o3.frequency3_init(geo3, capacity, dev)
    table, slots = _insert3(state.table, keys)
    shape = state.occupied.shape
    occ = _pool_array(shape, 0, np.int32, slots, rec["occupied"])
    vis = _pool_array(shape, 0, np.int32, slots, rec["visited"])
    return o3.Frequency3State(table, torch.as_tensor(occ, device=dev),
                              torch.as_tensor(vis, device=dev)), geo3


def write_probabilistic3(state, geo3, path: str) -> None:
    keys, slots = _active_patches(state.table)
    lo = _host(state.logodds, slots).astype("<f4")
    _write_map(path, geo3, 4, keys, [c.tobytes() for c in lo],
               _host(state.touched, slots), is_3d=True)


def read_probabilistic3(path: str, capacity: int = 4096, device=None):
    """(Probabilistic3State on ``device``, MapGeometry3)."""
    from . import occupancy3d as o3
    dev = _device(device)
    geo3, keys, lo_b, masks = _read_smd3(path, np.dtype("<f4"))
    state = o3.probabilistic3_init(geo3, capacity, dev)
    table, slots = _insert3(state.table, keys)
    shape = state.logodds.shape
    lo = _pool_array(shape, 0.0, np.float32, slots, lo_b)
    touched = _pool_array(shape, False, bool, slots, masks)
    return o3.Probabilistic3State(
        table, torch.as_tensor(lo, device=dev),
        torch.as_tensor(touched, device=dev)), geo3
