"""Maps on disk in the port against the JAX package, on the CPU: the .smd
readers and writers (iris_lama_tpu_torch/sdm/io.py), export (sdm/
export.py), the codec (utils/codec.py) and checkpoints (utils/
checkpoint.py).

A small fused map is built once (tests/test_mapping.py's ring scan) and
carried to the JAX package as numpy, so both packages hold the same
state. From it both write byte-identical files,
each reads the other's files into equal states, and the golden fixtures of
tests/test_io.py hold for the port. The last case is tests/test_loc2d.py's
file workflow on the port: Slam2D -> .smd -> a fresh Loc2D.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos.loc2d import maps_from_slam as jmaps_from_slam
from iris_lama_tpu.sdm import export as jexport
from iris_lama_tpu.sdm import io as jio
from iris_lama_tpu.sdm import mapping as jmapping
from iris_lama_tpu.sdm import occupancy as jocc
from iris_lama_tpu.sdm import pool as jpool
from iris_lama_tpu.utils import checkpoint as jckpt
from iris_lama_tpu.utils import codec as jcodec

from iris_lama_tpu_torch.algos import loc2d as tloc
from iris_lama_tpu_torch.algos import slam2d as tslam
from iris_lama_tpu_torch.core import lie as tlie
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.sdm import export
from iris_lama_tpu_torch.sdm import io as sdm_io
from iris_lama_tpu_torch.sdm import mapping as tmapping
from iris_lama_tpu_torch.sdm import occupancy as occ
from iris_lama_tpu_torch.sdm import pool as pool_mod
from iris_lama_tpu_torch.sdm.geometry import CENTER_PATCH, MapGeometry
from iris_lama_tpu_torch.utils import checkpoint as ckpt
from iris_lama_tpu_torch.utils import codec
from iris_lama_tpu_torch.utils import simulator as tsim
from iris_lama_tpu_torch.utils import state as tstate

from test_mapping import make_cfg, simulate_scan

TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")
GEO = MapGeometry(resolution=0.1, log2dim=4)
CPU = dict(device="cpu")


def _to_jax(table, *arrays):
    return (jpool.PatchTable(*(jnp.asarray(t.numpy()) for t in table)),
            *(jnp.asarray(a.numpy()) for a in arrays))


@pytest.fixture(scope="module")
def small_map():
    """(JAX MappingConfig, JAX SlamMapState, the port's SlamMapState of the
    same values): tests/test_mapping.py's ring scan through the port's
    update_maps (bit-equal to the JAX package's, tests/test_torch_slam2d.py),
    carried to the JAX package as numpy."""
    cfg = make_cfg()
    tcfg = tmapping.MappingConfig(geometry=GEO, l2_max=0.5, max_range=4.0,
                                  capacity=512)
    pts = torch.as_tensor(simulate_scan(80))
    state, _ = tmapping.update_maps(
        tmapping.slam_map_init(tcfg, "cpu"), tcfg, tlie.se2(0.5, -0.25, 0.3),
        pts, torch.ones(len(pts), dtype=torch.bool), torch.zeros(3))
    table, occ_, vis, dist = _to_jax(state.table, state.occupied,
                                     state.visited, state.dist)
    jstate = jmapping.SlamMapState(table, occ_.astype(jnp.uint16),
                                   vis.astype(jnp.uint16), dist)
    return cfg, jstate, state


@pytest.fixture(scope="module")
def states(small_map):
    """Each standalone map kind as (port state, JAX state), equal: the
    fused map's counts as a frequency map, its simple and distance maps,
    and a probabilistic map from random counts over 3,600 cells."""
    cfg, jstate, tstate_ = small_map
    jm = jmaps_from_slam(jstate, cfg)
    tm = tloc.maps_from_slam(tstate_)
    jfreq = jocc.FrequencyOccupancyState(jstate.table, jstate.occupied,
                                         jstate.visited)
    tfreq = occ.FrequencyOccupancyState(tstate_.table, tstate_.occupied,
                                        tstate_.visited)
    cells = np.stack(np.meshgrid(np.arange(-30, 30), np.arange(-30, 30)),
                     -1).reshape(-1, 2).astype(np.float32) * 0.1
    rng = np.random.default_rng(3)
    hits = torch.as_tensor(rng.integers(0, 3, len(cells)))
    misses = torch.as_tensor(rng.integers(0, 3, len(cells)))
    tprob = occ.probabilistic_apply(
        occ.probabilistic_init(occ.OccupancyConfig(GEO, 512)), GEO,
        GEO.w2m(torch.as_tensor(cells)), hits, misses)
    jprob = jocc.ProbabilisticOccupancyState(*_to_jax(*tprob))
    return {"frequency": (tfreq, jfreq), "simple": (tm.occupancy,
                                                    jm.occupancy),
            "distance": (tm.distance, jm.distance),
            "probabilistic": (tprob, jprob)}


def _write(pkg, kind, state, geo, path, l2_max=0.5):
    if kind == "distance":
        pkg.write_distance_map(state, geo, l2_max, path)
    else:
        getattr(pkg, f"write_{kind}_occupancy")(state, geo, path)


def _read(pkg, kind, path, capacity=512):
    kw = CPU if pkg is sdm_io else {}
    if kind == "distance":
        return pkg.read_distance_map(path, capacity, **kw)
    return getattr(pkg, f"read_{kind}_occupancy")(path, capacity, **kw)


def _assert_states_equal(port, ref):
    for f in TABLE:
        np.testing.assert_array_equal(getattr(port.table, f).numpy(),
                                      np.asarray(getattr(ref.table, f)), f)
    for name, a in zip(port._fields[1:], port[1:]):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(ref, name)), name)


KINDS = ["frequency", "simple", "distance", "probabilistic"]


@pytest.mark.parametrize("kind", KINDS)
def test_files_byte_identical_and_cross_read(tmp_path, small_map, states,
                                             kind):
    """From the same state both packages write the same bytes; the port
    reads the JAX file into the state the JAX reader gives, and the JAX
    reader reads the port's file into the same; write -> read -> write
    gives the same bytes."""
    cfg = small_map[0]
    port, ref = states[kind]
    pp, jp = str(tmp_path / "port.smd"), str(tmp_path / "jax.smd")
    _write(sdm_io, kind, port, GEO, pp)
    _write(jio, kind, ref, cfg.geometry, jp)
    raw = open(pp, "rb").read()
    assert raw == open(jp, "rb").read()
    loaded, meta = _read(sdm_io, kind, jp)
    jloaded, _ = _read(jio, kind, pp)
    _assert_states_equal(loaded, jloaded)
    assert loaded.table.keys.device.type == "cpu"
    geo = meta.geometry if kind == "distance" else meta
    again = str(tmp_path / "again.smd")
    _write(sdm_io, kind, loaded, geo, again)
    assert open(again, "rb").read() == raw


def test_header_layout(tmp_path, small_map):
    cfg, _, state = small_map
    path = str(tmp_path / "m.smd")
    sdm_io.write_frequency_occupancy(state, GEO, path)
    raw = open(path, "rb").read()
    magic, version = struct.unpack_from("<IH", raw, 0)
    assert magic == 0x6D64732E and version == 0x0103
    cell_size, patch_length = struct.unpack_from("<II", raw, 8)
    assert cell_size == 4 and patch_length == GEO.patch_length
    (n,) = struct.unpack_from("<Q", raw, 16)
    assert n == int(state.table.num_patches())
    (res,) = struct.unpack_from("<f", raw, 24)
    assert abs(res - GEO.resolution) < 1e-7
    vol = GEO.patch_length ** 2
    assert len(raw) == 32 + n * (8 + vol * 4 + max(vol >> 6, 1) * 8)


def _slot_of(table, key):
    return int(pool_mod.table_lookup(
        table, torch.tensor([key], dtype=torch.int32))[0])


def test_frequency_and_distance_roundtrip(tmp_path, small_map):
    """tests/test_io.py's round trips on the port: every allocated patch's
    counts, distances and obstacles come back at its key."""
    _, _, state = small_map
    fp, dp = str(tmp_path / "freq.smd"), str(tmp_path / "dm.smd")
    sdm_io.write_frequency_occupancy(state, GEO, fp)
    sdm_io.write_distance_map(state, GEO, 0.5, dp)
    freq, geo = sdm_io.read_frequency_occupancy(fp, 512, **CPU)
    dm, dcfg = sdm_io.read_distance_map(dp, 512, **CPU)
    assert abs(geo.resolution - GEO.resolution) < 1e-6
    assert dcfg.max_sqdist == 25
    keys, mask = pool_mod.active_keys(state.table)
    for slot in torch.nonzero(mask).reshape(-1).tolist():
        key = int(keys[slot])
        s_f, s_d = _slot_of(freq.table, key), _slot_of(dm.table, key)
        assert s_f >= 0 and s_d >= 0
        assert torch.equal(freq.occupied[s_f], state.occupied[slot])
        assert torch.equal(freq.visited[s_f], state.visited[slot])
        np.testing.assert_allclose(dm.dist[s_d].numpy(),
                                   state.dist[slot].numpy(), atol=1e-5)
        assert torch.equal(dm.obstacle[s_d], state.dist[slot] == 0.0)


def test_simple_roundtrip(tmp_path, small_map):
    _, _, state = small_map
    maps = tloc.maps_from_slam(state)
    path = str(tmp_path / "simple.smd")
    sdm_io.write_simple_occupancy(maps.occupancy, GEO, path)
    loaded, geo = sdm_io.read_simple_occupancy(path, 512, **CPU)
    np.testing.assert_array_equal(
        export.simple_occupancy_to_image(maps.occupancy, GEO),
        export.simple_occupancy_to_image(loaded, geo))


def test_reader_runs_on_cuda_unless_asked(tmp_path, small_map, monkeypatch):
    """A reader's default device is CUDA: without it, it raises."""
    path = str(tmp_path / "f.smd")
    sdm_io.write_frequency_occupancy(small_map[2], GEO, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sdm_io.read_frequency_occupancy(path)


# ---------------------------------------------------------------------------
# Golden byte fixtures of tests/test_io.py: hand-built from the reference
# struct spec (map.h:95-103, map.cpp:490-575, container.cpp:141-170)
# ---------------------------------------------------------------------------

_UC = 2642244  # UNIVERSAL_CONSTANT (map.h:68)


def _golden_header(cell_size, patch_length, n, resolution, is_3d=False):
    return struct.pack("<IH2xIIQf?3x", 0x6D64732E, 0x0103, cell_size,
                       patch_length, n, resolution, is_3d)


def _golden_patch_id(px_rel, py_rel):
    return (px_rel + (_UC >> 1)) * _UC + (py_rel + (_UC >> 1))


def test_golden_smd_frequency_fixture(tmp_path):
    L, vol = 8, 64
    cells = np.zeros(vol, sdm_io.FREQ_DTYPE)
    cells[5 * L + 3] = (7, 9)
    bitmask = np.zeros(vol, bool)
    bitmask[5 * L + 3] = True
    packed = np.packbits(bitmask, bitorder="little").tobytes()
    fixture = (_golden_header(4, L, 1, 0.05)
               + struct.pack("<Q", _golden_patch_id(0, 0))
               + cells.tobytes() + packed)
    path = str(tmp_path / "golden_freq.smd")
    open(path, "wb").write(fixture)
    loaded, geo = sdm_io.read_frequency_occupancy(path, 64, **CPU)
    assert geo.patch_length == L and abs(geo.resolution - 0.05) < 1e-7
    # world (0.15, 0.25) lands in cell (3, 5) of the origin patch
    cell = geo.w2m(torch.tensor([[0.15, 0.25]]))
    slot = _slot_of(loaded.table, int(geo.m2p(cell)[0]))
    assert slot >= 0
    o, v = loaded.occupied[slot], loaded.visited[slot]
    assert o[5, 3] == 7 and v[5, 3] == 9
    assert int(o.sum()) == 7 and int(v.sum()) == 9
    out = str(tmp_path / "rewrite.smd")
    sdm_io.write_frequency_occupancy(loaded, geo, out)
    assert open(out, "rb").read() == fixture


def test_golden_smd_simple_fixture(tmp_path):
    L, vol = 8, 64
    cells = np.zeros(vol, np.int8)
    cells[2 * L + 1] = 1
    cells[4 * L + 6] = -1
    bitmask = np.packbits(cells != 0, bitorder="little").tobytes()
    fixture = (_golden_header(1, L, 1, 0.1)
               + struct.pack("<Q", _golden_patch_id(3, -2))
               + cells.tobytes() + bitmask)
    path = str(tmp_path / "golden_simple.smd")
    open(path, "wb").write(fixture)
    loaded, geo = sdm_io.read_simple_occupancy(path, 64, **CPU)
    key = ((3 + CENTER_PATCH) << 15) | (-2 + CENTER_PATCH)
    slot = _slot_of(loaded.table, key)
    got = loaded.cells[slot]
    assert got[2, 1] == 1 and got[4, 6] == -1
    assert int(torch.count_nonzero(got)) == 2
    out = str(tmp_path / "rewrite_simple.smd")
    sdm_io.write_simple_occupancy(loaded, geo, out)
    assert open(out, "rb").read() == fixture


def test_golden_smd_distance_fixture(tmp_path):
    L, vol = 8, 64
    res, l2_max, max_sqdist = 0.1, 0.3, 9
    cells = np.zeros(vol, sdm_io.DIST_DTYPE)
    yy, xx = np.mgrid[0:L, 0:L]
    sq = ((xx - 2) ** 2 + (yy - 2) ** 2).reshape(-1)
    valid = sq < max_sqdist
    cells["ox"] = np.where(valid, 2 - xx.reshape(-1), 0)
    cells["oy"] = np.where(valid, 2 - yy.reshape(-1), 0)
    cells["sqdist"] = np.where(valid, sq, 0)
    cells["valid"] = valid
    allbits = np.packbits(np.ones(vol, bool), bitorder="little").tobytes()
    fixture = (_golden_header(10, L, 1, res) + struct.pack("<I", max_sqdist)
               + struct.pack("<Q", _golden_patch_id(0, 0))
               + cells.tobytes() + allbits)
    path = str(tmp_path / "golden_dist.smd")
    open(path, "wb").write(fixture)
    loaded, dcfg = sdm_io.read_distance_map(path, 64, **CPU)
    assert dcfg.max_sqdist == max_sqdist
    slot = _slot_of(loaded.table, (CENTER_PATCH << 15) | CENTER_PATCH)
    obst = loaded.obstacle[slot]
    assert obst[2, 2] and int(obst.sum()) == 1
    exp = np.sqrt(np.minimum(sq.reshape(L, L), max_sqdist)) * res
    np.testing.assert_allclose(loaded.dist[slot].numpy(), exp, atol=1e-6)
    out = str(tmp_path / "rewrite_dist.smd")
    sdm_io.write_distance_map(loaded, dcfg.geometry, l2_max, out)
    assert open(out, "rb").read() == fixture


def test_write_distance_map_sparse_clusters(tmp_path):
    """Two obstacle clusters 80 m apart: the file holds only the allocated
    patches, and the per-patch halo EDT equals the global brute force."""
    from iris_lama_tpu_torch.sdm import distance as dist_mod
    geo = MapGeometry(0.1, 3, False)
    dcfg = dist_mod.DistanceConfig(geo, 0.3)
    state = dist_mod.distance_map_init(dcfg, 64, device="cpu")
    cells = geo.np_w2m(np.array([[0.25, 0.25], [0.35, 0.25],
                                 [80.05, 0.25]]))
    pkeys = torch.unique(geo.m2p(torch.as_tensor(cells)))
    table, slots = pool_mod.table_insert(state.table, pkeys)
    slot_of = dict(zip(pkeys.tolist(), slots.tolist()))
    obst = state.obstacle.clone()
    for c in cells:
        k = int(geo.m2p(torch.as_tensor(c[None]))[0])
        obst[slot_of[k], int(c[1]) & 7, int(c[0]) & 7] = True
    state = state._replace(table=table, obstacle=obst)
    path = str(tmp_path / "sparse.smd")
    sdm_io.write_distance_map(state, geo, 0.3, path)
    n = int(state.table.num_patches())
    assert len(open(path, "rb").read()) == 36 + n * (8 + 64 * 10 + 8)
    loaded, _ = sdm_io.read_distance_map(path, 64, **CPU)
    keys, mask = pool_mod.active_keys(loaded.table)
    for slot in torch.nonzero(mask).reshape(-1).tolist():
        anchor = geo.p2anchor(keys[slot:slot + 1])[0].numpy()
        ly, lx = np.mgrid[0:8, 0:8]
        c = np.stack([anchor[0] + lx, anchor[1] + ly], -1)[..., None, :]
        bf = np.sqrt(((cells - c) ** 2).sum(-1).min(-1))
        bf = np.minimum(bf, 3.0) * 0.1
        np.testing.assert_allclose(loaded.dist[slot].numpy(), bf, atol=1e-5)


def _write_bytes(tmp_path, name, data):
    p = str(tmp_path / name)
    open(p, "wb").write(data)
    return p


def test_smd_bad_files_raise(tmp_path, small_map):
    """Truncated streams, corrupt headers and a patch id outside the world
    raise ValueError; an empty map parses."""
    path = str(tmp_path / "full.smd")
    sdm_io.write_frequency_occupancy(small_map[2], GEO, path)
    raw = open(path, "rb").read()
    per_patch = 8 + 256 * 4 + 32
    bad = {f"cut{c}": raw[:c] for c in
           (0, 7, 31, 32, 33, 36, 32 + per_patch - 1, 32 + per_patch + 3,
            len(raw) - 1)}

    def hdr(**kw):
        d = dict(magic=0x6D64732E, version=0x0103, cell_size=4,
                 patch_length=8, n=0, resolution=0.05, is_3d=False)
        d.update(kw)
        return struct.pack("<IH2xIIQf?3x", *d.values())

    for name, kw in {"magic": dict(magic=0xDEADBEEF),
                     "version": dict(version=0x0999),
                     "cellsize": dict(cell_size=77),
                     "patchlen_zero": dict(patch_length=0),
                     "patchlen_nonpow2": dict(patch_length=12),
                     "patchlen_huge": dict(patch_length=1 << 20),
                     "res_zero": dict(resolution=0.0),
                     "res_nan": dict(resolution=float("nan")),
                     "res_inf": dict(resolution=float("inf")),
                     "n_overclaim": dict(n=10 ** 6),
                     "n_maxu64": dict(n=(1 << 64) - 1),
                     "is3d": dict(is_3d=True)}.items():
        bad[name] = hdr(**kw)
    bad["garbage_id"] = (hdr(n=1) + struct.pack("<Q", 1 << 63)
                         + bytes(64 * 4 + 8))
    for name, data in bad.items():
        with pytest.raises(ValueError):
            sdm_io.read_frequency_occupancy(
                _write_bytes(tmp_path, f"{name}.smd", data), **CPU)
    loaded, _ = sdm_io.read_frequency_occupancy(
        _write_bytes(tmp_path, "empty.smd", hdr()), **CPU)
    assert int(loaded.table.num_patches()) == 0


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def test_export_images_equal_jax(tmp_path, small_map, states):
    """The image arrays equal the JAX package's; the PNG decodes (with PIL
    and with the port's reader) to the flipped image; PLY text equal."""
    cfg, jstate, state = small_map
    img = export.occupancy_to_image(state, GEO)
    np.testing.assert_array_equal(
        img, jexport.occupancy_to_image(jstate, cfg.geometry))
    assert (img == 0).any() and (img == 255).any() and (img == 127).any()
    tsimple, jsimple = states["simple"]
    np.testing.assert_array_equal(
        export.simple_occupancy_to_image(tsimple, GEO),
        jexport.simple_occupancy_to_image(jsimple, cfg.geometry))
    dimg = export.distance_to_image(state, GEO, 0.5)
    np.testing.assert_array_equal(
        dimg, jexport.distance_to_image(jstate, cfg.geometry, 0.5))
    assert dimg.min() == 0 and dimg.max() == 255
    p = str(tmp_path / "map.png")
    export.export_to_png(img, p)
    np.testing.assert_array_equal(export.read_image(p), img[::-1])
    Image = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img[::-1])
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1.5, 0]], np.float64)
    tris = np.array([[0, 1, 2]], np.int64)
    tp, jp = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    export.export_mesh_to_ply(verts, tris, tp)
    jexport.export_mesh_to_ply(verts, tris, jp)
    assert open(tp).read() == open(jp).read()


@pytest.mark.parametrize("optimize", [False, True])
def test_read_image_decodes_pil_png(tmp_path, optimize):
    """The port's reader decodes PIL's grayscale PNGs (its scanline
    filters included) equal to PIL's own decoding; other kinds raise."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    arr[:, 20:] = np.cumsum(arr[:, 20:], axis=1, dtype=np.uint8)
    arr[10:20] = np.arange(53, dtype=np.uint8) * 3
    p = str(tmp_path / "pil.png")
    Image.fromarray(arr, "L").save(p, optimize=optimize)
    np.testing.assert_array_equal(export.read_image(p),
                                  np.asarray(Image.open(p)))
    Image.fromarray(np.stack([arr] * 3, -1), "RGB").save(p)
    with pytest.raises(ValueError, match="grayscale"):
        export.read_image(p)


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(33)
CODEC_CASES = [
    b"", b"a", b"hello world " * 100, bytes(range(256)) * 10,
    np.zeros(4096, np.uint8).tobytes(),
    _rng.integers(0, 256, 5000).astype(np.uint8).tobytes(),
    (np.arange(1024, dtype=np.uint16) % 7).tobytes(),
    b"abcdabcdabcdabcdXYZ",
]


def _zstd_available():
    try:
        codec.BufferCompressor("zstd")
        return True
    except RuntimeError:
        return False


@pytest.mark.parametrize("algorithm", ["lz4", "zstd"])
def test_codec_matches_jax(algorithm):
    """tests/test_codec.py's round trips on the port; for every case the
    port compresses to the JAX module's bytes, within the bound, and each
    package decompresses the other's output."""
    if algorithm == "zstd" and not _zstd_available():
        pytest.skip("no zstd backend on this host")
    bc, jbc = codec.BufferCompressor(algorithm), jcodec.BufferCompressor(
        algorithm)
    assert jbc.is_native
    for data in CODEC_CASES:
        comp = bc.compress(data)
        assert comp == jbc.compress(data), len(data)
        assert len(comp) <= bc.compress_bound(len(data))
        assert bc.decompress(comp, len(data)) == data
        assert jbc.decompress(comp, len(data)) == data
        assert bc.decompress(jbc.compress(data), len(data)) == data
    if algorithm == "lz4":
        # a sparse occupancy patch compresses well (tests/test_codec.py)
        patch = np.zeros((32, 32), np.uint16)
        patch[10:12, :] = 7
        assert len(bc.compress(patch.tobytes())) < patch.nbytes // 4


def test_codec_builds_into_build_dir():
    codec.BufferCompressor("lz4")
    assert any(codec.BUILD_DIR.glob("lama_codec-*.so"))


def test_codec_refuses_missing_zstd_and_unknown(monkeypatch):
    monkeypatch.setattr(codec, "_zstd", None)
    monkeypatch.setattr(codec, "_zstd_tried", True)
    with pytest.raises(RuntimeError, match="zstd"):
        codec.BufferCompressor("zstd")
    with pytest.raises(ValueError):
        codec.BufferCompressor("snappy")


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_cross_loads(tmp_path, small_map, compress):
    """A ``utils.state`` dict saved by either package loads in the other,
    equal; the port's SlamMapState round-trips and loads into the JAX
    package's, whose file loads back into the port's."""
    cfg, jstate, state = small_map
    d = tstate.map_to_numpy(state)
    d["pose"] = np.asarray([0.5, -0.25, 0.9553365, 0.29552022], np.float32)
    tp, jp = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    ckpt.save_state(tp, d, compress=compress)
    jckpt.save_state(jp, d, compress=compress)
    for back in (ckpt.load_state(jp, d), jckpt.load_state(tp, d)):
        assert back.keys() == d.keys()
        for k in d:
            np.testing.assert_array_equal(np.asarray(back[k]), d[k], k)
            assert np.asarray(back[k]).dtype == d[k].dtype, k
    sp = str(tmp_path / "state.ckpt")
    ckpt.save_state(sp, state, compress=compress)
    like = tstate.map_from_numpy(tstate.map_to_numpy(state), "cpu")
    like.dist.fill_(0.0)
    back = ckpt.load_state(sp, like)
    for a, b in zip(pool_mod.PatchTable(*back.table), state.table):
        assert torch.equal(a, b)
    for name in ("occupied", "visited", "dist"):
        assert torch.equal(getattr(back, name), getattr(state, name))
        assert getattr(back, name).dtype == getattr(state, name).dtype
    jback = jckpt.load_state(sp, jstate)
    np.testing.assert_array_equal(np.asarray(jback.visited),
                                  np.asarray(jstate.visited))
    np.testing.assert_array_equal(np.asarray(jback.table.keys),
                                  np.asarray(jstate.table.keys))
    jckpt.save_state(jp, jstate, compress=compress)
    back = ckpt.load_state(jp, state)
    assert torch.equal(back.occupied, state.occupied)
    assert torch.equal(back.dist, state.dist)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_state(jp, {"a": state.dist})


# ---------------------------------------------------------------------------
# The file workflow (tests/test_loc2d.py::test_full_file_workflow_slam_to_loc)
# ---------------------------------------------------------------------------

def test_full_file_workflow_slam_to_loc(tmp_path):
    """Slam2D builds maps on the port, writes reference-format .smd, a
    fresh Loc2D loads them and localises (mean error < 0.2 m, as in the
    JAX test); the loaded maps equal the in-memory ones on a dense probe."""
    data = tsim.simulate(tsim.SimConfig(
        n_steps=50, seed=4, laser=tsim.LaserSpec(n_beams=120,
                                                 max_range=8.0)))
    slam = tslam.Slam2D(tslam.Slam2DOptions(
        resolution=0.1, patch_size=16, max_range=8.0, trans_thresh=0.2,
        rot_thresh=0.2, capacity=4096), device="cpu")
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    for k in range(50):
        slam.update(data.clouds[k], data.odometry[k], data.timestamps[k])
    occ_path = str(tmp_path / "world_occ.smd")
    dm_path = str(tmp_path / "world_dm.smd")
    m = slam.map
    maps0 = tloc.maps_from_slam(m, slam.cfg)
    sdm_io.write_simple_occupancy(maps0.occupancy, slam.cfg.geometry,
                                  occ_path)
    sdm_io.write_distance_map(m, slam.cfg.geometry, slam.cfg.l2_max, dm_path)
    occ_loaded, geo = sdm_io.read_simple_occupancy(occ_path, 4096, **CPU)
    dm_loaded, dcfg = sdm_io.read_distance_map(dm_path, 4096, **CPU)

    xs = np.linspace(-12.0, 12.0, 241, dtype=np.float32)
    pts = torch.as_tensor(np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2))
    cells = slam.cfg.geometry.w2m(pts)
    for fn in (occ.simple_is_free, occ.simple_is_occupied,
               occ.simple_is_unknown):
        assert torch.equal(fn(occ_loaded, geo, cells),
                           fn(maps0.occupancy, slam.cfg.geometry, cells))
    from iris_lama_tpu_torch.sdm import distance as dist_mod
    d0 = dist_mod.cell_distance(m.table, m.dist, slam.cfg.geometry, cells,
                                slam.cfg.distance.max_dist)
    d1 = dist_mod.cell_distance(dm_loaded.table, dm_loaded.dist, geo, cells,
                                dcfg.max_dist)
    assert torch.equal(slam.cfg.dist_to_sq(d0), slam.cfg.dist_to_sq(d1))
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=0, atol=1e-6)

    loc = tloc.Loc2D(tloc.Loc2DOptions(
        resolution=0.1, patch_size=16, l2_max=float(dcfg.l2_max),
        max_range=8.0, trans_thresh=0.2, rot_thresh=0.2),
        maps=tloc.LocMaps(occ_loaded, dm_loaded), device="cpu")
    loc.set_prior(Pose2D(*data.poses_gt[0]))
    errs = []
    for k in range(50):
        if loc.update(data.clouds[k], data.odometry[k], data.timestamps[k]):
            errs.append(np.linalg.norm(loc.pose().xy() - data.poses_gt[k][:2]))
    assert len(errs) > 3
    assert np.mean(errs) < 0.2, errs
