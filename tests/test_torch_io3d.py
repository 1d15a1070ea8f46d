"""The port's 3D ``.smd`` files (iris_lama_tpu_torch/sdm/io.py, the 3D
half) against the JAX package's, on the CPU.

The three 3D cases of tests/test_io.py (the frequency round trip, the
simple and probabilistic round trips, the hand-built golden fixture) run
on the port. Each state is built by both packages from the same calls;
the port's files equal the JAX package's byte for byte, and each package
reads the other's files back to equal states.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.sdm import io as jio
from iris_lama_tpu.sdm import occupancy3d as jo3

from iris_lama_tpu_torch.sdm import io as sdm_io
from iris_lama_tpu_torch.sdm import occupancy3d as o3
from iris_lama_tpu_torch.sdm import pool as pool_mod

_UC = 2642244
TABLE = ("keys", "slots", "free_slots", "n_free", "overflow")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.as_tensor(np.array(a))


def assert_same(port, ref):
    for f in TABLE:
        np.testing.assert_array_equal(getattr(port.table, f).numpy(),
                                      np.asarray(getattr(ref.table, f)), f)
    for name, a in zip(port._fields[1:], port[1:]):
        np.testing.assert_array_equal(
            a.numpy(), np.asarray(getattr(ref, name)).astype(
                a.numpy().dtype), name)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _build_3d_freq():
    geo3, jgeo3 = o3.MapGeometry3(0.1, 2), jo3.MapGeometry3(0.1, 2)
    pts = np.array([[0.1, 0.2, 0.3], [1.1, -0.4, 0.6], [0.1, 0.2, 0.35]],
                   np.float32)
    state = o3.frequency3_insert_scan(
        o3.frequency3_init(geo3, 256, "cpu"), geo3, t(pts),
        torch.ones(3, dtype=torch.bool), torch.zeros(3), max_steps=16)
    jstate = jo3.frequency3_insert_scan(
        jo3.frequency3_init(jgeo3, 256), jgeo3, jnp.asarray(pts),
        jnp.ones(3, bool), jnp.zeros(3, jnp.float32), max_steps=16)
    assert_same(state, jstate)
    return geo3, jgeo3, state, jstate


def _check_loaded(loaded, state):
    """Every allocated patch of ``state`` found in ``loaded`` with equal
    cells (the JAX test's check)."""
    keys = pool_mod.active_keys(state.table)[0].numpy()
    mask = pool_mod.active_slot_mask(state.table).numpy()
    for slot in np.nonzero(mask)[0]:
        s2 = int(pool_mod.table_lookup(loaded.table,
                                       t([int(keys[slot])]).int())[0])
        assert s2 >= 0
        for a, b in zip(loaded[1:], state[1:]):
            np.testing.assert_array_equal(a[s2].numpy(), b[slot].numpy())


def test_smd3_frequency_roundtrip(tmp_path):
    geo3, jgeo3, state, jstate = _build_3d_freq()
    path, jpath = str(tmp_path / "freq3.smd"), str(tmp_path / "jfreq3.smd")
    sdm_io.write_frequency3(state, geo3, path)
    jio.write_frequency3(jstate, jgeo3, jpath)
    assert _read(path) == _read(jpath)
    # header says is_3d; the 2D reader refuses it
    with pytest.raises(ValueError):
        sdm_io.read_frequency_occupancy(path, device="cpu")
    loaded, geo2 = sdm_io.read_frequency3(path, capacity=64, device="cpu")
    assert geo2.patch_length == geo3.patch_length
    assert geo2.resolution == np.float32(geo3.resolution)
    _check_loaded(loaded, state)
    jloaded, _ = jio.read_frequency3(path, capacity=64)
    assert_same(loaded, jloaded)
    # a 3D reader refuses a 2D file
    from iris_lama_tpu_torch.sdm import occupancy as occ
    from iris_lama_tpu_torch.sdm.geometry import MapGeometry
    st2 = occ.frequency_init(occ.OccupancyConfig(MapGeometry(0.1, 2), 8),
                             "cpu")
    p2 = str(tmp_path / "freq2.smd")
    sdm_io.write_frequency_occupancy(st2, MapGeometry(0.1, 2), p2)
    with pytest.raises(ValueError):
        sdm_io.read_frequency3(p2, device="cpu")


def test_smd3_simple_and_probabilistic_roundtrip(tmp_path):
    geo3, jgeo3 = o3.MapGeometry3(0.05, 2), jo3.MapGeometry3(0.05, 2)
    pts = np.array([[0.1, 0.1, 0.1], [-0.5, 0.3, 0.2]], np.float32)
    cells, jcells = geo3.w2m(t(pts)), jgeo3.w2m(jnp.asarray(pts))
    s = o3.simple3_set(o3.simple3_init(geo3, 64, "cpu"), geo3, cells, 1)
    js = jo3.simple3_set(jo3.simple3_init(jgeo3, 64), jgeo3, jcells, 1)
    p1, j1 = str(tmp_path / "simple3.smd"), str(tmp_path / "jsimple3.smd")
    sdm_io.write_simple3(s, geo3, p1)
    jio.write_simple3(js, jgeo3, j1)
    assert _read(p1) == _read(j1)
    l1, g1 = sdm_io.read_simple3(j1, capacity=64, device="cpu")
    assert g1.log2dim == geo3.log2dim
    _check_loaded(l1, s)
    assert_same(l1, jio.read_simple3(p1, capacity=64)[0])

    p = o3.probabilistic3_apply(o3.probabilistic3_init(geo3, 64, "cpu"),
                                geo3, cells, t([2, 0]), t([1, 4]))
    jp = jo3.probabilistic3_apply(jo3.probabilistic3_init(jgeo3, 64), jgeo3,
                                  jcells, jnp.asarray([2, 0]),
                                  jnp.asarray([1, 4]))
    p2, j2 = str(tmp_path / "prob3.smd"), str(tmp_path / "jprob3.smd")
    sdm_io.write_probabilistic3(p, geo3, p2)
    jio.write_probabilistic3(jp, jgeo3, j2)
    # log-odds are held within 4e-6 (XLA may fuse lo + h*HIT): compare
    # the files record by record
    a, b = _read(p2), _read(j2)
    assert len(a) == len(b) and a[:32] == b[:32]
    l2, _ = sdm_io.read_probabilistic3(p2, capacity=64, device="cpu")
    _check_loaded(l2, p)
    jl2, _ = jio.read_probabilistic3(j2, capacity=64)
    for f in TABLE:
        np.testing.assert_array_equal(getattr(l2.table, f).numpy(),
                                      np.asarray(getattr(jl2.table, f)))
    np.testing.assert_allclose(l2.logodds.numpy(), np.asarray(jl2.logodds),
                               atol=4e-6, rtol=0)
    np.testing.assert_array_equal(l2.touched.numpy(),
                                  np.asarray(jl2.touched))
    # the port's reader on the JAX file: the JAX state, bit for bit
    l3, _ = sdm_io.read_probabilistic3(j2, capacity=64, device="cpu")
    assert_same(l3, jio.read_probabilistic3(j2, capacity=64)[0])


def _golden_header(cell_size, patch_length, n, resolution, is_3d=False):
    return struct.pack("<IH2xIIQf?3x", 0x6D64732E, 0x0103, cell_size,
                       patch_length, n, resolution, is_3d)


def _golden_patch_id3(px_rel, py_rel, pz_rel):
    h = _UC >> 1
    return (((px_rel + h) * _UC) + (py_rel + h)) * _UC + (pz_rel + h)


def test_golden_smd3_fixture(tmp_path):
    """Hand-built 3D stream (reference conventions): a 4^3 patch, one
    simple-occupancy cell at local (x=1, y=2, z=3), patch offset (1, -2,
    0); the cell's linear index is x | y<<log2dim | z<<2log2dim
    (map.h:182-189)."""
    length = 4
    vol = length ** 3
    cells = np.zeros(vol, np.int8)
    lin = 1 | (2 << 2) | (3 << 4)
    cells[lin] = 1
    bits = np.zeros(vol, bool)
    bits[lin] = True
    fixture = (_golden_header(1, length, 1, 0.1, is_3d=True)
               + struct.pack("<Q", _golden_patch_id3(1, -2, 0))
               + cells.tobytes()
               + np.packbits(bits, bitorder="little").tobytes())
    p = str(tmp_path / "golden3.smd")
    with open(p, "wb") as f:
        f.write(fixture)
    loaded, geo3 = sdm_io.read_simple3(p, capacity=64, device="cpu")
    c = o3.CENTER_PATCH3
    key = (((1 + c) << (2 * o3.PKEY3_BITS)) | ((-2 + c) << o3.PKEY3_BITS)
           | c)
    slot = int(pool_mod.table_lookup(loaded.table, t([key]).int())[0])
    assert slot >= 0
    got = loaded.cells[slot].numpy()
    assert got[3, 2, 1] == 1 and np.count_nonzero(got) == 1
    assert_same(loaded, jio.read_simple3(p, capacity=64)[0])
    out = str(tmp_path / "rewrite3.smd")
    sdm_io.write_simple3(loaded, geo3, out)
    assert _read(out) == fixture


def test_smd3_many_patches_and_full_pool(tmp_path):
    """A cloud over a few hundred patches: the readers' ordered insert
    gives the JAX reader's table; into a pool smaller than the file, the
    overflow and the trash row as there."""
    rng = np.random.default_rng(31)
    geo3, jgeo3 = o3.MapGeometry3(0.1, 2), jo3.MapGeometry3(0.1, 2)
    pts = rng.uniform(-2, 2, (150, 3)).astype(np.float32)
    f = o3.frequency3_insert_scan(o3.frequency3_init(geo3, 1024, "cpu"),
                                  geo3, t(pts), torch.ones(150, dtype=bool),
                                  torch.zeros(3), 12)
    path = str(tmp_path / "many3.smd")
    sdm_io.write_frequency3(f, geo3, path)
    n = int(f.table.num_patches())
    assert n > 100
    for cap in (1024, n // 2):
        loaded, _ = sdm_io.read_frequency3(path, capacity=cap, device="cpu")
        jloaded, _ = jio.read_frequency3(path, capacity=cap)
        assert_same(loaded, jloaded)
    assert int(loaded.table.overflow) == n - n // 2
