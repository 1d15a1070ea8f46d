"""The port's package surface and its example runners, on the CPU.

* ``iris_lama_tpu_torch``'s lazy top-level names: the names of the JAX
  package's ``__init__`` (``iris_lama_tpu/__init__.py:18-45``), each
  resolving to the port's class, and the whole port importing no JAX and
  nothing of the JAX package (a fresh interpreter imports every module);
* ``examples/run_carmen_torch.py`` on a small CARMEN log written by the
  test (``utils/dataset.py``): the same updates and map as the port's
  Slam2D driven on the log's records directly, its ``.smd`` maps readable;
* ``examples/run_long_world_torch.py`` at a few scans (the route's 550 m
  in 20 steps: a smoke run of the control flow, not of accuracy).
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import iris_lama_tpu
import iris_lama_tpu_torch
from iris_lama_tpu_torch.sdm import io as sdm_io
from iris_lama_tpu_torch.utils import dataset as tds
from iris_lama_tpu_torch.utils import simulator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("Slam2D", "Slam2DOptions", "Loc2D", "Loc2DOptions", "PFSlam2D",
         "PFSlam2DOptions", "GraphSlam2D", "GraphSlam2DOptions", "SimplePGO",
         "LidarOdometry2D", "LidarOdometry2DOptions", "Pose2D", "Pose3D",
         "PointCloudXYZ")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_top_level_names(name):
    obj = getattr(iris_lama_tpu_torch, name)
    assert obj.__module__.startswith("iris_lama_tpu_torch."), obj.__module__
    # the same name the JAX package exports, for the same class
    assert type(obj) is type(getattr(iris_lama_tpu, name))
    assert obj.__name__ == getattr(iris_lama_tpu, name).__name__
    assert name in iris_lama_tpu_torch.__all__


def test_unknown_name_raises():
    with pytest.raises(AttributeError):
        iris_lama_tpu_torch.NoSuchDriver


def test_port_imports_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither ``jax`` nor the JAX package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import iris_lama_tpu_torch as p\n"
        "[getattr(p, n) for n in p.__all__]\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'iris_lama_tpu'\n"
        "             or m.startswith('iris_lama_tpu.'))\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('iris_lama_tpu_torch.')]))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) > 40


def _write_log(path, n_steps):
    data = simulator.simulate(simulator.SimConfig(n_steps=n_steps, seed=3))
    recs = [tds.LaserScanRecord(c, o, float(k))
            for k, (c, o) in enumerate(zip(data.clouds, data.odometry))]
    tds.write_carmen_flaser(path, recs)


def test_run_carmen_torch(tmp_path):
    log = str(tmp_path / "small.clf")
    _write_log(log, 24)
    prefix = str(tmp_path / "out")
    run = _example("run_carmen_torch")
    res = run.main([log, "--device", "cpu", "--algo", "slam2d",
                    "--capacity", "2048", "--out-prefix", prefix])
    assert res["scans"] == 24 and res["updates"] > 5
    for ext in ("_map.png", "_occ.smd", "_dm.smd", "_traj.txt"):
        assert os.path.exists(prefix + ext), ext
    # the same log through the port's Slam2D directly: the same map
    slam = iris_lama_tpu_torch.Slam2D(iris_lama_tpu_torch.Slam2DOptions(
        resolution=0.05, max_range=10.0, trans_thresh=0.25,
        rot_thresh=0.25, capacity=2048), device="cpu")
    n_upd = sum(bool(slam.update(r.cloud, r.odometry, r.timestamp))
                for r in tds.read_carmen_log(log, max_range=10.0))
    assert n_upd == res["updates"]
    path = str(tmp_path / "direct_occ.smd")
    sdm_io.write_frequency_occupancy(slam.map, slam.cfg.geometry, path)
    assert open(path, "rb").read() == open(prefix + "_occ.smd", "rb").read()
    occ, geo = sdm_io.read_frequency_occupancy(prefix + "_occ.smd",
                                               capacity=2048, device="cpu")
    assert int(occ.table.num_patches()) > 0 and geo.resolution > 0
    dm, _ = sdm_io.read_distance_map(prefix + "_dm.smd", capacity=2048,
                                     device="cpu")
    assert bool((dm.dist == 0).any())


def test_run_long_world_torch():
    run = _example("run_long_world_torch")
    rows = run.main(["--steps", "20", "--algos", "slam2d,lidar_odom",
                     "--device", "cpu"])
    assert [r["algo"] for r in rows] == ["slam2d", "lidar_odom"]
    assert all(r["device"] == "cpu" for r in rows)
    assert rows[0]["updates"] > 0 and np.isfinite(rows[0]["ate_m"])
    assert rows[1]["scans"] == 20
    assert np.isfinite(rows[1]["drift_m_per_100m"])
