"""The port's Lie groups (iris_lama_tpu_torch/core/lie.py) and box test
(core/aabb.py) against the JAX package's, on the CPU.

The thirteen cases of tests/test_lie.py run on the port, each also held
against the JAX function on the same numpy inputs: atol 1e-6 on
step-sized inputs (the SE(2) precedent of tests/test_torch_units.py),
looser only where the JAX test's own closed-form oracle is. Then every
SO(2)/SO(3)/SE(3)/quaternion helper on random and near-zero inputs (the
Taylor branches), and the AABB tests on seeded random boxes.
"""

import numpy as np
import pytest
import torch

from iris_lama_tpu.core import aabb as jaabb
from iris_lama_tpu.core import lie as jlie
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.core.pose import Pose3D as JPose3D

from iris_lama_tpu_torch.core import aabb
from iris_lama_tpu_torch.core import lie
from iris_lama_tpu_torch.core.pose import Pose2D, Pose3D

ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU paths make many small tensor ops; with the suite's
    workers sharing the cores, intra-op threads only contend. One thread
    for this module, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def T(a):
    return torch.as_tensor(np.array(a, np.float32))


def same(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def random_se2(rng, n):
    return (rng.uniform(-5, 5, n).astype(np.float32),
            rng.uniform(-5, 5, n).astype(np.float32),
            rng.uniform(-np.pi, np.pi, n).astype(np.float32))


def test_se2_compose_matches_matrix_form():
    rng = np.random.default_rng(0)
    a, b = random_se2(rng, 64), random_se2(rng, 64)
    ta, tb = lie.se2(*map(T, a)), lie.se2(*map(T, b))
    c = lie.se2_compose(ta, tb).numpy()
    same(c, jlie.se2_compose(jlie.se2(*a), jlie.se2(*b)))
    for i in range(64):
        ga, gb = ta[i].numpy(), tb[i].numpy()
        ra = np.array([[ga[2], -ga[3]], [ga[3], ga[2]]])
        rb = np.array([[gb[2], -gb[3]], [gb[3], gb[2]]])
        rc = ra @ rb
        np.testing.assert_allclose(c[i, :2], ga[:2] + ra @ gb[:2], atol=1e-5)
        np.testing.assert_allclose(c[i, 2:], [rc[0, 0], rc[1, 0]], atol=1e-6)


def test_se2_inverse_roundtrip():
    g = lie.se2(*map(T, random_se2(np.random.default_rng(1), 64)))
    ident = lie.se2_compose(g, lie.se2_inverse(g)).numpy()
    same(lie.se2_inverse(g), jlie.se2_inverse(g.numpy()))
    np.testing.assert_allclose(ident[:, :2], 0, atol=1e-5)
    np.testing.assert_allclose(ident[:, 2], 1, atol=1e-6)
    np.testing.assert_allclose(ident[:, 3], 0, atol=1e-6)


def test_se2_exp_log_roundtrip():
    xi = np.random.default_rng(2).uniform(-2, 2, (128, 3)).astype(np.float32)
    g = lie.se2_exp(T(xi))
    same(g, jlie.se2_exp(xi))
    back = lie.se2_log(g).numpy()
    same(back, jlie.se2_log(jlie.se2_exp(xi)), atol=1e-5)
    np.testing.assert_allclose(back, xi, atol=1e-4)


def test_se2_exp_small_angle():
    xi = np.array([[0.3, -0.2, 1e-7], [0.3, -0.2, 0.0]], np.float32)
    g = lie.se2_exp(T(xi)).numpy()
    same(g, jlie.se2_exp(xi))
    np.testing.assert_allclose(g[0], g[1], atol=1e-6)
    np.testing.assert_allclose(g[1, :2], [0.3, -0.2], atol=1e-6)


def test_se2_exp_matches_closed_form():
    xi = np.array([[1.0, 2.0, 0.5]], np.float32)
    g = lie.se2_exp(T(xi)).numpy()[0]
    same(g, np.asarray(jlie.se2_exp(xi))[0])
    w = 0.5
    v = np.array([[np.sin(w) / w, -(1 - np.cos(w)) / w],
                  [(1 - np.cos(w)) / w, np.sin(w) / w]])
    np.testing.assert_allclose(g[:2], v @ np.array([1.0, 2.0]), atol=1e-5)
    np.testing.assert_allclose(g[2:], [np.cos(w), np.sin(w)], atol=1e-6)


def test_se2_apply():
    g = lie.se2(1.0, 2.0, np.pi / 2)
    p = lie.se2_apply(g, T([1.0, 0.0])).numpy()
    same(p, jlie.se2_apply(jlie.se2(1.0, 2.0, np.pi / 2),
                           np.array([1.0, 0.0], np.float32)))
    np.testing.assert_allclose(p, [1.0, 3.0], atol=1e-5)


def test_so3_exp_log_roundtrip():
    w = np.random.default_rng(3).uniform(-2, 2, (64, 3)).astype(np.float32)
    q = lie.so3_exp(T(w))
    same(q, jlie.so3_exp(w))
    back = lie.so3_log(q).numpy()
    same(back, jlie.so3_log(jlie.so3_exp(w)), atol=1e-5)
    np.testing.assert_allclose(back, w, atol=1e-4)


def test_se3_compose_apply():
    rng = np.random.default_rng(4)
    xi = rng.uniform(-1, 1, (32, 6)).astype(np.float32)
    p = rng.uniform(-3, 3, (32, 3)).astype(np.float32)
    g = lie.se3_exp(T(xi))
    gi = lie.se3_inverse(g)
    q = lie.se3_apply(gi, lie.se3_apply(g, T(p))).numpy()
    jg = jlie.se3_exp(xi)
    same(g, jg)
    same(gi, jlie.se3_inverse(jg))
    same(q, jlie.se3_apply(jlie.se3_inverse(jg), jlie.se3_apply(jg, p)),
         atol=5e-6)
    np.testing.assert_allclose(q, p, atol=1e-4)


def test_se3_exp_log_roundtrip():
    xi = np.random.default_rng(5).uniform(-1.5, 1.5, (64, 6)) \
        .astype(np.float32)
    back = lie.se3_log(lie.se3_exp(T(xi))).numpy()
    same(back, jlie.se3_log(jlie.se3_exp(xi)), atol=2e-5)
    np.testing.assert_allclose(back, xi, atol=5e-4)


# ---------------------------------------------------------------------------
# Pose2D / Pose3D host semantics (src/pose2d.cpp:76-97), both packages
# ---------------------------------------------------------------------------

def test_pose2d_add_sub():
    for P in (Pose2D, JPose2D):
        a, b = P(1.0, 2.0, 0.3), P(-0.5, 0.25, -0.1)
        c = a + b
        ca, sa = np.cos(0.3), np.sin(0.3)
        np.testing.assert_allclose(c.x(), 1.0 + ca * -0.5 - sa * 0.25,
                                   atol=1e-12)
        np.testing.assert_allclose(c.y(), 2.0 + sa * -0.5 + ca * 0.25,
                                   atol=1e-12)
        np.testing.assert_allclose(c.rotation(), 0.2, atol=1e-12)
        np.testing.assert_allclose((a - c).xyr(), b.xyr(), atol=1e-12)
    np.testing.assert_allclose(
        (Pose2D(1.0, 2.0, 0.3) + Pose2D(-0.5, 0.25, -0.1)).xyr(),
        (JPose2D(1.0, 2.0, 0.3) + JPose2D(-0.5, 0.25, -0.1)).xyr(),
        atol=1e-12)


def test_pose2d_se2_array_roundtrip():
    p = Pose2D(3.0, -1.0, 2.0)
    q = Pose2D.from_se2_array(p.se2_array())
    np.testing.assert_allclose(q.xyr(), p.xyr(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(p.se2_array()),
                               np.asarray(JPose2D(3.0, -1.0, 2.0)
                                          .se2_array()), atol=1e-7)


def test_pose3d_add_sub():
    args_a, args_b = (1, 2, 3, 0.1, -0.2, 0.3), (-1, 0.5, 0, 0.2, 0.1, -0.4)
    a, b = Pose3D.from_xyzrpy(*args_a), Pose3D.from_xyzrpy(*args_b)
    c = a + b
    d = a - c
    np.testing.assert_allclose(d.t, b.t, atol=1e-12)
    np.testing.assert_allclose(abs(np.dot(d.q, b.q)), 1.0, atol=1e-12)
    jc = JPose3D.from_xyzrpy(*args_a) + JPose3D.from_xyzrpy(*args_b)
    np.testing.assert_allclose(c.t, jc.t, atol=1e-12)
    np.testing.assert_allclose(c.q, jc.q, atol=1e-12)


def test_pose2d_inverse():
    p = Pose2D(1.5, -0.7, 0.9)
    np.testing.assert_allclose((p + p.inverse()).xyr(), 0.0, atol=1e-12)
    np.testing.assert_allclose((p.inverse() + p).xyr(), 0.0, atol=1e-12)
    np.testing.assert_allclose((Pose2D() - p).xyr(), p.xyr(), atol=1e-12)
    np.testing.assert_allclose(p.inverse().xyr(),
                               JPose2D(1.5, -0.7, 0.9).inverse().xyr(),
                               atol=1e-12)


# ---------------------------------------------------------------------------
# Every helper against JAX, including the small-angle branches
# ---------------------------------------------------------------------------

def _angles(rng, n):
    """Rotation vectors: step-sized, and at and around the 1e-5 branch."""
    big = rng.uniform(-0.5, 0.5, (n, 3))
    tiny = rng.normal(size=(n, 3))
    tiny *= (10.0 ** rng.uniform(-9, -4, n))[:, None] / np.linalg.norm(
        tiny, axis=1, keepdims=True)
    return np.concatenate([big, tiny, np.zeros((1, 3))]).astype(np.float32)


@pytest.mark.parametrize("name", ["so3", "se3", "quat", "so2", "se2"])
def test_helpers_match_jax(name):
    rng = np.random.default_rng(6)
    if name == "so3":
        w = _angles(rng, 32)
        same(lie.so3_exp(T(w)), jlie.so3_exp(w))
        q = np.asarray(jlie.so3_exp(w))
        same(lie.so3_log(T(q)), jlie.so3_log(q))
    elif name == "se3":
        w = _angles(rng, 32)
        v = rng.uniform(-0.5, 0.5, w.shape).astype(np.float32)
        xi = np.concatenate([v, w], -1)
        g = np.asarray(jlie.se3_exp(xi))
        same(lie.se3_exp(T(xi)), g)
        same(lie.se3_log(T(g)), jlie.se3_log(g))
        h = np.roll(g, 1, axis=0)
        same(lie.se3_compose(T(g), T(h)), jlie.se3_compose(g, h))
        same(lie.se3_identity((2,)), jlie.se3_identity((2,)))
        same(lie.se3(T(v[0]), T(g[0, 3:])), jlie.se3(v[0], g[0, 3:]))
        same(lie.se3_translation(T(g)), jlie.se3_translation(g))
        same(lie.se3_quat(T(g)), jlie.se3_quat(g))
    elif name == "quat":
        q = np.asarray(jlie.so3_exp(_angles(rng, 16)))
        r = np.roll(q, 3, axis=0)
        p = rng.uniform(-3, 3, (q.shape[0], 3)).astype(np.float32)
        same(lie.quat_mul(T(q), T(r)), jlie.quat_mul(q, r))
        same(lie.quat_conj(T(q)), jlie.quat_conj(q))
        same(lie.quat_apply(T(q), T(p)), jlie.quat_apply(q, p), atol=2e-6)
        same(lie.quat_identity((3,)), jlie.quat_identity((3,)))
    elif name == "so2":
        th = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
        a = np.asarray(jlie.so2_from_angle(th))
        same(lie.so2_from_angle(T(th)), a)
        same(lie.so2_log(T(a)), jlie.so2_log(a))
        same(lie.so2_mul(T(a), T(a[::-1].copy())),
             jlie.so2_mul(a, a[::-1]))
    else:
        g = np.asarray(jlie.se2(*random_se2(rng, 16)))
        same(lie.se2_identity((2, 3)), jlie.se2_identity((2, 3)))
        same(lie.se2_translation(T(g)), jlie.se2_translation(g))
        same(lie.se2_adjoint(T(g)), jlie.se2_adjoint(g), atol=0)


def test_aabb_matches_jax():
    rng = np.random.default_rng(7)
    lo = rng.uniform(-5, 5, (200, 3))
    hi = lo + rng.uniform(0, 3, (200, 3))
    pts = rng.uniform(-6, 6, (200, 3))
    for i in range(200):
        a, ja = aabb.AABB(lo[i], hi[i]), jaabb.AABB(lo[i], hi[i])
        j = (i + 1) % 200
        b, jb = aabb.AABB(hi[j], lo[j]), jaabb.AABB(hi[j], lo[j])
        assert a.test_intersection(b) == ja.test_intersection(jb)
        assert a.contains(pts[i]) == ja.contains(pts[i])
    centers, hw = 0.5 * (lo + hi), 0.5 * (hi - lo)
    want = jaabb.batch_intersects(centers, hw, centers[0], hw[0])
    got = aabb.batch_intersects(centers, hw, centers[0], hw[0])
    np.testing.assert_array_equal(got, want)
    got_t = aabb.batch_intersects(torch.as_tensor(centers),
                                  torch.as_tensor(hw),
                                  torch.as_tensor(centers[0]),
                                  torch.as_tensor(hw[0]))
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert 0 < want.sum() < 200
