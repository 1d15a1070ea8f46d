"""The port's SE(2) factor graph and SimplePGO against the JAX package, on
the CPU.

Every case of tests/test_factor_graph.py runs through both packages on the
same numpy-seeded graphs, plus the normal equations, a matrix that is not
positive definite and bench_pgo.py's graph generator at 128 nodes.

Tolerances: nodes within ``POSE_ATOL`` (1e-4 m / 1e-4 rad) of JAX's; chi2
within rtol ``CHI2_RTOL`` (1e-4) and the same iteration count where the
optimum's chi2 is above float32's noise floor (for Levenberg-Marquardt at
the end of its productive steps, see :func:`_solve`); H and g of the normal
equations, and marginal covariances, within 1e-5 of the largest entry.
Where the optimum's chi2 is at the floor (measurements without noise), the
last steps and the stop test read rounding noise (XLA's own sin, cos and
atan2 and its fused multiply-adds against PyTorch's): there both packages
must reach the floor (chi2 below ``FLOOR_CHI2``) and agree on the nodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.algos.simple_pgo import SimplePGO as JSimplePGO
from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.nlls import factor_graph as jfg

from iris_lama_tpu_torch.algos.simple_pgo import SimplePGO
from iris_lama_tpu_torch.core.pose import Pose2D
from iris_lama_tpu_torch.nlls import factor_graph as tfg

POSE_ATOL = 1e-4
CHI2_RTOL = 1e-4
NE_RTOL = 1e-5
FLOOR_CHI2 = 1e-6
LM_NOISE_ATOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small tensor ops: with the suite's workers sharing the cores,
    intra-op threads only contend. One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Both:
    """One graph built in both packages' builders."""

    def __init__(self):
        self.j, self.t = jfg.GraphBuilder(), tfg.GraphBuilder()

    def add_prior(self, *a):
        self.j.add_prior(*a)
        self.t.add_prior(*a)

    def add_between(self, *a, **kw):
        self.j.add_between(*a, **kw)
        self.t.add_between(*a, **kw)


def _nodes(poses, n_pad):
    nodes = np.tile(np.array([0, 0, 1, 0], np.float32), (n_pad, 1))
    for i, p in enumerate(poses):
        nodes[i] = p.se2_array()
    active = np.zeros(n_pad, bool)
    active[:len(poses)] = True
    return nodes, active


def _xyr(a):
    a = np.asarray(a, np.float64)
    return np.stack([a[:, 0], a[:, 1], np.arctan2(a[:, 3], a[:, 2])], -1)


def _assert_nodes_close(got, want, atol=POSE_ATOL):
    g, w = _xyr(got), _xyr(want)
    np.testing.assert_allclose(g[:, :2], w[:, :2], atol=atol)
    dth = np.angle(np.exp(1j * (g[:, 2] - w[:, 2])))
    assert np.abs(dth).max() <= atol


_JAX_OPTIMIZE = {}


def _jax_optimize(nodes, graph, active, opts):
    """jfg.optimize jitted once per options (the graphs share shapes)."""
    if opts not in _JAX_OPTIMIZE:
        _JAX_OPTIMIZE[opts] = jax.jit(
            lambda nd, g, a: jfg.optimize(nd, g, a, opts))
    out, info = _JAX_OPTIMIZE[opts](jnp.asarray(nodes), graph,
                                    jnp.asarray(active))
    return np.asarray(out), float(info["chi2"]), int(info["iterations"])


def _port_optimize(nodes, graph, active, opts):
    out, info = tfg.optimize(torch.as_tensor(nodes), graph,
                             torch.as_tensor(active), opts)
    return out.numpy(), float(info["chi2"]), int(info["iterations"])


def _solve(b: Both, poses, n_pad, opts=None):
    """Optimize on both and compare. Returns the port's nodes and
    iterations.

    Where the optimum's chi2 is at float32's floor, both must reach the
    floor and agree on the nodes. Above it, chi2 must agree and: for GN and
    dogleg the nodes and the iteration count; for LM, whose run ends with
    steps that change chi2 by less than its stop test's rtol (1e-6, a few
    ulps: rounding noise, decided by each package's summation order), the
    nodes, chi2 and iteration count at its productive end — the first
    iteration k at which the port's chi2 is within that rtol of its final
    value, where JAX must have run k iterations too — and the final nodes
    within ``LM_NOISE_ATOL``, the motion those noise steps make along
    directions float32 chi2 cannot resolve.
    """
    opts = opts or {}
    nodes, active = _nodes(poses, n_pad)
    gj, gt = b.j.finalize(), b.t.finalize()
    jo, jc, jit = _jax_optimize(nodes, gj, active, jfg.PGOOptions(**opts))
    to, tc, tit = _port_optimize(nodes, gt, active, tfg.PGOOptions(**opts))
    if jc <= FLOOR_CHI2:
        _assert_nodes_close(to, jo)
        assert tc <= FLOOR_CHI2, (tc, jc)
        return to, tit
    np.testing.assert_allclose(tc, jc, rtol=CHI2_RTOL)
    if opts.get("strategy", "lm") != "lm":
        _assert_nodes_close(to, jo)
        assert tit == jit, (tit, jit)
        return to, tit
    _assert_nodes_close(to, jo, LM_NOISE_ATOL)
    rtol = tfg.PGOOptions().rtol
    for k in range(1, tit + 1):
        kopts = {**opts, "max_iterations": k}
        tok, tck, _ = _port_optimize(nodes, gt, active,
                                     tfg.PGOOptions(**kopts))
        if abs(tck - tc) <= rtol * tc:
            break
    jok, jck, jitk = _jax_optimize(nodes, gj, active,
                                   jfg.PGOOptions(**kopts))
    assert jitk == k, (k, jitk)
    np.testing.assert_allclose(tck, jck, rtol=CHI2_RTOL)
    _assert_nodes_close(tok, jok)
    return to, tit


def test_prior_only_pulls_to_measurement():
    b = Both()
    target = Pose2D(1.0, 2.0, 0.5)
    b.add_prior(0, target.se2_array(), (0.1, 0.1, 0.1))
    out, _ = _solve(b, [Pose2D(0, 0, 0)], 64)
    got = Pose2D.from_se2_array(out[0])
    np.testing.assert_allclose(got.xyr(), target.xyr(), atol=1e-4)


def test_chain_consistent_measurements_exact():
    rng = np.random.default_rng(6)
    true = [Pose2D(0, 0, 0)]
    for k in range(6):
        true.append(true[-1] + Pose2D(1.0, 0.1 * k, 0.15))
    b = Both()
    b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
    for i in range(6):
        b.add_between(i, i + 1, (true[i] - true[i + 1]).se2_array(),
                      (0.5, 0.5, 0.1))
    init = [Pose2D(p.x() + rng.normal(0, 0.3), p.y() + rng.normal(0, 0.3),
                   p.rotation() + rng.normal(0, 0.1)) for p in true]
    out, _ = _solve(b, init, 64)
    for i, p in enumerate(true):
        np.testing.assert_allclose(Pose2D.from_se2_array(out[i]).xyr(),
                                   p.xyr(), atol=1e-3)


def _square_loop():
    gt = [Pose2D(0, 0, 0)]
    for k in range(8):
        step = Pose2D(1.0, 0, 0) if k % 2 == 0 else Pose2D(1.0, 0, np.pi / 2)
        gt.append(gt[-1] + step)
    drift = [Pose2D(0, 0, 0)]
    for k in range(8):
        step = Pose2D(1.08, 0.02, 0.01) if k % 2 == 0 else \
            Pose2D(1.08, 0.02, np.pi / 2 + 0.01)
        drift.append(drift[-1] + step)
    return gt, drift


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "free"])
def test_simple_pgo_matches_jax(fixed):
    """SimplePGO with and without fixed nodes (the reference's sigma
    conventions); the fixed case is test_loop_closure_distributes_error."""
    gt, drift = _square_loop()
    rel = gt[0] - gt[8]
    runs = []
    for cls, pose in ((JSimplePGO, JPose2D), (SimplePGO, Pose2D)):
        pgo = cls() if cls is JSimplePGO else cls(device="cpu")
        pgo.node_list = [pose(*p.xyr()) for p in drift]
        pgo.edge_list = [(0, (8, pose(*rel.xyr())))]
        if fixed:
            pgo.fixed_list = [(0, pose(*gt[0].xyr()))]
        assert pgo.optimize()
        runs.append(np.asarray([p.xyr() for p in pgo.node_list]))
    np.testing.assert_allclose(runs[1][:, :2], runs[0][:, :2],
                               atol=POSE_ATOL)
    dth = np.angle(np.exp(1j * (runs[1][:, 2] - runs[0][:, 2])))
    assert np.abs(dth).max() <= POSE_ATOL
    if fixed:
        # the assertions of test_loop_closure_distributes_error
        got = runs[1]
        end = Pose2D(*got[0]) + rel
        np.testing.assert_allclose(got[8, :2], end.xy(), atol=0.05)
        err0 = np.linalg.norm(drift[8].xy() - gt[8].xy())
        err1 = np.linalg.norm(got[8, :2] - gt[8].xy())
        assert err1 < err0 * 0.3, (err0, err1)


def test_huber_downweights_outlier_edge():
    true = [Pose2D(k * 1.0, 0, 0) for k in range(5)]

    def solve(huber):
        b = Both()
        b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
        for i in range(4):
            b.add_between(i, i + 1, (true[i] - true[i + 1]).se2_array(),
                          (0.1, 0.1, 0.1))
        b.add_between(0, 4, Pose2D(0.5, 0, 0).se2_array(), (0.1, 0.1, 0.1),
                      huber_k=huber)
        out, _ = _solve(b, true, 64)
        return Pose2D.from_se2_array(out[4])

    robust = solve(0.1)
    quad = solve(0.0)
    assert abs(robust.x() - 4.0) < abs(quad.x() - 4.0)
    assert abs(robust.x() - 4.0) < 0.3


def test_padding_nodes_untouched():
    b = Both()
    b.add_prior(0, Pose2D(1, 1, 0).se2_array(), (0.1, 0.1, 0.1))
    out, _ = _solve(b, [Pose2D(0, 0, 0)], 64)
    np.testing.assert_allclose(out[1:], np.tile([0, 0, 1, 0], (63, 1)),
                               atol=1e-6)


def _cov_both(b: Both, poses, n_pad, idx):
    nodes, active = _nodes(poses, n_pad)
    jc = np.asarray(jfg.marginal_covariance(
        jnp.asarray(nodes), b.j.finalize(), jnp.asarray(active), idx))
    tc = tfg.marginal_covariance(torch.as_tensor(nodes), b.t.finalize(),
                                 torch.as_tensor(active), idx).numpy()
    np.testing.assert_allclose(tc, jc, atol=NE_RTOL * np.abs(jc).max())
    return tc


def test_marginal_covariance_prior_only():
    b = Both()
    s = 0.2
    b.add_prior(0, Pose2D(1, 2, 0.3).se2_array(), (s, s, s))
    cov = _cov_both(b, [Pose2D(1, 2, 0.3)], 8, 0)
    np.testing.assert_allclose(cov, s * s * np.eye(3), atol=1e-5)


def test_marginal_covariance_grows_along_chain():
    b = Both()
    poses = [Pose2D(k * 1.0, 0, 0) for k in range(4)]
    b.add_prior(0, poses[0].se2_array(), (0.1, 0.1, 0.1))
    for i in range(3):
        b.add_between(i, i + 1, (poses[i] - poses[i + 1]).se2_array(),
                      (0.2, 0.2, 0.1))
    tr = [np.trace(_cov_both(b, poses, 8, i)) for i in range(4)]
    assert tr[0] < tr[1] < tr[2] < tr[3], tr
    # a start past the matrix is clamped, as lax.dynamic_slice clamps it
    _cov_both(b, poses, 8, 8)


def _noisy_loop():
    true = [Pose2D(0, 0, 0)]
    for k in range(7):
        true.append(true[-1] + Pose2D(1.0, 0.0, np.pi / 4))
    b = Both()
    b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
    r2 = np.random.default_rng(3)
    for i in range(7):
        meas = true[i] - true[i + 1]
        noisy = Pose2D(meas.x() + r2.normal(0, 0.05),
                       meas.y() + r2.normal(0, 0.05),
                       meas.rotation() + r2.normal(0, 0.02))
        b.add_between(i, i + 1, noisy.se2_array(), (0.5, 0.5, 0.1))
    b.add_between(7, 0, (true[7] - true[0]).se2_array(), (0.2, 0.2, 0.05))
    init = [Pose2D(p.x() + r2.normal(0, 0.2), p.y() + r2.normal(0, 0.2),
                   p.rotation() + r2.normal(0, 0.05)) for p in true]
    return b, init


@pytest.mark.parametrize("strategy", ["lm", "gn", "dogleg"])
def test_gn_and_dogleg_match_lm(strategy):
    """Each strategy on the noisy loop graph against JAX's; GN and dogleg
    also converge to LM's solution (test_gn_and_dogleg_match_lm)."""
    b, init = _noisy_loop()
    out, iterations = _solve(b, init, 64, dict(strategy=strategy))
    assert iterations > 0
    nodes, active = _nodes(init, 64)
    graph = b.t.finalize()
    lm, lm_chi2, _ = _port_optimize(nodes, graph, active, tfg.PGOOptions())
    chi2 = _port_optimize(nodes, graph, active,
                          tfg.PGOOptions(strategy=strategy))[1]
    np.testing.assert_allclose(chi2, lm_chi2, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(out[:8], lm[:8], atol=2e-3)


def test_normal_equations_match():
    b, init = _noisy_loop()
    b.add_between(2, 6, Pose2D(0.3, 2.0, 2.0).se2_array(), (0.5, 0.5, 0.1),
                  huber_k=0.1)
    nodes, active = _nodes(init, 64)
    jH, jg, jc = jfg._normal_equations(jnp.asarray(nodes), b.j.finalize(),
                                       jnp.asarray(active))
    tH, tg, tc = tfg._normal_equations(torch.as_tensor(nodes),
                                       b.t.finalize(), torch.as_tensor(active))
    jH, jg = np.asarray(jH), np.asarray(jg)
    np.testing.assert_allclose(tH.numpy(), jH,
                               atol=NE_RTOL * np.abs(jH).max())
    np.testing.assert_allclose(tg.numpy(), jg,
                               atol=NE_RTOL * np.abs(jg).max())
    np.testing.assert_allclose(float(tc), float(jc), rtol=NE_RTOL)
    np.testing.assert_array_equal(tH.numpy(), tH.numpy().T)


def test_not_positive_definite_step_refused():
    """A Hessian that is not positive definite (an active node that no
    factor touches: its rows are exactly 0): JAX's Cholesky gives NaN, the
    step is refused (NaN < chi2 is false), GN stops at once and LM raises
    its damping until its iterations run out; the port's factor is NaN
    likewise, read on no host."""
    b = Both()
    b.add_prior(0, Pose2D(1.0, 0.0, 0.1).se2_array(), (0.5, 0.5, 0.1))
    init = [Pose2D(0, 0, 0), Pose2D(0.5, 0.2, 0.0)]
    nodes, active = _nodes(init, 64)
    H, _, _ = tfg._normal_equations(torch.as_tensor(nodes), b.t.finalize(),
                                    torch.as_tensor(active))
    _, info = torch.linalg.cholesky_ex(H)
    assert int(info) > 0
    assert torch.isnan(tfg._cho_solve(H, torch.ones(H.shape[0]))).all()
    for strategy in ("gn", "lm"):
        out, iterations = _solve(b, init, 64, dict(strategy=strategy,
                                                   max_iterations=6))
        np.testing.assert_array_equal(out, nodes)
        assert iterations == (1 if strategy == "gn" else 6)


def _bench_pgo_graph(n: int, seed: int = 9, loops: int = 32):
    """bench_pgo.py's generator: a corridor chain with loop closures."""
    rng = np.random.default_rng(seed)
    true = [Pose2D(0, 0, 0)]
    for k in range(n - 1):
        true.append(true[-1] + Pose2D(1.0, 0.02 * np.sin(k / 7), 0.012))
    b = Both()
    b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
    for i in range(n - 1):
        b.add_between(i, i + 1, (true[i] - true[i + 1]).se2_array(),
                      (0.25, 0.25, 0.15))
    for _ in range(loops):
        i = int(rng.integers(0, n - 60))
        j = int(rng.integers(i + 40, n))
        b.add_between(i, j, (true[i] - true[j]).se2_array(), (0.5, 0.5, 0.1),
                      huber_k=0.1)
    init = [Pose2D(p.x() + rng.normal(0, 0.3), p.y() + rng.normal(0, 0.3),
                   p.rotation() + rng.normal(0, 0.05)) for p in true]
    return b, init, true


def test_bench_pgo_graph_128():
    """bench_pgo.py's graph at 128 nodes: measurements without noise, so
    chi2 ends at float32's floor and the iteration count is not compared;
    nodes agree with JAX's and hold bench_pgo.py's error bound."""
    b, init, true = _bench_pgo_graph(128)
    out, _ = _solve(b, init, 128)
    err = np.mean([np.linalg.norm(Pose2D.from_se2_array(out[i]).xy()
                                  - true[i].xy()) for i in range(0, 128, 16)])
    assert err < 0.03, err
