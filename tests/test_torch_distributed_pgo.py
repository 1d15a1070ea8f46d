"""The port's distributed pose-graph GN-CG
(iris_lama_tpu_torch/parallel/distributed_pgo.py) against the JAX
package's on the CPU, on tests/test_distributed_pgo.py's loop graphs and
bench_pgo.py's 512-node graph, and with its factors split over 4 gloo
ranks.

Tolerances. Against JAX on the same graph: nodes within 1e-4 on the loop
graphs (measured 1e-6) and 1e-3 m on bench_pgo.py's (measured 1.2e-4: its
nodes reach 500 m, where float32's spacing is 6e-5, and its chain hangs on
one prior, so the last steps are at float32's floor); ``chi2_history``
within rtol 1e-5 at the first entry and 1e-3 at the second, and from the
third on both below 1e-6 of the first: float32's floor, where each entry
is rounding noise (XLA and PyTorch sum the residuals in other orders). World 4 against one process:
the same bounds (the sums over factors are split at other places).
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iris_lama_tpu.core.pose import Pose2D as JPose2D
from iris_lama_tpu.nlls import factor_graph as jfg
from iris_lama_tpu.parallel import distributed_pgo as jdpgo

import torch_parallel_ranks as ranks
from iris_lama_tpu_torch.nlls import factor_graph as tfg
from iris_lama_tpu_torch.parallel import distributed_pgo as tdpgo
from iris_lama_tpu_torch.parallel import group as G

NODE_ATOL = {"loop24": 1e-4, "loop30": 1e-4, "bench512": 1e-3}
INDEX_FIELDS = ("prior_idx", "bet_i", "bet_j")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def loop_graph(n=24, drift=0.04, seed=17):
    """tests/test_distributed_pgo.py::build_loop_graph (its module rng at
    its first use)."""
    rng = np.random.default_rng(seed)
    true = [JPose2D(0, 0, 0)]
    for k in range(n - 1):
        true.append(true[-1] + JPose2D(1.0, 0.05 * np.sin(k), 0.26))
    b = jfg.GraphBuilder()
    b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
    for i in range(n - 1):
        b.add_between(i, i + 1, (true[i] - true[i + 1]).se2_array(),
                      (0.5, 0.5, 0.1))
    for (i, j) in [(0, n - 1), (2, n // 2)]:
        b.add_between(i, j, (true[i] - true[j]).se2_array(), (0.5, 0.5, 0.1))
    init = [JPose2D(p.x() + rng.normal(0, drift), p.y() + rng.normal(0, drift),
                    p.rotation() + rng.normal(0, drift)) for p in true]
    return _problem(b, init, true)


def pgo_graph(n=512, seed=9, loops=32):
    """bench_pgo.py's graph: a corridor chain with Huber loop closures."""
    rng = np.random.default_rng(seed)
    true = [JPose2D(0, 0, 0)]
    for k in range(n - 1):
        true.append(true[-1] + JPose2D(1.0, 0.02 * np.sin(k / 7), 0.012))
    b = jfg.GraphBuilder()
    b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
    for i in range(n - 1):
        b.add_between(i, i + 1, (true[i] - true[i + 1]).se2_array(),
                      (0.25, 0.25, 0.15))
    for _ in range(loops):
        i = int(rng.integers(0, n - 60))
        j = int(rng.integers(i + 40, n))
        b.add_between(i, j, (true[i] - true[j]).se2_array(), (0.5, 0.5, 0.1),
                      huber_k=0.1)
    init = [JPose2D(p.x() + rng.normal(0, 0.3), p.y() + rng.normal(0, 0.3),
                    p.rotation() + rng.normal(0, 0.05)) for p in true]
    return _problem(b, init, true)


def _problem(b, init, true):
    """(nodes f32 [n_pad, 4], graph numpy fields, active, true poses)."""
    n_pad = jfg.GraphBuilder._bucket(len(true))
    nodes = np.tile(np.array([0, 0, 1, 0], np.float32), (n_pad, 1))
    for i, p in enumerate(init):
        nodes[i] = p.se2_array()
    active = np.zeros(n_pad, bool)
    active[:len(true)] = True
    graph = tuple(np.array(a, np.int64 if f in INDEX_FIELDS else None)
                  for f, a in zip(jfg.SE2Graph._fields, b.finalize()))
    return nodes, graph, active, true


def _torch(nodes, graph, active):
    return (torch.as_tensor(nodes), tfg.SE2Graph(*map(torch.as_tensor, graph)),
            torch.as_tensor(active))


def _jax(nodes, graph, active):
    out, info = jax.jit(jdpgo.optimize_distributed)(
        jnp.asarray(nodes), jfg.SE2Graph(*map(jnp.asarray, graph)),
        jnp.asarray(active))
    return np.asarray(out), np.asarray(info["chi2_history"])


def _assert_chi2(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    assert (got[2:] <= 1e-6 * got[0]).all(), got
    assert (want[2:] <= 1e-6 * want[0]).all(), want


def _err(nodes, true):
    return np.array([np.linalg.norm(JPose2D.from_se2_array(nodes[i]).xy()
                                    - t.xy()) for i, t in enumerate(true)])


PROBLEMS = {"loop24": lambda: loop_graph(24), "loop30": lambda: loop_graph(30),
            "bench512": pgo_graph}


@pytest.fixture(scope="module")
def problems():
    return {k: f() for k, f in PROBLEMS.items()}


@pytest.fixture(scope="module")
def world4(problems):
    """optimize_distributed with the factors over 4 gloo ranks, one world
    for every problem; rank 0's nodes and history (each rank holds the
    same: the node states are replicated)."""
    res = G.run_ranks(ranks.pgo, 4, args=(
        [p[:3] for p in problems.values()], 10, 50), timeout=300)
    for r in res[1:]:
        for (a, ha), (b, hb) in zip(res[0], r):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(ha, hb)
    return dict(zip(problems, res[0]))


def test_matches_dense_lm(problems):
    """tests/test_distributed_pgo.py::test_matches_dense_lm on the port:
    within 2 cm of the port's dense LM and 5 cm of the truth."""
    nodes, graph, active, true = problems["loop24"]
    dense, _ = tfg.optimize(*_torch(nodes, graph, active))
    dist, info = tdpgo.optimize_distributed(*_torch(nodes, graph, active))
    dense, dist = dense.numpy(), dist.numpy()
    n = len(true)
    assert (np.linalg.norm(dense[:n, :2] - dist[:n, :2], axis=1)
            < 2e-2).all()
    assert (_err(dist, true) < 5e-2).all()
    assert info["chi2_history"].shape == (10,)


def test_sharded_factors_on_group(world4, problems):
    """tests/test_distributed_pgo.py::test_sharded_factors_on_mesh on the
    port: the n = 30 loop with its factors over 4 gloo ranks, within 5 cm
    of the truth."""
    out, _ = world4["loop30"]
    assert (_err(out, problems["loop30"][3]) < 5e-2).all()


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_matches_jax(problems, name):
    """The port's one-process GN-CG against the JAX package's."""
    nodes, graph, active, true = problems[name]
    want, wchi = _jax(nodes, graph, active)
    got, info = tdpgo.optimize_distributed(*_torch(nodes, graph, active))
    n = len(true)
    np.testing.assert_allclose(got.numpy()[:n], want[:n], atol=NODE_ATOL[name])
    _assert_chi2(info["chi2_history"].numpy(), wchi)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_world4_equals_one_process(world4, problems, name):
    nodes, graph, active, true = problems[name]
    one, info = tdpgo.optimize_distributed(*_torch(nodes, graph, active))
    got, chi = world4[name]
    n = len(true)
    np.testing.assert_allclose(got[:n], one.numpy()[:n], atol=NODE_ATOL[name])
    _assert_chi2(chi, info["chi2_history"].numpy())


def test_shard_graph_splits_factors(problems):
    """shard_graph's slices: the priors and the betweens each split in
    rank order (the graph of world 4, rank 2, through a fake group)."""
    _, graph, _, _ = problems["bench512"]
    g = tfg.SE2Graph(*map(torch.as_tensor, graph))
    np_, nb = g.prior_idx.shape[0], g.bet_i.shape[0]
    assert np_ % 4 == 0 and nb % 4 == 0
    sp, sb = slice(2 * np_ // 4, 3 * np_ // 4), slice(2 * nb // 4, 3 * nb // 4)

    with mock.patch.object(G, "size", lambda group=None: 4), \
            mock.patch.object(G, "rank", lambda group=None: 2):
        part = tdpgo.shard_graph(g, object())
    for f, a, b in zip(tfg.SE2Graph._fields, part, g):
        want = b[sp] if f.startswith("prior") else b[sb]
        assert torch.equal(a, want), f
