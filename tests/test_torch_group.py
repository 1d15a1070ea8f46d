"""The port's collectives (iris_lama_tpu_torch/parallel/group.py) at world
1, 2 and 4 on gloo, the ranks spawned by ``run_ranks``: each helper
against its single-process meaning on seeded tensors, and the spawner's
failure paths (a rank that raises, a rank that hangs), each failing within
its time limit.

Tolerances: none but the sum all-reduce's (float32 sums in another order:
torch.testing's float32 default); gathers, row exchanges and halos are
equal, and the bytes a row exchange reports are the rows that changed
rank times the row's bytes.
"""

import time

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from iris_lama_tpu_torch.parallel import group as G

WORLDS = (1, 2, 4)
EXCHANGES = ("all_move", "none_move", "perm", "ragged")


@pytest.fixture(scope="module", params=WORLDS)
def checks(request):
    return G.run_ranks(ranks.group_checks, request.param, args=(5,),
                       timeout=120)


def test_all_sum(checks):
    for got, want in (c["sum"] for c in checks):
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("name", ["gather", "gather_int"])
def test_all_gather_cat(checks, name):
    for got, want in (c[name] for c in checks):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("name", EXCHANGES)
def test_exchange_rows(checks, name):
    """Every rank's rows after the exchange are its rows of ``x[idx]``;
    the reported bytes are those of the rows that changed rank (all of
    them under the rotation, none under the identity)."""
    for r, c in enumerate(checks):
        got, want, moved, expect = c[name]
        assert torch.equal(got, want), (name, r)
        assert moved == expect, (name, r, moved, expect)
    if name == "none_move":
        assert checks[0][name][2] == 0
    if name == "all_move" and len(checks) > 1:
        assert checks[0][name][2] == 3 * len(checks) * 10 * 4


def test_exchange_rows_two_arrays(checks):
    """Two arrays of other row shapes and dtypes in one exchange: each
    re-ordered, the bytes those of both arrays' crossing rows."""
    for r, c in enumerate(checks):
        got, want, moved, expect = c["two_arrays"]
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), r
        assert moved == expect, (r, moved, expect)


def test_without_group_is_one_process():
    """``group=None``: each helper's single-process meaning, no process
    group needed (the unsharded PF update runs through them)."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn((6, 3), generator=g)
    assert (G.size(), G.rank(), G.rows(6)) == (1, 0, slice(0, 6))
    assert G.all_sum(x) is x and G.all_gather_cat(x) is x
    idx = torch.tensor([5, 0, 0, 2, 4, 1])
    a, b = x.clone(), (x > 0).clone()
    assert G.exchange_rows([a, b], idx) == 0
    assert torch.equal(a, x[idx]) and torch.equal(b, (x > 0)[idx])
    above, below = G.halo_exchange(x > 0, 2)
    assert above.shape == below.shape == (2, 3)
    assert above.dtype == torch.bool and not (above.any() or below.any())


def test_halo_exchange(checks):
    """Each rank receives its neighbours' edge rows; the first and the last
    rank an all-False halo on the grid's edge."""
    for r, c in enumerate(checks):
        (above, below), (want_a, want_b) = c["halo"]
        assert above.dtype == torch.bool
        assert torch.equal(above, want_a), r
        assert torch.equal(below, want_b), r


def test_rank_that_raises_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        G.run_ranks(ranks.fail_on_rank, 2, args=(1,), timeout=60)
    assert time.monotonic() - t0 < 60


def test_rank_that_hangs_times_out():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[1\]"):
        G.run_ranks(ranks.hang_on_rank, 2, args=(1,), timeout=6)
    assert time.monotonic() - t0 < 30


def test_exchange_plan():
    """The host plan: which destination rows take a row of which rank
    (two ranks of two rows; rows 0 and 3 stay, 1 and 2 cross)."""
    plan = G.exchange_plan(np.array([0, 2, 1, 3]), 2, 2)
    assert [list(a) for a in plan[0]] == [[0], [2]]
    assert [list(a) for a in plan[1]] == [[1], [3]]
