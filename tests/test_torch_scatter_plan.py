"""The launch plan of the value scatters B7 and B8
(``iris_lama_tpu_torch/ops/scatter_pallas.py:launch_blocks``), a plain
function of the shapes, and the kernel's division of the work under it
(``csrc/deposit.cu:scatter_grid_kernel``, mirrored here in numpy): every
cell of the grid is zeroed by exactly one thread, every element is taken
by exactly one thread in one round, each block runs the same rounds in all
its threads (the warps' shuffles see all 32 lanes), and the launch fits the
card at once (a cooperative launch). The kernels run only on the card
(``tests/test_torch_cuda.py::test_value_scatters_match_plain``).
"""

import numpy as np
import pytest

from iris_lama_tpu_torch.ops.scatter_pallas import PER, SMS, THREADS
from iris_lama_tpu_torch.ops.scatter_pallas import launch_blocks

# every grid a path or a test sends the two functions: the Slam2D deposit
# window padded to 128 columns, Slam2D's window, Loc2D's window padded, the
# GraphSlam2D rebuild's size class, the smallest B8 grid, a 16-MB grid; and
# edges: a 280-KB row, a cell count no multiple of 4, no cell
GRIDS = [(448, 512), (448, 448), (576, 640), (768, 1024), (8, 128),
         (2048, 2048), (2, 70_000), (449, 447), (0, 128)]
STREAMS = (0, 1, 43_281, SMS * THREADS * PER, SMS * THREADS * PER + 1,
           2_424_000)
RESIDENT_BLOCKS_PER_SM = 2048 // THREADS   # an SM's 2,048 threads


def zeroed_by(total: int, threads: int) -> np.ndarray:
    """How many times each cell is zeroed: 16-byte stores i = tid, tid +
    threads, ... below total // 4, then the ragged tail cell by cell."""
    hits = np.zeros(total, dtype=np.int64)
    vec = np.arange(total // 4)
    for k in range(4):
        np.add.at(hits, vec * 4 + k, 1)
    tail = np.arange(total // 4 * 4, total)
    assert np.all(tail - total // 4 * 4 < threads)   # one thread a cell
    np.add.at(hits, tail, 1)
    return hits


def element_rounds(n: int, blocks: int) -> np.ndarray:
    """Element -> (block, round, thread, j) by the kernel's layout: round r
    of block b covers THREADS * PER consecutive elements from (r * blocks +
    b) * THREADS * PER, its thread t elements t + j * THREADS."""
    per_round = THREADS * PER
    t = np.arange(n, dtype=np.int64)
    chunk = t // per_round
    block, rnd = chunk % blocks, chunk // blocks
    within = t - chunk * per_round
    j, thread = within // THREADS, within % THREADS
    return np.stack([block, rnd, thread, j], axis=1)


@pytest.mark.parametrize("n", STREAMS)
@pytest.mark.parametrize("hw", GRIDS)
def test_launch_covers_every_cell_and_element_once(hw, n):
    h, w = hw
    blocks = launch_blocks(n)
    assert blocks in (SMS, 4 * SMS)
    assert blocks <= SMS * RESIDENT_BLOCKS_PER_SM   # all resident at once
    threads = blocks * THREADS
    if h * w <= 2_000_000:
        assert np.all(zeroed_by(h * w, threads) == 1)
    if n <= 100_000:
        own = element_rounds(n, blocks)
        assert np.unique(own, axis=0).shape[0] == n
        assert np.all((own[:, 2] < THREADS) & (own[:, 3] < PER))
        # one round holds the stream: every load before the barrier
        if n <= SMS * THREADS * PER:
            assert blocks == SMS and np.all(own[:, 1] == 0)
    # the rounds a block runs: every thread of it the same count
    rounds = [max(0, -(-(n - b * THREADS * PER) // (blocks * THREADS * PER)))
              for b in range(blocks)]
    assert max(rounds) - min(rounds) <= 1
    assert sum(rounds) * THREADS * PER >= n


def test_launch_blocks_is_a_function_of_the_length():
    """The plan: one block a streaming multiprocessor while one round of
    loads holds the stream, four beyond; the same answer every time."""
    one_round = SMS * THREADS * PER
    assert [launch_blocks(n) for n in (0, one_round, one_round + 1)] == [
        SMS, SMS, 4 * SMS]
    assert launch_blocks(43_281) == launch_blocks(43_281)
