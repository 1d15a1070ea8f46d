"""Standalone pose-graph optimization (the reference's SimplePGO).

reference: include/lama/simple_pgo.h:44-56, src/simple_pgo.cpp:48-105 —
nodes + odometry chain + loop edges + fixed priors, optimized with
minisam LM. Sigma conventions as the reference's:
* no fixed nodes -> prior on node 0 with sigmas (1, 1, 1);
* fixed nodes -> priors with sigmas (0.1, 0.1, 0.1);
* odometry chain between consecutive nodes, sigmas (0.5, 0.5, 0.1),
  measurement = node_i^-1 * node_{i+1} from the initial values;
* loop edges sigmas (0.5, 0.5, 0.1).

The solve runs on the CUDA device unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..core.pose import Pose2D
from ..nlls import factor_graph as fg
from .slam2d import resolve_device


@dataclasses.dataclass
class SimplePGO:
    """node_list / edge_list / fixed_list like the reference struct."""

    node_list: List[Pose2D] = dataclasses.field(default_factory=list)
    # (from, (to, relative pose))
    edge_list: List[Tuple[int, Tuple[int, Pose2D]]] = dataclasses.field(
        default_factory=list)
    fixed_list: List[Tuple[int, Pose2D]] = dataclasses.field(
        default_factory=list)
    device: object = None

    def optimize(self, opts: fg.PGOOptions = fg.PGOOptions()) -> bool:
        n = len(self.node_list)
        if n == 0:
            return False
        dev = resolve_device(self.device)

        b = fg.GraphBuilder()
        if not self.fixed_list:
            b.add_prior(0, self.node_list[0].se2_array(), (1.0, 1.0, 1.0))
        else:
            for idx, pose in self.fixed_list:
                b.add_prior(idx, pose.se2_array(), (0.1, 0.1, 0.1))

        for i in range(n - 1):
            diff = self.node_list[i] - self.node_list[i + 1]
            b.add_between(i, i + 1, diff.se2_array(), (0.5, 0.5, 0.1))

        for frm, (to, rel) in self.edge_list:
            b.add_between(frm, to, rel.se2_array(), (0.5, 0.5, 0.1))

        graph = b.finalize(dev)
        n_pad = fg.GraphBuilder._bucket(n)
        nodes = np.tile(np.array([0, 0, 1, 0], np.float32), (n_pad, 1))
        for i, p in enumerate(self.node_list):
            nodes[i] = p.se2_array()
        active = np.zeros(n_pad, bool)
        active[:n] = True

        out, _ = fg.optimize(torch.as_tensor(nodes, device=dev), graph,
                             torch.as_tensor(active, device=dev), opts)
        out = out.cpu().numpy()
        if not np.isfinite(out[:n]).all():
            return False
        for i in range(n):
            self.node_list[i] = Pose2D.from_se2_array(out[i])
        return True
