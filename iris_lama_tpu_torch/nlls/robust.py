"""Robust cost weight functions (IRLS weights) on tensors.

reference: include/lama/nlls/robust_cost.h:42-76,
src/nlls/robust_cost.cpp:36-83. ``weight(x)`` is w(x); the IRLS solver
scales residual rows by sqrt(w) (src/nlls/solver.cpp:69-77). The scan
matchers use Cauchy; the pose-graph front end of GraphSlam2D uses Huber.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RobustCost:
    """Static spec; ``weight(x)`` evaluates elementwise."""

    kind: str = "unit"      # unit | cauchy | tukey | tstudent | huber
    param: float = 1.0

    def weight(self, x):
        x = x.to(torch.float32)
        if self.kind == "unit":
            return torch.ones_like(x)
        if self.kind == "cauchy":
            # w = 1 / (1 + x^2 / c^2)   (robust_cost.cpp:66-73)
            c = 1.0 / (self.param * self.param)
            return 1.0 / (1.0 + x * x * c)
        if self.kind == "tukey":
            # w = (1 - x^2/b^2)^2 for |x| <= b else 0  (robust_cost.cpp:41-54)
            bb = self.param * self.param
            t = 1.0 - (x * x) / bb
            return torch.where(x * x <= bb, t * t, 0.0)
        if self.kind == "tstudent":
            # w = (dof + 1) / (dof + x^2)  (robust_cost.cpp:56-63)
            return (self.param + 1.0) / (self.param + x * x)
        if self.kind == "huber":
            # w = 1 if x < k else k/|x|  (robust_cost.cpp:75-83)
            k = self.param
            return torch.where(x < k, 1.0,
                               k / torch.clamp(torch.abs(x), min=1e-30))
        raise ValueError(f"unknown robust cost: {self.kind}")


UNIT = RobustCost("unit")
# Tukey's default b (robust_cost.h:52)
TUKEY_DEFAULT = RobustCost("tukey", 4.685)
# The scan matchers hardwire Cauchy(0.15) (src/slam2d.cpp:106, loc2d.cpp:70)
CAUCHY_SCAN = RobustCost("cauchy", 0.15)
