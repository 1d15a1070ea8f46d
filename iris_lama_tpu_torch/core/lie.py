"""SO(2), SE(2), SO(3) and SE(3) as functions on tensors.

SE(2): tensor [..., 4] = (tx, ty, cos(theta), sin(theta)) in float32 — the
unit complex number instead of the angle avoids trig in ``compose``
(Sophus' SO2 storage). SO(3): unit quaternion [..., 4] = (w, x, y, z).
SE(3): [..., 7] = (tx, ty, tz, qw, qx, qy, qz). Tangent (twist)
conventions as in Sophus: SE(2) (v1, v2, omega) (se2.hpp:389 ``exp``),
SE(3) (v, omega) in R^6 (se3.hpp ``exp``). Every function broadcasts over
leading batch dimensions and keeps its inputs' device.
"""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# SO(2)
# ---------------------------------------------------------------------------

def so2_from_angle(theta):
    """Angle -> unit complex (cos, sin)."""
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def so2_log(cs):
    """Unit complex -> angle in (-pi, pi] (Sophus so2.hpp log)."""
    return torch.atan2(cs[..., 1], cs[..., 0])


def so2_mul(a, b):
    """Complex multiplication (rotation composition)."""
    ca, sa = a[..., 0], a[..., 1]
    cb, sb = b[..., 0], b[..., 1]
    return torch.stack([ca * cb - sa * sb, ca * sb + sa * cb], dim=-1)


# ---------------------------------------------------------------------------
# SE(2)
# ---------------------------------------------------------------------------


def se2(tx, ty, theta, device=None):
    """Build SE(2) element(s) from scalars/arrays (float32)."""
    tx, ty, theta = torch.broadcast_tensors(
        torch.as_tensor(tx, dtype=torch.float32, device=device),
        torch.as_tensor(ty, dtype=torch.float32, device=device),
        torch.as_tensor(theta, dtype=torch.float32, device=device))
    return torch.stack([tx, ty, torch.cos(theta), torch.sin(theta)], dim=-1)


def se2_identity(shape=(), device=None):
    out = torch.zeros(tuple(shape) + (4,), dtype=torch.float32,
                      device=device)
    out[..., 2] = 1.0
    return out


def se2_translation(g):
    return g[..., 0:2]


def se2_angle(g):
    return torch.atan2(g[..., 3], g[..., 2])


def se2_compose(a, b):
    """a * b (group product, Sophus se2.hpp operator*)."""
    ca, sa = a[..., 2], a[..., 3]
    cb, sb = b[..., 2], b[..., 3]
    tx = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    ty = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    c = ca * cb - sa * sb
    s = sa * cb + ca * sb
    return torch.stack([tx, ty, c, s], dim=-1)


def se2_inverse(g):
    """g^-1 (Sophus se2.hpp inverse)."""
    c, s = g[..., 2], g[..., 3]
    tx, ty = g[..., 0], g[..., 1]
    itx = -(c * tx + s * ty)
    ity = -(-s * tx + c * ty)
    return torch.stack([itx, ity, c, -s], dim=-1)


def se2_apply(g, p):
    """Transform 2D point(s) p [..., 2] by g."""
    c, s = g[..., 2], g[..., 3]
    x, y = p[..., 0], p[..., 1]
    return torch.stack([g[..., 0] + c * x - s * y,
                        g[..., 1] + s * x + c * y], dim=-1)


def _sinc_cosc(theta):
    """(sin t / t, (1 - cos t) / t) with a Taylor branch near 0 — the
    entries of the SE(2) left Jacobian V used by exp (se2.hpp:389-417)."""
    small = torch.abs(theta) < 1e-4
    t2 = theta * theta
    # sin(t)/t ~ 1 - t^2/6;  (1-cos t)/t ~ t/2 - t^3/24
    safe = torch.where(small, torch.ones_like(theta), theta)
    sinc = torch.where(small, 1.0 - t2 / 6.0, torch.sin(safe) / safe)
    cosc = torch.where(small, theta / 2.0 - t2 * theta / 24.0,
                       (1.0 - torch.cos(safe)) / safe)
    return sinc, cosc


def se2_exp(xi):
    """Exponential map: twist (v1, v2, omega) -> SE(2) (se2.hpp:389)."""
    v1, v2, w = xi[..., 0], xi[..., 1], xi[..., 2]
    sinc, cosc = _sinc_cosc(w)
    tx = sinc * v1 - cosc * v2
    ty = cosc * v1 + sinc * v2
    return torch.stack([tx, ty, torch.cos(w), torch.sin(w)], dim=-1)


def se2_log(g):
    """Logarithm map: SE(2) -> twist (v1, v2, omega) (se2.hpp:178)."""
    theta = se2_angle(g)
    tx, ty = g[..., 0], g[..., 1]
    sinc, cosc = _sinc_cosc(theta)
    # V = [[sinc, -cosc], [cosc, sinc]]; det = sinc^2 + cosc^2
    det = sinc * sinc + cosc * cosc
    v1 = (sinc * tx + cosc * ty) / det
    v2 = (-cosc * tx + sinc * ty) / det
    return torch.stack([v1, v2, theta], dim=-1)


def se2_adjoint(g):
    """Adjoint matrix [..., 3, 3] (se2.hpp:125)."""
    c, s = g[..., 2], g[..., 3]
    tx, ty = g[..., 0], g[..., 1]
    z = torch.zeros_like(c)
    o = torch.ones_like(c)
    rows = [torch.stack([c, -s, ty], dim=-1),
            torch.stack([s, c, -tx], dim=-1),
            torch.stack([z, z, o], dim=-1)]
    return torch.stack(rows, dim=-2)


# ---------------------------------------------------------------------------
# SO(3) — quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_identity(shape=(), device=None):
    out = torch.zeros(tuple(shape) + (4,), dtype=torch.float32,
                      device=device)
    out[..., 0] = 1.0
    return out


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q):
    return torch.stack([q[..., 0], -q[..., 1], -q[..., 2], -q[..., 3]],
                       dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_apply(q, v):
    """Rotate vector(s) v [..., 3] by quaternion q."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def so3_exp(w):
    """Rotation vector -> quaternion (so3.hpp exp); a Taylor branch below
    1e-5 rad."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-5
    half = 0.5 * theta
    # sin(t/2)/t ~ 0.5 - t^2/48
    safe = torch.where(small, torch.ones_like(theta), theta)
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / safe)
    qw = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([qw[..., None], k[..., None] * w], dim=-1)


def so3_log(q):
    """Quaternion -> rotation vector (so3.hpp log), angle in (-pi, pi]."""
    qw = q[..., 0]
    qv = q[..., 1:4]
    n = torch.sqrt(torch.sum(qv * qv, dim=-1))
    small = n < 1e-7
    safe_n = torch.where(small, torch.ones_like(n), n)
    angle = 2.0 * torch.atan2(n, qw)
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    k = torch.where(small, 2.0 / torch.where(qw == 0, torch.ones_like(qw),
                                             qw), angle / safe_n)
    return k[..., None] * qv


# ---------------------------------------------------------------------------
# SE(3) — (t[3], q[4])
# ---------------------------------------------------------------------------

def se3(t, q, device=None):
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    q = torch.as_tensor(q, dtype=torch.float32, device=device)
    return torch.cat([t, q], dim=-1)


def se3_identity(shape=(), device=None):
    out = torch.zeros(tuple(shape) + (7,), dtype=torch.float32,
                      device=device)
    out[..., 3] = 1.0
    return out


def se3_translation(g):
    return g[..., 0:3]


def se3_quat(g):
    return g[..., 3:7]


def se3_compose(a, b):
    t = se3_translation(a) + quat_apply(se3_quat(a), se3_translation(b))
    q = quat_mul(se3_quat(a), se3_quat(b))
    return torch.cat([t, q], dim=-1)


def se3_inverse(g):
    qc = quat_conj(se3_quat(g))
    return torch.cat([-quat_apply(qc, se3_translation(g)), qc], dim=-1)


def se3_apply(g, p):
    return se3_translation(g) + quat_apply(se3_quat(g), p)


def se3_exp(xi):
    """Twist (v, w) in R^6 -> SE(3) (se3.hpp exp)."""
    v, w = xi[..., 0:3], xi[..., 3:6]
    q = so3_exp(w)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-5
    one = torch.ones_like(theta)
    safe2 = torch.where(small, one, theta2)
    safe3 = torch.where(small, one, theta2 * theta)
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe2)
    b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / safe3)
    wxv = _cross(w, v)
    wxwxv = _cross(w, wxv)
    t = v + a[..., None] * wxv + b[..., None] * wxwxv
    return torch.cat([t, q], dim=-1)


def se3_log(g):
    """SE(3) -> twist (v, w)."""
    w = so3_log(se3_quat(g))
    t = se3_translation(g)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-5
    one = torch.ones_like(theta)
    safe2 = torch.where(small, one, theta2)
    half = 0.5 * theta
    # coefficient of w x (w x t) in V^-1
    cot = (1.0 - half * torch.cos(half)
           / torch.where(small, one, torch.sin(half))) / safe2
    cot = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, cot)
    wxt = _cross(w, t)
    wxwxt = _cross(w, wxt)
    v = t - 0.5 * wxt + cot[..., None] * wxwxt
    return torch.cat([v, w], dim=-1)
