"""The check of a GraphSlam2D run against the plain reference.

The reference (include/lama/graph_slam2d.h, src/graph_slam2d.cpp) is
followed from the program's own state (teacher forcing), piece by piece,
on the program's record (the node's journal of its key poses, factors,
dispatched and harvested batches, optimisations and publications):

- the front end: at sampled updates of the window, the scan is matched
  from the program's prediction (the previous matched pose composed with
  the odometry increment) on a copy of the program's resident distance
  window made before the update, by the plain Gauss-Newton IRLS of
  ``plain.match``;
- the key-pose gate (graph_slam2d.cpp:199-207) is replayed over the
  program's matched trajectory in float32: a key fires when the matched
  pose has moved 1 m or turned 0.5 pi from the last key's;
- every candidate search (:284-313): the adaptive radius ``max^r *
  min^(1 - r)``, ``r = min(accdist, 100) / 100``, over the key poses'
  positions as the search saw them, the last ``ignore_n_chain_poses`` keys
  left out, the ``loop_max_candidates`` closest kept;
- the verification (:315-355): every query's accepted candidate by the
  reference's order (fine rank 0; else the coarse fallback on rank 0; else
  the first fine rank 1+) from the program's own RMSEs, against the loop
  factors the program added; at sampled dispatches, each row's two
  one-step solves (from the candidate's pose and from the query's position
  with the candidate's heading), the full solve from the better one
  (Huber 0.15, at most 100 steps) and the nearest-cell RMSE; at sampled
  coarse batches (:357-392), each job's coarse field (the query's scan at
  its pose on a 0.25 m grid, its exact distance capped at 2.5 m), the full
  solve of the candidate's scan on it, the full solve on the live map from
  there and the RMSE; each in plain torch on a copy of the map the
  program read;
- the correction (:209-232, :416-425), replayed on the program's key
  poses (their slam-frame poses, held to the trajectory above) and its
  optimised key poses: each key's corrected pose, the rows' poses in the
  slam frame, the distance the search radius grew from, each
  optimisation's start, the key poses of each publication and the pose
  published after every window update (the correction on top of the front
  end's pose);
- the factors: the prior, each chain factor ``key_i^-1 * key_j`` and each
  loop factor ``s^-1 * ref`` (the matched state ``s`` of the row or job
  the acceptance order took: the plain one where sampled, else the
  program's, and ``ref`` the query's pose in the slam frame), built by the
  check itself and held against those the program added;
- the pose graph (:394-430): a plain dense float64 Levenberg-Marquardt on
  the check's factors with the reference's noise models (prior 0.01, chain
  0.25 / 0.25 / 0.15, loop 0.5 / 0.5 / 0.1 with Huber 0.1), from the
  check's key poses, at every optimisation (the one the node asks for
  after the window among them);
- the published map (:131-164): every key scan deposited at the check's
  key poses of the last publication, counts and the capped distance map.

Numbers, each held to a limit from the configuration's ``check.limits``:
``pose_gap_m`` and ``pose_gap_rad`` (the front end's sampled matches),
``keys_differ`` (key updates the gate and the program do not share, and
program keys whose raw pose is not the matched pose of its update),
``candidates_differ`` (searches whose candidate list differs),
``rmse_gap`` and ``coarse_rmse_gap`` (the largest RMSE gap over the
sampled rows or coarse jobs that either side puts within the coarse
acceptance, 2 x 0.05 m), ``decisions_differ`` (accepted loops that the
reference's order and the program's factors do not share, plus sampled
rows and jobs whose acceptance differs, those whose plain RMSE lies within
the RMSE limit of the acceptance not counted), ``factor_gap_m`` and
``factor_gap_rad`` (the factors), ``correction_gap_m`` and
``correction_gap_rad`` (the correction's replay), ``pgo_gap_m`` and
``pgo_gap_rad`` (the optimised key poses), ``pgo_chi2_excess`` (their chi2
over the plain optimum's, as a share: how far the program's LM stopped
short of its stop rules), ``map_counts_differ`` and ``map_dist_differ``
(shares of cells, as in the Slam2D check) and ``samples_missing``
(front-end, verification and coarse samples the run was to copy and did
not, and a window without a publication).

The control (:func:`numbers` with a ``dtype`` below float32) puts the
reference, computed in that precision, in the program's place: the front
end's matches, the key gate, the candidate searches, the sampled rows and
jobs, the correction's replay and the factors, the LM (its nodes held in
that precision) and the published map's deposit. The acceptance order's
replay reads the program's own RMSEs, so the control leaves it as it is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import plain
from reference import slam2d as ref_slam

HUBER_MATCH = 0.15                     # graph_slam2d.cpp:327, 363
PRIOR_SIGMA = (0.01, 0.01, 0.01)       # :198
CHAIN_SIGMA = (0.25, 0.25, 0.15)       # :227
LOOP_SIGMA = (0.5, 0.5, 0.1)           # :266
LOOP_HUBER = 0.1
COARSE = plain.MapSpec(0.25, 2.5)      # the coarse field (:357-392)
COARSE_MARGIN = 2.0                    # m round the sensor's reach
KEY_TOL = 1e-4                         # m and rad: a key's raw pose against
#                                        its update's matched pose (float32
#                                        rounding of the prior aside)


def _xyr(p) -> tuple:
    st = p.double().cpu().numpy()
    return (st[0], st[1], math.atan2(st[3], st[2]))


def _events(outputs, name: str) -> list:
    return [r for r in outputs["journal"] if r["event"] == name]


def key_updates(outputs, record, hz: float) -> list:
    """Record indices of the program's key poses (from their time
    stamps)."""
    at = {u.j: i for i, u in enumerate(record)}
    return [at[int(round(k["ts"] * hz))] for k in _events(outputs, "key")]


# -- the front end ------------------------------------------------------

def front_gaps(lap, record, outputs, config, dtype, device) -> dict:
    fe = config["front_end"]
    spec = plain.MapSpec(fe["resolution"], fe["l2_max"])
    sol = plain.SolveSpec(fe["max_iter"])
    beams = max(len(p) for p in lap.points)
    first = next(i for i, u in enumerate(record) if u.timed)
    got, want = {}, {}
    for f in outputs["front"]:
        i = first + f["ordinal"]
        prev, cur = record[i - 1], record[i]
        d2 = f["d2"].to(device)

        def solve(dt):
            pts, m = plain.scan(lap.points[cur.scan], beams, dt, device)
            pose0 = ref_slam._prediction(prev, cur.odom, dt, device)
            return _xyr(plain.match(d2, f["origin"], pose0, pts, m, spec,
                                    sol)[0])

        want[i] = solve(torch.float32)
        got[i] = (_xyr(ref_slam.pose_of(cur, torch.float64, "cpu"))
                  if dtype == torch.float32 else solve(dtype))
    return ref_slam.pose_gaps(got, want)


# -- the key-pose gate --------------------------------------------------

def _inverse(g):
    c, s, tx, ty = g[..., 2], g[..., 3], g[..., 0], g[..., 1]
    return torch.stack([-(c * tx + s * ty), -(-s * tx + c * ty), c, -s], -1)


def gate(raw, kd: float, ka: float, block: int = 256) -> list:
    """Update indices of the key poses the gate fires on over matched
    poses ``raw [N, 4]`` (float32, CPU): key 0 at update 0, then each
    update whose pose is ``kd`` from, or ``ka`` turned from, the last
    key's."""
    keys, last, i = [0], raw[0], 1
    while i < len(raw):
        rel = plain.compose(_inverse(last)[None], raw[i:i + block])
        d2 = rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]
        ang = torch.abs(torch.atan2(rel[:, 3], rel[:, 2]))
        fire = torch.nonzero((d2 >= kd * kd) | (ang >= ka))
        if len(fire) == 0:
            i += block
            continue
        i += int(fire[0, 0])
        keys.append(i)
        last = raw[i]
        i += 1
    return keys


def keys_differ(record, outputs, config, hz: float, dtype) -> float:
    """Key updates the gate (in ``dtype``) and the program do not share,
    and program keys whose raw pose is not their update's matched pose;
    the control's gate in ``dtype`` takes the program's place."""
    o = config["options"]
    raw = torch.tensor([u.raw for u in record], dtype=torch.float32)
    want = gate(raw, o["key_pose_distance"],
                o["key_pose_angular_distance"])
    got = (key_updates(outputs, record, hz) if dtype == torch.float32 else
           gate(raw.to(dtype), o["key_pose_distance"],
                o["key_pose_angular_distance"]))
    differ = len(set(want) ^ set(got))
    for i, k in zip(got, _events(outputs, "key")):
        p, q = k["raw"], _xyr(raw[i])
        dth = math.atan2(math.sin(p[2] - q[2]), math.cos(p[2] - q[2]))
        differ += (math.hypot(p[0] - q[0], p[1] - q[1]) > KEY_TOL
                   or abs(dth) > KEY_TOL)
    return float(differ)


# -- candidate search and the acceptance order --------------------------

def candidates(xy, qid: int, accdist: float, o: dict,
               dtype=torch.float64) -> list:
    """The radius search of key ``qid`` over key positions ``xy [n, 2]``
    as the search saw them, in ``dtype``."""
    r = min(accdist, 100.0) / 100.0
    radius = (o["loop_search_max_distance"] ** r
              * o["loop_search_min_distance"] ** (1.0 - r))
    limit = len(xy) - o["ignore_n_chain_poses"]
    if limit <= 0:
        return []
    p = torch.as_tensor(xy, dtype=torch.float64).to(dtype)
    d = torch.sqrt(torch.sum((p[:limit] - p[qid]) ** 2, -1))
    order = torch.argsort(d, stable=True).tolist()
    sel = [i for i in order if float(d[i]) <= radius and i != qid]
    return sel[:o["loop_max_candidates"]]


def harvested(outputs) -> dict:
    """{kind: {(query, candidate): packed row (state, RMSE)}} of every
    batch the program read."""
    out = {"verify": {}, "coarse": {}}
    for h in _events(outputs, "harvest"):
        for pair, row in zip(h["pairs"], h["packed"]):
            out[h["kind"]][tuple(pair)] = np.asarray(row, np.float64)
    return out


def search_and_order(outputs, o: dict, got: dict, dtype) -> tuple:
    """(searches whose candidates differ, accepted loops the order and the
    program's factors do not share, {(candidate, query): the kind of the
    row the order accepted}); the control's search in ``dtype`` takes the
    program's place."""
    thr = o["loop_closure_scan_rmse"]
    coarse = {k: float(v[4]) for k, v in got["coarse"].items()}
    differ, accepted = 0, {}
    for d in _events(outputs, "dispatch"):
        per_q: dict = {}
        for q, c, _, _ in d["rows"]:
            row = got["verify"].get((q, c))
            per_q.setdefault(q, []).append(
                (c, math.inf if row is None else float(row[4])))
        for q in d["queries"]:
            mine = ([c for c, _ in per_q.get(q, [])]
                    if dtype == torch.float32 else
                    candidates(d["xy"], q, d["accdist"], o, dtype))
            differ += mine != candidates(d["xy"], q, d["accdist"], o)
        for q, res in per_q.items():
            (c0, e0), rest = res[0], res[1:]
            if e0 <= thr:
                accepted[(c0, q)] = "verify"
                continue
            if coarse.get((q, c0), math.inf) <= 2.0 * thr:
                accepted[(c0, q)] = "coarse"
                continue
            for c, e in rest:
                if e <= thr:
                    accepted[(c, q)] = "verify"
                    break
    links = {(f["i"], f["j"]) for f in _events(outputs, "factor")
             if f["loop"]}
    return (float(differ), float(len(set(accepted) ^ links)), accepted)


# -- the sampled rows and coarse jobs -----------------------------------

def hmatch(d2, origin, pose0, pts, mask, spec, max_iter: int):
    """``plain.match``'s Gauss-Newton IRLS with the verification's Huber
    weights ``min(1, k / |r|)``; returns the pose."""
    fm = mask.to(pose0.dtype)

    def weighted(state):
        hits = plain.apply(state, pts)
        dist, gx, gy = plain.interp(d2, origin, hits, spec)
        r = dist * fm
        gx, gy = gx * fm, gy * fm
        jw = gy * hits[:, 0] - gx * hits[:, 1]
        sw = torch.sqrt(torch.where(r < HUBER_MATCH, torch.ones_like(r),
                                    HUBER_MATCH / torch.clamp(r.abs(),
                                                              min=1e-30)))
        r = r * sw
        return r, torch.stack([gx, gy, jw], -1) * sw[:, None], torch.sum(r * r)

    state = pose0
    r, J, chi2 = weighted(state)
    for _ in range(max_iter):
        A = (J[:, :, None] * J[:, None, :]).sum(0)
        g = (J * r[:, None]).sum(0)
        if float(g.abs().max()) < 1e-4:
            break
        h = plain._solve3(A, g)
        if float(h.abs().max()) < 1e-4:
            break
        cand = plain.compose(plain.exp(h), state)
        nr, nJ, nchi2 = weighted(cand)
        if not float(chi2 - nchi2) > 0.0:
            break
        state, r, J, chi2 = cand, nr, nJ, nchi2
    return state


def rmse(d2, origin, state, pts, mask, spec):
    """Nearest-cell RMSE (match_surface_2d.cpp:92-116); cells off the grid
    read the capped distance."""
    dt = state.dtype
    cell = plain.w2m(plain.apply(state, pts), spec)
    lx, ly = cell[:, 0] - origin[0], cell[:, 1] - origin[1]
    h, w = d2.shape
    ok = (lx >= 0) & (lx < w) & (ly >= 0) & (ly < h)
    v = d2[ly.clamp(0, h - 1), lx.clamp(0, w - 1)].to(dt)
    res = torch.as_tensor(spec.resolution, dtype=dt)
    d = torch.where(ok, torch.sqrt(v) * res,
                    torch.as_tensor(spec.max_dist, dtype=dt,
                                    device=v.device)) * mask.to(dt)
    n = torch.clamp(mask.sum(), min=1).to(dt)
    return float(torch.sqrt(torch.sum(d * d) / n))


def verify_row(d2, origin, ref_xyr, cand_xyr, pts, mask, spec, dtype,
               device) -> tuple:
    """One (query, candidate) row's dual-hypothesis verification: (the
    matched state, its RMSE)."""
    cand = plain.pose4(cand_xyr, dtype, device)
    hypo = plain.pose4((ref_xyr[0], ref_xyr[1], cand_xyr[2]), dtype, device)
    s0 = hmatch(d2, origin, cand, pts, mask, spec, 1)
    s1 = hmatch(d2, origin, hypo, pts, mask, spec, 1)
    e0 = rmse(d2, origin, s0, pts, mask, spec)
    e1 = rmse(d2, origin, s1, pts, mask, spec)
    s = hmatch(d2, origin, s0 if e0 < e1 else s1, pts, mask, spec, 100)
    return s, rmse(d2, origin, s, pts, mask, spec)


def coarse_row(d2, origin, ref_xyr, cand_xyr, ref_scan, scan, spec, side,
               dtype, device) -> tuple:
    """One coarse job (graph_slam2d.cpp:357-392): the query's scan
    ``ref_scan`` as obstacles on a ``side``-cell square of 0.25 m cells
    centred on its pose, their exact distance capped at 2.5 m, the full
    Huber solve of the candidate's ``scan`` on that field from the
    candidate's pose, then on the live map; (the state, its RMSE)."""
    ref = plain.pose4(ref_xyr, dtype, device)
    ref_pts, ref_mask = ref_scan
    pts, mask = scan
    cells = plain.w2m(plain.apply(ref, ref_pts), COARSE)
    org = plain.w2m(ref[:2], COARSE) - side // 2
    loc = cells - org
    ok = ref_mask & (loc >= 0).all(-1) & (loc < side).all(-1)
    obst = torch.zeros((side, side), dtype=torch.bool, device=device)
    obst[loc[ok, 1], loc[ok, 0]] = True
    field = plain.capped_edt(obst, COARSE)
    corg = (int(org[0]), int(org[1]))
    s0 = hmatch(field, corg, plain.pose4(cand_xyr, dtype, device), pts, mask,
                COARSE, 100)
    s = hmatch(d2, origin, s0, pts, mask, spec, 100)
    return s, rmse(d2, origin, s, pts, mask, spec)


def sampled(lap, record, outputs, config, limits: dict, dtype,
            device) -> dict:
    """Over the sampled rows and coarse jobs: the largest RMSE gaps of
    each kind, the rows and jobs whose acceptance differs, and the plain
    matched states, {(kind, query, candidate): (x, y, theta)}, of the
    reference (``want``) and of the control (``got``)."""
    fe, o = config["front_end"], config["options"]
    spec = plain.MapSpec(fe["resolution"], fe["l2_max"])
    thr = o["loop_closure_scan_rmse"]
    side = 2 * math.ceil((config["sensor"]["max_range_m"] + COARSE.l2_max
                          + COARSE_MARGIN) / COARSE.resolution)
    beams = max(len(p) for p in lap.points)
    keys = key_updates(outputs, record, lap.hz)

    def scan(k, dt):
        return plain.scan(lap.points[record[keys[k]].scan], beams, dt,
                          device)

    def solve(kind, d2, org, q, c, ref, cand, dt):
        if kind == "verify":
            return verify_row(d2, org, ref, cand, *scan(c, dt), spec, dt,
                              device)
        return coarse_row(d2, org, ref, cand, scan(q, dt), scan(c, dt), spec,
                          side, dt, device)

    out = {"rmse_gap": 0.0, "coarse_rmse_gap": 0.0, "differ": 0,
           "want": {}, "got": {}}
    for kind, accept, name in (("verify", thr, "rmse_gap"),
                               ("coarse", 2.0 * thr, "coarse_rmse_gap")):
        for smp in outputs["samples"][kind]:
            d2 = smp["map"]["d2"].to(device)
            org = smp["map"]["origin"]
            for (q, c, ref, cand), e_prog in zip(smp["rows"], smp["errs"]):
                s, want = solve(kind, d2, org, q, c, ref, cand,
                                torch.float32)
                out["want"][(kind, q, c)] = _xyr(s)
                got = float(e_prog)
                if dtype != torch.float32:
                    s, got = solve(kind, d2, org, q, c, ref, cand, dtype)
                    out["got"][(kind, q, c)] = _xyr(s)
                if min(want, got) <= 2.0 * thr:
                    out[name] = max(out[name], abs(want - got))
                if (abs(want - accept) > limits[name]
                        and (want <= accept) != (got <= accept)):
                    out["differ"] += 1
    return out


# -- the correction and the factors -------------------------------------

def _p(xyr, dt):
    return torch.as_tensor(np.asarray(xyr, np.float64)).to(dt)


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _compose(a, b):
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                        a[..., 1] + s * b[..., 0] + c * b[..., 1],
                        _wrap(a[..., 2] + b[..., 2])], -1)


def _between(a, b):
    """``a^-1 * b`` (Pose2D's operator-)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy,
                        _wrap(b[..., 2] - a[..., 2])], -1)


def _invert(a):
    return _between(a, torch.zeros_like(a))


def _se2_xyr(g) -> np.ndarray:
    g = np.asarray(g, np.float64)
    return np.stack([g[..., 0], g[..., 1], np.arctan2(g[..., 3], g[..., 2])],
                    -1)


def replay(outputs, record, states: dict, accepted: dict, got: dict,
           dt) -> dict:
    """The correction's bookkeeping and the factors, in ``dt``, on the
    program's key poses (slam frame) and optimised key poses, with the loop
    factors' states from ``states`` where sampled, else from the program's
    harvest ``got``. Returns the check's values beside the program's, in
    the journal's order (each [k, 3] float64): ``correction`` and
    ``correction_prog``, ``factor`` and ``factor_prog``; ``factors``
    [(i, j, measurement (x, y, theta), loop)] and ``optimizes`` (each: the
    start, the factors so far, the program's result, the window flag);
    ``published`` (the key poses of the last publication, and its record)."""
    C = torch.zeros(3, dtype=dt)
    keys, raws, factors, refs = [], [], [], {}
    accdist = 0.0
    corr, corr_prog, fac, fac_prog = [], [], [], []
    optimizes, published, marks = [], None, [(-1, C)]

    def held(mine, prog):
        corr.append(mine.double().reshape(-1, 3))
        corr_prog.append(torch.as_tensor(np.asarray(prog, np.float64))
                         .reshape(-1, 3))

    for rec in outputs["journal"]:
        ev = rec["event"]
        if ev == "key":
            raw = _p(rec["raw"], dt)
            if raws:
                accdist += float(torch.linalg.norm(
                    _between(raws[-1].double(), raw.double())[:2]))
            keys.append(_compose(C, raw))
            raws.append(raw)
            held(keys[-1], rec["pose"])
        elif ev == "factor":
            i, j = rec["i"], rec["j"]
            if i == j:
                want = keys[i]
            elif not rec["loop"]:
                want = _between(keys[i], keys[j])
            else:
                kind = accepted.get((i, j), "verify" if (j, i) in
                                    got["verify"] else "coarse")
                s = states.get((kind, j, i))
                if s is None:
                    row = got[kind].get((j, i))
                    s = None if row is None else _se2_xyr(row[:4])
                if s is None or (j, i) not in refs:
                    continue
                want = _between(_p(s, dt), refs[(j, i)])
            factors.append((i, j, want.double().numpy(), rec["loop"]))
            fac.append(want.double().reshape(1, 3))
            fac_prog.append(torch.as_tensor(_se2_xyr(rec["m"])).reshape(1, 3))
        elif ev == "dispatch":
            corr.append(torch.tensor([[accdist, 0.0, 0.0]],
                                     dtype=torch.float64))
            corr_prog.append(torch.tensor([[rec["accdist"], 0.0, 0.0]],
                                          dtype=torch.float64))
            inv = _invert(C)
            for q, c, ref, cand in rec["rows"]:
                refs[(q, c)] = _compose(inv, keys[q])
                held(refs[(q, c)], ref)
                held(_compose(inv, keys[c]), cand)
        elif ev == "optimize":
            start = torch.stack(keys)
            held(start, _se2_xyr(rec["start"]))
            optimizes.append({"start": start.double().numpy(),
                              "factors": list(factors), "out": rec["out"],
                              "window": rec["window"]})
            if rec["out"] is not None:
                keys = list(_p(_se2_xyr(rec["out"]), dt))
                C = _compose(keys[-1], _invert(raws[-1]))
                accdist = 0.0
                marks.append((rec["at"], C))
        elif ev == "publish":
            published = (torch.stack(keys).double().numpy(), rec)
    # the pose published after each window update: the correction as it
    # stood when the update returned, on top of the front end's pose
    ats = [a for a, _ in marks]
    upd = [i for i, u in enumerate(record) if u.timed]
    seg = np.searchsorted(ats, upd, side="right") - 1
    for m in np.unique(seg):
        idx = [u for u, s in zip(upd, seg) if s == m]
        raw = _p(_se2_xyr([record[u].raw for u in idx]), dt)
        held(_compose(marks[m][1], raw), [record[u].pose for u in idx])
    return {"correction": torch.cat(corr), "correction_prog":
            torch.cat(corr_prog), "factor": torch.cat(fac) if fac else
            torch.zeros((0, 3), dtype=torch.float64),
            "factor_prog": torch.cat(fac_prog) if fac_prog else
            torch.zeros((0, 3), dtype=torch.float64),
            "optimizes": optimizes, "published": published}


def _gaps(a, b) -> tuple:
    """The largest position and heading gaps between rows of [k, 3]."""
    if len(a) == 0:
        return 0.0, 0.0
    d = a - b
    return (float(torch.hypot(d[:, 0], d[:, 1]).max()),
            float(_wrap(d[:, 2]).abs().max()))


# -- the pose graph -----------------------------------------------------

def _log(g):
    """SE(2) logarithm (v1, v2, theta) in float64."""
    tx, ty, c, s = g[:, 0], g[:, 1], g[:, 2], g[:, 3]
    th = torch.atan2(s, c)
    small = th.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(th), th)
    sinc = torch.where(small, 1.0 - th * th / 6.0, torch.sin(safe) / safe)
    cosc = torch.where(small, th / 2.0, (1.0 - torch.cos(safe)) / safe)
    det = sinc * sinc + cosc * cosc
    return torch.stack([(sinc * tx + cosc * ty) / det,
                        (-cosc * tx + sinc * ty) / det, th], -1)


def _retract(x, delta):
    return plain.compose(x, plain.exp(delta))


def _factor_residuals(x, fac, dxi, dxj):
    """Whitened residuals [F, 3] of every factor at nodes ``x`` [n, 4]
    with the tangent steps ``dxi``, ``dxj`` [F, 3] on their two nodes."""
    xi = _retract(x[fac["i"]], dxi)
    xj = _retract(x[fac["j"]], dxj)
    rel = torch.where(fac["prior"][:, None], xj,
                      plain.compose(_inverse(xi), xj))
    return fac["w"] * _log(plain.compose(_inverse(fac["meas"]), rel))


def _huber(r, k):
    """sqrt of minisam's Huber weight on each residual's norm [F]."""
    n = torch.sqrt(torch.sum(r * r, -1))
    return torch.sqrt(torch.where((k > 0) & (n > k),
                                  k / n.clamp(min=1e-300),
                                  torch.ones_like(n)))


def _chi2(x, fac) -> float:
    zero = torch.zeros((len(fac["i"]), 3), dtype=x.dtype, device=x.device)
    r = _factor_residuals(x, fac, zero, zero)
    return float(torch.sum((r * _huber(r, fac["huber"])[:, None]) ** 2))


def _linearize(x, fac, h: float = 1e-6):
    """Residuals [F, 3] and central-difference Jacobians on each factor's
    two nodes [F, 3, 3] (a prior's first node is unused: its block is 0),
    Huber-scaled as minisam scales them."""
    zero = torch.zeros((len(fac["i"]), 3), dtype=x.dtype, device=x.device)
    r = _factor_residuals(x, fac, zero, zero)
    cols_i, cols_j = [], []
    for k in range(3):
        e = zero.clone()
        e[:, k] = h
        cols_i.append((_factor_residuals(x, fac, e, zero)
                       - _factor_residuals(x, fac, -e, zero)) / (2 * h))
        cols_j.append((_factor_residuals(x, fac, zero, e)
                       - _factor_residuals(x, fac, zero, -e)) / (2 * h))
    s = _huber(r, fac["huber"])[:, None]
    return (r * s, torch.stack(cols_i, -1) * s[..., None],
            torch.stack(cols_j, -1) * s[..., None])


def lm(x, fac, max_iter: int = 50, rtol: float = 1e-6, held=None):
    """Levenberg-Marquardt (minisam: lambda 1e-5, x0.1 on a better step,
    x10 on a worse one, the diagonal damped) to its stop rules: the
    relative fall of chi2 below ``rtol`` or a step below 1e-8. ``held``:
    a precision the nodes are rounded to after each step (the control)."""
    n = x.shape[0]
    lam = 1e-5
    i, j = fac["i"], fac["j"]
    for _ in range(max_iter):
        r, Ji, Jj = _linearize(x, fac)
        chi2 = float(torch.sum(r * r))
        H = torch.zeros((n, n, 3, 3), dtype=x.dtype, device=x.device)
        g = torch.zeros((n, 3), dtype=x.dtype, device=x.device)
        for a, Ja in ((i, Ji), (j, Jj)):
            g.index_put_((a,), torch.einsum("fab,fa->fb", Ja, r),
                         accumulate=True)
            for b, Jb in ((i, Ji), (j, Jj)):
                H.index_put_((a, b), torch.einsum("fab,fac->fbc", Ja, Jb),
                             accumulate=True)
        H = H.permute(0, 2, 1, 3).reshape(3 * n, 3 * n)
        Hd = H + torch.diag(lam * torch.diagonal(H))
        delta = torch.linalg.solve(Hd, -g.reshape(-1)).reshape(n, 3)
        new = _retract(x, delta)
        if held is not None:
            new = new.to(held).to(x.dtype)
        new_chi2 = _chi2(new, fac)
        better = new_chi2 < chi2
        lam = min(max(lam * (0.1 if better else 10.0), 1e-9), 1e6)
        if better:
            x = new
        if ((better and abs(chi2 - new_chi2) / max(chi2, 1e-12) < rtol)
                or float(delta.abs().max()) < 1e-8):
            break
    return x


def factors(facs, device) -> dict:
    """Factors [(i, j, measurement (x, y, theta), loop)] with the
    reference's noise models, as float64 tensors (a prior has i == j)."""
    prior = [i == j for i, j, _, _ in facs]
    loop = [lp for _, _, _, lp in facs]
    sig = [PRIOR_SIGMA if p else LOOP_SIGMA if lp else CHAIN_SIGMA
           for p, lp in zip(prior, loop)]

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return {"i": t([f[0] for f in facs], torch.int64),
            "j": t([f[1] for f in facs], torch.int64),
            "meas": _se2([f[2] for f in facs], device), "w": 1.0 / t(sig),
            "prior": t(prior, torch.bool),
            "huber": t([LOOP_HUBER if lp else 0.0 for lp in loop])}


def _se2(xyr, device):
    x = torch.as_tensor(np.asarray(xyr), dtype=torch.float64, device=device)
    return torch.stack([x[:, 0], x[:, 1], torch.cos(x[:, 2]),
                        torch.sin(x[:, 2])], -1)


def pgo_gaps(book, control, dtype, device) -> dict:
    """Every optimisation (the window's, the warm-up's and the node's
    after the window) against the plain LM on the check's
    factors from the check's start: the largest position and heading gaps
    of the optimised key poses, and the largest excess of their chi2 over
    the plain LM's, as a share of it (both in float64 with the reference's
    noise models). The control's LM starts from, and holds its nodes in,
    ``dtype``, on the control's factors."""
    gm = gr = excess = 0.0
    theirs = control["optimizes"] if control else book["optimizes"]
    for rec, ctl in zip(book["optimizes"], theirs):
        if rec["out"] is None:
            continue
        fac = factors(rec["factors"], device)
        want = lm(_se2(rec["start"], device), fac)
        got = (torch.as_tensor(rec["out"], dtype=torch.float64,
                               device=device)
               if control is None else
               lm(_se2(ctl["start"], device), factors(ctl["factors"],
                                                      device),
                  held=dtype))
        got = _se2(_se2_xyr(got.cpu().numpy()), device)
        c_want, c_got = _chi2(want, fac), _chi2(got, fac)
        excess = max(excess, (c_got - c_want) / max(c_want, 1e-300))
        d = (got - want).cpu().numpy()
        gm = max(gm, float(np.max(np.hypot(d[:, 0], d[:, 1]))))
        th = torch.atan2(got[:, 3], got[:, 2]) - torch.atan2(want[:, 3],
                                                             want[:, 2])
        gr = max(gr, float(torch.atan2(torch.sin(th),
                                       torch.cos(th)).abs().max()))
    return {"pgo_gap_m": gm, "pgo_gap_rad": gr, "pgo_chi2_excess": excess}


# -- the published map --------------------------------------------------

def rebuild(lap, record, outputs, poses, config, dtype, device) -> dict:
    """The plain map of the first ``len(poses)`` key scans at ``poses``
    ([n, 3], the check's key poses of the last publication)."""
    fe = config["front_end"]
    spec = plain.MapSpec(fe["resolution"], fe["l2_max"])
    keys = key_updates(outputs, record, lap.hz)[:len(poses)]
    se2 = plain.pose4(poses, torch.float32, device)
    beams = max(len(p) for p in lap.points)
    margin = config["sensor"]["max_range_m"] + (spec.radius + 4) * \
        spec.resolution
    xy = se2[:, :2].double().cpu().numpy()
    lo = np.floor((xy.min(0) - margin) * spec.scale).astype(int)
    hi = np.ceil((xy.max(0) + margin) * spec.scale).astype(int)
    grid = plain.Grid((int(lo[0]), int(lo[1])), int(hi[1] - lo[1]),
                      int(hi[0] - lo[0]), device)
    for a in range(0, len(keys), ref_slam.BLOCK):
        block = keys[a:a + ref_slam.BLOCK]
        pts, masks = zip(*(plain.scan(lap.points[record[k].scan], beams,
                                      dtype, device) for k in block))
        plain.deposit(grid, se2[a:a + len(block)].to(dtype),
                      torch.stack(pts), torch.stack(masks), spec)
    occ, vis = grid.counts()
    d2 = plain.capped_edt(grid.obstacles(), spec)
    return {"origin": grid.origin, "occ": occ.cpu().numpy(),
            "vis": vis.cpu().numpy(), "d2": d2.cpu().numpy()}


def numbers(lap, record, outputs, config, seed, device,
            dtype=torch.float32) -> dict:
    """The check's numbers for the program's run, or, with a ``dtype``
    below float32, for the control put in the program's place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fe, o, check = config["front_end"], config["options"], config["check"]
    limits = check["limits"]
    max_sq = plain.MapSpec(fe["resolution"], fe["l2_max"]).max_sq
    sound = dtype == torch.float32
    out = front_gaps(lap, record, outputs, config, dtype, device)
    out["keys_differ"] = keys_differ(record, outputs, config, lap.hz, dtype)
    got = harvested(outputs)
    out["candidates_differ"], order_differ, accepted = search_and_order(
        outputs, o, got, dtype)
    smp = sampled(lap, record, outputs, config, limits, dtype, device)
    out["rmse_gap"] = smp["rmse_gap"]
    out["coarse_rmse_gap"] = smp["coarse_rmse_gap"]
    out["decisions_differ"] = order_differ + smp["differ"]
    book = replay(outputs, record, smp["want"], accepted, got,
                  torch.float64)
    ctl = (None if sound else
           replay(outputs, record, smp["got"], accepted, got, dtype))
    mine = book if sound else ctl
    out["factor_gap_m"], out["factor_gap_rad"] = _gaps(
        mine["factor" if ctl else "factor_prog"], book["factor"])
    out["correction_gap_m"], out["correction_gap_rad"] = _gaps(
        mine["correction" if ctl else "correction_prog"],
        book["correction"])
    out.update(pgo_gaps(book, ctl, dtype, device))
    pub = book["published"]
    if pub is not None:
        want = rebuild(lap, record, outputs, pub[0], config, torch.float32,
                       device)
        mapped = (pub[1]["map"] if sound else
                  rebuild(lap, record, outputs, ctl["published"][0], config,
                          dtype, device))
        out.update(ref_slam.compare_maps(mapped, want, max_sq))
    else:
        out.update({"map_counts_differ": 0.0, "map_dist_differ": 0.0})
    missing = (max(0, check["samples"] - len(outputs["front"]))
               + max(0, check["verify_samples"]
                     - len(outputs["samples"]["verify"]))
               + max(0, check["coarse_samples"]
                     - len(outputs["samples"]["coarse"]))
               + (pub is None or pub[1]["window"] is not True))
    out["samples_missing"] = float(missing)
    return out
