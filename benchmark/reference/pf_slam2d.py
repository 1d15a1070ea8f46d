"""The check of a PFSlam2D run against the plain reference.

A particle filter's free run is chaotic (an ulp in a near-singular match
turns into another step), so the reference follows the filter from its own
state: at each update the run copied (drawn from the seed, among the
window's first updates, and one that re-organised the maps), it takes the
particles, weights and maps from before the update and computes the
update itself, then compares what the program held after it. The maps it
starts from are the program's counts (pools and resident grids); it works
the distance map out again from them. The start (every particle's map
after the first scan) is checked by itself against the first scan.

One update of the reference (src/pf_slam2d.cpp): every odometry packet
since the last update moves every particle by the motion model with its
normal draw (drawFromMotion, :365-391); every particle is scan-matched on
its own map (the plain Gauss-Newton IRLS of ``plain.match``) and weighted
by ``-SSE / meas_sigma`` of its residuals at the matched pose (:393-437);
the weights are normalised with Neff and, when Neff < N / 2, systematically
resampled with the update's uniform draw (:511-574); the scan goes into
every particle's map at its pose (:439-509). The draws are the filter's
own: a CPU ``torch.Generator`` seeded as the filter is, one ``randn(N,
3)`` a packet and one ``rand()`` an update, in the stream's order.

Numbers, each held to a limit from the configuration's ``check.limits``:
``pose_gap_m`` and ``pose_gap_rad`` (particles after the update),
``weight_gap`` (the accumulated log weights), ``resample_differ`` (the
share of particles whose ancestor differs), ``map_counts_differ`` and
``map_dist_differ`` (shares of cells, as in the Slam2D check),
``samples_missing`` (updates the run was to copy and did not).
"""

from __future__ import annotations

import math

import torch

from harness import traffic as traffic_mod
from reference import plain


def stream_odometry(lap, upto: int) -> list:
    """The odometry of stream scans 0 .. ``upto``."""
    st = traffic_mod.Stream(lap)
    return [st.next()[1] for _ in range(upto + 1)]


def draws(seed: int, record, n: int, wanted: set) -> dict:
    """{record index: (normal draws [fed, n, 3], uniform)} for the wanted
    updates, from the filter's generator replayed from the start."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, u in enumerate(record[1:], start=1):
        eps = [torch.randn((n, 3), generator=gen) for _ in range(u.fed)]
        uni = torch.rand((), generator=gen)
        if i in wanted:
            out[i] = (torch.stack(eps), uni)
        if i >= max(wanted, default=0):
            break
    return out


def increment(a, b):
    """a^-1 * b of (x, y, theta) odometry, as (x, y, cos, sin) from
    float64."""
    c, s = math.cos(a[2]), math.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    th = math.atan2(math.sin(b[2] - a[2]), math.cos(b[2] - a[2]))
    return (c * dx + s * dy, -s * dx + c * dy, math.cos(th), math.sin(th))


def motion(o: dict, pose, od, eps):
    """Every particle moved by one odometry increment ``od`` (x, y, cos,
    sin) with standard normal draws ``eps [N, 3]``."""
    dt = pose.dtype
    dx, dy = od[0], od[1]
    drot = torch.atan2(od[3], od[2])
    stt, str_ = o["stt"], o["str_"]
    srr, srt = o["srr"], o["srt"]
    sig_x = stt * dx.abs() + str_ * drot.abs() + 0.3 * stt * dy.abs()
    sig_y = stt * dy.abs() + str_ * drot.abs() + 0.3 * stt * dx.abs()
    sig_r = srr * drot.abs() + srt * torch.sqrt(dx * dx + dy * dy)
    eps = eps.to(dt)
    x = dx + eps[:, 0] * sig_x
    y = dy + eps[:, 1] * sig_y
    yaw = drot + eps[:, 2] * sig_r
    yaw = torch.atan2(torch.sin(yaw), torch.cos(yaw))
    step = torch.stack([x, y, torch.cos(yaw), torch.sin(yaw)], -1)
    return plain.compose(pose, step)


def resample(o: dict, weight, weight_sum, lik, u):
    """(ancestor index, weight, weight sum) after the normalisation and,
    when Neff < N / 2, systematic resampling with the uniform ``u``."""
    n = weight.shape[0]
    w = weight + lik
    ws = weight_sum + lik
    nw = torch.exp((w - w.max()) / (o["meas_sigma_gain"] * n))
    nw = nw / nw.sum()
    neff = 1.0 / torch.sum(nw * nw)
    ar = torch.arange(n, device=w.device)
    if float(neff) >= 0.5 * n:
        return ar, w, ws
    targets = (ar.to(w.dtype) + u.to(w.dtype)) / n
    cum = torch.cumsum(nw, 0)
    idx = torch.searchsorted(cum, targets, right=True).clamp(max=n - 1)
    return idx, torch.zeros_like(w), ws[idx]


def step(o, spec, sol, pre, origin, eps, ods, u, pts, mask, dtype):
    """One reference update from the program's state ``pre``."""
    n = pre["pose"].shape[0]
    dev = pre["pose"].device
    pose = pre["pose"].to(dtype)
    for k, od in enumerate(ods):
        pose = motion(o, pose, torch.tensor(od, dtype=torch.float64,
                                            device=dev).to(dtype),
                      eps[k].to(dev))
    grids = []
    states, liks = [], []
    for i in range(n):
        g = plain.Grid(origin, *pre["occ"].shape[1:], dev)
        g.occ, g.vis = pre["occ"][i].long(), pre["vis"][i].long()
        d2 = plain.capped_edt(g.obstacles(), spec)
        st, _ = plain.match(d2, origin, pose[i], pts, mask, spec, sol)
        d, _, _ = plain.interp(d2, origin, plain.apply(st, pts), spec)
        d = d * mask.to(dtype)
        states.append(st)
        liks.append(-torch.sum(d * d) / o["meas_sigma"])
        grids.append(g)
    states = torch.stack(states)
    idx, _, ws = resample(o, pre["weight"].to(dtype),
                          pre["weight_sum"].to(dtype), torch.stack(liks),
                          u.to(dev))
    pose = states[idx]
    occ, vis, d2 = [], [], []
    for i, src in enumerate(idx.tolist()):
        g = plain.Grid(origin, *pre["occ"].shape[1:], dev)
        g.occ, g.vis = grids[src].occ.clone(), grids[src].vis.clone()
        plain.deposit(g, pose[i:i + 1], pts[None], mask[None], spec)
        c_occ, c_vis = g.counts()
        occ.append(c_occ)
        vis.append(c_vis)
        d2.append(plain.capped_edt(g.obstacles(), spec))
    return {"pose": pose, "weight_sum": ws, "idx": idx,
            "occ": torch.stack(occ), "vis": torch.stack(vis),
            "d2": torch.stack(d2)}


def first_scan(lap, u, st, spec, beams, dtype) -> dict:
    """Counts and capped squared distance of the first scan alone, at its
    published pose, over the start's grid."""
    dev = st["occ"].device
    g = plain.Grid(st["origin"], *st["occ"].shape[1:], dev)
    pts, m = plain.scan(lap.points[u.scan], beams, dtype, dev)
    plain.deposit(g, plain.pose4(u.pose, dtype, dev)[None], pts[None],
                  m[None], spec)
    occ, vis = g.counts()
    return {"occ": occ, "vis": vis,
            "d2": plain.capped_edt(g.obstacles(), spec)}


def _shares(occ, vis, d2, want, ys, xs, r, max_sq):
    """(cells differing in counts, cells seen), (in distance, near), over
    the window ``ys, xs``; distances at least ``r`` cells from the grid's
    edge."""
    h, w = want["occ"].shape[-2:]
    o, v, d = (t[..., ys, xs] for t in (occ, vis, d2))
    wo, wv, wd = (want[k][..., ys, xs] for k in ("occ", "vis", "d2"))
    seen = (v > 0) | (wv > 0)
    counts = ((o != wo) | (v != wv)) & seen
    inner = torch.zeros((h, w), dtype=torch.bool, device=occ.device)
    inner[r:h - r, r:w - r] = True
    inner = inner[ys, xs]
    near = ((d < max_sq) | (wd < max_sq)) & inner
    dist = (d != wd) & near
    return (int(counts.sum()), int(seen.sum()), int(dist.sum()),
            int(near.sum()))


def numbers(lap, record, outputs, config, seed, device,
            dtype=torch.float32) -> dict:
    """The check's numbers for the program's run, or, with a ``dtype``
    below float32, for the control put in the program's place."""
    o = config["options"]
    spec = plain.MapSpec(o["resolution"], o["l2_max"])
    sol = plain.SolveSpec(o["max_iter"])
    n = o["particles"]
    beams = max(len(p) for p in lap.points)
    first = next(i for i, u in enumerate(record) if u.timed)
    samples = outputs["samples"]
    at = {first + s["ordinal"]: s for s in samples}
    rnd = draws(outputs["seed"], record, n, set(at))
    odo = stream_odometry(lap, max((record[i].j for i in at), default=0))
    gap_m = gap_r = gap_w = 0.0
    differ = counted = 0

    # the start: every particle's map is the first scan's
    st = outputs["start"]
    want = first_scan(lap, record[0], st, spec, beams, torch.float32)
    if dtype == torch.float32:
        got = st
    else:
        got = {k: v[None].expand(n, -1, -1) for k, v in
               first_scan(lap, record[0], st, spec, beams, dtype).items()}
    full = slice(None)
    tally = list(_shares(got["occ"], got["vis"], got["d2"], want, full,
                         full, spec.radius, spec.max_sq))

    for i, smp in sorted(at.items()):
        u = record[i]
        eps, uni = rnd[i]
        ods = [increment(odo[j - 1], odo[j])
               for j in range(u.j - u.fed + 1, u.j + 1)]
        pts, m = plain.scan(lap.points[u.scan], beams, dtype, device)
        ref = step(o, spec, sol, smp["pre"], smp["origin"], eps, ods, uni,
                   pts, m, torch.float32)
        if dtype == torch.float32:
            got = smp["post"]
            lineage = got["lineage"].long()
            want_lineage = (ref["idx"] if smp["reorg"]
                            else smp["pre"]["lineage"].long()[ref["idx"]])
        else:
            got = step(o, spec, sol, smp["pre"], smp["origin"], eps, ods,
                       uni, pts, m, dtype)
            lineage, want_lineage = got["idx"], ref["idx"]
        dp = (got["pose"].double() - ref["pose"].double())
        gap_m = max(gap_m, float(torch.hypot(dp[:, 0], dp[:, 1]).max()))
        ang = (torch.atan2(got["pose"][:, 3].double(),
                           got["pose"][:, 2].double())
               - torch.atan2(ref["pose"][:, 3].double(),
                             ref["pose"][:, 2].double()))
        gap_r = max(gap_r, float(torch.atan2(torch.sin(ang),
                                             torch.cos(ang)).abs().max()))
        gap_w = max(gap_w, float((got["weight_sum"].double()
                                  - ref["weight_sum"].double()).abs().max()))
        differ += int((lineage != want_lineage).sum())
        counted += n
        y0, x0, hh, ww = smp["post"]["window"]
        ys, xs = slice(y0, y0 + hh), slice(x0, x0 + ww)
        tally = [a + b for a, b in zip(tally, _shares(
            got["occ"], got["vis"], got["d2"], ref, ys, xs, spec.radius,
            spec.max_sq))]
    check = config["check"]
    want_reorg = check.get("reorg_samples", 0)
    n_reorg = min(sum(s["reorg"] for s in samples), want_reorg)
    missing = (max(0, check["samples"] - (len(samples) - n_reorg))
               + want_reorg - n_reorg)
    return {"pose_gap_m": gap_m, "pose_gap_rad": gap_r,
            "weight_gap": gap_w,
            "resample_differ": differ / max(counted, 1),
            "map_counts_differ": tally[0] / max(tally[1], 1),
            "map_dist_differ": tally[2] / max(tally[3], 1),
            "samples_missing": float(max(missing, 0))}
