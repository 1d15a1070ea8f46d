#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (iris_lama_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # every group, in one process
    python3 chip_smoke.py --group NAME    # one group, at full depth

Groups (each after the device and build phases): ``slam`` (phases 3-5,
12, 16), ``pf`` (6-8), ``loc`` (9-11), ``lo`` (13-15), ``graph``
(17-20), ``maps`` (21-23), ``spill`` (24-26), ``3d`` (27), ``parallel``
(28). The run of every group (no argument, ``--group all``) has the
1,200 s limit of one call, so it cuts repeats, never a check: each bench
workload's repeats to one pass (phases 5, 8, 11, 15 and 19), the
profiled passes that count device activities to 20 (11), 25 (15) and 40
(19) scans and 2 updates (23), each timing's calls to a quarter, and in
phase 28 the pool path's updates to one and GN-CG at world 4 over gloo to
bench_pgo.py's graph (the 16,384-node graph runs there at world 1); a
group's own run keeps the full depth. Every check against a plain
version, every CPU-against-card prefix, warm-up pass and bound stays.

Phases, one JSON line each:

1. device — the card's name, and its name and power limit as nvidia-smi
   reports them;
2. build — compiles the hand-written CUDA kernels of
   iris_lama_tpu_torch/csrc (one nvcc per source, all at once) and prints
   each kernel's registers, shared memory and spills (ptxas -v);
3. kernels — each kernel against its plain PyTorch version at the main
   path's shapes (bit-equal required; B3 also at shapes that are no
   multiple of its tile, radii 1, 5, 10, and its large-radius kernel at R =
   65, 100 and 254; B1 on the scan's beam-ordered free-space stream, timed
   there, shuffled and with sentinels, alone and as the map update's pair
   with the hits, the pair's yardsticks ``index_put_`` and ``index_add_``;
   B2 also at uint8, int16 and int32; the whole solve B4, Slam2D's match
   on the card, on the main path's own inputs after phase 4 and at every
   width), with its device time per call
   (torch.profiler) beside the plain version's, a one-call PyTorch
   yardstick's and the bytes/ops bound; beside them the CUDA-event time
   per call of back-to-back calls (host enqueue included): ``kernel_ms``,
   ``plain_events_ms``, ``library_events_ms``;
4. prefix — the first 60 scans of the main path on the CPU (plain
   versions) and on the card (kernels); trajectories within 1 mm / 1e-3
   rad, resident grids compared cell by cell; every match of the card's
   run recorded ([wm, wm] int8 sub-window, the 768-beam bucket and its
   mask, the predicted pose, Slam2D's solver options) and solved again by
   B4 and by its plain version: bit-equal state, iterations, chi2 and
   likelihood, and the run's own result (phase 3's B4 entries);
5. main_path — the Slam2D bench workload (synthetic office world,
   SimConfig(n_steps=440, seed=3), 720 beams, 5 cm cells) replayed through
   Slam2D.update_many_prepadded from device-staged scans: scans/s, ATE (<
   12 mm), re-orgs, zero escapes, no IRLS stop flag read on the host;
   then the kernels of one more, untimed pass (rep 0's: a counted pass,
   below): launches > 0 (the deposit through the pair), one B4 launch a
   matched update and no B2 over the whole pass;
6. pf_kernel — the particle filter's kernels at the bench_pf.py shapes (30
   particles, 720 beams padded to 768, 5 cm cells) on a real particle set:
   the batched Gauss-Newton solve B6 (also at uint8, int16 and int32 on
   the same windows), the batched deposit and pair and the batched EDT,
   each bit-equal to its plain version, with times and bounds as in phase
   3; B6 also at 1, 255, 257, 1100, 2049, 3000 and 4096 beams, on the
   largest window it stages in shared memory and on windows at odd byte
   offsets, at every width, max_iter 0, 1 and 50, with and without the
   likelihood; the batched EDT also at P = 3, on border-only masks and at
   ragged shapes; the motion kernel on a queue of 21 packets (the
   benchmark's ~21 packets an update), bit-equal to 21 eager
   ``draw_from_motion`` calls, with its launch floor and the host ms of a
   whole flush beside the per-packet loop it replaced;
7. pf_prefix — the first 24 PFSlam2D updates of that workload on the CPU
   (plain versions) and on the card (kernels), one seed, through the run's
   first band scroll: the same resample indices, best particle, scrolls
   and window origin, resident grids compared. A control run (the card
   again, the motion draws scaled by 1 + 3e-7) shows what an ulp-sized
   change does to particles on this trajectory: at most twice its count
   of particle-updates beyond 1 mm / 1e-3 rad, and every particle within
   1 mm / 1e-3 rad or twice the control's largest move. Before the
   scroll's scan, the scroll alone from the card run's state on both,
   bit-equal;
8. pf_main_path — the bench_pf.py workload (SimConfig(n_steps=120,
   seed=5), its PFSlam2DOptions) through PFSlam2D.update_prepadded from
   device-staged scans, three fresh filters: updates/s, final error (< 5
   cm), re-orgs, escapes, peak memory, match iterations; then launches per
   update of one more, untimed pass (rep 0's, counted): one motion launch
   an update;
9. loc_kernel — Loc2D's kernels at the bench_loc.py shapes (720 beams
   padded to 768, 5 cm cells, 576 x 576 match windows of the bench map):
   the whole solve B4 at one particle and at eight with a scan each (and
   at 255, 257, 2048, 2049 and 4096 beams, on windows read from global
   memory and staged in shared memory, at every width, max_iter 0, 1 and
   50, with and without the likelihood), the fused evaluation B5 and the
   corner selection B2 on the scan's cells at a real pose (operands as the
   fused loop passes them: strided views), B4 and B5 also at uint8, int16
   and int32, and the value scatters B7 / B8 on a Slam2D deposit stream
   into [448, 512] (B7 with values 1 and -3..3, B8 on the words unsorted
   and sorted; also moved into [768, 1024], a larger grid, and with every
   element on one cell over 20 calls), each bit-equal to its plain
   version, with times and bounds as in phase 3 and, for B2, B5, B7 and
   B8, the launch floor (an empty kernel of the same launch shape,
   csrc/floor.cu; B7/B8's a cooperative launch, also with its one grid
   barrier); B7/B8 also with their blocks, one device activity a call
   (their device time per recorded activity: the profiler can drop an
   event) and, beside ``zeros`` + ``index_put_(accumulate=True)``, a second
   yardstick ``zeros`` + ``index_add_`` (atomics); B5 also at 1, 255,
   257, 1100, 2048, 2049, 3000 and 4096 beams, P = 1 and 3, cells off the
   window on every side, an all-masked scan, strided and contiguous
   operands, a grid at an odd byte offset and operands expanded with a
   stride of 0; B2 on grids of every width modulo 4 at byte offsets 0-3
   with the last column and row, indices contiguous and strided;
10. loc_prefix — the first 60 Loc2D updates of that workload on the CPU
   (plain versions) and on the card (kernels) in the "solve" and "fused"
   match modes, on one map built on the card and carried to the CPU as
   numpy: the same accepted scans, poses within 1 mm / 1e-3 rad; and one
   3000-hypothesis global-localisation round on both from the same draws,
   picking the same hypothesis;
11. loc_main_path — the bench_loc.py workload (SimConfig(n_steps=200,
   seed=7, laps=1), its Loc2DOptions, the map built by Slam2D over the log)
   in each match mode (generic, sq, solve, fused) through
   Loc2D.update_many_prepadded from device-staged scans: 3 reps of one
   fresh pass (bench_loc.py runs 3; cut to keep the run's time) after a
   warm-up pass: updates/s (median rep), mean error (< 1 cm), host reads
   per update, peak memory, and the kernels' launches and all device
   activities per update of the first 41 scans of one more (profiled)
   pass; then one pass of the
   live Loc2D.update API, the time of one global-localisation round and of the
   covariance (loc_extra);
12. fine_slam2d, fine_pf — Slam2D at 4 cm cells (uint8 windows) and 3 cm
   (int16) over the first 40 scans of the phase 5 workload, and PFSlam2D
   at 4 cm over the first 6 updates of the phase 8 workload, on the CPU
   and on the card, each card run made again, untimed, under the
   profiler: the same accepted scans, resample decisions and best
   particle, poses within 1 mm / 1e-3 rad, and B4 (Slam2D, one launch a
   matched scan) or B6 (PF) launched at that width (the element type in
   the kernel's name);
13. lo_kernels — LidarOdometry2D's kernels on the bench_lidar.py workload's
   first scan and window (720 beams padded to 768, 5 cm cells, a 640 x 640
   window, 1 m rays of 22 steps, l2_max 1 m): B1's pair into [2, 640, 640]
   and B3 at R = 20, cap 400 (on the scan's obstacles and on random masks),
   each bit-equal to its plain version, with times, bounds and launch
   floors as in phase 3;
14. lo_prefix — the first 60 scans of that workload on the CPU (plain
   versions) and on the card (kernels): poses within 1 mm / 1e-3 rad, the
   same refresh decisions and patch counts, and the maps through the dense
   window around the last pose (visits and meters equal, log-odds within
   4e-6, but for at most 0.1% of the cells: ulp-different poses, as in
   phase 4); then one map update from the card's state at its last pose on
   both devices: pool tables, visits and meters equal, log-odds within
   4e-6;
15. lo_main_path — the bench_lidar.py workload (SimConfig(n_steps=1600,
   seed=3, smooth=4), LidarOdometry2DOptions(resolution=0.05,
   max_range=10.0, capacity=4096)) through LidarOdometry2D.update_prepadded
   from device-staged scans: a 100-scan warm-up, then 3 reps of the 1,600
   scans (bench_lidar.py runs 5), each rep's first scan moved by rep·1e-4
   m as there: scans/s (median rep), drift m/100 m per rep and the median
   (< 8, bench_lidar.py's bound on a device), diverged reps (> 3x the
   median), the final error, host reads per scan, refreshes, the pool's
   peak patch count and overflow (0), peak memory; then device
   activities, the kernels' launches and device time a scan over 100
   scans of a profiled pass (lo_profiled);
16. slam2d_transient, slam2d_pool — the phase 5 workload with
   ``transient_map=True`` and with ``resident_window=False``: the first 60
   scans on the CPU and on the card compared as in phase 4 (the maps
   through the dense window around the last pose), then one full pass on
   the card: scans/s, ATE (the pool path < 12 mm; the transient map within
   1 mm of the JAX package's 18.71 mm on this workload,
   ref_slam2d_options.py: it forgets what the loop would close on), zero
   escapes, and B1, B3 and B4 launched in one more, untimed pass
   (counted);
17. graph_kernels — GraphSlam2D's map rebuild and coarse fields on the
   key poses of a warm-up pass of the bench_graph.py workload
   (SimConfig(n_steps=300, seed=8), 720 beams padded to 768, 5 cm cells):
   B1's pair over every key-pose scan into the rebuild grid (one launch of
   millions of elements), B3 on that grid (R = 10), on the coarse
   fallback's [4, 116, 116] fields (R = 10) and on the coarse distance
   map's 0.1 m grid at R = 50 (cap 2,500), each ``torch.equal`` to its
   plain version, with times, bounds and launch floors as in phase 3;
18. graph_prefix — the first 60 scans of that workload through the
   per-scan GraphSlam2D.update_prepadded on the CPU and on the card: the
   same key-pose update indices, key poses within 1 mm / 1e-3 rad; then one
   verification batch from one state (the card's, carried to both) within
   1e-5;
19. graph_main_path — the bench_graph.py workload through
   GraphSlam2D.update_many_prepadded from device-staged scans: a warm-up
   pass, then 3 reps (each rep's prior moved by rep·1e-4 m, as there),
   each rep followed by generate_occupancy_map and
   generate_coarse_distance_map: scans/s (median rep) and spread,
   key-pose ATE (< 0.15 m) and loop closures (>= 4) of the median rep
   (bench_graph.py's bounds), key poses, optimizes, the ``stats`` phase
   counters, solver host reads a sync, peak memory, the maps' times and
   patch counts, beside the JAX package's figures on the same workload
   (ref_graph_slam2d.py, on the CPU); each phase 17 shape's launches (the
   warm-up pass's coarse fallback, the last rep's two maps made again),
   counted on the profiler's trace; B1/B3/B4 launches (each > 0) of one
   more, untimed pass (rep 0's, counted); then device activities, device
   time and the ``stats`` split of the first 150 scans of one more pass
   under torch.profiler (graph_profiled);
20. pgo — bench_pgo.py's 512-node graph with 32 loop closures: ms per
   solve over 5 solves after one, the mean error of every 16th node (<
   3 cm), nodes within 1e-3 of the CPU port's at the end of the
   productive steps after a rigid SE(2) alignment (at float32's floor
   every step is noise and an ulp of input turns this chain about its one
   prior: the final differences are printed beside a CPU control's),
   beside the JAX package's iterations and error;
21. occupancy_apply — the standalone frequency and probabilistic states'
   updates (``frequency_apply_counts``, ``probabilistic_apply``) on the
   cells of the phase 5 workload's first scan (768 endpoints + 768 x 202
   ray cells, duplicates included) on the CPU and on the card: the states
   ``torch.equal``; the time of an apply into an empty and into a filled
   state (no kernel: ``index_add_`` scatter-adds);
22. file_workflow — bench_loc.py's workload through files: Slam2D builds
   the map on the card (B1's pair, B2, B3 at phase 3's shapes); its
   frequency, simple and distance maps are written as .smd files and its
   occupancy as a PNG (the same bytes as from the map moved to the CPU),
   read back onto the card (equal to the in-memory maps on a dense probe
   of the map's box; write -> read -> write gives the same bytes), and a
   fresh Loc2D(match="solve") (B4 and B2 at phase 9's shapes) localises
   the 199 updates on the loaded maps (mean error < 1 cm): write and read
   times, file sizes, both drivers' launches (each run under the
   profiler);
23. pf_pool_kernel, pf_pool_prefix, pf_pool_main_path — PFSlam2D with
   ``resident_window=False`` on the phase 8 workload: B6 on every
   particle's pool window (``[30,512,512]``), B1's pair and B3 on one
   particle's map-update window (512²), each bit-equal to its plain
   version with times and bounds as in phase 3; the first ``PF_PREFIX``
   updates on the CPU and on the card under phase 7's bounds and control
   (every particle's pool through the resident window compared), and the
   resident path on the card, which the pool path equals bit for bit;
   one pass on the card: updates/s, final error (< 5 cm), peak memory;
   the kernels' launches and all device activities per update of one
   more, untimed pass (counted).

24. slam_spill — Slam2D with the host spill tier (``use_compression``,
   capacity SPILL_CAPACITY) over the first SPILL_SCANS scans of the
   corridor world's figure-8 route (SimConfig(n_steps=1200, seed=4,
   world="corridor"), 720 beams to 10 m, examples/run_long_world.py's
   odometry noise and Slam2D options), against the unbounded pool path
   (capacity SPILL_REF_CAPACITY) on the card: trajectories and
   ``full_map()`` against the unbounded map key by key ``torch.equal``,
   the unbounded run above the bound, no overflow, spills, refills and
   cache hits fired, ``full_map()`` through a .smd file with more patches
   than the live pool; patches, store bytes, each spill's and refill's
   ms, host reads per update, scans/s of both runs, ATE, launches (each
   run made again, untimed, and counted);
25. pf_spill — PFSlam2D with the per-particle spill tier over the first
   PF_SPILL_SCANS scans of tests/test_pf_spill.py's corridor route
   (n_steps=400) at 720 beams and 5 cm, bench_pf.py's options (30
   particles) at capacity PF_SPILL_CAPACITY, against capacity
   PF_SPILL_REF_CAPACITY without the tier: poses, weights and resident
   distance grids ``torch.equal``, the same best particle, its merged map
   equal to the unbounded particle map key by key, pools at or below high
   water at the end, no overflow, spills and refills fired; updates/s,
   re-orgs, store bytes (shared blobs once), memory, launches (each run
   made again, untimed, and counted);
26. summary_slam2d, summary_pf — bench.py's first SUMMARY_SCANS scans and
   bench_pf.py's first 60 updates with ``create_summary`` and
   ``detailed_summary``, the trajectories (particles) ``torch.equal`` to
   the same scans without them; both reports, beside the card's name and
   power limit.
27. maps3d_prefix, maps3d_main_path — the 3D maps at the reference's
   default sizes (5 cm cells, 16^3 patches; ``frequency3``, ``simple3``,
   ``probabilistic3`` and the distance map at capacity 4,096, l2_max 0.5
   m: R = 10; the TSDF at its constructor's defaults, capacity 8,192) on
   ROOM3D_CLOUDS clouds of a 16-ring scanner (-15 to +15 degrees, 1,024
   azimuths, 12 m, 1 cm noise) at SE(3) poses along a loop in a 12 x 8 x 3
   m room with six boxes: the first ROOM3D_PREFIX clouds on the CPU and on
   the card (integer state ``torch.equal``, log-odds within 4e-6, TSDF
   within rtol 1e-5 and the observed set equal, 100,000 trilinear reads of
   the distance map and the TSDF within 1e-5, mesh triangle counts within
   0.5%); then every cloud on the card, one map at a time: ms a cloud,
   device activities and device ms a cloud (torch.profiler over
   PROFILED_CLOUDS more clouds, the top device ops), peak memory,
   ``update3``'s dirty count and carry, ``to_mesh``'s time and triangles,
   and the three occupancy states through .smd files (the same bytes as
   from the state moved to the CPU; read back onto the card and written
   again: the same bytes). No hand-written kernel runs on this path.
28. parallel_kernel, parallel_pf_pool, parallel_pf_resident,
   parallel_rebuild, parallel_pgo — the parallel paths
   (parallel/{pf_sharding, distributed_pgo, map_rebuild}.py) in spawned
   ranks of one ``torch.distributed`` group (parallel/group.py), at world
   1 over NCCL and at world 4 over gloo with the four ranks on cuda:0 (one
   card: NCCL takes one rank a device; gloo moves the collectives' bytes
   through the host), and at world 4 over NCCL, one rank a card, when the
   machine has four. The parent runs each part unsharded on the card first
   (the reference, one file the ranks memory-map) and checks B6, B1's
   pair and B3 ``torch.equal`` to their plain versions at a world-4
   rank's share (B6 on 128 pool windows and on 128 resident sub-windows,
   the pair and B3 on 128 resident update windows, the pair over 18 of the
   rebuild's key scans, B3 on a rebuild strip with its halos), with times
   and bounds as in phase 3. Each rank then runs, each part but GN-CG
   made again from the same start after its timed run, untimed, for its
   launches on the rank's device trace: the PF pool path at
   bench_pf_scale.py's size (512 particles, 720 beams, 5 cm, capacity
   512, max_iter 16; the first scan, then 3 updates, one in the run of
   every group, the last with its weights spread so that it resamples and
   most pools change rank; updates/s, the bytes
   the row exchanges moved, resample indices, poses and weights
   ``torch.equal``, every pool cell compared); the PF resident path at
   __graft_entry__.dryrun_multichip's size (512 particles, 0.1 m) through
   tests/test_pf_slam2d.py's three sharded steps (plain, forced resample,
   forced re-org), compared as the pool path; GN-CG on bench_pgo.py's
   512-node graph and on a 16,384-node one (world W against world 1 and
   the card against the CPU within PAR_PGO_ATOL, raw and after a rigid
   alignment, finite nodes, non-increasing chi2, the dense LM's error beside); and
   bench_graph.py's rebuild through ``generate_occupancy_map(mesh=...)``,
   bit-equal. A rank that fails or hangs fails the phase.

Launches are counted on torch.profiler's device trace, by the kernel names
of ``utils/devprof.py``. A counted pass (phases 5, 8, 16, 19, 23-25) is
one more pass of the phase's workload by a fresh driver, untimed, each
COUNT_WINDOW scans of it a profile of its own (phases 5 and 8: the pass
made twice, each window's larger count kept), since the profiler drops
stretches of long profiles (PERF.md §7).

Each group ends with a ``group`` line (its seconds). Then the ``kernels``
line (each entry's ``launches`` from its main path's counted pass; phase
28's
new shapes count the world-4 ranks' launches; phases 22,
24, 25 and 28's counts under ``path_launches``, each with the
shape that path sent the kernel, which may differ from the shape the
entry's times were measured at) and, last,
``{"ok":
true, "device": {...}}``.
Any failure raises and exits non-zero; without a CUDA device, or without
the package beside this script, it exits non-zero before printing a
result.
"""

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor float32 (int32 alike)
ATE_BOUND_M = 0.012            # bench.py:144
PREFIX_SCANS = 60
PF_PREFIX = 24                 # PF updates compared CPU vs card
PF_SCROLL_SCAN = 22            # the bench_pf.py run's first re-org: a scroll
PF_ERR_BOUND_M = 0.05          # bench_pf.py:109
PF_MOTION_PACKETS = 21         # packets an update behind pf30's 0.5 m gate
LOC_PREFIX = 60                # Loc2D updates compared CPU vs card
LOC_ERR_BOUND_M = 0.01         # bench_loc.py:127
LOC_PASSES = 1                 # Loc2D passes a rep (bench_loc.py: 3)
LOC_PROFILED = 41              # Loc2D scans of the profiled pass
WIDTHS = ("uint8", "int16", "int32")   # squared-distance widths past int8
FINE_SCANS = 40                # Slam2D scans at 4 and 3 cm, CPU vs card
FINE_PF = 6                    # PF updates at 4 cm, CPU vs card
LO_SCANS = 1600                # bench_lidar.py's scans a rep
LO_WARMUP = 100                # LidarOdometry2D warm-up scans
LO_REPS = 3                    # LidarOdometry2D reps (bench_lidar.py: 5)
LO_PREFIX = 60                 # LidarOdometry2D scans, CPU vs card
LO_PROFILED = 100              # LidarOdometry2D scans of the profiled pass
LO_DRIFT_BOUND = 8.0           # bench_lidar.py:106, m/100 m on a device
LO_ATOL = 4e-6                 # log-odds, CPU vs card
# Slam2D's transient map on the phase 5 workload: the JAX package's ATE on
# the CPU (ref_slam2d_options.py); a transient map has no loop closure, so
# bench.py's 12 mm bound does not apply to it
TRANSIENT_ATE_REF_M = 0.018708577
TRANSIENT_ATE_TOL_M = 0.001


# phase 27: the 3D maps at the reference's default sizes
ROOM3D = (12.0, 8.0, 3.0)      # the room's extent (m), the floor at z = 0
ROOM3D_CLOUDS = 40             # scanner poses along a loop
ROOM3D_PREFIX = 8              # clouds compared CPU vs card
ROOM3D_RINGS = 16              # -15 to +15 degrees
ROOM3D_AZIMUTHS = 1024
ROOM3D_RANGE = 12.0            # m
ROOM3D_NOISE = 0.01            # m, range noise
DIST3_MAX_DIRTY = 2048         # update3's drain a cloud
ROOM3D_QUERIES = 100_000       # trilinear reads compared CPU vs card
TSDF_RTOL = 1e-5
INTERP_ATOL = 1e-5
MESH_TRI_RTOL = 0.005
PROFILED_CLOUDS = 3            # clouds a map under torch.profiler

GROUPS = ("slam", "pf", "loc", "lo", "graph", "maps", "spill", "3d",
          "parallel")

_START = []   # main()'s start on the host clock
_ONE_REP = [False]   # main(): the ``all`` run cuts each bench's repeats to 1


def bench_reps(n: int) -> int:
    """A bench workload's repeats: ``n`` in a group's own run, one when
    every group runs in one process (its time limit)."""
    return 1 if _ONE_REP[0] else n


def depth(full: int, cut: int) -> int:
    """A profiled pass's length or a timing's calls: ``full`` in a group's
    own run, ``cut`` when every group runs in one process (its time
    limit)."""
    return cut if _ONE_REP[0] else full


def emit(obj) -> None:
    """Print one JSON line; a phase line also gets the seconds since the
    run started (``elapsed_s``)."""
    if "phase" in obj and _START:
        obj = {**obj, "elapsed_s": time.perf_counter() - _START[0]}
    print(json.dumps(obj), flush=True)


def cuda_time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=None)
def devprof():
    """The port's ``utils/devprof.py`` beside this script, loaded by path:
    the A/B scripts import this file with an older checkout's package on
    the path."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "iris_lama_tpu_torch", "utils", "devprof.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_devprof", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(torch, fn, reps: int) -> tuple:
    """(device ms per call, timing source): the device time of everything
    ``fn`` launches, from torch.profiler over ``reps`` calls; where the
    profiler reports no device time, the CUDA-event time per call of
    back-to-back calls (which then includes the host's enqueue time)."""
    dp = devprof()
    fn()
    us = dp.device_us(dp.cuda_rows(dp.profile_calls(fn, reps)))
    if us > 0:
        return us / 1e3 / reps, "profiler"
    return cuda_time_ms(torch, fn, reps), "events"


def timings(torch, prefix: str, fn, reps: int) -> dict:
    """``<prefix>ms``: device time per call; ``<prefix>events_ms`` (for the
    kernel itself ``kernel_ms``): CUDA events around ``reps`` back-to-back
    calls, per call — host enqueue included, which dominates at µs-scale
    kernels. The run of every group times a quarter of ``reps`` (at least
    3)."""
    reps = depth(reps, max(3, reps // 4))
    ms, src = device_ms(torch, fn, reps)
    events_key = f"{prefix}events_ms" if prefix else "kernel_ms"
    return {f"{prefix}ms": ms, f"{prefix}ms_source": src,
            events_key: cuda_time_ms(torch, fn, reps)}


def bound(nbytes: float, nops: float) -> tuple:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def b6_window_bytes(torch, grids, orgs, start, solved, pts, mask, kw) -> int:
    """The bytes of B6's (or B4's) window grids that a solve must read. A
    window the kernel stages in shared memory is read whole. A window read
    from global memory is read where the corners are: every 32-byte sector
    that holds one of the four corners of a valid beam at the start state
    or at the solved state (the first and the last evaluation), counted
    once — the least this run's data needs (the iterations between move
    the corners by a few cells)."""
    from iris_lama_tpu_torch.ops import gn_solve
    p, h, w = grids.shape
    isz = grids.element_size()
    if gn_solve.staged(h, w, pts.shape[0], isz):
        return grids.numel() * isz
    px, py = pts[:, 0][mask], pts[:, 1][mask]
    org = orgs.to(torch.int64)
    scale = torch.tensor(kw["scale"], dtype=torch.float32)
    base = torch.arange(p, device=grids.device)[:, None] * (h * w)
    sectors = []
    for st in (start, solved):
        tx, ty, c, s_ = (st[:, k:k + 1] for k in range(4))
        mx = torch.floor((tx + c * px - s_ * py) * scale).long()
        my = torch.floor((ty + s_ * px + c * py) * scale).long()
        lx = mx + kw["cell_offset"] - org[:, 0:1]
        ly = my + kw["cell_offset"] - org[:, 1:2]
        for dy in (0, 1):
            for dx in (0, 1):
                cell = ((ly + dy).clamp(0, h - 1) * w
                        + (lx + dx).clamp(0, w - 1))
                sectors.append(((base + cell) * isz // 32).reshape(-1))
    return int(torch.unique(torch.cat(sectors)).numel()) * 32


def border_mask(torch, dev, shape, seed: int):
    """A bool mask with obstacles only on its border rows and columns (30%
    of their cells)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.zeros(shape, dtype=torch.bool, device=dev)
    for sl in ((..., 0, slice(None)), (..., -1, slice(None)),
               (..., slice(None), 0), (..., slice(None), -1)):
        m[sl] = torch.rand(m[sl].shape, generator=g, device=dev) < 0.3
    return m


def b3_mask(torch, dev, shape, density: float):
    """Phase 3's B3 input: a random bool mask of the given obstacle
    density."""
    g = torch.Generator(device=dev).manual_seed(int(density * 100))
    return torch.rand(shape, generator=g, device=dev) < density


def edt_edges(torch, dev, leads) -> int:
    """B3 against its plain version at shapes that are no multiple of its
    32 x 64 tile, radii 1, 5 and 10, each leading shape of ``leads``, on
    random and border-only masks (bit-equal required). Returns the count
    of cases."""
    from iris_lama_tpu_torch.ops import edt_pallas
    g = torch.Generator(device=dev).manual_seed(13)
    n = 0
    for hw in ((61, 203), (33, 65)):
        for r in (1, 5, 10):
            for lead in leads:
                shape = (*lead, *hw)
                for m in (torch.rand(shape, generator=g, device=dev) < 0.03,
                          border_mask(torch, dev, shape, n)):
                    got = edt_pallas.edt2d(m, (r + 1) ** 2 - 1, r)
                    want = edt_pallas.edt2d_plain(m, (r + 1) ** 2 - 1, r)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), f"B3 at {shape}, R={r}"
                    n += 1
    return n


def solve_case(torch, dev, p: int, hw: tuple, b: int, per_particle: bool,
               width: str = "int8"):
    """Whole-solve inputs: p squared-distance windows [h, w] (each side at
    least 401; int8 values stored as ``width``) of one wall layout shifted
    per particle, b beams on the walls (10% masked out), one scan per
    particle or one shared, start states up to ~0.2 m / 0.1 rad off; and
    the solve's keywords at 5 cm cells."""
    from iris_lama_tpu_torch.ops import edt_pallas
    g = torch.Generator().manual_seed(b + p)
    obst = torch.zeros(hw, dtype=torch.bool)
    obst[60, 40:400] = True
    obst[60:380, 380] = True
    obst[300, 100:380] = True
    obst[torch.randint(40, 400, (40,), generator=g),
         torch.randint(40, 400, (40,), generator=g)] = True
    sq = edt_pallas.edt2d_plain(obst, 100, 10).to(torch.int8)
    grids = torch.stack([torch.roll(sq, (q % 3, q % 5), (0, 1))
                         for q in range(p)]).to(getattr(torch, width))
    ys, xs = torch.nonzero(obst, as_tuple=True)
    lead = (p,) if per_particle else ()
    k = torch.randint(0, len(ys), (*lead, b), generator=g)
    pts = torch.stack([(xs[k] + 0.5) * 0.05, (ys[k] + 0.5) * 0.05], -1)
    mask = torch.rand((*lead, b), generator=g) < 0.9
    off = (torch.rand((p, 3), generator=g) - 0.5) * torch.tensor(
        [0.4, 0.4, 0.2])
    st0 = torch.stack([off[:, 0], off[:, 1], torch.cos(off[:, 2]),
                       torch.sin(off[:, 2])], -1)
    org = torch.full((p, 2), 262144, dtype=torch.int32)
    kw = dict(max_dist=0.5, res=0.05, scale=20.0, cell_offset=262144,
              cauchy_c=0.15, eps1=1e-4, eps2=1e-4)
    return [t.to(dev) for t in (grids, org, st0, pts, mask)], kw


def solve_edges(torch, dev, mod, cases) -> int:
    """The whole solve (``mod``: ops.gn_batch, one shared scan, or
    ops.gn_solve, a scan per particle) against its plain version on each
    (p, (h, w), b[, width]) of ``cases`` at max_iter 0, 1 and 50, with and
    without the likelihood (bit-equal required). Returns the count of
    cases."""
    n = 0
    for p, hw, b, *width in cases:
        args, kw = solve_case(torch, dev, p, hw, b,
                              mod.__name__.endswith("gn_solve"), *width)
        for max_iter in (0, 1, 50):
            for want_lik in (False, True):
                got = mod.solve_window_sq(*args, **kw, max_iter=max_iter,
                                          want_lik=want_lik)
                want = mod.solve_window_sq_plain(*args, **kw,
                                                 max_iter=max_iter,
                                                 want_lik=want_lik)
                torch.cuda.synchronize()
                for name, a, w in zip(("state", "iterations", "chi2",
                                       "sum_d2"), got, want):
                    assert torch.equal(a, w), \
                        f"{mod.__name__} {name} at {p, hw, b}, " \
                        f"max_iter {max_iter}, want_lik {want_lik}"
                n += 1
    return n


def widened(torch, grid, width: str):
    """An int8 squared-distance grid as ``width``: the same values."""
    return grid.to(getattr(torch, width)).contiguous()


def width_grid(torch, grid, width: str, seed: int):
    """A grid of ``grid``'s shape over ``width``'s non-negative range (the
    squared distances a window of that width can hold)."""
    g = torch.Generator().manual_seed(seed)
    hi = torch.iinfo(getattr(torch, width)).max
    return torch.randint(0, hi, tuple(grid.shape), generator=g,
                         dtype=torch.int64).to(getattr(torch, width)).to(
                             grid.device)


def memset_floor_ms(torch, dev, nbytes: int, blocks: int,
                    threads: int) -> float:
    """Device ms of the cudaMemsetAsync of ``nbytes`` and an empty kernel
    of ``blocks`` x ``threads`` (csrc/floor.cu): the floor of the deposit's
    zero-then-scatter pair of launches."""
    from iris_lama_tpu_torch.ops import _cuda
    lib = _cuda.library("floor")
    stream = _cuda.stream_handle(dev)
    buf = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)

    def fn():
        _cuda.check(lib.memset_floor(buf.data_ptr(), nbytes, blocks, threads,
                                     stream), "memset_floor")

    return device_ms(torch, fn, 1000)[0]


def deposit_library(torch, dev, streams, p: int, h: int, w: int,
                    add: bool = False):
    """One PyTorch call computing a deposit: ``index_put_(accumulate=True)``
    (``add``: ``index_add_``, atomics on the card) of ones into a zeroed
    buffer with one bin per cell of each output grid and one dropped bin
    per grid. ``streams``: (ly, lx, grids) with ly, lx [p, n] and grids the
    output grids (0: occ/counts, 1: vis) they add to."""
    hw1 = h * w + 1
    n_grids = max(g for *_, gs in streams for g in gs) + 1
    parts = []
    for ly, lx, gs in streams:
        ok = (ly >= 0) & (ly < h) & (lx >= 0) & (lx < w)
        cell = torch.where(ok, ly.long() * w + lx.long(), h * w)
        for g in gs:
            base = (torch.arange(p, device=dev)[:, None] * n_grids + g) * hw1
            parts.append((cell.reshape(p, -1) + base).reshape(-1))
    flat = torch.cat(parts)
    ones = torch.ones(flat.numel(), dtype=torch.int32, device=dev)

    def call():
        buf = torch.zeros(p * n_grids * hw1, dtype=torch.int32, device=dev)
        if add:
            buf.index_add_(0, flat, ones)
        else:
            buf.index_put_((flat,), ones, accumulate=True)

    return call


def launch_floor_ms(torch, dev, blocks: int, threads: int) -> float:
    """Device ms of an empty kernel launched as ``blocks`` x ``threads``
    (csrc/floor.cu): what any launch of that shape costs on the card."""
    from iris_lama_tpu_torch.ops import _cuda
    lib = _cuda.library("floor")
    stream = _cuda.stream_handle(dev)

    def fn():
        _cuda.check(lib.launch_floor(blocks, threads, stream), "launch_floor")

    return device_ms(torch, fn, 1000)[0]


def b2_floor_ms(torch, dev, b: int) -> float:
    """The launch floor at B2's launch shape for ``b`` beams
    (csrc/select4.cu: blocks of 256 threads, one beam a thread)."""
    return launch_floor_ms(torch, dev, -(-b // 256), 256)


def b5_floor_ms(torch, dev, p: int, b: int) -> float:
    """The launch floor at B5's launch shape (gn_common.cuh: Shape): one
    block of 256 * min(ceil(b / 256), 4) threads per particle."""
    return launch_floor_ms(torch, dev, p, 256 * min(-(-b // 256), 4))


def eval_case(torch, dev, p: int, b: int, seed: int, masked=False):
    """B5's operands: p int8 windows 431 x 433 (the same bytes also at an
    odd byte offset), cells up to 3 off the window on every side (beams
    0-3 on its edges), fractions, hits within 10 m, 90% of the beams kept
    (none when ``masked``), as the fused loop's [p, b, 2] cell, fraction
    and hit tensors. Returns ((grid, odd grid), strided operand views)."""
    g = torch.Generator().manual_seed(seed)
    h, w = 431, 433
    grid = torch.randint(0, 101, (p, h, w), generator=g, dtype=torch.int8)
    ly = torch.randint(-3, h + 3, (p, b), generator=g, dtype=torch.int32)
    lx = torch.randint(-3, w + 3, (p, b), generator=g, dtype=torch.int32)
    for i, (y, x) in enumerate(((-1, 5), (h - 1, 7), (9, -1), (11, w - 1))):
        if i < b:
            ly[:, i], lx[:, i] = y, x
    loc = torch.stack([lx, ly], -1).to(dev)
    mu = torch.rand((p, b, 2), generator=g).to(dev)
    hits = ((torch.rand((p, b, 2), generator=g) - 0.5) * 20.0).to(dev)
    fm = torch.zeros((p, b)) if masked else \
        (torch.rand((p, b), generator=g) < 0.9).float()
    buf = torch.empty(p * h * w + 1, dtype=torch.int8)
    buf[1:] = grid.flatten()
    odd = buf.to(dev)[1:].view(p, h, w)
    return (grid.to(dev), odd), (loc[..., 1], loc[..., 0], mu[..., 0],
                                 mu[..., 1], hits[..., 0], hits[..., 1],
                                 fm.to(dev))


def eval_edges(torch, dev) -> int:
    """B5 against its plain version at the edges of its design (bit-equal
    required): 1, 255, 257, 1100 and 2048 beams (held in registers) and
    2049, 3000 and 4096 (the further beams read again), P = 1 (the
    unbatched entry point) and 3, unit and Cauchy weights, cells off the
    window on every side, an all-masked scan, the fused loop's strided
    views and contiguous copies, a grid at an odd byte offset, operands
    expanded with a stride of 0. Returns the count of cases."""
    from iris_lama_tpu_torch.ops import match_eval
    n = 0
    for b in (1, 255, 257, 1100, 2048, 2049, 3000, 4096):
        for p in (1, 3):
            for masked in ((False, True) if b == 257 else (False,)):
                grids, views = eval_case(torch, dev, p, b, b + p, masked)
                for ops in (views, [v.contiguous() for v in views]):
                    for grid in grids:
                        for cauchy_c in (0.15, 0.0):
                            kw = dict(max_dist=0.5, res=0.05, scale=20.0,
                                      cauchy_c=cauchy_c)
                            args = (grid, *ops) if p > 1 else \
                                (grid[0], *(t[0] for t in ops))
                            got = match_eval.gn_eval_sq(*args, **kw)
                            want = match_eval.gn_eval_sq_plain(*args, **kw)
                            torch.cuda.synchronize()
                            assert torch.equal(got, want), \
                                f"B5 at {p} x {b} beams, masked {masked}, " \
                                f"cauchy_c {cauchy_c}"
                            n += 1
    grids, views = eval_case(torch, dev, 3, 768, 5)
    ops = list(views)
    ops[2] = views[2][:, :1].expand(3, 768)     # stride 0 along the beams
    ops[6] = views[6][0].expand(3, 768)         # stride 0 along particles
    kw = dict(max_dist=0.5, res=0.05, scale=20.0, cauchy_c=0.15)
    got = match_eval.gn_eval_sq(grids[0], *ops, **kw)
    want = match_eval.gn_eval_sq_plain(grids[0],
                                       *(t.contiguous() for t in ops), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "B5 on expanded operands"
    return n + 1


def select4_edges(torch, dev) -> int:
    """B2 against its plain version (bit-equal required) on 37-row grids of width 488-491 (every row end
    within a 32-bit word) at byte offsets 0-3, cells in and around the last
    column and row, indices contiguous, as the interleaved columns of a
    [B, 2] tensor and as columns of a [B, 3] one. Returns the count of
    cases."""
    from iris_lama_tpu_torch.ops import select4
    n = 0
    for w in (488, 489, 490, 491):
        g = torch.Generator().manual_seed(w)
        h, b = 37, 777
        buf = torch.randint(-128, 128, (h * w + 3,), generator=g,
                            dtype=torch.int8).to(dev)
        ly = torch.randint(-3, h + 3, (b,), generator=g, dtype=torch.int32)
        lx = torch.randint(-3, w + 3, (b,), generator=g, dtype=torch.int32)
        edge = torch.tensor([[h - 1, w - 1], [h - 1, w - 2], [h - 2, w - 1],
                             [h, w], [-1, w - 1], [h - 1, -1], [0, 0],
                             [h - 1, w - 3], [h - 1, w - 4]],
                            dtype=torch.int32)
        ly[:len(edge)], lx[:len(edge)] = edge[:, 0], edge[:, 1]
        pair = torch.stack([lx, ly], -1).to(dev)
        wide = torch.stack([ly, ly, lx], -1).to(dev)
        for off in range(4):
            grid = buf[off:off + h * w].view(h, w)
            for iy, ix in ((ly.to(dev), lx.to(dev)), (pair[:, 1], pair[:, 0]),
                           (wide[:, 0], wide[:, 2])):
                got = select4.select4_sq(grid, iy, ix)
                want = select4.select4_sq_plain(grid, iy, ix)
                torch.cuda.synchronize()
                assert torch.equal(got, want), \
                    f"B2 at w {w}, offset {off}, strides {iy.stride()}"
                n += 1
    return n


def path_counts(launches: dict, shapes: dict) -> dict:
    """A path's launches for the kernels line: per kernel, its count and
    the shape of the grids the path sent it."""
    return {n: {"launches": c, "shape": list(shapes[n])}
            for n, c in launches.items()}


def host_reads(*sites) -> int:
    """The port's host reads so far at ``sites`` (``utils/trace.py``'s
    ``reads.<site>`` counters)."""
    from iris_lama_tpu_torch.utils import trace
    got = trace.counts()
    return sum(got.get("reads." + s, 0) for s in sites)


def device_launches(torch, fn) -> int:
    """The device activities (kernels, copies, fills) that ``fn``
    launches, counted by torch.profiler."""
    dp = devprof()
    return dp.launch_count(dp.cuda_rows(dp.profile_calls(fn)))


COUNT_WINDOW = 20              # scans a profile of a counted pass holds


def counted_pass(make, feed, n: int, kernels: dict, tries: int = 1,
                 window: int = COUNT_WINDOW) -> tuple:
    """The kernels that one untimed pass of a fresh driver launched,
    counted on torch.profiler's device trace by name (``kernels`` as
    ``devprof.launches_by_window`` takes them): ``make()`` returns the
    driver, ``feed(driver, a, b)`` gives it scans a..b-1 and returns the
    accepted ones. Each ``window`` scans are a profile of their own (the
    profiler drops stretches of long profiles, PERF.md §7); with ``tries``
    > 1 the pass is made that many times, the same work each time, and each
    window's count is the largest seen. Returns (the accepted scans, the
    launches)."""
    def windows():
        drv = make()
        return [functools.partial(feed, drv, a, min(a + window, n))
                for a in range(0, n, window)]
    outs, launches = devprof().launches_by_window(windows, kernels, tries)
    return [k for w in outs for k in w], launches


def one_by_one(staged, odoms):
    """``counted_pass``'s ``feed`` for a driver that takes the
    device-staged scans one ``update_prepadded`` call each."""
    return lambda drv, a, b: [k for k in range(a, b)
                              if drv.update_prepadded(*staged[k], odoms[k])]


def fresh(cls, opts, dev, pose):
    """A new driver ``cls(opts, device=dev)`` with its prior at ``pose``
    (x, y, theta)."""
    from iris_lama_tpu_torch.core.pose import Pose2D
    drv = cls(opts, device=dev)
    drv.set_prior(Pose2D(*pose))
    return drv


@functools.lru_cache(maxsize=None)
def slam_workload():
    """bench.py's Slam2D workload: (data, options, scans padded to 768)."""
    from iris_lama_tpu_torch.algos.slam2d import Slam2DOptions
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    data = simulator.simulate(simulator.SimConfig(
        n_steps=440, seed=3,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    opts = Slam2DOptions(resolution=0.05, max_range=10.0,
                         trans_thresh=0.05, rot_thresh=0.05,
                         capacity=8192, max_iter=50)
    return data, opts, [pad_scan(c, beam_bucket(720)) for c in data.clouds]


def slam_pass(torch, dev, data, opts, staged, p: int) -> dict:
    """One timed Slam2D pass (phase 5): a fresh driver, prior x offset
    ``p``·1e-4 m, two scans untimed, then update_many_prepadded over the
    rest of the device-staged scans."""
    from iris_lama_tpu_torch.algos.slam2d import Slam2D
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils.evaluation import ate_rmse

    slam = Slam2D(opts, device=dev)
    slam.set_prior(Pose2D(data.poses_gt[0][0] + p * 1e-4,
                          data.poses_gt[0][1], data.poses_gt[0][2]))
    slam.update_prepadded(*staged[0], data.odometry[0])
    slam.update_prepadded(*staged[1], data.odometry[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = slam.update_many_prepadded(staged[2:], data.odometry[2:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    gt = np.asarray([data.poses_gt[2 + k] for k in acc])
    ate = ate_rmse(slam.trajectory()[-len(gt):], gt)
    return {"scans_per_s": len(acc) / dt, "updates": len(acc),
            "seconds": dt, "ate_m": ate, "reorgs": slam.n_reorgs,
            "scrolls": slam.n_scrolls, "escaped": slam.escaped_count()}


@functools.lru_cache(maxsize=None)
def pf_workload():
    """bench_pf.py's PFSlam2D workload: (data, options, scans padded to
    768)."""
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2DOptions
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    data = simulator.simulate(simulator.SimConfig(
        n_steps=120, seed=5,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    opts = PFSlam2DOptions(particles=30, resolution=0.05, max_range=10.0,
                           trans_thresh=0.25, rot_thresh=0.25,
                           capacity=2048, max_iter=50, seed=11)
    return data, opts, [pad_scan(c, beam_bucket(720)) for c in data.clouds]


def pf_pass(torch, dev, data, opts, staged, rep: int) -> dict:
    """One timed PFSlam2D pass (phase 8): a fresh filter, prior x offset
    ``rep``·1e-4 m, the first scan untimed, then update_prepadded over the
    rest of the device-staged scans."""
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
    from iris_lama_tpu_torch.core.pose import Pose2D

    f = PFSlam2D(opts, device=dev)
    f.set_prior(Pose2D(data.poses_gt[0][0] + rep * 1e-4,
                       data.poses_gt[0][1], data.poses_gt[0][2]))
    f.update_prepadded(*staged[0], data.odometry[0])
    torch.cuda.synchronize()
    iters = []
    n_up, gt_last = 0, data.poses_gt[0]
    t0 = time.perf_counter()
    for i in range(1, len(staged)):
        if f.update_prepadded(*staged[i], data.odometry[i]):
            n_up += 1
            gt_last = data.poses_gt[i]
            iters.append((f._last_info_dev["match_iters_max"],
                          f._last_info_dev["match_iters_mean"]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = float(np.linalg.norm(f.pose().xy() - np.asarray(gt_last)[:2]))
    it_max = torch.stack([a for a, _ in iters]).float()
    it_mean = torch.stack([m for _, m in iters])
    return {"updates_per_s": n_up / dt, "updates": n_up, "seconds": dt,
            "final_err_m": err, "reorgs": f.n_reorgs, "scrolls": f.n_scrolls,
            "escaped": f.escaped_count(),
            "match_iters_max": float(it_max.max()),
            "match_iters_mean": float(it_mean.mean())}


def pf_kernel_inputs(torch, dev, data, opts, staged) -> dict:
    """Phase 6's inputs: the filter after six updates of the bench_pf.py
    workload, its particles moved by the next odometry packet; their match
    windows and B6's arguments, and the batched B3's mask (the exact-update
    sub-window of the resident distance grid at each particle's pose)."""
    from iris_lama_tpu_torch.algos import pf_slam2d as pf_mod
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.sdm import mapping

    cfg = opts.mapping_config()
    geo = cfg.geometry
    pf = PFSlam2D(opts, device=dev)
    pf.set_prior(Pose2D(*data.poses_gt[0]))
    k = 0
    while k < 6:
        pf.update_prepadded(*staged[k], data.odometry[k])
        k += 1
    pf._flush_motion()
    ps = pf.pset
    odelta = torch.as_tensor((pf.odom_ - data.odometry[k]).se2_array(),
                             dtype=torch.float32, device=dev)
    eps = torch.randn((opts.particles, 3),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    poses = pf_mod.draw_from_motion(opts, eps, odelta, ps.pose).contiguous()
    pts, msk, ori = staged[k]
    grids, orgs = pf_mod.match_windows(opts, ps.res_org, ps.res_dist, poses)
    sopts = opts.solver_options()
    b6_kw = dict(max_dist=cfg.distance.max_dist, res=geo.resolution,
                 scale=geo.scale, cell_offset=geo.cell_offset,
                 cauchy_c=sopts.robust.param, eps1=sopts.eps1,
                 eps2=sopts.eps2, max_iter=sopts.max_iterations,
                 want_lik=True)
    wu, w_res = cfg.resident_update_cells, cfg.resident_window_cells
    lp = geo.w2m(poses[:, :2]) - ps.res_org
    start = torch.clamp(lp - wu // 2, 0, w_res - wu)
    obst = mapping.dyn_slice(ps.res_dist, start[:, 1], start[:, 0], wu,
                             wu) == 0
    return {"pf": pf, "pset": ps, "poses": poses, "pts": pts, "msk": msk,
            "ori": ori, "grids": grids, "start": start,
            "b6_args": (grids, orgs, poses, pts[:, :2].contiguous(), msk),
            "b6_kw": b6_kw, "obst": obst, "radius": cfg.distance.radius_cells,
            "cap": cfg.distance.max_sqdist}


def motion_queue(k: int, seed: int = 0) -> np.ndarray:
    """float32 [k, 4] odometry increments (x, y, cos, sin) as the
    benchmark's 40 Hz stream queues them behind the PF's gate: ~2.5 cm
    steps with small turns."""
    from iris_lama_tpu_torch.core.pose import Pose2D
    rng = np.random.default_rng(seed)
    return np.stack([Pose2D(rng.normal(0.025, 0.002), rng.normal(0.0, 0.001),
                            rng.normal(0.0, 0.005)).se2_array()
                     for _ in range(k)]).astype(np.float32)


def pf_motion_entry(torch, dev, pf, k: int = PF_MOTION_PACKETS) -> dict:
    """Phase 6's motion entry: the motion kernel (``ops/motion.py``) on
    ``pf``'s 30 particles and a queue of ``k`` packets, bit-equal to ``k``
    eager ``draw_from_motion`` calls on the card; its device time beside
    the eager chain's, the launch floor of its launch shape and its bound;
    and the host ms of a whole flush (draws, staging, copy, launch) beside
    the per-packet loop it replaced (a pageable copy of each draw and
    packet, then the eager chain), each drained by a synchronise."""
    from iris_lama_tpu_torch.algos.pf_slam2d import draw_from_motion
    from iris_lama_tpu_torch.ops import motion

    opts, n = pf.options, pf.options.particles
    queue = motion_queue(k)
    gen = torch.Generator().manual_seed(7)
    eps = torch.randn((k, n, 3), generator=gen).to(dev)
    packets = torch.as_tensor(queue, device=dev)
    poses = pf.pset.pose.contiguous()

    def kernel():
        return motion.apply_queue(opts, eps, packets, poses)

    def eager():
        out = poses
        for j in range(k):
            out = draw_from_motion(opts, eps[j], packets[j], out)
        return out

    got, want = kernel(), eager()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert torch.equal(got, want), f"motion kernel differs: {err}"

    def loop_flush():
        out = pf.pset.pose
        for od in queue:
            out = draw_from_motion(opts, pf._draw("normal", (n, 3)),
                                   pf._tensor(od), out)
        return out

    def queued_flush():
        pf._odelta_queue = list(queue)
        pf._flush_motion()

    host = {}
    for name, fn in (("flush", queued_flush), ("loop_flush", loop_flush)):
        times = []
        for _ in range(depth(30, 8)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        host[f"{name}_host_ms"] = float(np.median(times))
    # bytes: the poses in and out, the draws and packets; operations: ~60
    # arithmetic a packet and particle plus atan2f, cosf and sinf (~30
    # each)
    bd = bound(32 * n + (12 * n + 16) * k, 150 * n * k)
    return {"name": "motion", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/motion.cu",
            "replaces": "none (the eager chain of "
                        "algos/pf_slam2d.py:draw_from_motion, a packet "
                        "at a time)",
            "shape": [k, n], "max_abs_err": err,
            "launch_floor_ms": launch_floor_ms(torch, dev, -(-n // 128),
                                               128),
            **timings(torch, "", kernel, 200),
            **timings(torch, "plain_", eager, 20),
            "library_ms": None,
            "library_call": "none: no single PyTorch call applies a queue "
                            "of motion packets",
            "bound_ms": bd[0], "bound_by": bd[1], **host}


def pf_phases(torch, dev) -> list:
    """Phases 6-8 (PFSlam2D, the bench_pf.py workload): B6 and the batched
    B1 / B3 against their plain versions at the PF shapes, the first
    ``PF_PREFIX`` updates on the CPU and on the card, then the workload on
    the card. Returns the kernels line's entries of this path."""
    from iris_lama_tpu_torch.algos import pf_slam2d as pf_mod
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.ops import edt_pallas, gn_batch, gn_solve
    from iris_lama_tpu_torch.ops import scatter_matmul
    from iris_lama_tpu_torch.sdm import mapping

    data, opts, padded = pf_workload()
    cfg = opts.mapping_config()
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]

    # 6. kernels at the PF shapes, on a real particle set
    kin = pf_kernel_inputs(torch, dev, data, opts, staged)
    pf, ps, poses, pts, msk, ori = (kin[n] for n in (
        "pf", "pset", "poses", "pts", "msk", "ori"))
    grids, b6_args, b6_kw = kin["grids"], kin["b6_args"], kin["b6_kw"]
    got = gn_batch.solve_window_sq(*b6_args, **b6_kw)
    want = gn_batch.solve_window_sq_plain(*b6_args, **b6_kw)
    torch.cuda.synchronize()
    (st, it, chi2, sse), (pst, pit, pchi2, psse) = got, want
    n_p, b = grids.shape[0], pts.shape[0]
    b6_err = float((st - pst).abs().max())
    rel = {name: float(((a - w) / w.abs().clamp(min=1e-6)).abs().max())
           for name, a, w in (("chi2", chi2, pchi2), ("sum_d2", sse, psse))}
    mism = int((it != pit).sum())
    # the plain version sums in the kernel's order and the kernel is built
    # without FMA contraction: every particle's results bit-equal
    for name, a, w in zip(("state", "iterations", "chi2", "sum_d2"), got,
                          want):
        assert torch.equal(a, w), \
            f"B6 {name} differs: state err {b6_err}, {mism} iteration " \
            f"counts, {rel}"
    # the edges of the design: 1, 255, 257 and 1100 beams (one, two, five
    # a summation lane), the largest window staged beside 768 beams'
    # exchange buffer, windows at odd byte offsets
    b6_edges = solve_edges(torch, dev, gn_batch, (
        (3, (432, 432), 1), (3, (432, 432), 255), (4, (432, 432), 257),
        (2, (458, 459), 768), (5, (431, 433), 768), (2, (432, 432), 1100),
        (2, (432, 432), 2049), (2, (576, 576), 3000, "int16"),
        (2, (432, 432), 4096, "uint8"), (3, (458, 459), 768, "uint8"),
        (2, (432, 432), 768, "int32")))
    # bytes: every grid once, the scan, the starts and the rows; operations:
    # ~60 per beam and evaluation, over this run's evaluations (the start,
    # each iteration's candidate, the likelihood)
    evals = int(it.sum()) + 2 * n_p
    b6_bound = bound(grids.numel() + n_p * (8 + 16 + 32) + b * 9,
                     60 * b * evals)
    b6 = {"name": "gn_batch_solve", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/gn_solve.cu",
          "replaces": "iris_lama_tpu/ops/gn_batch.py:108",
          "shape": [n_p, grids.shape[1], grids.shape[2], b],
          "variant": "shared" if gn_solve.staged(*grids.shape[1:], b)
                     else "global",
          "edge_cases": b6_edges,
          "max_abs_err": b6_err, "rel_err": rel,
          "iters_differ": mism, "iters_max": int(it.max()),
          "iters_mean": float(it.float().mean()),
          **timings(torch, "", lambda: gn_batch.solve_window_sq(
              *b6_args, **b6_kw), 50),
          **timings(torch, "plain_", lambda: gn_batch.solve_window_sq_plain(
              *b6_args, **b6_kw), 5),
          "library_ms": None,
          "library_call": "none: no single PyTorch call computes an IRLS "
                          "solve",
          "bound_ms": b6_bound[0], "bound_by": b6_bound[1]}
    # B6's other widths on the same windows (an exact widening: the int8
    # kernel's results); int16 and int32 windows of 432 x 432 no longer fit
    # in shared memory and are read from global memory
    b6_widths = []
    for width in WIDTHS:
        args_w = (widened(torch, grids, width), *b6_args[1:])
        got_w = gn_batch.solve_window_sq(*args_w, **b6_kw)
        want_w = gn_batch.solve_window_sq_plain(*args_w, **b6_kw)
        torch.cuda.synchronize()
        for name, a, w_, i8 in zip(("state", "iterations", "chi2", "sum_d2"),
                                   got_w, want_w, got):
            assert torch.equal(a, w_) and torch.equal(a, i8), \
                f"B6 {width} {name} differs"
        bd = bound(args_w[0].numel() * args_w[0].element_size()
                   + n_p * (8 + 16 + 32) + b * 9, 60 * b * evals)
        b6_widths.append({
            "name": f"gn_batch_solve_{width}", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/gn_solve.cu",
            "replaces": "iris_lama_tpu/ops/gn_batch.py:108",
            "shape": [n_p, grids.shape[1], grids.shape[2], b],
            "dtype": width,
            "variant": "shared" if gn_solve.staged(
                *grids.shape[1:], b, args_w[0].element_size()) else "global",
            "max_abs_err": 0.0,
            **timings(torch, "", lambda: gn_batch.solve_window_sq(
                *args_w, **b6_kw), 50),
            **timings(torch, "plain_", lambda: gn_batch.solve_window_sq_plain(
                *args_w, **b6_kw), 3),
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes an IRLS "
                            "solve",
            "bound_ms": bd[0], "bound_by": bd[1]})

    # the map phase's streams and masks for every particle (the exact-update
    # sub-window at each particle's pose)
    wu, start = cfg.resident_update_cells, kin["start"]
    idx = mapping.deposit_indices(cfg, poses, pts, msk, ori,
                                  ps.res_org + start, wu)
    n_dep = idx.free_ly.shape[1]
    perm = torch.argsort(torch.rand((n_p, n_dep), device=dev), dim=1)
    sent = torch.rand((n_p, n_dep), device=dev) < 0.3
    cases = {"beam_ordered": (idx.free_ly, idx.free_lx),
             "shuffled": (torch.gather(idx.free_ly, 1, perm),
                          torch.gather(idx.free_lx, 1, perm)),
             "sentinels": (torch.where(sent, wu, idx.free_ly).contiguous(),
                           idx.free_lx)}
    b1_err = 0
    for name, (ly, lx) in cases.items():
        g1 = scatter_matmul.deposit_counts(ly, lx, wu, wu)
        w1 = scatter_matmul.deposit_counts_plain(ly, lx, wu, wu)
        torch.cuda.synchronize()
        b1_err = max(b1_err, int((g1 - w1).abs().max()))
        assert torch.equal(g1, w1), f"B1 batched {name}: differs"
    ly, lx = cases["beam_ordered"]
    b1_bound = bound(n_p * (n_dep * 8 + wu * wu * 4), n_p * n_dep)
    b1b = {"name": "deposit_counts_batched", "route": "cuda",
           "source": "iris_lama_tpu_torch/csrc/deposit.cu",
           "replaces": "iris_lama_tpu/ops/scatter_matmul.py:228",
           "shape": [n_p, n_dep, wu, wu],
           "stream": "beam_ordered", "max_abs_err": b1_err,
           "launch_floor_ms": memset_floor_ms(
               torch, dev, n_p * wu * wu * 4,
               scatter_matmul.launch_blocks(n_p, [n_dep]), 256),
           **timings(torch, "", lambda: scatter_matmul.deposit_counts(
               ly, lx, wu, wu), 100),
           **timings(torch, "plain_",
                     lambda: scatter_matmul.deposit_counts_plain(
                         ly, lx, wu, wu), 20),
           **timings(torch, "library_", deposit_library(
               torch, dev, [(ly, lx, (0,))], n_p, wu, wu), 10),
           "library_call": "zeros + index_put_(accumulate=True)",
           "bound_ms": b1_bound[0], "bound_by": b1_bound[1]}
    hit = (idx.hit_ly, idx.hit_lx)
    n_hit = hit[0].shape[1]
    pair_err = 0
    for name, (fly, flx) in cases.items():
        got_p = scatter_matmul.deposit_pair(*hit, fly, flx, wu, wu)
        want_p = scatter_matmul.deposit_pair_plain(*hit, fly, flx, wu, wu)
        torch.cuda.synchronize()
        for g_, w_ in zip(got_p, want_p):
            pair_err = max(pair_err, int((g_ - w_).abs().max()))
            assert torch.equal(g_, w_), f"B1 pair batched {name}: differs"
    del got_p, want_p
    pb_bound = bound(n_p * ((n_hit + n_dep) * 8 + 2 * wu * wu * 4),
                     n_p * (2 * n_hit + n_dep))
    pair_b = {"name": "deposit_pair_batched", "route": "cuda",
              "source": "iris_lama_tpu_torch/csrc/deposit.cu",
              "replaces": "iris_lama_tpu/ops/scatter_matmul.py:228",
              "shape": [n_p, n_hit, n_dep, wu, wu],
              "stream": "beam_ordered", "max_abs_err": pair_err,
              "launch_floor_ms": memset_floor_ms(
                  torch, dev, 2 * n_p * wu * wu * 4,
                  scatter_matmul.launch_blocks(n_p, [n_hit, n_dep]), 256),
              **timings(torch, "", lambda: scatter_matmul.deposit_pair(
                  *hit, ly, lx, wu, wu), 100),
              **timings(torch, "plain_",
                        lambda: scatter_matmul.deposit_pair_plain(
                            *hit, ly, lx, wu, wu), 20),
              **timings(torch, "library_", deposit_library(
                  torch, dev, [(hit[0], hit[1], (0, 1)), (ly, lx, (1,))],
                  n_p, wu, wu), 10),
              "library_call": "zeros + index_put_(accumulate=True) over "
                              "both grids' bins",
              "bound_ms": pb_bound[0], "bound_by": pb_bound[1]}

    r, cap, obst = kin["radius"], kin["cap"], kin["obst"]
    b3_err = 0
    for m in (obst, torch.rand(obst.shape, device=dev) < 0.3,
              obst[:3].contiguous(), border_mask(torch, dev, obst.shape, 5)):
        g3 = edt_pallas.edt2d(m, cap, r)
        w3 = edt_pallas.edt2d_plain(m, cap, r)
        torch.cuda.synchronize()
        b3_err = max(b3_err, int((g3 - w3).abs().max()))
        assert torch.equal(g3, w3), "B3 batched: differs"
    b3_bound = bound(obst.numel() * (1 + 4), obst.numel() * 4 * (2 * r + 1))
    b3b = {"name": "edt2d_batched", "route": "cuda",
           "source": "iris_lama_tpu_torch/csrc/edt.cu",
           "replaces": "iris_lama_tpu/ops/edt_pallas.py:25",
           "shape": list(obst.shape), "radius": r,
           "obstacle_share": float(obst.float().mean()),
           "edge_cases": edt_edges(torch, dev, ((3,),)),
           "max_abs_err": b3_err,
           **timings(torch, "", lambda: edt_pallas.edt2d(obst, cap, r), 100),
           **timings(torch, "plain_", lambda: edt_pallas.edt2d_plain(
               obst, cap, r), 20),
           "library_ms": None,
           "library_call": "none: no single PyTorch call computes a capped "
                           "EDT",
           "bound_ms": b3_bound[0], "bound_by": b3_bound[1]}
    # the motion step: the queue of a benchmark update in one launch
    pf_kernels = [b6, *b6_widths, b1b, pair_b, b3b,
                  pf_motion_entry(torch, dev, pf)]
    for kern in pf_kernels:
        emit({"phase": "pf_kernel", **kern})
    del pf, ps, grids, b6_args, cases, idx, obst, kin

    # 7. prefix: CPU plain versions vs the card, same seed, same draws;
    # and, as a control, the card again with the motion draws scaled by
    # 1 + 3e-7 (how far an ulp-sized change moves the particles)
    def make(device, scale=None):
        draws = None
        if scale is not None:
            gen = torch.Generator().manual_seed(opts.seed)

            def draws(kind, shape):
                if kind == "normal":
                    return torch.randn(shape, generator=gen) * scale
                return torch.rand(shape, generator=gen)
        f = PFSlam2D(opts, device=device, draws=draws)
        f.set_prior(Pose2D(*data.poses_gt[0]))
        return f

    def advance(f, lo, hi, infos):
        """Scans [lo, hi) through ``f``; one record per accepted update."""
        for i in range(lo, hi):
            scan = (torch.as_tensor(a, device=f.device) for a in padded[i])
            if f.update_prepadded(*scan, data.odometry[i]) and i:
                infos.append((f.pset.pose.cpu().numpy(),
                              f.pset.lineage.cpu().numpy(),
                              bool(f._last_info["resampled"]),
                              f.best_particle_idx()))

    def forced_scroll(f):
        """The band scroll that the next update starts with, from the card
        run's state, on the CPU and on the card: a scroll moves data only,
        so the two state dicts must be bit-equal."""
        assert f.n_reorgs == 0, "PF prefix: re-org before the scroll scan"
        snap = f.state_dict()
        out = []
        for device in ("cpu", dev):
            g = PFSlam2D(opts, device=device)
            g.load_state_dict(snap)
            g.pset = pf_mod.scroll(g.options, g.pset, g.options.scroll_kp)
            out.append(g.state_dict())
            del g
        return {"shift_cells": (out[1]["res_org"]
                                - snap["res_org"]).tolist(),
                "kp": f.options.scroll_kp,
                "differing_arrays": sorted(
                    k for k in out[0]
                    if not np.array_equal(out[0][k], out[1][k]))}

    def pose_diff(a, g):
        """Per-particle |dxy| (m) and |dtheta| (rad) of two [N, 4] sets."""
        dth = np.angle(np.exp(1j * (np.arctan2(a[:, 3], a[:, 2])
                                    - np.arctan2(g[:, 3], g[:, 2]))))
        return np.abs(a[:, :2] - g[:, :2]).max(1), np.abs(dth)

    def same_decisions(x, y):
        return all(np.array_equal(a[1], g[1]) and a[2] == g[2]
                   for a, g in zip(x, y))

    cpu_pf, gpu_pf, ctl_pf = make("cpu"), make(dev), make(dev, 1.0 + 3e-7)
    cpu_inf, gpu_inf, ctl_inf = [], [], []
    t_cpu, scroll_check = 0.0, None
    for lo, hi in ((0, PF_SCROLL_SCAN), (PF_SCROLL_SCAN, PF_PREFIX + 1)):
        if lo:
            scroll_check = forced_scroll(gpu_pf)
        t0 = time.perf_counter()
        advance(cpu_pf, lo, hi, cpu_inf)
        t_cpu += time.perf_counter() - t0
        advance(gpu_pf, lo, hi, gpu_inf)
        advance(ctl_pf, lo, hi, ctl_inf)
    assert len(cpu_inf) == len(gpu_inf) == PF_PREFIX, "PF prefix: accepted"
    ctl = [pose_diff(a[0], g[0]) for a, g in zip(ctl_inf, gpu_inf)]
    ctl_dxy = max(float(d[0].max()) for d in ctl)
    ctl_dth = max(float(d[1].max()) for d in ctl)
    diffs = [pose_diff(a[0], g[0]) for a, g in zip(cpu_inf, gpu_inf)]
    dxy = max(float(d[0].max()) for d in diffs)
    dth = max(float(d[1].max()) for d in diffs)
    def n_beyond(ds):
        """Particle-updates beyond 1 mm / 1e-3 rad."""
        return sum(int(((d[0] > 1e-3) | (d[1] > 1e-3)).sum()) for d in ds)

    beyond, ctl_beyond = n_beyond(diffs), n_beyond(ctl)
    best = [(a[3], g[3], d[0][a[3]], d[1][a[3]])
            for a, g, d in zip(cpu_inf, gpu_inf, diffs)]
    grids_diff = {}
    for name in ("res_occ", "res_vis", "res_dist"):
        a = getattr(cpu_pf.pset, name).numpy()
        b_ = getattr(gpu_pf.pset, name).cpu().numpy()
        grids_diff[name] = int(np.sum(a != b_))
    n_cells = gpu_pf.pset.res_occ.numel()
    # at most twice as many particle-updates beyond 1 mm / 1e-3 rad as the
    # control has, and every particle within 1 mm / 1e-3 rad or within
    # twice what the control moved a particle in this run
    lim_xy, lim_th = max(1e-3, 2 * ctl_dxy), max(1e-3, 2 * ctl_dth)
    emit({"phase": "pf_prefix", "updates": PF_PREFIX, "cpu_s": t_cpu,
          "max_dxy_m": dxy, "max_dtheta_rad": dth,
          "limit_dxy_m": lim_xy, "limit_dtheta_rad": lim_th,
          "particle_updates_beyond_1mm": beyond,
          "particle_updates": PF_PREFIX * opts.particles,
          "best_particle_equal": all(b_[0] == b_[1] for b_ in best),
          "best_max_dxy_m": max(float(b_[2]) for b_ in best),
          "best_max_dtheta_rad": max(float(b_[3]) for b_ in best),
          "resample_indices_equal": same_decisions(cpu_inf, gpu_inf),
          "control_max_dxy_m": ctl_dxy, "control_max_dtheta_rad": ctl_dth,
          "control_particle_updates_beyond_1mm": ctl_beyond,
          "control_resample_indices_equal": same_decisions(ctl_inf, gpu_inf),
          "reorgs": [cpu_pf.n_reorgs, gpu_pf.n_reorgs],
          "scrolls": [cpu_pf.n_scrolls, gpu_pf.n_scrolls],
          "forced_scroll": scroll_check,
          "org_equal": bool(torch.equal(cpu_pf.pset.res_org,
                                        gpu_pf.pset.res_org.cpu())),
          "differing_cells": grids_diff, "cells": n_cells})
    # The CPU and the card round sin/cos/atan2 differently, so particles
    # differ by ulps and a few hits move across a cell boundary (as in the
    # Slam2D prefix); a particle in a poorly constrained spot turns such an
    # ulp into a millimetre. The control run measures that on the card
    # alone (the plain B6 is bit-equal to the kernel), and is a measure of
    # it only while it takes the card run's decisions. The filter must take
    # the same decisions — resample indices, best particle, band scrolls —
    # and its tail must be no wider than the control's, in count and size.
    assert same_decisions(ctl_inf, gpu_inf), "PF prefix: control decisions"
    assert same_decisions(cpu_inf, gpu_inf), \
        "PF prefix: resample indices differ"
    assert all(b_[0] == b_[1] for b_ in best), "PF prefix: best particle"
    assert cpu_pf.n_scrolls == gpu_pf.n_scrolls == cpu_pf.n_reorgs \
        == gpu_pf.n_reorgs >= 1, "PF prefix: band scrolls differ"
    assert not scroll_check["differing_arrays"] and any(
        scroll_check["shift_cells"]), f"PF prefix: scroll {scroll_check}"
    assert beyond <= 2 * ctl_beyond, \
        f"PF prefix: {beyond} particle-updates beyond 1 mm (control " \
        f"{ctl_beyond})"
    assert dxy <= lim_xy and dth <= lim_th, "PF prefix: particles diverge"
    assert bool(torch.equal(cpu_pf.pset.res_org,
                            gpu_pf.pset.res_org.cpu())), "PF prefix: org"
    assert sum(grids_diff.values()) <= 1e-3 * n_cells, \
        f"PF prefix: resident grids differ {grids_diff}"
    del cpu_pf, gpu_pf, ctl_pf

    # 8. the bench_pf.py workload on the card -------------------------------
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    passes = []
    for rep in range(bench_reps(3)):
        passes.append(pf_pass(torch, dev, data, opts, staged, rep))
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    # the kernels of one more pass, rep 0's, untimed (counted_pass)
    dp = devprof()
    acc, launches = counted_pass(
        lambda: fresh(PFSlam2D, opts, dev, data.poses_gt[0]),
        one_by_one(staged, data.odometry), len(staged),
        {"deposit_pair_batched": dp.DEPOSIT, "edt2d_batched": dp.EDT,
         "gn_batch_solve": dp.GN_SOLVE, "motion": dp.MOTION}, tries=2)
    updates = sum(k > 0 for k in acc)      # after the first, as timed
    rates = sorted(p["updates_per_s"] for p in passes)
    emit({"phase": "pf_main_path", "passes": passes,
          "median_updates_per_s": rates[len(rates) // 2],
          "counted_updates": updates, "launches": launches,
          "launches_per_update": {n: v / updates
                                  for n, v in launches.items()},
          "peak_mem_mb": peak_mb, "before_mem_mb": base_mem / 2 ** 20})
    for p in passes:
        assert p["final_err_m"] < PF_ERR_BOUND_M, \
            f"PF final error {p['final_err_m']:.4f} m"
        assert p["reorgs"] >= 1, "PF: no re-org"
    # the counted pass did rep 0's work; the map update deposits through
    # the pair; each update's motion queue goes in one launch
    assert updates == passes[0]["updates"], (updates, passes[0]["updates"])
    assert all(launches[n] > 0 for n in ("deposit_pair_batched",
                                         "edt2d_batched", "gn_batch_solve")
               ), f"launches {launches}"
    assert launches["motion"] == updates, f"launches {launches}"
    for kern in pf_kernels:
        kern["launches"] = launches.get(kern["name"], 0)
    return pf_kernels


def value_scatter_edges(torch, ly, lx, vals) -> dict:
    """B7 and B8 beyond phase 9's grid, each ``torch.equal`` to its plain
    version: the phase's stream moved into [768, 1024] (a larger grid), and
    every element of it on one cell (20 calls of each); B7 with values 1
    and ``vals``, B8 on the words unsorted and sorted. Returns each case's
    grid."""
    from iris_lama_tpu_torch.ops import scatter_pallas as sp
    from iris_lama_tpu_torch.ops import scatter_sorted as ss
    n = ly.numel()
    ones = torch.ones_like(ly)
    hot = torch.full_like(ly, 200)
    out = {}
    for name, shape, cy, cx, calls in (
            ("multi_band", (768, 1024), ly + 160, lx + 300, 1),
            ("hot_cell", (448, 512), hot, hot + 100, 20)):
        for v in (ones, vals):
            want = sp.scatter_add_2d_plain(cy, cx, v, shape)
            for _ in range(calls):
                got = sp.scatter_add_2d(cy, cx, v, shape)
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"B7 {name} differs"
        want = sp.scatter_add_2d_plain(cy, cx, ones, shape)
        words = ss.pack_updates(cy, cx, ones)
        for w in (words, torch.sort(words).values):
            for _ in range(calls):
                got = ss.scatter_add_sorted(w, shape)
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"B8 {name} differs"
        out[name] = {"hw": list(shape), "n": n, "calls": calls}
    return out


def value_scatter_launch(torch, dev, call, n: int, reps: int) -> dict:
    """B7's or B8's launch for ``n`` elements: its blocks; from one profile
    of ``reps`` calls, the device activities a call (one: the cooperative
    launch, no memset) and the device time a call, taken per recorded
    activity (the profiler can drop an event, never add one; a dropped
    one would bias a mean over the calls low); ``kernel_ms`` as in
    :func:`timings`; and the floors of that launch shape (csrc/floor.cu:
    an empty cooperative kernel, and one that meets at one grid
    barrier)."""
    from iris_lama_tpu_torch.ops import _cuda, scatter_pallas as sp
    reps = depth(reps, max(3, reps // 4))
    blocks = sp.launch_blocks(n)
    dp = devprof()
    call()
    rows = dp.cuda_rows(dp.profile_calls(call, reps))
    events = dp.launch_count(rows)
    assert 0 < events <= reps, f"{events} device activities in {reps} calls"
    lib = _cuda.library("floor")
    stream = _cuda.stream_handle(dev)

    def floor(sync):
        def fn():
            _cuda.check(lib.launch_floor_cooperative(blocks, sp.THREADS, sync,
                                                     stream),
                        "launch_floor_cooperative")
        return device_ms(torch, fn, 1000)[0]

    return {"blocks": blocks, "threads": sp.THREADS,
            "activities_per_call": events / reps,
            "ms": dp.device_us(rows) / events / 1e3,
            "ms_source": "profiler, per recorded activity",
            "kernel_ms": cuda_time_ms(torch, call, reps),
            "launch_floor_ms": floor(0), "barrier_floor_ms": floor(1)}


def loc_setup(torch, dev) -> dict:
    """bench_loc.py's workload: the log (SimConfig(n_steps=200, seed=7,
    laps=1), 720 beams padded to 768), the fixed map that its Slam2D builds
    over the log on the card, its Loc2DOptions and the device-staged
    scans."""
    from iris_lama_tpu_torch.algos import loc2d
    from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils import simulator, state
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    data = simulator.simulate(simulator.SimConfig(
        n_steps=200, seed=7, laps=1,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    odoms = list(data.odometry)
    padded = [pad_scan(c, beam_bucket(720)) for c in data.clouds]
    sopts_map = Slam2DOptions(resolution=0.05, max_range=10.0,
                              trans_thresh=0.2, rot_thresh=0.2,
                              capacity=8192)
    slam = Slam2D(sopts_map, device=dev)
    slam.set_prior(Pose2D(*data.poses_gt[0]))
    slam.update_many_prepadded(
        [tuple(torch.as_tensor(a, device=dev) for a in p) for p in padded],
        odoms)
    maps = loc2d.maps_from_slam(slam.map, slam.cfg)
    opts = loc2d.Loc2DOptions(resolution=0.05, l2_max=0.5, max_range=10.0,
                              trans_thresh=0.1, rot_thresh=0.1)
    staged = [(torch.as_tensor(np.ascontiguousarray(p[:, :2]), device=dev),
               torch.as_tensor(m, device=dev)) for p, m, _ in padded]
    return {"data": data, "odoms": odoms, "padded": padded, "maps": maps,
            "maps_np": state.locmaps_to_numpy(maps), "map_cfg": slam.cfg,
            "slam_map": slam.map, "opts": opts, "staged": staged}


def loc_kernel_inputs(torch, dev, lw) -> dict:
    """Phase 9's inputs on loc_setup's workload ``lw``: Loc2D (``solve``)
    after 11 updates, the pose predicted for scan 11 and its 576 x 576
    match window; B4's arguments at one particle and at eight, each at the
    (noisy) true pose of a scan of its own."""
    from iris_lama_tpu_torch.algos import loc2d
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.core.pose import Pose2D

    data, odoms, staged = lw["data"], lw["odoms"], lw["staged"]
    loc = loc2d.Loc2D(lw["opts"], maps=lw["maps"], device=dev, match="solve")
    loc.set_prior(Pose2D(*data.poses_gt[0]))
    loc.update_many_prepadded(staged[:11], odoms[:11])
    k = 11
    od = torch.as_tensor((loc.odom_ - odoms[k]).se2_array(), device=dev)
    pose0 = lie.se2_compose(loc._pose_dev, od)
    sub, sub_org = loc.match_window(pose0)
    pts, msk = staged[k]
    geo, sop = loc.geo, loc.sopts
    b4_kw = dict(max_dist=loc.max_dist, res=geo.resolution, scale=geo.scale,
                 cell_offset=geo.cell_offset, cauchy_c=sop.robust.param,
                 eps1=sop.eps1, eps2=sop.eps2,
                 max_iter=sop.max_iterations)
    g = torch.Generator().manual_seed(3)
    noise = (torch.rand((8, 3), generator=g) - 0.5) * torch.tensor(
        [0.2, 0.2, 0.1])
    wins, orgs, starts = [], [], []
    for j in range(8):
        x, y, th = (data.poses_gt[k + j] + noise[j].numpy())
        pj = lie.se2(x, y, th, device=dev)
        w_j, o_j = loc.match_window(pj)
        wins.append(w_j)
        orgs.append(o_j)
        starts.append(pj)
    return {"loc": loc, "k": k, "pose0": pose0, "sub": sub,
            "sub_org": sub_org, "pts": pts, "msk": msk, "b4_kw": b4_kw,
            "b4_args": (sub[None], sub_org[None], pose0[None].contiguous(),
                        pts, msk),
            "b4p_args": (torch.stack(wins), torch.stack(orgs),
                         torch.stack(starts),
                         torch.stack([staged[k + j][0] for j in range(8)]),
                         torch.stack([staged[k + j][1] for j in range(8)]))}


def loc_phases(torch, dev) -> list:
    """Phases 9-11 (Loc2D, the bench_loc.py workload): B4, B5, B2, B7 and
    B8 against their plain versions, the first ``LOC_PREFIX`` updates on the
    CPU and on the card, then the workload in every match mode on the
    card. Returns the kernels line's entries of this path."""
    from iris_lama_tpu_torch.algos import loc2d
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.match import match_surface_2d as match_mod
    from iris_lama_tpu_torch.nlls import solver as nlls_solver
    from iris_lama_tpu_torch.ops import gn_solve, match_eval, scatter_pallas
    from iris_lama_tpu_torch.ops import scatter_sorted, select4
    from iris_lama_tpu_torch.sdm import mapping
    from iris_lama_tpu_torch.utils import state

    t_start = time.perf_counter()
    lw = loc_setup(torch, dev)
    data, odoms, padded, staged = (lw[n] for n in (
        "data", "odoms", "padded", "staged"))
    maps, maps_np, map_cfg, opts = (lw[n] for n in (
        "maps", "maps_np", "map_cfg", "opts"))
    n_steps = len(data.clouds)
    map_mb = sum(a.nbytes for a in maps_np.values()) / 2 ** 20

    # 9. the kernels at Loc2D's shapes, on the bench map --------------------
    kin = loc_kernel_inputs(torch, dev, lw)
    loc, k, pose0, sub, sub_org, pts, msk = (kin[n] for n in (
        "loc", "k", "pose0", "sub", "sub_org", "pts", "msk"))
    b4_kw, b4_args, b4p_args = kin["b4_kw"], kin["b4_args"], kin["b4p_args"]
    geo, sop = loc.geo, loc.sopts
    b = pts.shape[0]
    # the edges of the design with a scan per particle: 255, 257 and 2048
    # beams, windows read from global memory (576 x 576, and 459 x 459, one
    # row beyond the largest staged at 768 beams) and staged (432 x 432)
    b4_edges = solve_edges(torch, dev, gn_solve, (
        (2, (576, 576), 255), (2, (576, 576), 257), (2, (459, 459), 768),
        (3, (432, 432), 768), (2, (432, 432), 2048), (2, (576, 576), 2049),
        (2, (432, 432), 4096, "int16"), (2, (576, 576), 768, "uint8"),
        (2, (432, 432), 768, "int32")))
    b4_rows = {}
    for label, args in (("p1", b4_args), ("p8", b4p_args)):
        got = gn_solve.solve_window_sq(*args, **b4_kw, want_lik=True)
        want = gn_solve.solve_window_sq_plain(*args, **b4_kw, want_lik=True)
        torch.cuda.synchronize()
        err = float((got[0] - want[0]).abs().max())
        for name, a, w in zip(("state", "iterations", "chi2", "sum_d2"),
                              got, want):
            assert torch.equal(a, w), f"B4 {label} {name} differs ({err})"
        it = got[1]
        # bytes: the windows once, the scans, the starts and the rows;
        # operations: ~60 per beam and evaluation over the timed calls'
        # evaluations (the start and each iteration's candidate; no SSE,
        # as on the main path)
        n_p = args[0].shape[0]
        evals = int(it.sum()) + n_p
        scan_bytes = args[3].numel() * 4 + args[4].numel()
        bd = bound(args[0].numel() + scan_bytes + n_p * (8 + 16 + 32),
                   60 * b * evals)
        b4_rows[label] = {
            "shape": list(args[0].shape) + [b], "max_abs_err": err,
            "iters": it.tolist(),
            **timings(torch, "", lambda: gn_solve.solve_window_sq(
                *args, **b4_kw), 100),
            **timings(torch, "plain_", lambda: gn_solve.solve_window_sq_plain(
                *args, **b4_kw), 5),
            "bound_ms": bd[0], "bound_by": bd[1]}
    b4 = {"name": "gn_solve_batched", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/gn_solve.cu",
          "replaces": "iris_lama_tpu/ops/gn_solve.py:104",
          "variant": "shared" if gn_solve.staged(*sub.shape, b)
                     else "global",
          "edge_cases": b4_edges,
          **b4_rows["p1"], "p8_per_particle_scans": b4_rows["p8"],
          "library_ms": None,
          "library_call": "none: no single PyTorch call computes an IRLS "
                          "solve"}
    # B4's other widths on the same window (an exact widening)
    b4_widths = []
    ref8 = gn_solve.solve_window_sq(*b4_args, **b4_kw, want_lik=True)
    for width in WIDTHS:
        args_w = (widened(torch, b4_args[0], width), *b4_args[1:])
        got_w = gn_solve.solve_window_sq(*args_w, **b4_kw, want_lik=True)
        want_w = gn_solve.solve_window_sq_plain(*args_w, **b4_kw,
                                                want_lik=True)
        torch.cuda.synchronize()
        for name, a, w_, i8 in zip(("state", "iterations", "chi2", "sum_d2"),
                                   got_w, want_w, ref8):
            assert torch.equal(a, w_) and torch.equal(a, i8), \
                f"B4 {width} {name} differs"
        evals = int(got_w[1].sum()) + 1
        bd = bound(args_w[0].numel() * args_w[0].element_size()
                   + b * 9 + 56, 60 * b * evals)
        b4_widths.append({
            "name": f"gn_solve_batched_{width}", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/gn_solve.cu",
            "replaces": "iris_lama_tpu/ops/gn_solve.py:104",
            "shape": list(args_w[0].shape) + [b], "dtype": width,
            "max_abs_err": 0.0,
            **timings(torch, "", lambda: gn_solve.solve_window_sq(
                *args_w, **b4_kw), 100),
            **timings(torch, "plain_", lambda: gn_solve.solve_window_sq_plain(
                *args_w, **b4_kw), 3),
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes an IRLS "
                            "solve",
            "bound_ms": bd[0], "bound_by": bd[1]})

    # B5: one evaluation at the predicted pose, as the fused loop makes it
    hits = lie.se2_apply(pose0, pts)
    mi, mu = geo.w2m_frac(hits)
    loc_c = mi - sub_org
    # the operands as match_surface_2d._solve_window_fused passes them:
    # views of the [768, 2] cells, fractions and hits
    b5_args = (sub, loc_c[:, 1], loc_c[:, 0], mu[:, 0], mu[:, 1],
               hits[:, 0], hits[:, 1], msk.to(torch.float32))
    b5_kw = dict(max_dist=loc.max_dist, res=geo.resolution, scale=geo.scale,
                 cauchy_c=sop.robust.param)
    got = match_eval.gn_eval_sq(*b5_args, **b5_kw)
    want = match_eval.gn_eval_sq_plain(*b5_args, **b5_kw)
    torch.cuda.synchronize()
    b5_err = float((got - want).abs().max())
    assert torch.equal(got, want), f"B5 differs ({b5_err})"
    bd = bound(b * (7 * 4 + 4) + 40, 60 * b)
    b5 = {"name": "gn_eval_sq", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/match_eval.cu",
          "replaces": "iris_lama_tpu/ops/match_eval.py:122",
          "shape": list(sub.shape) + [b], "max_abs_err": b5_err,
          "edge_cases": eval_edges(torch, dev),
          "launch_floor_ms": b5_floor_ms(torch, dev, 1, b),
          **timings(torch, "", lambda: match_eval.gn_eval_sq(
              *b5_args, **b5_kw), 300),
          **timings(torch, "plain_", lambda: match_eval.gn_eval_sq_plain(
              *b5_args, **b5_kw), 100),
          "library_ms": None,
          "library_call": "none: no single PyTorch call computes the ten "
                          "weighted normal-equation sums",
          "bound_ms": bd[0], "bound_by": bd[1]}
    b5_widths = []
    for k_w, width in enumerate(WIDTHS):
        sub_w = width_grid(torch, sub, width, 40 + k_w)
        args_w = (sub_w, *b5_args[1:])
        for a_ in ((widened(torch, sub, width), *b5_args[1:]), args_w):
            got = match_eval.gn_eval_sq(*a_, **b5_kw)
            want = match_eval.gn_eval_sq_plain(*a_, **b5_kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"B5 {width} differs"
        assert torch.equal(match_eval.gn_eval_sq(
            widened(torch, sub, width), *b5_args[1:], **b5_kw),
            match_eval.gn_eval_sq(*b5_args, **b5_kw)), f"B5 {width} vs int8"
        bd = bound(b * (7 * 4 + 4 * sub_w.element_size()) + 40, 60 * b)
        b5_widths.append({
            "name": f"gn_eval_sq_{width}", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/match_eval.cu",
            "replaces": "iris_lama_tpu/ops/match_eval.py:122",
            "shape": list(sub.shape) + [b], "dtype": width,
            "max_abs_err": 0.0,
            **timings(torch, "", lambda: match_eval.gn_eval_sq(
                *args_w, **b5_kw), 300),
            **timings(torch, "plain_", lambda: match_eval.gn_eval_sq_plain(
                *args_w, **b5_kw), 100),
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes the ten "
                            "weighted normal-equation sums",
            "bound_ms": bd[0], "bound_by": bd[1]})

    # B2 at Loc2D's shapes: the scan's cells at the predicted pose in the
    # 576 x 576 match window, as the covariance/RMSE evaluation (and each
    # evaluation of `sq`) gives them
    s_ly, s_lx = b5_args[1], b5_args[2]
    got = select4.select4_sq(sub, s_ly, s_lx)
    want = select4.select4_sq_plain(sub, s_ly, s_lx)
    torch.cuda.synchronize()
    b2_err = int((got - want).abs().max())
    assert torch.equal(got, want), f"B2 at Loc2D's shapes: err {b2_err}"
    hs, ws = sub.shape
    y0, y1 = s_ly.clamp(0, hs - 1).long(), (s_ly + 1).clamp(0, hs - 1).long()
    x0, x1 = s_lx.clamp(0, ws - 1).long(), (s_lx + 1).clamp(0, ws - 1).long()

    def b2_library():
        return (sub[y0, x0], sub[y0, x1], sub[y1, x0], sub[y1, x1])

    bd = bound(b * (8 + 4 + 16), b * 8)
    b2 = {"name": "select4_sq_loc2d", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/select4.cu",
          "replaces": "iris_lama_tpu/ops/select4.py:36",
          "n": b, "hw": [hs, ws], "max_abs_err": b2_err,
          "in_window": float(((s_ly >= 0) & (s_ly < hs) & (s_lx >= 0)
                              & (s_lx < ws)).float().mean()),
          "edge_cases": select4_edges(torch, dev),
          "launch_floor_ms": b2_floor_ms(torch, dev, b),
          **timings(torch, "", lambda: select4.select4_sq(
              sub, s_ly, s_lx), 1000),
          **timings(torch, "plain_", lambda: select4.select4_sq_plain(
              sub, s_ly, s_lx), 1000),
          **timings(torch, "library_", b2_library, 1000),
          "library_call": "four advanced-index reads",
          "bound_ms": bd[0], "bound_by": bd[1]}

    # B7 / B8: the Slam2D deposit's free-space stream of one scan (its
    # in-window elements) into [448, 512]
    wu = map_cfg.resident_update_cells
    pose_s = lie.se2(*data.poses_gt[k], device=dev)
    p3 = torch.as_tensor(padded[k][0], device=dev)
    ori = torch.as_tensor(padded[k][2], device=dev)
    idx = mapping.deposit_indices(map_cfg, pose_s,
                                  p3, msk, ori,
                                  geo.w2m(pose_s[:2]) - wu // 2, wu)
    ok = idx.free_ly < wu
    sly = idx.free_ly[ok].contiguous()
    slx = idx.free_lx[ok].contiguous()
    n_s = int(sly.numel())
    shape = (wu, (wu + 127) // 128 * 128)
    ones = torch.ones(n_s, dtype=torch.int32, device=dev)
    vals = torch.randint(-3, 4, (n_s,), dtype=torch.int32, device=dev)
    for v in (ones, vals):
        got = scatter_pallas.scatter_add_2d(sly, slx, v, shape)
        want = scatter_pallas.scatter_add_2d_plain(sly, slx, v, shape)
        torch.cuda.synchronize()
        assert torch.equal(got, want), "B7 differs"
    packed = scatter_sorted.pack_updates(sly, slx, ones)
    packed_sorted = torch.sort(packed).values
    for words in (packed, packed_sorted):
        got = scatter_sorted.scatter_add_sorted(words, shape)
        torch.cuda.synchronize()
        assert torch.equal(
            got, scatter_sorted.scatter_add_sorted_plain(words, shape)), \
            "B8 differs"
        assert torch.equal(got, scatter_pallas.scatter_add_2d_plain(
            sly, slx, ones, shape)), "B8 differs from the value scatter"
    # beyond this grid: a larger grid, every element on one cell
    value_edges = value_scatter_edges(torch, sly, slx, vals)
    flat = sly.long() * shape[1] + slx.long()

    def index_put_library():
        torch.zeros(shape[0] * shape[1], dtype=torch.int32,
                    device=dev).index_put_((flat,), ones, accumulate=True)

    def index_add_library():
        torch.zeros(shape[0] * shape[1], dtype=torch.int32,
                    device=dev).index_add_(0, flat, ones)

    def b7_call():
        return scatter_pallas.scatter_add_2d(sly, slx, ones, shape)

    def b8_call():
        return scatter_sorted.scatter_add_sorted(packed_sorted, shape)

    grid_bytes = shape[0] * shape[1] * 4
    b7_bd = bound(n_s * 12 + grid_bytes, n_s)
    b7 = {"name": "scatter_add_2d", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/deposit.cu",
          "replaces": "iris_lama_tpu/ops/scatter_pallas.py:28",
          "n": n_s, "hw": list(shape), "max_abs_err": 0,
          **value_scatter_launch(torch, dev, b7_call, n_s, 300),
          **timings(torch, "plain_", lambda: scatter_pallas.scatter_add_2d_plain(
              sly, slx, ones, shape), 300),
          **timings(torch, "library_", index_put_library, 100),
          "library_call": "zeros + index_put_(accumulate=True)",
          **timings(torch, "index_add_", index_add_library, 100),
          "index_add_call": "zeros + index_add_ on the flattened grid",
          "edges": value_edges,
          "bound_ms": b7_bd[0], "bound_by": b7_bd[1]}
    b8_bd = bound(n_s * 4 + grid_bytes, n_s * 10)
    b8 = {"name": "scatter_add_sorted", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/deposit.cu",
          "replaces": "iris_lama_tpu/ops/scatter_sorted.py:47",
          "n": n_s, "hw": list(shape), "max_abs_err": 0,
          **value_scatter_launch(torch, dev, b8_call, n_s, 300),
          **timings(torch, "plain_",
                    lambda: scatter_sorted.scatter_add_sorted_plain(
                        packed_sorted, shape), 300),
          **timings(torch, "library_", index_put_library, 100),
          "library_call": "zeros + index_put_(accumulate=True)",
          **timings(torch, "index_add_", index_add_library, 100),
          "index_add_call": "zeros + index_add_ on the decoded cells",
          "bound_ms": b8_bd[0], "bound_by": b8_bd[1]}
    loc_kernels = [b4, *b4_widths, b5, *b5_widths, b2, b7, b8]
    for kern in loc_kernels:
        emit({"phase": "loc_kernel", **kern})
    del loc, kin, b4p_args, idx

    # 10. prefix: CPU plain versions vs the card, one map ------------------
    maps_cpu = state.locmaps_from_numpy(maps_np, "cpu")
    prefix = {}
    for mode in ("solve", "fused"):
        runs = []
        for device, mp in (("cpu", maps_cpu), (dev, maps)):
            lc = loc2d.Loc2D(opts, maps=mp, device=device, match=mode)
            lc.set_prior(Pose2D(*data.poses_gt[0]))
            st = [tuple(t.to(device) for t in s)
                  for s in staged[:LOC_PREFIX + 1]]
            t0 = time.perf_counter()
            acc = lc.update_many_prepadded(st, odoms[:LOC_PREFIX + 1])
            runs.append((acc, lc.trajectory(), lc.covariance(), lc.rmse(),
                         time.perf_counter() - t0))
        (acc_c, tc, cc, rc, t_c), (acc_g, tg, cg, rg, _) = runs
        dxy = float(np.abs(tc[:, :2] - tg[:, :2]).max())
        dth = float(np.abs(np.angle(np.exp(1j * (tc[:, 2]
                                                 - tg[:, 2])))).max())
        prefix[mode] = {"accepted": len(acc_c), "cpu_s": t_c,
                        "max_dxy_m": dxy, "max_dtheta_rad": dth,
                        "cov_max_rel_diff": float(
                            np.abs(cc - cg).max() / np.abs(cc).max()),
                        "rmse_rel_diff": abs(rc - rg) / max(rc, 1e-12)}
        assert acc_c == acc_g, f"Loc2D prefix {mode}: accepted differ"
        assert dxy <= 1e-3 and dth <= 1e-3, \
            f"Loc2D prefix {mode}: poses differ {dxy} m {dth} rad"
    # one gloc round on both from the same draws
    gk = LOC_PREFIX
    gloc = []
    for device, mp in (("cpu", maps_cpu), (dev, maps)):
        gen = torch.Generator().manual_seed(5)

        def draw(kind, shape, device=device, gen=gen):
            return torch.rand(shape, generator=gen).to(device)

        lc = loc2d.Loc2D(opts, maps=mp, device=device)
        p_g, s_g = loc2d.global_localization_kernel(
            mp, lc.geo, lc.max_dist, staged[gk][0].to(device),
            staged[gk][1].to(device), opts.gloc_particles, draw)
        gloc.append((p_g.cpu().numpy(), float(s_g)))
    (pc, sc), (pg, sg) = gloc
    gloc_dxy = float(np.abs(pc[:2] - pg[:2]).max())
    emit({"phase": "loc_prefix", "updates": LOC_PREFIX, "modes": prefix,
          "gloc_same_hypothesis_dxy_m": gloc_dxy,
          "gloc_sse": [sc, sg],
          "gloc_true_pose": [float(v) for v in data.poses_gt[gk]],
          "gloc_pose_xy": [float(pg[0]), float(pg[1])]})
    assert gloc_dxy <= 1e-4, f"Loc2D gloc: hypotheses differ by {gloc_dxy}"
    del maps_cpu

    # 11. the bench_loc.py workload on the card, every match mode ----------
    dp = devprof()
    kernels = {"gn_solve_batched": dp.GN_SOLVE, "gn_eval_sq": dp.GN_EVAL,
               "select4_sq": dp.SELECT4}

    def one_pass(mode, rep, p, scans=n_steps):
        lc = loc2d.Loc2D(opts, maps=maps, device=dev, match=mode)
        lc.set_prior(Pose2D(data.poses_gt[0][0] + (rep * 7 + p) * 1e-4,
                            data.poses_gt[0][1], data.poses_gt[0][2]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = lc.update_many_prepadded(staged[:scans], odoms[:scans])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        est = lc.trajectory()[-len(acc):]
        gt = np.asarray([data.poses_gt[i] for i in acc])
        err = float(np.sum(np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)))
        return dt, err, len(acc), lc.n_gathers

    modes = {}
    for mode in loc2d.MATCH_MODES:
        one_pass(mode, 9, 0)                       # warm-up, discarded
        reads0 = host_reads("loc_cell", "irls_stop")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reps = []
        for rep in range(bench_reps(3)):
            t_tot = err_sum = 0.0
            n_tot = gathers = 0
            for p in range(LOC_PASSES):
                dt, es, n, ng = one_pass(mode, rep, p)
                t_tot += dt
                err_sum += es
                n_tot += n
                gathers += ng
            reps.append({"updates_per_s": n_tot / t_tot,
                         "mean_err_m": err_sum / n_tot, "updates": n_tot,
                         "seconds": t_tot, "gathers": gathers})
        updates = sum(r["updates"] for r in reps)
        rates = sorted(r["updates_per_s"] for r in reps)
        modes[mode] = {
            "reps": reps, "median_updates_per_s": rates[len(rates) // 2],
            "host_reads_per_update": (host_reads("loc_cell", "irls_stop")
                                      - reads0) / updates,
            "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20}
        # the kernels and every device activity (kernels, copies, fills) of
        # the first LOC_PROFILED scans of one more pass, counted by the
        # profiler (whose overhead on a whole pass of the generic modes is
        # ~75 s)
        counted, launches = dp.launches_by_name(
            lambda: one_pass(mode, 8, 0, depth(LOC_PROFILED, 20)),
            {**kernels, "all": ""}, tries=2)
        n_dev = launches.pop("all")
        modes[mode].update(
            launches=launches,
            launches_per_update={n: v / counted[2]
                                 for n, v in launches.items()},
            device_launches_per_update=n_dev / counted[2])
        emit({"phase": "loc_main_path", "mode": mode, **modes[mode]})
        for r in reps:
            assert r["mean_err_m"] < LOC_ERR_BOUND_M, \
                f"Loc2D {mode}: mean error {r['mean_err_m']:.4f} m"
    lpu = {m: v["launches_per_update"] for m, v in modes.items()}
    assert lpu["solve"]["gn_solve_batched"] == 1.0, lpu["solve"]
    assert lpu["fused"]["gn_eval_sq"] >= 1.0, lpu["fused"]
    assert all(lpu[m]["select4_sq"] > 0 for m in ("sq", "solve", "fused"))
    assert lpu["generic"]["select4_sq"] == 0, lpu["generic"]

    # the live per-scan API (bench_loc.py IRIS_LOC_BENCH_SEQ=1), solve mode
    lc = loc2d.Loc2D(opts, maps=maps, device=dev, match="solve")
    lc.set_prior(Pose2D(*data.poses_gt[0]))
    lc.has_first_scan = True
    lc.odom_ = odoms[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = [i for i in range(1, n_steps)
           if lc.update(data.clouds[i], odoms[i], data.timestamps[i])]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    est = lc.trajectory()[-len(acc):]
    gt = np.asarray([data.poses_gt[i] for i in acc])
    live_err = float(np.mean(np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)))
    assert live_err < LOC_ERR_BOUND_M, f"Loc2D live: {live_err:.4f} m"

    # one 3000-hypothesis global-localisation round, and the covariance
    lc = loc2d.Loc2D(opts, maps=maps, device=dev)
    gpts, gmsk = staged[gk]
    gen = torch.Generator().manual_seed(6)

    def gloc_round():
        return loc2d.global_localization_kernel(
            maps, lc.geo, lc.max_dist, gpts, gmsk, opts.gloc_particles,
            lambda kind, shape: torch.rand(shape, generator=gen).to(dev))

    gloc_round()
    torch.cuda.synchronize()
    gloc_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        gloc_round()
        torch.cuda.synchronize()
        gloc_ms.append((time.perf_counter() - t0) * 1e3)
    r_eval, j_eval = match_mod.make_window_eval(
        sub, sub_org, geo, lc.max_dist, pts, msk)(pose0)
    cov_ms = timings(torch, "", lambda: nlls_solver.covariance_from_eval(
        r_eval, j_eval, sop.robust), 50)
    rate = modes["solve"]["median_updates_per_s"]
    emit({"phase": "loc_extra",
          "live_update_api": {"mode": "solve", "updates": len(acc),
                              "updates_per_s": len(acc) / dt,
                              "mean_err_m": live_err},
          "gloc_round_ms": gloc_ms, "gloc_particles": opts.gloc_particles,
          "covariance": {**cov_ms,
                         "share_of_solve_update": cov_ms["kernel_ms"]
                         * rate / 1e3},
          "map_mb": map_mb, "seconds": time.perf_counter() - t_start})
    for kern in loc_kernels:      # summed over phase 11's profiled passes
        counter = kern["name"].removesuffix("_loc2d")
        kern["launches"] = sum(m["launches"].get(counter, 0)
                               for m in modes.values())
    return loc_kernels


def fine_phases(torch, dev) -> dict:
    """Phase 12: squared-distance windows wider than int8 on their paths.
    Slam2D at 4 cm cells (uint8 windows) and 3 cm (int16) over the first
    ``FINE_SCANS`` scans of the phase 5 workload, and PFSlam2D at 4 cm over
    the first ``FINE_PF`` updates of the phase 8 workload, each on the CPU
    (plain versions) and on the card (kernels), the card's runs under the
    profiler: the same accepted scans, resample decisions and best
    particle, poses within 1 mm / 1e-3 rad, the window of the expected
    width, and B4 (Slam2D) or B6 (PF) launched at that width (the element
    type in the kernel's name). Returns {kernels-line name: launches}."""
    import dataclasses
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
    from iris_lama_tpu_torch.algos.slam2d import Slam2D
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils.evaluation import ate_rmse

    dp = devprof()

    def kernels(width):
        """Phase 12's counts: B4/B6 at every width and at ``width``."""
        return {"select4_sq": dp.SELECT4, "gn_solve": dp.GN_SOLVE,
                f"gn_solve_{width}": dp.typed(dp.GN_SOLVE, width),
                "deposit_pair": dp.DEPOSIT, "edt2d": dp.EDT}

    out = {}

    def pose_diff(a, g):
        dth = np.angle(np.exp(1j * (a[..., 2] - g[..., 2])))
        return float(np.abs(a[..., :2] - g[..., :2]).max()), \
            float(np.abs(dth).max())

    data, opts, padded = slam_workload()
    for res, width in ((0.04, "uint8"), (0.03, "int16")):
        o = dataclasses.replace(opts, resolution=res)
        runs = []
        for device in ("cpu", dev):
            staged = [tuple(torch.as_tensor(a, device=device) for a in p)
                      for p in padded[:FINE_SCANS]]

            def run():
                slam = Slam2D(o, device=device)
                slam.set_prior(Pose2D(*data.poses_gt[0]))
                return slam, slam.update_many_prepadded(
                    staged, data.odometry[:FINE_SCANS])

            t0 = time.perf_counter()
            slam, acc = run()
            if device != "cpu":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if device != "cpu":
                # a fresh driver's run again, untimed, under the profiler
                _, counts = dp.launches_by_name(run, kernels(width), tries=2)
            runs.append((acc, slam.trajectory(), str(slam._res_dist.dtype),
                         slam.escaped_count(), dt))
        (acc_c, tc, dt_c, _, s_c), (acc_g, tg, dt_g, esc, s_g) = runs
        dxy, dth = pose_diff(tc, tg)
        gt = np.asarray([data.poses_gt[k] for k in acc_g])
        ate = ate_rmse(tg, gt)
        n_b4 = counts[f"gn_solve_{width}"]
        emit({"phase": "fine_slam2d", "resolution": res, "dtype": dt_g,
              "scans": FINE_SCANS, "accepted": len(acc_g), "cpu_s": s_c,
              "card_s": s_g, "max_dxy_m": dxy, "max_dtheta_rad": dth,
              "ate_m": ate, "escaped": esc, "launches": counts})
        assert acc_c == acc_g, f"Slam2D {res} m: accepted scans differ"
        assert dt_c == dt_g == f"torch.{width}", (dt_c, dt_g)
        assert dxy <= 1e-3 and dth <= 1e-3, f"Slam2D {res} m: poses differ"
        assert ate < ATE_BOUND_M and esc == 0, f"Slam2D {res} m: {ate}, {esc}"
        assert n_b4 == len(acc_g) - 1, \
            f"Slam2D {res} m: B4 at {width} launched {n_b4} times"
        out[f"gn_solve_batched_slam2d_{width}"] = n_b4

    data, opts, padded = pf_workload()
    o = dataclasses.replace(opts, resolution=0.04)
    runs = []
    for device in ("cpu", dev):
        staged = [tuple(torch.as_tensor(a, device=device) for a in p)
                  for p in padded[:FINE_PF + 1]]

        def run():
            f = fresh(PFSlam2D, o, device, data.poses_gt[0])
            infos = []
            for i in range(FINE_PF + 1):
                if f.update_prepadded(*staged[i], data.odometry[i]) and i:
                    infos.append((f.pset.pose.cpu().numpy(),
                                  f.pset.lineage.cpu().numpy(),
                                  f.best_particle_idx()))
            return infos, str(f.pset.res_dist.dtype)

        t0 = time.perf_counter()
        infos, dtype = run()
        if device != "cpu":
            torch.cuda.synchronize()
        runs.append((infos, dtype, time.perf_counter() - t0))
        if device != "cpu":
            # a fresh filter's run again, untimed, under the profiler
            _, counts = dp.launches_by_name(run, kernels("uint8"))
    (inf_c, dt_c, s_c), (inf_g, dt_g, s_g) = runs
    diffs = []
    for a, g in zip(inf_c, inf_g):
        pa = np.stack([a[0][:, 0], a[0][:, 1],
                       np.arctan2(a[0][:, 3], a[0][:, 2])], -1)
        pg = np.stack([g[0][:, 0], g[0][:, 1],
                       np.arctan2(g[0][:, 3], g[0][:, 2])], -1)
        diffs.append(pose_diff(pa, pg))
    dxy = max(d[0] for d in diffs)
    dth = max(d[1] for d in diffs)
    n_b6 = counts["gn_solve_uint8"]
    emit({"phase": "fine_pf", "resolution": 0.04, "dtype": dt_g,
          "updates": len(inf_g), "cpu_s": s_c, "card_s": s_g,
          "max_dxy_m": dxy, "max_dtheta_rad": dth,
          "resample_indices_equal": all(np.array_equal(a[1], g[1])
                                        for a, g in zip(inf_c, inf_g)),
          "best_particle_equal": all(a[2] == g[2]
                                     for a, g in zip(inf_c, inf_g)),
          "launches": counts})
    assert len(inf_c) == len(inf_g) == FINE_PF, "PF 4 cm: accepted"
    assert dt_c == dt_g == "torch.uint8", (dt_c, dt_g)
    assert all(np.array_equal(a[1], g[1]) and a[2] == g[2]
               for a, g in zip(inf_c, inf_g)), "PF 4 cm: decisions differ"
    assert dxy <= 1e-3 and dth <= 1e-3, f"PF 4 cm: particles {dxy} {dth}"
    assert n_b6 > 0, "PF 4 cm: B6 at uint8 never launched"
    out["gn_batch_solve_uint8"] = n_b6
    return out


@functools.lru_cache(maxsize=None)
def lo_workload():
    """bench_lidar.py's LidarOdometry2D workload: (data, options, scans
    padded to 768, ground truth relative to the start pose, path
    length)."""
    from iris_lama_tpu_torch.algos.lidar_odometry_2d import (
        LidarOdometry2DOptions)
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    data = simulator.simulate(simulator.SimConfig(
        n_steps=LO_SCANS, seed=3, smooth=4,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    opts = LidarOdometry2DOptions(resolution=0.05, max_range=10.0,
                                  capacity=4096)
    g0 = Pose2D(*data.poses_gt[0])
    rel_gt = np.asarray([(g0 - Pose2D(*p)).xyr() for p in data.poses_gt])
    path_len = float(np.sum(np.linalg.norm(np.diff(rel_gt[:, :2], axis=0),
                                           axis=1)))
    padded = [pad_scan(c, beam_bucket(720)) for c in data.clouds]
    return data, opts, padded, rel_gt, path_len


def map_window(state, cfg, pose) -> tuple:
    """(occupied, visited, dist) of the pool map ``state`` as numpy grids
    over the ``cfg.window_patches`` window centred at ``pose``."""
    from iris_lama_tpu_torch.sdm import window as win_mod
    geo, wp = cfg.geometry, cfg.window_patches
    org = win_mod.window_org(geo, geo.w2m(pose[:2]), wp)
    keys = win_mod.window_patch_keys(geo, org, wp)
    return tuple(
        win_mod.gather_window(state.table, arr, keys, default)[0].cpu()
        .numpy()
        for arr, default in ((state.occupied, 0), (state.visited, 0),
                             (state.dist, cfg.distance.max_dist)))


def lo_phases(torch, dev) -> list:
    """Phases 13-15: LidarOdometry2D's kernels at its shapes, the CPU/card
    prefix, and the bench_lidar.py workload. Returns the kernels-line
    entries of B1's pair and B3 at LidarOdometry2D's shapes, with their
    launches in phase 15."""
    from iris_lama_tpu_torch.algos.lidar_odometry_2d import LidarOdometry2D
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.ops import edt_pallas, scatter_matmul
    from iris_lama_tpu_torch.sdm import mapping
    from iris_lama_tpu_torch.sdm import window as win_mod
    from iris_lama_tpu_torch.sdm.occupancy import probabilistic_saturate

    data, opts, padded, rel_gt, path_len = lo_workload()
    cfg = opts.mapping_config()
    geo = cfg.geometry
    w = cfg.window_cells
    r, cap = cfg.distance.radius_cells, cfg.distance.max_sqdist

    # 13. B1's pair and B3 on the first scan's window (the first map
    # update: the identity pose)
    pts, msk, ori = (torch.as_tensor(a, device=dev) for a in padded[0])
    pose = lie.se2(0.0, 0.0, 0.0, device=dev)
    org = win_mod.window_org(geo, geo.w2m(pose[:2]), cfg.window_patches)
    idx = mapping.deposit_indices(cfg, pose, pts, msk, ori, org, w)
    hit = (idx.hit_ly, idx.hit_lx)
    free = (idx.free_ly, idx.free_lx)
    n_hit, n_free = idx.hit_ly.numel(), idx.free_ly.numel()
    got = scatter_matmul.deposit_pair(*hit, *free, w, w)
    want = scatter_matmul.deposit_pair_plain(*hit, *free, w, w)
    torch.cuda.synchronize()
    pair_err = max(int((g - x).abs().max()) for g, x in zip(got, want))
    assert all(torch.equal(g, x) for g, x in zip(got, want)), \
        f"B1 pair at LidarOdometry2D's [2,{w},{w}]: err {pair_err}"
    pair_library = deposit_library(torch, dev, [
        (idx.hit_ly[None], idx.hit_lx[None], (0, 1)),
        (idx.free_ly[None], idx.free_lx[None], (1,))], 1, w, w)
    pb = bound((n_hit + n_free) * 8 + 2 * w * w * 4, 2 * n_hit + n_free)
    pair = {"name": "deposit_pair_lo", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/deposit.cu",
            "replaces": "iris_lama_tpu/ops/scatter_matmul.py:81",
            "n_hit": n_hit, "n_free": n_free, "ray_steps": cfg.ray_steps,
            "hw": [w, w], "max_abs_err": pair_err,
            "cells_in_window": int((idx.free_ly < w).sum()
                                   + (idx.hit_ly < w).sum()),
            "launch_floor_ms": memset_floor_ms(
                torch, dev, 2 * w * w * 4,
                scatter_matmul.launch_blocks(1, [n_hit, n_free]), 256),
            **timings(torch, "", lambda: scatter_matmul.deposit_pair(
                *hit, *free, w, w), 300),
            **timings(torch, "plain_",
                      lambda: scatter_matmul.deposit_pair_plain(
                          *hit, *free, w, w), 300),
            **timings(torch, "library_", pair_library, 20),
            "library_call": "zeros + index_put_(accumulate=True) over both "
                            "grids' bins",
            "bound_ms": pb[0], "bound_by": pb[1]}
    occ_add, vis_add = got
    real = probabilistic_saturate(torch.zeros((w, w), device=dev), occ_add,
                                  vis_add - occ_add) > 0.0
    b3_err = 0
    for m in (real, b3_mask(torch, dev, (w, w), 0.01),
              b3_mask(torch, dev, (w, w), 0.3),
              b3_mask(torch, dev, (w, w), 1.0)):
        g3 = edt_pallas.edt2d(m, cap, r)
        w3 = edt_pallas.edt2d_plain(m, cap, r)
        torch.cuda.synchronize()
        b3_err = max(b3_err, int((g3 - w3).abs().max()))
        assert torch.equal(g3, w3), f"B3 at {w}^2, R={r}: err {b3_err}"
    # squared distances up to the cap: past the 255 of a byte
    assert cap > 255 and int(edt_pallas.edt2d(real, cap, r).max()) == cap
    eb = bound(w * w * (1 + 4), w * w * 4 * (2 * r + 1))
    edt = {"name": "edt2d_lo", "route": "cuda",
           "source": "iris_lama_tpu_torch/csrc/edt.cu",
           "replaces": "iris_lama_tpu/ops/edt_pallas.py:25",
           "hw": [w, w], "radius": r, "cap": cap, "max_abs_err": b3_err,
           "obstacles": int(real.sum()),
           "launch_floor_ms": launch_floor_ms(
               torch, dev, -(-w // 64) * -(-w // 32), 256),
           **timings(torch, "", lambda: edt_pallas.edt2d(real, cap, r), 300),
           **timings(torch, "plain_", lambda: edt_pallas.edt2d_plain(
               real, cap, r), 100),
           "library_ms": None,
           "library_call": "none: no single PyTorch call computes a capped EDT",
           "bound_ms": eb[0], "bound_by": eb[1]}
    for k in (pair, edt):
        emit({"phase": "lo_kernels", **k})

    # 14. prefix: CPU plain versions vs the card
    def prefix(device):
        lo = LidarOdometry2D(opts, device=device)
        flags, patches = [], []
        t0 = time.perf_counter()
        for p in padded[:LO_PREFIX]:
            lo.update_prepadded(*(torch.as_tensor(a, device=device)
                                  for a in p))
            flags.append(lo.last_refresh)
            patches.append(int(lo.map.table.num_patches()))
        return lo, flags, patches, time.perf_counter() - t0

    cpu, flags_c, patches_c, s_c = prefix("cpu")
    gpu, flags_g, patches_g, s_g = prefix(dev)
    tc, tg = cpu.trajectory(), gpu.trajectory()
    dxy = float(np.abs(tc[:, :2] - tg[:, :2]).max())
    dth = float(np.abs(np.angle(np.exp(1j * (tc[:, 2] - tg[:, 2])))).max())
    last = gpu._pose_dev.cpu()
    wc = map_window(cpu.map, cfg, last)
    wg = map_window(gpu.map, cfg, last.to(dev))
    occ_d = float(np.abs(wc[0] - wg[0]).max())
    emit({"phase": "lo_prefix", "scans": LO_PREFIX, "cpu_s": s_c,
          "card_s": s_g, "max_dxy_m": dxy, "max_dtheta_rad": dth,
          "refreshes": sum(flags_g), "same_refreshes": flags_c == flags_g,
          "patches": [patches_c[-1], patches_g[-1]],
          "window": list(wc[0].shape),
          "differing_cells": {"visited": int(np.sum(wc[1] != wg[1])),
                              "dist": int(np.sum(wc[2] != wg[2])),
                              "log_odds_beyond_tol": int(np.sum(
                                  np.abs(wc[0] - wg[0]) > LO_ATOL))},
          "max_log_odds_diff": occ_d})
    assert dxy <= 1e-3 and dth <= 1e-3, "lo_prefix: trajectories diverge"
    assert flags_c == flags_g, "lo_prefix: refresh decisions differ"
    assert patches_c == patches_g, "lo_prefix: patch counts differ"
    # as in phase 4: the card's and the CPU's matched poses differ by ulps,
    # so a ray may end in the neighbouring cell; a few cells may differ
    diff = (np.sum(wc[1] != wg[1]) + np.sum(wc[2] != wg[2])
            + np.sum(np.abs(wc[0] - wg[0]) > LO_ATOL))
    assert diff <= 1e-3 * wc[0].size, f"lo_prefix: {diff} cells differ"
    # one map update from one state at one pose on both: exact
    from iris_lama_tpu_torch.utils import state as state_mod
    d = state_mod.lo_to_numpy(gpu)
    scan = padded[LO_PREFIX]
    after = []
    for device in ("cpu", dev):
        st, _ = mapping.update_maps(
            state_mod.map_from_numpy(d, device), cfg,
            torch.as_tensor(d["pose"], device=device),
            *(torch.as_tensor(a, device=device) for a in scan))
        after.append(state_mod.map_to_numpy(st))
    same = {k: bool(np.array_equal(after[0][k], after[1][k]))
            for k in after[0] if k != "occupied"}
    occ_one = float(np.abs(after[0]["occupied"]
                           - after[1]["occupied"]).max())
    emit({"phase": "lo_prefix_update", "equal": same,
          "max_log_odds_diff": occ_one,
          "num_patches": cfg.capacity - int(after[1]["table_n_free"])})
    assert all(same.values()) and occ_one <= LO_ATOL, \
        f"lo_prefix: one update from one state differs {same} {occ_one}"
    del cpu, gpu

    # 15. the bench_lidar.py workload on the card
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]

    def one_pass(rep, scans=LO_SCANS):
        lo = LidarOdometry2D(opts, device=dev)
        p0, m0, o0 = staged[0]
        lo.update_prepadded(p0 + rep * 1e-4, m0, o0)
        peak = lo.map.table.num_patches().clone()
        refreshes = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(1, scans):
            lo.update_prepadded(*staged[k])
            if lo.last_refresh:
                refreshes += 1
                peak = torch.maximum(peak, lo.map.table.num_patches())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        est = lo.trajectory()
        err = np.linalg.norm(est[:, :2] - rel_gt[:len(est), :2], axis=1)
        return {"scans_per_s": (scans - 1) / dt, "seconds": dt,
                "drift_m_per_100m": float(err[-1]) / path_len * 100.0,
                "final_err_m": float(err[-1]), "refreshes": refreshes,
                "peak_patches": int(peak),
                "overflow": int(lo.map.table.overflow)}

    one_pass(9, LO_WARMUP)            # warm-up: discarded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reads0 = host_reads("refresh", "irls_stop")
    n_reps = bench_reps(LO_REPS)
    reps = [one_pass(rep) for rep in range(n_reps)]
    scans = n_reps * (LO_SCANS - 1)
    rates = sorted(p["scans_per_s"] for p in reps)
    drifts = sorted(p["drift_m_per_100m"] for p in reps)
    med = drifts[len(drifts) // 2]
    med_rep = sorted(reps, key=lambda p: p["drift_m_per_100m"])[
        len(reps) // 2]
    emit({"phase": "lo_main_path", "reps": reps, "scans": LO_SCANS,
          "reps_cut": f"{n_reps} reps (bench_lidar.py runs 5 on an "
                      "accelerator)",
          "median_scans_per_s": rates[len(rates) // 2],
          "drift_m_per_100m": med, "drifts": drifts,
          "diverged_reps": [d for d in drifts if d > 3.0 * max(med, 1e-9)],
          "final_err_m": med_rep["final_err_m"], "path_len_m": path_len,
          "host_reads_per_scan": (host_reads("refresh", "irls_stop")
                                  - reads0) / scans,
          "refreshes_per_rep": [p["refreshes"] for p in reps],
          "peak_patches": max(p["peak_patches"] for p in reps),
          "overflow": max(p["overflow"] for p in reps),
          "peak_mem_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20})
    profiled = lo_profile(torch, dev, opts, staged)
    emit({"phase": "lo_profiled", **profiled})
    launches = profiled["launches"]
    assert med < LO_DRIFT_BOUND, f"LidarOdometry2D drift {med} m/100 m"
    assert all(p["overflow"] == 0 for p in reps), "pool overflow"
    assert launches["deposit_pair"] > 0 and launches["edt2d"] > 0, launches
    pair["launches"] = launches["deposit_pair"]
    edt["launches"] = launches["edt2d"]
    return [pair, edt]


def lo_profile(torch, dev, opts, staged) -> dict:
    """Device activities, the kernels' launches and device time a scan
    over ``LO_PROFILED`` scans of a fresh LidarOdometry2D pass (after its
    first 100), from torch.profiler; ``busy_share`` is the device time over
    the profiled wall time (the profiler slows the host, so it reads
    high)."""
    from iris_lama_tpu_torch.algos.lidar_odometry_2d import LidarOdometry2D
    dp = devprof()
    lo = LidarOdometry2D(opts, device=dev)
    for k in range(101):
        lo.update_prepadded(*staged[k])
    scans = range(101, 101 + depth(LO_PROFILED, 25))
    run = {"refreshes": 0}

    def profiled():
        t0 = time.perf_counter()
        for k in scans:
            lo.update_prepadded(*staged[k])
            run["refreshes"] += lo.last_refresh
        torch.cuda.synchronize()
        run["wall"] = time.perf_counter() - t0

    events = dp.cuda_rows(dp.profile_calls(profiled))
    dev_us = dp.device_us(events)
    n, wall = len(scans), run["wall"]
    launches = {n: dp.launch_count(events, k) for n, k in (
        ("deposit_pair", dp.DEPOSIT), ("select4_sq", dp.SELECT4),
        ("edt2d", dp.EDT))}
    return {"scans": n, "refreshes": run["refreshes"],
            "ms_per_scan_profiled": wall * 1e3 / n,
            "device_ms_per_scan": dev_us / 1e3 / n,
            "activities_per_scan": dp.launch_count(events) / n,
            "launches": launches,
            "launches_per_scan": {k: v / n for k, v in launches.items()},
            "busy_share": dev_us / 1e6 / wall}


def slam_option_phases(torch, dev) -> None:
    """Phase 16: Slam2D with ``transient_map=True`` and with
    ``resident_window=False`` on the phase 5 workload: the first
    ``PREFIX_SCANS`` scans on the CPU and on the card (accepted scans,
    poses within 1 mm / 1e-3 rad, the map through a dense window around the
    last pose; the kernels of the card's prefix counted on the profiler's
    trace: B1, B3 and B4), then one full pass on the card."""
    import dataclasses
    from iris_lama_tpu_torch.algos.slam2d import Slam2D
    from iris_lama_tpu_torch.core.pose import Pose2D

    data, opts, padded = slam_workload()
    dp = devprof()
    kernels = {"deposit_pair": dp.DEPOSIT,
               "gn_solve_batched_slam2d": dp.GN_SOLVE, "edt2d": dp.EDT}
    for name, kw in (("slam2d_transient", dict(transient_map=True)),
                     ("slam2d_pool", dict(resident_window=False))):
        o = dataclasses.replace(opts, **kw)
        cfg = o.mapping_config()
        runs = []
        for device in ("cpu", dev):
            slam = Slam2D(o, device=device)
            slam.set_prior(Pose2D(*data.poses_gt[0]))
            staged = [tuple(torch.as_tensor(a, device=device) for a in p)
                      for p in padded[:PREFIX_SCANS]]
            t0 = time.perf_counter()
            acc = slam.update_many_prepadded(staged,
                                             data.odometry[:PREFIX_SCANS])
            runs.append((slam, acc, time.perf_counter() - t0))
        (sc, acc_c, s_c), (sg, acc_g, s_g) = runs
        tc, tg = sc.trajectory(), sg.trajectory()
        dxy = float(np.abs(tc[:, :2] - tg[:, :2]).max())
        dth = float(np.abs(np.angle(np.exp(1j * (tc[:, 2] - tg[:, 2]))))
                    .max())
        last = sg._pose_dev.cpu()
        wc = map_window(sc.map, cfg, last)
        wg = map_window(sg.map, cfg, last.to(dev))
        diff = {k: int(np.sum(a != b))
                for k, a, b in zip(("occ", "vis", "dist"), wc, wg)}
        staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
                  for p in padded]
        torch.cuda.synchronize()
        main = slam_pass(torch, dev, data, o, staged, 0)
        # the kernels of one more, untimed pass (counted_pass)
        counted, launches = counted_pass(
            lambda: fresh(Slam2D, o, dev, data.poses_gt[0]),
            one_by_one(staged, data.odometry), len(staged), kernels)
        emit({"phase": name, "prefix_scans": PREFIX_SCANS,
              "accepted": len(acc_g), "cpu_s": s_c, "card_s": s_g,
              "max_dxy_m": dxy, "max_dtheta_rad": dth,
              "differing_cells": diff, "cells": int(wc[0].size),
              "patches": [int(sc.map.table.num_patches()),
                          int(sg.map.table.num_patches())],
              "main_pass": main, "launches": launches,
              "launches_per_scan": {k: v / len(counted)
                                    for k, v in launches.items()}})
        assert acc_c == acc_g, f"{name}: accepted scans differ"
        assert dxy <= 1e-3 and dth <= 1e-3, f"{name}: trajectories diverge"
        # as in phase 4: ulp-different matched poses may move a few cells
        assert sum(diff.values()) <= 1e-3 * wc[0].size, f"{name}: {diff}"
        if kw.get("transient_map"):
            assert abs(main["ate_m"] - TRANSIENT_ATE_REF_M) \
                <= TRANSIENT_ATE_TOL_M, f"{name}: ATE {main['ate_m']}"
        else:
            assert main["ate_m"] < ATE_BOUND_M, f"{name}: ATE {main['ate_m']}"
        assert main["escaped"] == 0, f"{name}: escapes"
        assert all(v > 0 for v in launches.values()), f"{name}: {launches}"
        del sc, sg


GRAPH_STEPS = 300              # bench_graph.py's scans
GRAPH_PREFIX = 60              # GraphSlam2D scans, CPU vs card
GRAPH_REPS = 3                 # bench_graph.py: 3 reps after a warm-up
GRAPH_PROFILED = 150           # GraphSlam2D scans of the profiled pass
GRAPH_ATE_BOUND_M = 0.15       # bench_graph.py:22
GRAPH_MIN_LOOPS = 4            # bench_graph.py:23
VERIFY_ATOL = 1e-5             # one verification batch, CPU vs card
# the JAX package on bench_graph.py's workload, on the CPU
# (ref_graph_slam2d.py, rep 0's prior)
GRAPH_JAX_REF = {"updates": 248, "key_poses": 71, "loop_closures": 9,
                 "optimizes": 2, "key_pose_ate_m": 0.09950922907729592}
PGO_NODES = 512                # bench_pgo.py
PGO_REPS = 5                   # bench_pgo.py: 5 timed solves after one
PGO_ERR_BOUND_M = 0.03         # bench_pgo.py:63
PGO_ATOL = 1e-3                # nodes, CPU vs card
# the JAX package's solve of that graph on the CPU (ref_graph_slam2d.py)
PGO_JAX_REF = {"iterations": 28, "mean_err_m": 0.005641845984653941}


@functools.lru_cache(maxsize=None)
def graph_workload():
    """bench_graph.py's GraphSlam2D workload: (data, options, scans padded
    to 768)."""
    from iris_lama_tpu_torch.algos.graph_slam2d import GraphSlam2DOptions
    from iris_lama_tpu_torch.algos.slam2d import Slam2DOptions
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    data = simulator.simulate(simulator.SimConfig(
        n_steps=GRAPH_STEPS, seed=8,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0),
        odom_trans_noise=0.02, odom_rot_noise=0.004))
    opts = GraphSlam2DOptions(
        slam=Slam2DOptions(resolution=0.05, max_range=10.0,
                           trans_thresh=0.25, rot_thresh=0.25,
                           capacity=4096, transient_map=True),
        ignore_n_chain_poses=10, key_pose_head_delay=3,
        loop_closure_scan_rmse=0.12)
    return data, opts, [pad_scan(c, beam_bucket(720)) for c in data.clouds]


def kernel_entry(torch, name, source_line, fn, plain, nbytes, nops,
                 library=None, library_call="none", reps=300,
                 library_reps=10, **extra):
    """A kernels-line entry: device ms of ``fn`` and of its plain version,
    the library call's where there is one, and the bytes/ops bound."""
    src = ("iris_lama_tpu_torch/csrc/deposit.cu" if "deposit" in name
           else "iris_lama_tpu_torch/csrc/edt.cu")
    b = bound(nbytes, nops)
    entry = {"name": name, "route": "cuda", "source": src,
             "replaces": source_line, **extra,
             **timings(torch, "", fn, reps),
             **timings(torch, "plain_", plain, max(reps // 10, 5))}
    if library is None:
        entry["library_ms"] = None
    else:
        entry.update(timings(torch, "library_", library, library_reps))
    entry.update(library_call=library_call, bound_ms=b[0], bound_by=b[1])
    return entry


def graph_kernel_phase(torch, dev, gs) -> list:
    """Phase 17: B1's pair over every key-pose scan of one pass into the
    rebuild grid, and B3 on that grid (R = 10), on the coarse fallback's [4,
    116, 116] fields and on the coarse distance map's grid at R = 50, each
    ``torch.equal`` to its plain version, with device times, bounds and
    launch floors."""
    import dataclasses
    from iris_lama_tpu_torch.algos import graph_slam2d as gmod
    from iris_lama_tpu_torch.ops import edt_pallas, scatter_matmul
    from iris_lama_tpu_torch.parallel import map_rebuild

    kps = gs.key_poses
    cfg = dataclasses.replace(gs.slam.cfg, capacity=4 * gs.slam.cfg.capacity)
    poses = np.asarray([kp.pose.se2_array() for kp in kps], np.float32)
    org, h, w = map_rebuild.grid_bounds(cfg, cfg.geometry, poses)
    pts = torch.stack([kp.points for kp in kps])
    msk = torch.stack([kp.mask for kp in kps])
    ori = torch.stack([kp.origin for kp in kps])
    (hy, hx), (fy, fx) = map_rebuild._scan_cells(
        cfg, torch.as_tensor(poses, device=dev), pts, msk, ori,
        torch.as_tensor(org, dtype=torch.int32, device=dev), h, w)
    n_hit, n_free = hy.numel(), fy.numel()
    got = scatter_matmul.deposit_pair(hy, hx, fy, fx, h, w)
    want = scatter_matmul.deposit_pair_plain(hy, hx, fy, fx, h, w)
    torch.cuda.synchronize()
    err = max(int((g - x).abs().max()) for g, x in zip(got, want))
    assert all(torch.equal(g, x) for g, x in zip(got, want)), \
        f"B1 pair at the rebuild's [2,{h},{w}]: err {err}"
    pair = kernel_entry(
        torch, "deposit_pair_rebuild", "iris_lama_tpu/ops/scatter_matmul.py:81",
        lambda: scatter_matmul.deposit_pair(hy, hx, fy, fx, h, w),
        lambda: scatter_matmul.deposit_pair_plain(hy, hx, fy, fx, h, w),
        (n_hit + n_free) * 8 + 2 * h * w * 4, 2 * n_hit + n_free,
        library=deposit_library(torch, dev, [
            (hy[None], hx[None], (0, 1)), (fy[None], fx[None], (1,))],
            1, h, w),
        library_call="zeros + index_put_(accumulate=True) over both grids' "
                     "bins", reps=50, library_reps=2,
        key_poses=len(kps), n_hit=n_hit, n_free=n_free, hw=[h, w],
        ray_steps=cfg.ray_steps, max_abs_err=err,
        int32_elements_ok=bool(n_free < 2 ** 31),
        blocks=scatter_matmul.launch_blocks(1, [n_hit, n_free]),
        cells_in_grid=int((fy < h).sum() + (hy < h).sum()),
        launch_floor_ms=memset_floor_ms(
            torch, dev, 2 * h * w * 4,
            scatter_matmul.launch_blocks(1, [n_hit, n_free]), 256))

    def edt_case(name, line, obst, cap, r, masks, reps=300):
        shape = tuple(obst.shape)
        err = 0
        for m in (obst, *masks):
            g3 = edt_pallas.edt2d(m, cap, r)
            w3 = edt_pallas.edt2d_plain(m, cap, r)
            torch.cuda.synchronize()
            err = max(err, int((g3 - w3).abs().max()))
            assert torch.equal(g3, w3), f"B3 {name} {shape} R={r}: err {err}"
        cells = obst.numel()
        hh, ww = shape[-2:]
        p = cells // (hh * ww)
        blocks = p * -(-ww // 64) * -(-hh // 32)
        return kernel_entry(
            torch, name, line, lambda: edt_pallas.edt2d(obst, cap, r),
            lambda: edt_pallas.edt2d_plain(obst, cap, r),
            cells * (1 + 4), cells * 4 * (2 * r + 1),
            library_call="none: no single PyTorch call computes a capped EDT",
            reps=reps, shape=list(shape), radius=r, cap=cap,
            max_abs_err=err, obstacles=int(obst.sum()),
            launch_floor_ms=launch_floor_ms(torch, dev, blocks, 256))

    r, cap = cfg.distance.radius_cells, cfg.distance.max_sqdist
    obst = (4 * got[0]) > got[1]
    edt_rebuild = edt_case("edt2d_rebuild", "iris_lama_tpu/ops/edt_pallas.py:25",
                           obst, cap, r, [b3_mask(torch, dev, (h, w), 0.01),
                                          b3_mask(torch, dev, (h, w), 0.3)])
    # the coarse fallback's fields of the last four key poses
    last = kps[-gmod.COARSE_CHUNK:]
    cobst, _ = gmod.coarse_obstacles(
        torch.as_tensor(np.stack([kp.raw_pose.se2_array() for kp in last]),
                        device=dev),
        torch.stack([kp.points[:, :2] for kp in last]),
        torch.stack([kp.mask for kp in last]), gmod.coarse_side(gs.slam.cfg))
    side = cobst.shape[-1]
    edt_coarse = edt_case("edt2d_coarse", "iris_lama_tpu/ops/edt_pallas.py:25",
                          cobst, gmod.COARSE_R ** 2, gmod.COARSE_R,
                          [b3_mask(torch, dev, (4, side, side), 0.05)])
    # generate_coarse_distance_map's defaults: 0.1 m cells, 5 m: R = 50
    dobst, _, dcfg = gs.coarse_obstacles()
    dobst = torch.as_tensor(dobst, device=dev)
    edt_r50 = edt_case("edt2d_r50", "iris_lama_tpu/ops/edt_pallas.py:25",
                       dobst, dcfg.max_sqdist, dcfg.radius_cells,
                       [b3_mask(torch, dev, tuple(dobst.shape), 0.01)],
                       reps=100)
    assert (dcfg.radius_cells, dcfg.max_sqdist) == (50, 2500)
    entries = [pair, edt_rebuild, edt_coarse, edt_r50]
    for k in entries:
        emit({"phase": "graph_kernels", **k})
    return entries


def graph_phases(torch, dev) -> list:
    """Phases 17-19: GraphSlam2D on bench_graph.py's workload. A warm-up
    pass on the card (its key poses feed phase 17's kernels; B3's launches
    in its coarse fallback counted on the profiler's trace), the CPU/card
    prefix (18), then the bench workload (19). Returns the kernels-line
    entries of phase 17 with their launches: the warm-up pass's coarse
    fallback, and the last rep's two maps made again under the
    profiler."""
    import dataclasses
    from iris_lama_tpu_torch.algos import graph_slam2d as gmod
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.utils import state as state_mod
    from iris_lama_tpu_torch.utils.evaluation import ate_rmse

    data, opts, padded = graph_workload()
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]
    times = [float(k) for k in range(GRAPH_STEPS)]
    g0 = data.poses_gt[0]
    coarse_launches = [0]
    dp = devprof()

    def counted_coarse(gs):
        """Count B3's launches in the coarse fallback (its batches)."""
        corr, gate, coarse = gs._programs()

        def fn(*args):
            out, n = dp.launches_by_name(lambda: coarse(*args),
                                         {"edt2d": dp.EDT})
            coarse_launches[0] += n["edt2d"]
            return out

        gs._kernels = (corr, gate, fn)

    def one_pass(rep, maps=False, count=False):
        gs = gmod.GraphSlam2D(opts, device=dev)
        if count:
            counted_coarse(gs)
        gs.set_prior(Pose2D(g0[0] + rep * 1e-4, g0[1], g0[2]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs.update_many_prepadded(staged, data.odometry, timestamps=times)
        kps = gs.key_poses
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        est = np.asarray([kp.pose.xyr() for kp in kps])
        gt = np.asarray([data.poses_gt[int(kp.timestamp)] for kp in kps])
        n_upd = gs.slam._n_updates
        out = {"scans_per_s": n_upd / dt, "seconds": dt, "updates": n_upd,
               "key_poses": len(kps), "loop_closures": len(gs.links),
               "optimizes": gs.stats.get("optimize_n", 0),
               "key_pose_ate_m": ate_rmse(est, gt),
               "escaped": gs.slam.escaped_count()}
        if maps:
            t0 = time.perf_counter()
            state = gs.generate_occupancy_map()
            torch.cuda.synchronize()
            out["occupancy_map_ms"] = (time.perf_counter() - t0) * 1e3
            out["occupancy_map_patches"] = int(state.table.num_patches())
            t0 = time.perf_counter()
            dstate, _ = gs.generate_coarse_distance_map()
            torch.cuda.synchronize()
            out["coarse_distance_map_ms"] = (time.perf_counter() - t0) * 1e3
            out["coarse_distance_map_patches"] = int(
                dstate.table.num_patches())
        out["stats"] = dict(gs.stats)
        return gs, out

    # warm-up pass, discarded; its key poses feed phase 17
    warm, _ = one_pass(9, count=True)
    entries = graph_kernel_phase(torch, dev, warm)
    del warm

    # 18. prefix: CPU plain versions vs the card, the per-scan path
    runs = []
    for device in ("cpu", dev):
        gs = gmod.GraphSlam2D(opts, device=device)
        gs.set_prior(Pose2D(*g0))
        t0 = time.perf_counter()
        for k in range(GRAPH_PREFIX):
            gs.update_prepadded(*(torch.as_tensor(a, device=device)
                                  for a in padded[k]), data.odometry[k],
                                times[k])
        kps = gs.key_poses
        runs.append((gs, kps, time.perf_counter() - t0))
    (gc, kc, s_c), (gg, kg, s_g) = runs
    pc = np.asarray([kp.pose.xyr() for kp in kc])
    pg = np.asarray([kp.pose.xyr() for kp in kg])
    same_keys = [kp.timestamp for kp in kc] == [kp.timestamp for kp in kg]
    dxy = float(np.abs(pc[:, :2] - pg[:, :2]).max()) if same_keys else None
    dth = (float(np.abs(np.angle(np.exp(1j * (pc[:, 2] - pg[:, 2])))).max())
           if same_keys else None)
    # one verification batch from one state (the card's) on both devices
    d = state_mod.graph_to_numpy(gg)
    both = []
    for device in ("cpu", dev):
        g = gmod.GraphSlam2D(opts, device=device)
        state_mod.graph_from_numpy(g, d)
        both.append(g)
    # the last key pose against the five before it: candidates inside the
    # transient map, so each row solves on map content
    n_kp = len(kg)
    rows = [(n_kp - 1, c) for c in range(max(n_kp - 6, 0), n_kp - 1)]
    packed = []
    for g in both:
        corr, _, _ = g._programs()
        kps = g._key_poses
        inv = g.correction.inverse()
        cand = np.stack([(inv + kps[c].pose).se2_array() for _, c in rows])
        hyp = np.stack([Pose2D((inv + kps[q].pose).x(),
                               (inv + kps[q].pose).y(),
                               (inv + kps[c].pose).rotation()).se2_array()
                        for q, c in rows])
        packed.append(corr(g.slam.map, torch.as_tensor(cand, device=g.device),
                           torch.as_tensor(hyp, device=g.device),
                           torch.stack([kps[c].points[:, :2] for _, c in rows]),
                           torch.stack([kps[c].mask for _, c in rows]))
                      .cpu().numpy())
    verify_err = float(np.abs(packed[0] - packed[1]).max())
    emit({"phase": "graph_prefix", "scans": GRAPH_PREFIX,
          "updates": gg.slam._n_updates, "key_poses": n_kp,
          "same_key_updates": same_keys, "cpu_s": s_c, "card_s": s_g,
          "max_dxy_m": dxy, "max_dtheta_rad": dth,
          "links": [list(gc.links), list(gg.links)],
          "verification_rows": len(rows),
          "verification_max_abs_diff": verify_err,
          "verification_errors": packed[1][:, 4].tolist()})
    assert same_keys, "graph_prefix: key-pose update indices differ"
    assert dxy <= 1e-3 and dth <= 1e-3, "graph_prefix: key poses diverge"
    assert verify_err <= VERIFY_ATOL, f"graph_prefix: verification {verify_err}"
    del gc, gg, both, runs

    # 19. the bench_graph.py workload on the card (the front end matches
    # through B4; the verification and the coarse fallback on float
    # windows, without B2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reads0 = host_reads("irls_stop")
    reps = []
    for rep in range(bench_reps(GRAPH_REPS)):
        gs, out = one_pass(rep, maps=True)
        reps.append(out)
    reads = host_reads("irls_stop") - reads0
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    _, rebuild = dp.launches_by_name(gs.generate_occupancy_map,
                                     {"deposit_pair": dp.DEPOSIT,
                                      "edt2d": dp.EDT})
    _, r50 = dp.launches_by_name(gs.generate_coarse_distance_map,
                                 {"edt2d": dp.EDT})
    del gs

    # the kernels of one more pass, rep 0's, untimed (counted_pass; its
    # windows whole slices of the front end's sync_scans)
    def feed(g, a, b):
        acc = [a + k for k in g.update_many_prepadded(
            staged[a:b], data.odometry[a:b], timestamps=times[a:b])]
        if b == len(staged):
            len(g.key_poses)             # drains the verifications in flight
        return acc

    sync_scans = opts.sync_scans
    counted, launches = counted_pass(
        lambda: fresh(gmod.GraphSlam2D, opts, dev, g0), feed, len(staged),
        {"deposit_pair": dp.DEPOSIT, "gn_solve_batched_slam2d": dp.GN_SOLVE,
         "edt2d": dp.EDT},
        window=sync_scans * max(1, COUNT_WINDOW // sync_scans))
    profiled = graph_profile(torch, dev, opts, staged, data, times)
    syncs = sum(r["stats"].get("sync_n", 0) for r in reps)
    rates = sorted(r["scans_per_s"] for r in reps)
    med = sorted(reps, key=lambda r: r["scans_per_s"])[len(reps) // 2]
    emit({"phase": "graph_main_path", "reps": reps,
          "median_scans_per_s": rates[len(rates) // 2],
          "spread": rates[-1] / max(rates[0], 1e-9),
          "key_pose_ate_m": med["key_pose_ate_m"],
          "loop_closures": med["loop_closures"],
          "key_poses": med["key_poses"], "optimizes": med["optimizes"],
          "jax_reference_cpu": GRAPH_JAX_REF,
          "launches": launches,
          "launches_per_update": {k: v / len(counted)
                                  for k, v in launches.items()},
          "kernel_launches": {"deposit_pair_rebuild": rebuild["deposit_pair"],
                              "edt2d_rebuild": rebuild["edt2d"],
                              "edt2d_coarse": coarse_launches[0],
                              "edt2d_r50": r50["edt2d"]},
          "solver_host_reads": reads, "syncs": syncs,
          "solver_host_reads_per_sync": reads / max(syncs, 1),
          "peak_mem_mb": peak_mb})
    emit({"phase": "graph_profiled", **profiled})
    assert med["key_pose_ate_m"] < GRAPH_ATE_BOUND_M, \
        f"GraphSlam2D key-pose ATE {med['key_pose_ate_m']}"
    assert med["loop_closures"] >= GRAPH_MIN_LOOPS, \
        f"GraphSlam2D loop closures {med['loop_closures']}"
    assert all(v > 0 for v in launches.values()), launches
    for k, n in zip(entries, (rebuild["deposit_pair"], rebuild["edt2d"],
                              coarse_launches[0], r50["edt2d"])):
        k["launches"] = n
    assert all(k["launches"] > 0 for k in entries), \
        [(k["name"], k["launches"]) for k in entries]
    return entries


def graph_profile(torch, dev, opts, staged, data, times) -> dict:
    """Device activities, device time and the ``stats`` split of the first
    ``GRAPH_PROFILED`` scans of one more GraphSlam2D pass of the
    bench_graph.py workload under torch.profiler (half the pass: the
    profiler's post-processing of a whole pass took ~2 min); ``busy_share``
    is the device time over the profiled wall time (the profiler slows the
    host, so it reads high)."""
    from iris_lama_tpu_torch.algos.graph_slam2d import GraphSlam2D
    from iris_lama_tpu_torch.core.pose import Pose2D
    dp = devprof()
    gs = GraphSlam2D(opts, device=dev)
    gs.set_prior(Pose2D(*data.poses_gt[0]))
    run = {}
    n_prof = depth(GRAPH_PROFILED, 40)

    def profiled():
        t0 = time.perf_counter()
        gs.update_many_prepadded(staged[:n_prof], data.odometry[:n_prof],
                                 timestamps=times[:n_prof])
        run["keys"] = len(gs.key_poses)  # drains the verifications in flight
        torch.cuda.synchronize()
        run["wall"] = time.perf_counter() - t0

    events = dp.cuda_rows(dp.profile_calls(profiled))
    dev_us = dp.device_us(events)
    n, wall = gs.slam._n_updates, run["wall"]
    top = sorted(events, key=lambda e: -dp.event_us(e))
    return {"updates": n, "key_poses": run["keys"],
            "ms_per_update_profiled": wall * 1e3 / n,
            "device_ms_per_update": dev_us / 1e3 / n,
            "activities_per_update": dp.launch_count(events) / n,
            "busy_share": dev_us / 1e6 / wall,
            "top_device_us": {e.key[:60]: dp.event_us(e) for e in top[:8]},
            "stats": dict(gs.stats)}


def pgo_graph(n: int = PGO_NODES, seed: int = 9, loops: int = 32):
    """bench_pgo.py's graph: a corridor chain with loop closures.
    Returns (builder, initial nodes, active mask, true poses)."""
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.nlls import factor_graph as fg
    rng = np.random.default_rng(seed)
    true = [Pose2D(0, 0, 0)]
    for k in range(n - 1):
        true.append(true[-1] + Pose2D(1.0, 0.02 * np.sin(k / 7), 0.012))
    b = fg.GraphBuilder()
    b.add_prior(0, true[0].se2_array(), (0.01, 0.01, 0.01))
    for i in range(n - 1):
        b.add_between(i, i + 1, (true[i] - true[i + 1]).se2_array(),
                      (0.25, 0.25, 0.15))
    for _ in range(loops):
        i = int(rng.integers(0, n - 60))
        j = int(rng.integers(i + 40, n))
        b.add_between(i, j, (true[i] - true[j]).se2_array(), (0.5, 0.5, 0.1),
                      huber_k=0.1)
    n_pad = fg.GraphBuilder._bucket(n)
    nodes = np.tile(np.array([0, 0, 1, 0], np.float32), (n_pad, 1))
    for i, p in enumerate(true):
        nodes[i] = Pose2D(p.x() + rng.normal(0, 0.3),
                          p.y() + rng.normal(0, 0.3),
                          p.rotation() + rng.normal(0, 0.05)).se2_array()
    active = np.zeros(n_pad, bool)
    active[:n] = True
    return b, nodes, active, true


def pgo_phase(torch, dev) -> None:
    """Phase 20: bench_pgo.py's 512-node graph with 32 loop closures on the
    card: ms per solve over PGO_REPS solves after a warm-up, the mean error
    of every 16th node (< 3 cm), and the nodes against the CPU port's.

    The graph's measurements have no noise, so its optimum's chi2 is at
    float32's floor, and the chain's orientation about node 0 is pinned
    only by node 0's prior (sigma 0.01): there every LM step is rounding
    noise, and an ulp of input moves the far nodes by ~1e-2 m, mostly by
    turning the whole chain (the control: the CPU port from nodes moved by
    1e-7 relative). So the nodes are compared within PGO_ATOL at the end
    of the productive steps (the first iteration at which the CPU port's
    chi2 is below 1e-5 of its start) after the rigid SE(2) alignment that
    removes that turn; the final differences, raw and aligned, are printed
    beside the control's."""
    from iris_lama_tpu_torch.nlls import factor_graph as fg
    from iris_lama_tpu_torch.utils.evaluation import align_se2

    b, nodes, active, true = pgo_graph()

    def solve(device, start=nodes, **kw):
        res, info = fg.optimize(torch.as_tensor(start, device=device),
                                b.finalize(device),
                                torch.as_tensor(active, device=device),
                                fg.PGOOptions(**kw))
        a = res.cpu().numpy()[:PGO_NODES].astype(np.float64)
        xyr = np.stack([a[:, 0], a[:, 1], np.arctan2(a[:, 3], a[:, 2])], -1)
        return xyr, int(info["iterations"]), float(info["chi2"])

    def diffs(x, ref):
        return (float(np.abs(x[:, :2] - ref[:, :2]).max()),
                float(np.abs(align_se2(x, ref) - ref[:, :2]).max()))

    t0 = time.perf_counter()
    cpu, cpu_iters, _ = solve("cpu")
    cpu_s = time.perf_counter() - t0
    control = diffs(solve("cpu", nodes * np.float32(1 + 1e-7))[0], cpu)
    chi0 = float(fg._chi2_only(torch.as_tensor(nodes), b.finalize("cpu")))
    k = next(k for k in range(1, cpu_iters + 1)
             if solve("cpu", max_iterations=k)[2] <= 1e-5 * chi0)
    productive = diffs(solve(dev, max_iterations=k)[0],
                       solve("cpu", max_iterations=k)[0])
    got, iters, _ = solve(dev)
    final = diffs(got, cpu)
    graph = b.finalize(dev)
    nd = torch.as_tensor(nodes, device=dev)
    act = torch.as_tensor(active, device=dev)
    reads0 = host_reads("irls_stop")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PGO_REPS):
        fg.optimize(nd, graph, act)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / PGO_REPS * 1e3
    reads = (host_reads("irls_stop") - reads0) / PGO_REPS
    err = float(np.mean([np.linalg.norm(got[i, :2] - true[i].xy())
                         for i in range(0, PGO_NODES, 16)]))
    emit({"phase": "pgo", "nodes": PGO_NODES, "loop_edges": 32,
          "ms_per_solve": ms, "reps": PGO_REPS, "iterations": iters,
          "cpu_iterations": cpu_iters, "cpu_s": cpu_s,
          "host_reads_per_solve": reads, "mean_err_m": err,
          "productive_iterations": k,
          "diff_vs_cpu_productive_m": productive[0],
          "diff_vs_cpu_productive_aligned_m": productive[1],
          "diff_vs_cpu_final_m": final[0],
          "diff_vs_cpu_final_aligned_m": final[1],
          "cpu_control_final_m": control[0],
          "cpu_control_final_aligned_m": control[1],
          "jax_reference_cpu": PGO_JAX_REF})
    assert err < PGO_ERR_BOUND_M, f"PGO mean error {err}"
    assert productive[1] <= PGO_ATOL, \
        f"PGO nodes CPU vs card after {k} iterations, aligned: {productive}"


# ---------------------------------------------------------------------------
# 21-23: maps on disk and the particle filter's pool path
# ---------------------------------------------------------------------------

FILE_ERR_BOUND_M = 0.01        # Loc2D on maps read from files


def occupancy_phase(torch, dev) -> None:
    """Phase 21: frequency_apply_counts and probabilistic_apply on the
    cells of bench.py's first scan (its 768 beam endpoints and 768 x 202
    ray cells, duplicates included; cells that are not hits or free
    space carry count 0 at the robot's cell) on the CPU and on the card:
    the states ``torch.equal``; the time of one apply into an empty state
    (patches allocated) and of one more into the filled state, each the
    median of 5 on the card."""
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.sdm import mapping
    from iris_lama_tpu_torch.sdm import occupancy as occ
    from iris_lama_tpu_torch.sdm.raycast import ray_cells

    data, opts, padded = slam_workload()
    cfg = opts.mapping_config()
    geo = cfg.geometry
    pts, msk, ori = (torch.as_tensor(a) for a in padded[0])
    pose = lie.se2(*data.poses_gt[0])
    g = mapping.beam_geometry(cfg, pose, pts, msk, ori)
    hit, start = geo.w2m(g.hit_xy), geo.w2m(g.start_xy)
    free, free_ok = ray_cells(start, hit, cfg.ray_steps)
    free_ok = free_ok & g.valid[:, None]
    free = torch.where(free_ok[..., None], free, start[:, None, :])
    cells = torch.cat([hit, free.reshape(-1, 2)])
    hit_ok = (g.valid & g.mark_hit).to(torch.int32)
    fok = free_ok.reshape(-1).to(torch.int32)
    occ_add = torch.cat([hit_ok, torch.zeros_like(fok)])
    vis_add = torch.cat([hit_ok, fok])
    ocfg = occ.OccupancyConfig(geo, 1024)

    def apply(device, f=None, p=None):
        c, oa, va = (t.to(device) for t in (cells, occ_add, vis_add))
        f = occ.frequency_init(ocfg, device) if f is None else f
        p = occ.probabilistic_init(ocfg, device) if p is None else p
        return (occ.frequency_apply_counts(f, geo, c, oa, va),
                occ.probabilistic_apply(p, geo, c, oa, va - oa))

    def flat(states):
        return [t.cpu() for st in states for t in (*st.table, *st[1:])]

    cpu, card = apply("cpu"), apply(dev)
    cpu2, card2 = apply("cpu", *cpu), apply(dev, *card)
    equal = [torch.equal(a, b) for a, b in zip(flat(cpu + cpu2),
                                               flat(card + card2))]

    def median_ms(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return sorted(ts)[2]

    c, oa, va = (t.to(dev) for t in (cells, occ_add, vis_add))
    f0, p0 = occ.frequency_init(ocfg, dev), occ.probabilistic_init(ocfg, dev)
    f1, p1 = card
    filled_device_ms, _ = device_ms(
        torch, lambda: occ.frequency_apply_counts(f1, geo, c, oa, va), 5)
    filled_activities = device_launches(
        torch, lambda: occ.frequency_apply_counts(f1, geo, c, oa, va))
    emit({"phase": "occupancy_apply", "cells": int(cells.shape[0]),
          "hits": int(hit_ok.sum()), "free": int(fok.sum()),
          "patches": int(card[0].table.num_patches()),
          "capacity": ocfg.capacity, "states_equal": all(equal),
          "frequency_empty_ms": median_ms(
              lambda: occ.frequency_apply_counts(f0, geo, c, oa, va)),
          "frequency_filled_ms": median_ms(
              lambda: occ.frequency_apply_counts(f1, geo, c, oa, va)),
          "frequency_filled_device_ms": filled_device_ms,
          "frequency_filled_device_activities": filled_activities,
          "probabilistic_empty_ms": median_ms(
              lambda: occ.probabilistic_apply(p0, geo, c, oa, va - oa)),
          "probabilistic_filled_ms": median_ms(
              lambda: occ.probabilistic_apply(p1, geo, c, oa, va - oa)),
          "kernels": "none: scatter-adds through index_add_"})
    assert cells.shape[0] == 768 * (1 + cfg.ray_steps), "phase 21: cells"
    assert all(equal), f"occupancy_apply: CPU and card differ {equal}"


def file_workflow_phase(torch, dev, tmp: str) -> dict:
    """Phase 22: bench_loc.py's workload through files. Slam2D builds the
    map on the card (B1's pair, B4, B3 at phase 3's shapes); the
    frequency, simple and distance .smd files and the occupancy PNG are
    written from its maps, read back onto the card, written again (the
    same bytes) and written from the map moved to the CPU (the same
    bytes); the loaded maps equal the in-memory ones on a dense probe of
    the world; a fresh Loc2D(match="solve") (B4, B2 at phase 9's shapes)
    localises the 199 updates on the loaded maps, mean error < 10 mm.
    Returns the launches of both drivers, counted on the profiler's
    trace."""
    from iris_lama_tpu_torch.algos import loc2d
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.sdm import distance as dist_mod
    from iris_lama_tpu_torch.sdm import export, io as sdm_io
    from iris_lama_tpu_torch.sdm import occupancy as occ
    from iris_lama_tpu_torch.utils import state

    dp = devprof()
    lw, slam_launches = dp.launches_by_name(
        lambda: loc_setup(torch, dev),
        {"deposit_pair": dp.DEPOSIT, "gn_solve_batched_slam2d": dp.GN_SOLVE,
         "edt2d": dp.EDT})
    m, maps, cfg = lw["slam_map"], lw["maps"], lw["map_cfg"]
    geo, l2 = cfg.geometry, cfg.l2_max
    host = state.map_from_numpy(state.map_to_numpy(m), "cpu")
    host_maps = loc2d.maps_from_slam(host)

    def path(name):
        return os.path.join(tmp, name)

    def write_all(mm, lm, tag, times=None):
        for kind, fn in (
                ("frequency", lambda: sdm_io.write_frequency_occupancy(
                    mm, geo, path(f"{tag}_freq.smd"))),
                ("simple", lambda: sdm_io.write_simple_occupancy(
                    lm.occupancy, geo, path(f"{tag}_occ.smd"))),
                ("distance", lambda: sdm_io.write_distance_map(
                    lm.distance, geo, l2, path(f"{tag}_dm.smd"))),
                ("png", lambda: export.export_to_png(
                    export.occupancy_to_image(mm, geo),
                    path(f"{tag}_occ.png")))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if times is not None:
                times[kind] = time.perf_counter() - t0

    def read(name):
        with open(path(name), "rb") as f:
            return f.read()

    write_s, read_s = {}, {}
    write_all(m, maps, "card", write_s)
    write_all(host, host_maps, "cpu")
    names = ("freq.smd", "occ.smd", "dm.smd", "occ.png")
    same_as_cpu = {n: read(f"card_{n}") == read(f"cpu_{n}") for n in names}
    cap = int(m.table.capacity)
    loaded = {}
    for kind, fn in (
            ("frequency", lambda: sdm_io.read_frequency_occupancy(
                path("card_freq.smd"), cap, device=dev)),
            ("simple", lambda: sdm_io.read_simple_occupancy(
                path("card_occ.smd"), cap, device=dev)),
            ("distance", lambda: sdm_io.read_distance_map(
                path("card_dm.smd"), cap, device=dev))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded[kind] = fn()
        torch.cuda.synchronize()
        read_s[kind] = time.perf_counter() - t0
    (freq, g_f), (simple, g_s), (dm, dcfg) = (loaded[k] for k in (
        "frequency", "simple", "distance"))
    sdm_io.write_frequency_occupancy(freq, g_f, path("again_freq.smd"))
    sdm_io.write_simple_occupancy(simple, g_s, path("again_occ.smd"))
    sdm_io.write_distance_map(dm, dcfg.geometry, l2, path("again_dm.smd"))
    rewrite_same = {n: read(f"again_{n}") == read(f"card_{n}")
                    for n in names[:3]}
    png = export.read_image(path("card_occ.png"))
    png_same = bool(np.array_equal(
        png, export.occupancy_to_image(m, geo)[::-1]))

    # a dense probe of the world: every cell of the map's bounding box
    lo_w, hi_w = loc2d.map_bounds(m.table, geo)
    lo_c, hi_c = geo.w2m(lo_w), geo.w2m(hi_w)
    ys, xs = torch.meshgrid(torch.arange(int(lo_c[1]), int(hi_c[1]),
                                         device=dev),
                            torch.arange(int(lo_c[0]), int(hi_c[0]),
                                         device=dev), indexing="ij")
    cells = torch.stack([xs, ys], -1).reshape(-1, 2).to(torch.int32)
    probe = {}
    for name, fn in (("free", occ.simple_is_free),
                     ("occupied", occ.simple_is_occupied),
                     ("unknown", occ.simple_is_unknown)):
        probe[name] = int((fn(simple, g_s, cells)
                           != fn(maps.occupancy, geo, cells)).sum())
    fs = occ.FrequencyOccupancyState(m.table, m.occupied, m.visited)
    for name, fn in (("freq_occupied", occ.frequency_is_occupied),
                     ("freq_free", occ.frequency_is_free),
                     ("freq_prob", occ.frequency_prob)):
        probe[name] = int((fn(freq, g_f, cells) != fn(fs, geo, cells)).sum())
    d0 = dist_mod.cell_distance(m.table, m.dist, geo, cells,
                                cfg.distance.max_dist)
    d1 = dist_mod.cell_distance(dm.table, dm.dist, dcfg.geometry, cells,
                                dcfg.max_dist)
    probe["dist_sq"] = int((cfg.dist_to_sq(d0) != cfg.dist_to_sq(d1)).sum())
    dist_max_abs = float((d0 - d1).abs().max())

    # a fresh Loc2D on the maps read from the files
    data, odoms, staged = lw["data"], lw["odoms"], lw["staged"]
    lc = loc2d.Loc2D(lw["opts"], maps=loc2d.LocMaps(simple, dm), device=dev,
                     match="solve")
    lc.set_prior(Pose2D(*data.poses_gt[0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, loc_launches = dp.launches_by_name(
        lambda: lc.update_many_prepadded(staged, odoms),
        {"gn_solve_batched": dp.GN_SOLVE, "select4_sq_loc2d": dp.SELECT4})
    dt = time.perf_counter() - t0
    est = lc.trajectory()[-len(acc):]
    gt = np.asarray([data.poses_gt[i] for i in acc])
    err = float(np.mean(np.linalg.norm(est[:, :2] - gt[:, :2], axis=1)))
    emit({"phase": "file_workflow", "patches": int(m.table.num_patches()),
          "capacity": cap,
          "file_bytes": {n: os.path.getsize(path(f"card_{n}"))
                         for n in names},
          "write_s": write_s, "read_s": read_s,
          "same_bytes_as_cpu_map": same_as_cpu,
          "rewrite_same_bytes": rewrite_same, "png_decodes_equal": png_same,
          "probe_cells": int(cells.shape[0]), "probe_differing": probe,
          "dist_max_abs_m": dist_max_abs,
          "loc_updates": len(acc), "loc_updates_per_s_profiled": len(acc) / dt,
          "loc_mean_err_m": err, "slam_launches": slam_launches,
          "loc_launches": loc_launches,
          "loc_launches_per_update": {n: v / len(acc)
                                      for n, v in loc_launches.items()}})
    assert all(same_as_cpu.values()), f"file_workflow: {same_as_cpu}"
    assert all(rewrite_same.values()), f"file_workflow: {rewrite_same}"
    assert png_same, "file_workflow: the PNG does not decode to the image"
    assert not any(probe.values()), f"file_workflow: probe {probe}"
    assert dist_max_abs <= 1e-6, f"file_workflow: dist {dist_max_abs}"
    assert len(acc) == len(odoms) - 1, f"file_workflow: {len(acc)} updates"
    assert err < FILE_ERR_BOUND_M, f"file_workflow: mean error {err:.4f} m"
    assert all(v > 0 for v in {**slam_launches, **loc_launches}.values()), \
        f"file_workflow: launches {slam_launches} {loc_launches}"
    ru, mw = cfg.resident_update_cells, cfg.match_window_cells
    hs = ws = lc._ws                              # the match window's side
    return {"file_workflow_slam2d": path_counts(slam_launches, {
                "deposit_pair": [2, ru, ru],
                "gn_solve_batched_slam2d": [1, mw, mw], "edt2d": [ru, ru]}),
            "file_workflow_loc2d": path_counts(loc_launches, {
                "gn_solve_batched": [1, hs, ws],
                "select4_sq_loc2d": [hs, ws]})}


def pf_pool_phases(torch, dev) -> list:
    """Phase 23 (PFSlam2D ``resident_window=False``, the bench_pf.py
    workload): B6 on every particle's pool window, B1's pair and B3 on one
    particle's map-update window, each against its plain version; the
    first ``PF_PREFIX`` updates on the CPU and on the card under phase 7's
    bounds and control, and the resident path on the card, bit-equal; one
    pass on the card. Returns the kernels line's entries of this path."""
    import dataclasses
    from iris_lama_tpu_torch.algos import pf_slam2d as pf_mod
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.ops import edt_pallas, gn_batch, scatter_matmul
    from iris_lama_tpu_torch.sdm import mapping
    from iris_lama_tpu_torch.sdm import window as win_mod

    data, opts0, padded = pf_workload()
    opts = dataclasses.replace(opts0, resident_window=False)
    cfg = opts.mapping_config()
    geo = cfg.geometry
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]

    # kernels at the pool path's shapes, on a real particle set
    pf = PFSlam2D(opts, device=dev)
    pf.set_prior(Pose2D(*data.poses_gt[0]))
    k = 0
    while k < 6:
        pf.update_prepadded(*staged[k], data.odometry[k])
        k += 1
    pf._flush_motion()
    ps = pf.pset
    odelta = torch.as_tensor((pf.odom_ - data.odometry[k]).se2_array(),
                             dtype=torch.float32, device=dev)
    eps = torch.randn((opts.particles, 3),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    poses = pf_mod.draw_from_motion(opts, eps, odelta, ps.pose).contiguous()
    pts, msk, ori = staged[k]
    grids, orgs = pf_mod.pool_windows(opts, ps.maps, poses)
    sopts = opts.solver_options()
    b6_kw = dict(max_dist=cfg.distance.max_dist, res=geo.resolution,
                 scale=geo.scale, cell_offset=geo.cell_offset,
                 cauchy_c=sopts.robust.param, eps1=sopts.eps1,
                 eps2=sopts.eps2, max_iter=sopts.max_iterations,
                 want_lik=True)
    b6_args = (grids, orgs, poses, pts[:, :2].contiguous(), msk)
    got = gn_batch.solve_window_sq(*b6_args, **b6_kw)
    want = gn_batch.solve_window_sq_plain(*b6_args, **b6_kw)
    torch.cuda.synchronize()
    for name, a, w in zip(("state", "iterations", "chi2", "sum_d2"), got,
                          want):
        assert torch.equal(a, w), f"B6 pool windows: {name} differs"
    n_p, b = grids.shape[0], pts.shape[0]
    it = got[1]
    evals = int(it.sum()) + 2 * n_p
    win_bytes = b6_window_bytes(torch, grids, orgs, poses, got[0],
                                pts[:, :2], msk, b6_kw)
    bd = bound(win_bytes + n_p * (8 + 16 + 32) + b * 9, 60 * b * evals)
    b6 = {"name": "gn_batch_solve_pool", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/gn_solve.cu",
          "replaces": "iris_lama_tpu/ops/gn_batch.py:108",
          "shape": [n_p, grids.shape[1], grids.shape[2], b],
          "dtype": str(grids.dtype).replace("torch.", ""),
          "max_abs_err": 0.0, "iters_max": int(it.max()),
          "iters_mean": float(it.float().mean()),
          "window_bytes_read": win_bytes,
          "window_bytes": grids.numel() * grids.element_size(),
          # B6 launches B4's kernel: B5's launch shape (gn_common.cuh)
          "launch_floor_ms": b5_floor_ms(torch, dev, n_p, b),
          **timings(torch, "", lambda: gn_batch.solve_window_sq(
              *b6_args, **b6_kw), 50),
          **timings(torch, "plain_", lambda: gn_batch.solve_window_sq_plain(
              *b6_args, **b6_kw), 5),
          "library_ms": None,
          "library_call": "none: no single PyTorch call computes an IRLS "
                          "solve",
          "bound_ms": bd[0], "bound_by": bd[1]}

    # particle 0's map update: its window at its pose, the scan's streams
    w, wp = cfg.window_cells, cfg.window_patches
    pool0 = pf_mod._pool(ps.maps, 0)
    org0 = win_mod.window_org(geo, geo.w2m(poses[0, :2]), wp)
    idx = mapping.deposit_indices(cfg, poses[0], pts, msk, ori, org0, w)
    hit, free = (idx.hit_ly, idx.hit_lx), (idx.free_ly, idx.free_lx)
    n_hit, n_dep = idx.hit_ly.numel(), idx.free_ly.numel()
    got_p = scatter_matmul.deposit_pair(*hit, *free, w, w)
    want_p = scatter_matmul.deposit_pair_plain(*hit, *free, w, w)
    torch.cuda.synchronize()
    for g_, w_ in zip(got_p, want_p):
        assert torch.equal(g_, w_), "B1 pair at the pool window: differs"
    pb = bound((n_hit + n_dep) * 8 + 2 * w * w * 4, 2 * n_hit + n_dep)
    pair = {"name": "deposit_pair_pool", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/deposit.cu",
            "replaces": "iris_lama_tpu/ops/scatter_matmul.py:81",
            "shape": [n_hit, n_dep, w, w], "max_abs_err": 0,
            "launch_floor_ms": memset_floor_ms(
                torch, dev, 2 * w * w * 4,
                scatter_matmul.launch_blocks(1, [n_hit, n_dep]), 256),
            **timings(torch, "", lambda: scatter_matmul.deposit_pair(
                *hit, *free, w, w), 300),
            **timings(torch, "plain_",
                      lambda: scatter_matmul.deposit_pair_plain(
                          *hit, *free, w, w), 50),
            **timings(torch, "library_", deposit_library(
                torch, dev, [(hit[0][None], hit[1][None], (0, 1)),
                             (free[0][None], free[1][None], (1,))], 1, w,
                w), 20),
            "library_call": "zeros + index_put_(accumulate=True) over both "
                            "grids' bins",
            "bound_ms": pb[0], "bound_by": pb[1]}
    keys = win_mod.window_patch_keys(geo, org0, wp)
    dist_w, _ = win_mod.gather_window(pool0.table, pool0.dist, keys,
                                      cfg.distance.max_dist)
    r, cap = cfg.distance.radius_cells, cfg.distance.max_sqdist
    obst = dist_w == 0.0
    for msk_ in (obst, torch.rand(obst.shape, device=dev) < 0.3):
        g3 = edt_pallas.edt2d(msk_, cap, r)
        w3 = edt_pallas.edt2d_plain(msk_, cap, r)
        torch.cuda.synchronize()
        assert torch.equal(g3, w3), "B3 at the pool window: differs"
    b3b = bound(obst.numel() * (1 + 4), obst.numel() * 4 * (2 * r + 1))
    b3 = {"name": "edt2d_pool", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/edt.cu",
          "replaces": "iris_lama_tpu/ops/edt_pallas.py:25",
          "shape": list(obst.shape), "radius": r,
          "obstacle_share": float(obst.float().mean()), "max_abs_err": 0,
          # the tile kernel (csrc/edt.cu): a block of 256 threads per 32 x
          # 64 output tile
          "launch_floor_ms": launch_floor_ms(
              torch, dev, -(-w // 64) * -(-w // 32), 256),
          **timings(torch, "", lambda: edt_pallas.edt2d(obst, cap, r), 300),
          **timings(torch, "plain_", lambda: edt_pallas.edt2d_plain(
              obst, cap, r), 50),
          "library_ms": None,
          "library_call": "none: no single PyTorch call computes a capped "
                          "EDT",
          "bound_ms": b3b[0], "bound_by": b3b[1]}
    entries = [b6, pair, b3]
    for kern in entries:
        emit({"phase": "pf_pool_kernel", **kern})
    del pf, ps, grids, b6_args, got, want, got_p, want_p, dist_w, pool0

    # the prefix: CPU plain versions vs the card, same draws, and the
    # card again with the motion draws scaled by 1 + 3e-7, over phase 7's
    # PF_PREFIX updates (so that its bounds and control apply as they
    # stand); and the resident path on the card, which the pool path must
    # equal bit for bit (both match on B6 over the same distances)
    def make(o, device, scale=None):
        draws = None
        if scale is not None:
            gen = torch.Generator().manual_seed(o.seed)

            def draws(kind, shape):
                if kind == "normal":
                    return torch.randn(shape, generator=gen) * scale
                return torch.rand(shape, generator=gen)
        f = PFSlam2D(o, device=device, draws=draws)
        f.set_prior(Pose2D(*data.poses_gt[0]))
        return f

    def advance(f, infos):
        i = 0
        while len(infos) < PF_PREFIX:
            scan = (torch.as_tensor(a, device=f.device) for a in padded[i])
            if f.update_prepadded(*scan, data.odometry[i]) and i:
                infos.append((f.pset.pose.cpu().numpy(),
                              bool(f._last_info["resampled"]),
                              f.best_particle_idx(),
                              f.pset.weight.cpu().numpy()))
            i += 1

    def pose_diff(a, g):
        dth = np.angle(np.exp(1j * (np.arctan2(a[:, 3], a[:, 2])
                                    - np.arctan2(g[:, 3], g[:, 2]))))
        return np.abs(a[:, :2] - g[:, :2]).max(1), np.abs(dth)

    def same_decisions(x, y):
        return all(a[1] == g[1] and a[2] == g[2] for a, g in zip(x, y))

    runs = {}
    for name, o, device, scale in (("cpu", opts, "cpu", None),
                                   ("card", opts, dev, None),
                                   ("control", opts, dev, 1.0 + 3e-7),
                                   ("resident", opts0, dev, None)):
        f, infos = make(o, device, scale), []
        t0 = time.perf_counter()
        advance(f, infos)
        runs[name] = (f, infos, time.perf_counter() - t0)
        del f
    (cpu_pf, cpu_inf, t_cpu), (gpu_pf, gpu_inf, t_gpu) = (
        runs["cpu"], runs["card"])
    ctl_inf, res_inf = runs["control"][1], runs["resident"][1]
    diffs = [pose_diff(a[0], g[0]) for a, g in zip(cpu_inf, gpu_inf)]
    ctl = [pose_diff(a[0], g[0]) for a, g in zip(ctl_inf, gpu_inf)]
    dxy = max(float(d[0].max()) for d in diffs)
    dth = max(float(d[1].max()) for d in diffs)
    ctl_dxy = max(float(d[0].max()) for d in ctl)
    ctl_dth = max(float(d[1].max()) for d in ctl)

    def n_beyond(ds):
        return sum(int(((d[0] > 1e-3) | (d[1] > 1e-3)).sum()) for d in ds)

    beyond, ctl_beyond = n_beyond(diffs), n_beyond(ctl)
    lim_xy, lim_th = max(1e-3, 2 * ctl_dxy), max(1e-3, 2 * ctl_dth)
    resident_equal = same_decisions(res_inf, gpu_inf) and all(
        np.array_equal(a[0], g[0]) and np.array_equal(a[3], g[3])
        for a, g in zip(res_inf, gpu_inf))
    # every particle's pool through the resident run's window, the grids
    # that phase 7 compares
    org = runs["resident"][0].pset.res_org
    map_diff, n_cells = {"occ": 0, "vis": 0, "dist": 0}, 0
    for i in range(opts.particles):
        wc = mapping.resident_gather(pf_mod._pool(cpu_pf.pset.maps, i), cfg,
                                     org.cpu())
        wg = mapping.resident_gather(pf_mod._pool(gpu_pf.pset.maps, i), cfg,
                                     org)
        for k_, a, b_ in zip(("occ", "vis", "dist"), wc, wg):
            map_diff[k_] += int((a != b_.cpu()).sum())
        n_cells += int(wc[0].numel())
    emit({"phase": "pf_pool_prefix", "updates": PF_PREFIX,
          "cpu_s": t_cpu, "card_s": t_gpu, "max_dxy_m": dxy,
          "max_dtheta_rad": dth, "limit_dxy_m": lim_xy,
          "limit_dtheta_rad": lim_th,
          "particle_updates_beyond_1mm": beyond,
          "particle_updates": PF_PREFIX * opts.particles,
          "control_max_dxy_m": ctl_dxy, "control_max_dtheta_rad": ctl_dth,
          "control_particle_updates_beyond_1mm": ctl_beyond,
          "decisions_equal": same_decisions(cpu_inf, gpu_inf),
          "control_decisions_equal": same_decisions(ctl_inf, gpu_inf),
          "card_equals_resident_path": resident_equal,
          "resident_path_scrolls": runs["resident"][0].n_scrolls,
          "resampled": sum(a[1] for a in gpu_inf),
          "differing_cells": map_diff, "cells": n_cells})
    assert resident_equal, "PF pool: the card's pool path is not the " \
        "resident path's"
    assert same_decisions(ctl_inf, gpu_inf), "PF pool: control decisions"
    assert same_decisions(cpu_inf, gpu_inf), \
        "PF pool: resample decisions or best particle differ"
    assert beyond <= 2 * ctl_beyond, \
        f"PF pool: {beyond} particle-updates beyond 1 mm (control " \
        f"{ctl_beyond})"
    assert dxy <= lim_xy and dth <= lim_th, "PF pool: particles diverge"
    assert sum(map_diff.values()) <= 1e-3 * n_cells, \
        f"PF pool: pools differ {map_diff}"
    del runs, cpu_pf, gpu_pf, org

    # one pass of the bench_pf.py workload on the card
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    main = pf_pass(torch, dev, data, opts, staged, 0)
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    pool_bytes = (3 * opts.particles * (opts.capacity + 1)
                  * geo.patch_length ** 2 * 4)
    # the kernels and every device activity (kernels, copies, fills) of one
    # more pass, untimed (counted_pass)
    dp = devprof()
    counted, launches = counted_pass(
        lambda: make(opts, dev), one_by_one(staged, data.odometry),
        len(staged), {"deposit_pair_pool": dp.DEPOSIT, "edt2d_pool": dp.EDT,
                      "gn_batch_solve_pool": dp.GN_SOLVE, "all": ""})
    n_dev = launches.pop("all")
    emit({"phase": "pf_pool_main_path", "main_pass": main,
          "launches": launches,
          "launches_per_update": {n: v / len(counted)
                                  for n, v in launches.items()},
          "device_launches_per_update": n_dev / len(counted),
          "pool_mb": pool_bytes / 2 ** 20, "peak_mem_mb": peak_mb,
          "before_mem_mb": base_mem / 2 ** 20})
    assert main["final_err_m"] < PF_ERR_BOUND_M, \
        f"PF pool: final error {main['final_err_m']:.4f} m"
    assert main["reorgs"] == 0 and main["escaped"] == 0, "PF pool: re-orgs"
    assert all(v > 0 for v in launches.values()), f"launches {launches}"
    for kern in entries:
        kern["launches"] = launches[kern["name"]]
    return entries


SPILL_STEPS = 1200             # phase 24: the corridor route's scans
# the first scans of that route replayed: the smallest multiple of 100 at
# which spills, refills and cache hits had all fired in the CPU rehearsal
SPILL_SCANS = 600
SPILL_CAPACITY = 512
SPILL_REF_CAPACITY = 2048
PF_SPILL_STEPS = 400           # phase 25: tests/test_pf_spill.py's route
PF_SPILL_SCANS = 260
# in the CPU rehearsal (4 particles) capacity 768 spills once in 260 scans
# and never refills, 704 refills once, 640 spills twice and refills 15
# times: the phase needs both events
PF_SPILL_CAPACITY = 640
PF_SPILL_REF_CAPACITY = 4096
SUMMARY_SCANS = 120            # phase 26: bench.py's first scans
SUMMARY_PF_SCANS = 61          # ... and bench_pf.py's first 60 updates


def corridor_data(n_steps: int, beams: int, trans_noise: float,
                  rot_noise: float):
    """The corridor world's figure-8 route with ``beams`` beams to 10 m:
    (data, scans padded to the beam bucket)."""
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    data = simulator.simulate(simulator.SimConfig(
        n_steps=n_steps, seed=4, world="corridor",
        laser=simulator.LaserSpec(n_beams=beams, max_range=10.0),
        odom_trans_noise=trans_noise, odom_rot_noise=rot_noise))
    return data, [pad_scan(c, beam_bucket(beams)) for c in data.clouds]


def pool_content(torch, state, skip_default=None) -> dict:
    """{patch key: slot} of a pool's active patches (with
    ``skip_default`` = max_dist, only those whose cells are not all at
    their initial values)."""
    from iris_lama_tpu_torch.sdm import pool

    keys, mask = pool.active_keys(state.table)
    keys = keys[mask]
    slots = pool.table_lookup(state.table, keys).long()
    if skip_default is not None:
        live = ((state.occupied[slots] != 0).flatten(1).any(1)
                | (state.visited[slots] != 0).flatten(1).any(1)
                | (state.dist[slots] != skip_default).flatten(1).any(1))
        keys, slots = keys[live], slots[live]
    return dict(zip(keys.tolist(), slots.tolist()))


def pools_equal(torch, a, b, skip_default=None) -> tuple:
    """(same key set, every common key's blocks equal) of two pools."""
    ca = pool_content(torch, a, skip_default)
    cb = pool_content(torch, b, skip_default)
    if set(ca) != set(cb):
        return False, False
    ks = sorted(ca)
    sa = torch.as_tensor([ca[k] for k in ks], device=a.dist.device)
    sb = torch.as_tensor([cb[k] for k in ks], device=b.dist.device)
    return True, all(torch.equal(x[sa], y[sb]) for x, y in (
        (a.occupied, b.occupied), (a.visited, b.visited), (a.dist, b.dist)))


def refill_xy(store, stored: set, poses) -> np.ndarray:
    """The route pose (every 10th of ``poses``) whose refill window holds
    the fewest ``stored`` keys but one at least: a refill of the size the
    run's own refills have (a margin's row as the robot comes back)."""
    counts = [(len(stored.intersection(
        int(k) for k in store.window_keys_np(np.asarray(p[:2])))), i)
        for i, p in enumerate(poses[::10])]
    _, i = min((c, i) for c, i in counts if c > 0)
    return np.asarray(poses[::10][i][:2], np.float64)


def tier_events(torch, store, spill, refill) -> dict:
    """Device activities and ms of one spill and one refill, forced after
    a run: ``spill()`` and ``refill()`` run one event each on the driver's
    state (the ms on the host clock, under the profiler)."""
    out = {}
    for name, fn in (("spill", spill), ("refill", refill)):
        n_ev = store.spills + store.refills
        hits = store.cache_hit
        took = []

        def timed(fn=fn):
            t0 = time.perf_counter()
            fn()
            took.append((time.perf_counter() - t0) * 1e3)

        launches = device_launches(torch, timed)
        fired = store.spills + store.refills > n_ev
        out[name] = {"device_activities": launches, "fired": fired,
                     "keys_refilled": store.cache_hit - hits,
                     "ms": took[-1] if fired else None}
    return out


def slam_spill_phase(torch, dev, tmp: str) -> dict:
    """Phase 24: Slam2D with the spill tier over the corridor world at full
    width, against the unbounded pool path on the card. Returns the
    launches of the spill run, counted on the profiler's trace."""
    import dataclasses
    from iris_lama_tpu_torch.algos.slam2d import Slam2D, Slam2DOptions
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.sdm import io as sdm_io
    from iris_lama_tpu_torch.utils.evaluation import ate_rmse

    t0 = time.perf_counter()
    data, padded = corridor_data(SPILL_STEPS, 720, 0.01, 0.002)
    sim_s = time.perf_counter() - t0
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded[:SPILL_SCANS]]
    odoms = data.odometry[:SPILL_SCANS]
    # examples/run_long_world.py's Slam2D options, the pool bounded
    opts = Slam2DOptions(resolution=0.05, max_range=10.0, trans_thresh=0.25,
                         rot_thresh=0.25, capacity=SPILL_CAPACITY,
                         use_compression=True)
    ref_opts = dataclasses.replace(opts, use_compression=False,
                                   resident_window=False,
                                   capacity=SPILL_REF_CAPACITY)
    dp = devprof()
    kernels = {"deposit_pair": dp.DEPOSIT,
               "gn_solve_batched_slam2d": dp.GN_SOLVE, "edt2d": dp.EDT}
    runs = {}
    for name, o in (("reference", ref_opts), ("spill", opts)):
        slam = Slam2D(o, device=dev)
        slam.set_prior(Pose2D(*data.poses_gt[0]))
        torch.cuda.synchronize()
        solver_reads = host_reads("irls_stop")
        tier_reads = host_reads("spill")
        reads_at = []
        t0 = time.perf_counter()
        acc = []
        for k in range(SPILL_SCANS):
            r0 = host_reads("spill")
            if slam.update_prepadded(*staged[k], odoms[k]):
                acc.append(k)
            if host_reads("spill") > r0:
                reads_at.append(k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[name] = dict(slam=slam, acc=acc, seconds=dt, reads_at=reads_at,
                          solver_reads=host_reads("irls_stop") - solver_reads,
                          tier_reads=host_reads("spill") - tier_reads)
        # the kernels of one more run, untimed (counted_pass)
        runs[name]["launches"] = counted_pass(
            lambda: fresh(Slam2D, o, dev, data.poses_gt[0]),
            one_by_one(staged, odoms), SPILL_SCANS, kernels)[1]
    ref, sp_run = runs["reference"], runs["spill"]
    slam, big = sp_run["slam"], ref["slam"]
    sp = slam._spill
    n = slam._n_updates
    traj_equal = bool(torch.equal(slam._traj[:n], big._traj[:n]))
    t0 = time.perf_counter()
    full = slam.full_map()
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    same_keys, same_blocks = pools_equal(torch, full, big.map)
    path = os.path.join(tmp, "spill_full.smd")
    sdm_io.write_distance_map(full, slam.cfg.geometry, slam.cfg.l2_max, path)
    back, _ = sdm_io.read_distance_map(path, capacity=4096, device=dev)
    gt = np.asarray([data.poses_gt[k] for k in sp_run["acc"]])
    patches = {"reference": int(big.map.table.num_patches()),
               "live": int(slam.map.table.num_patches()),
               "stored": len(sp.store),
               "merged": int(full.table.num_patches()),
               "smd_read_back": int(back.table.num_patches())}
    overflow = {"live": int(slam.map.table.overflow),
                "merged": int(full.table.overflow),
                "reference": int(big.map.table.overflow)}
    tier = {"store_bytes": sp.memory_usage(),
            "memory_usage_bytes": slam.memory_usage(),
            "spills": sp.spills, "refills": sp.refills,
            "cache_hits": sp.cache_hit, "cache_misses": sp.cache_miss,
            "tier_host_reads": sp_run["tier_reads"],
            "tier_host_reads_per_update": (sp_run["tier_reads"]
                                           / len(sp_run["acc"])),
            "updates_with_tier_reads": len(sp_run["reads_at"])}
    # one more spill (low water at half the live patches) and one refill,
    # counted by the profiler after the comparisons
    sp.low = patches["live"] // 2
    events = tier_events(
        torch, sp,
        lambda: setattr(slam, "_map", sp.spill(slam._map,
                                               slam.pose().xy())),
        lambda: setattr(slam, "_map", sp.refill(slam._map, refill_xy(
            sp, set(sp.store), data.poses_gt[:SPILL_SCANS]))))
    emit({"phase": "slam_spill", "scans": SPILL_SCANS,
          "route_steps": SPILL_STEPS, "simulate_s": sim_s,
          "capacity": SPILL_CAPACITY,
          "reference_capacity": SPILL_REF_CAPACITY,
          "updates": len(sp_run["acc"]), "patches": patches,
          "overflow": overflow, **tier, "merge_s": merge_s,
          "forced_events": events,
          "solver_host_reads_per_update": {
              k: r["solver_reads"] / len(r["acc"]) for k, r in runs.items()},
          "scans_per_s": {k: len(r["acc"]) / r["seconds"]
                          for k, r in runs.items()},
          "ate_m": ate_rmse(slam.trajectory()[:len(gt)], gt),
          "launches": {k: r["launches"] for k, r in runs.items()},
          "trajectories_equal": traj_equal,
          "full_map_same_keys": same_keys,
          "full_map_blocks_equal": same_blocks})
    assert sp_run["acc"] == ref["acc"], "slam_spill: accepted scans differ"
    assert traj_equal, "slam_spill: the bounded run's trajectory differs"
    assert same_keys and same_blocks, "slam_spill: full_map differs"
    assert patches["reference"] > SPILL_CAPACITY, \
        f"slam_spill: the unbounded run holds {patches['reference']} patches"
    assert not any(overflow.values()), f"slam_spill: overflow {overflow}"
    assert tier["spills"] > 0 and tier["refills"] > 0 \
        and tier["cache_hits"] > 0, \
        "slam_spill: spills, refills and cache hits must all fire"
    assert patches["smd_read_back"] == patches["merged"] > patches["live"], \
        f"slam_spill: the .smd file {patches}"
    assert all(v > 0 for v in sp_run["launches"].values()), \
        f"slam_spill: launches {sp_run['launches']}"
    w = opts.mapping_config().window_cells    # the pool-per-scan window
    return {"slam_spill": path_counts(sp_run["launches"], {
        "deposit_pair": [2, w, w], "gn_solve_batched_slam2d": [1, w, w],
        "edt2d": [w, w]})}


def pf_spill_phase(torch, dev) -> dict:
    """Phase 25: PFSlam2D with the per-particle spill tier over
    tests/test_pf_spill.py's corridor route at full width, against the
    unbounded run on the card. Returns the launches of the spill run,
    counted on the profiler's trace."""
    import dataclasses
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
    from iris_lama_tpu_torch.core.pose import Pose2D

    t0 = time.perf_counter()
    data, padded = corridor_data(PF_SPILL_STEPS, 720, 0.005, 0.001)
    sim_s = time.perf_counter() - t0
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded[:PF_SPILL_SCANS]]
    _, bench_opts, _ = pf_workload()
    opts = dataclasses.replace(bench_opts, capacity=PF_SPILL_CAPACITY,
                               use_compression=True)
    # the tier takes full re-orgs only (no band scrolls): so does the
    # reference, so that both move their windows alike
    ref_opts = dataclasses.replace(bench_opts, capacity=PF_SPILL_REF_CAPACITY,
                                   scroll_reorg=False)
    dp = devprof()
    kernels = {"deposit_pair_batched": dp.DEPOSIT, "edt2d_batched": dp.EDT,
               "gn_batch_solve": dp.GN_SOLVE}
    runs = {}
    for name, o in (("reference", ref_opts), ("spill", opts)):
        f = PFSlam2D(o, device=dev)
        f.set_prior(Pose2D(*data.poses_gt[0]))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tier_reads = host_reads("spill")
        t0 = time.perf_counter()
        n_up = sum(bool(f.update_prepadded(*staged[k], data.odometry[k]))
                   for k in range(PF_SPILL_SCANS))
        f._flush_motion()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tier_reads = host_reads("spill") - tier_reads
        m = f.pset.maps
        runs[name] = dict(
            f=f, updates=n_up, seconds=dt, tier_reads=tier_reads,
            peak_mem_mb=torch.cuda.max_memory_allocated(dev) / 2 ** 20,
            before_mem_mb=base / 2 ** 20,
            pool_mb=sum(a.numel() * a.element_size() for a in
                        (m.occupied, m.visited, m.dist)) / 2 ** 20)
        # the kernels of one more run, untimed (counted_pass)
        runs[name]["launches"] = counted_pass(
            lambda: fresh(PFSlam2D, o, dev, data.poses_gt[0]),
            one_by_one(staged, data.odometry), PF_SPILL_SCANS, kernels)[1]
        if name == "reference":
            ref_f = f
        del f
    f, sp_run = runs["spill"]["f"], runs["spill"]
    sp = f._pf_spill
    equal = {k: bool(torch.equal(getattr(f.pset, k),
                                 getattr(ref_f.pset, k)))
             for k in ("pose", "weight", "res_dist")}
    best = (f.best_particle_idx(), ref_f.best_particle_idx())
    max_dist = float(np.float32(opts.mapping_config().distance.max_dist))
    t0 = time.perf_counter()
    merged, _ = f.full_particle_map(best[0])
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    same_keys, same_blocks = pools_equal(
        torch, merged, ref_f.particle_map(best[1]), max_dist)
    counts = f.pset.maps.table.num_patches()
    overflow = int(f.pset.maps.table.overflow.max())
    tier = {"spills": sp.spills, "refills": sp.refills,
            "cache_hits": sp.cache_hit,
            "tier_host_reads": sp_run["tier_reads"],
            "store_bytes_shared_once": sp.memory_usage(),
            "store_entries": sum(len(st) for st in sp.stores)}

    def spill_event():
        f._pf_settle_stores()
        maps, _ = sp.spill_batch(f.pset.maps, f.pose().xy())
        f.pset = f.pset._replace(maps=maps)

    def refill_event():
        f._pf_settle_stores()
        f.pset = f.pset._replace(maps=sp.refill_batch(f.pset.maps, refill_xy(
            sp, set().union(*sp.stores), data.poses_gt[:PF_SPILL_SCANS])))

    # one more spill (low water at half the fullest pool) and one refill,
    # counted by the profiler after the comparisons
    sp.low = int(counts.max()) // 2
    events = tier_events(torch, sp, spill_event, refill_event)
    emit({"phase": "pf_spill", "scans": PF_SPILL_SCANS,
          "route_steps": PF_SPILL_STEPS, "simulate_s": sim_s,
          "particles": opts.particles, "capacity": PF_SPILL_CAPACITY,
          "reference_capacity": PF_SPILL_REF_CAPACITY,
          "updates": sp_run["updates"],
          "updates_per_s": {k: r["updates"] / r["seconds"]
                            for k, r in runs.items()},
          "reorgs": [f.n_reorgs, ref_f.n_reorgs],
          "scrolls": [f.n_scrolls, ref_f.n_scrolls],
          "escaped": [f.escaped_count(), ref_f.escaped_count()],
          **tier, "merge_s": merge_s, "forced_events": events,
          "high_water": sp.high, "live_patches_max": int(counts.max()),
          "overflow": overflow, "best_particle": list(best), "equal": equal,
          "merged_same_keys": same_keys, "merged_blocks_equal": same_blocks,
          "memory_mb": {k: {"pool_mb": r["pool_mb"],
                            "peak_above_before_mb": (r["peak_mem_mb"]
                                                     - r["before_mem_mb"])}
                        for k, r in runs.items()},
          "launches": {k: r["launches"] for k, r in runs.items()}})
    assert all(equal.values()), f"pf_spill: {equal}"
    assert best[0] == best[1], f"pf_spill: best particle {best}"
    assert same_keys and same_blocks, "pf_spill: the merged map differs"
    assert int(counts.max()) <= sp.high, "pf_spill: above high water"
    assert overflow == 0, "pf_spill: overflow"
    assert tier["spills"] > 0 and tier["refills"] > 0, \
        "pf_spill: spills and refills"
    assert f.n_scrolls == 0, "pf_spill: band scrolls under the tier"
    assert all(v > 0 for v in sp_run["launches"].values()), \
        f"pf_spill: launches {sp_run['launches']}"
    c, n_p = opts.mapping_config(), opts.particles
    ru, mw = c.resident_update_cells, c.match_window_cells
    return {"pf_spill": path_counts(sp_run["launches"], {
        "deposit_pair_batched": [2, n_p, ru, ru],
        "edt2d_batched": [n_p, ru, ru],
        "gn_batch_solve": [n_p, mw, mw]})}


def summary_phase(torch, dev) -> None:
    """Phase 26: bench.py's Slam2D workload (first SUMMARY_SCANS scans)
    and bench_pf.py's (first 60 updates) with create_summary and
    detailed_summary on the card, against the same scans without them:
    the trajectories and particles torch.equal; both reports printed
    with the card's name and power limit."""
    import dataclasses
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2D
    from iris_lama_tpu_torch.algos.slam2d import Slam2D
    from iris_lama_tpu_torch.core.pose import Pose2D

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    out = {}
    for kind, (data, opts0, padded), n, cls in (
            ("slam2d", slam_workload(), SUMMARY_SCANS, Slam2D),
            ("pf", pf_workload(), SUMMARY_PF_SCANS, PFSlam2D)):
        staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
                  for p in padded[:n]]
        drivers = []
        for kw in ({}, dict(create_summary=True, detailed_summary=True)):
            d = cls(dataclasses.replace(opts0, **kw), device=dev)
            d.set_prior(Pose2D(*data.poses_gt[0]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for k in range(n):
                d.update_prepadded(*staged[k], data.odometry[k],
                                   data.timestamps[k])
            torch.cuda.synchronize()
            drivers.append((d, time.perf_counter() - t0))
        (plain, t_plain), (det, t_det) = drivers
        if kind == "slam2d":
            k = plain._n_updates
            equal = bool(torch.equal(plain._traj[:k], det._traj[:k]))
        else:
            plain._flush_motion()
            det._flush_motion()
            equal = all(torch.equal(getattr(plain.pset, a),
                                    getattr(det.pset, a))
                        for a in ("pose", "weight", "res_dist"))
        s = det.summary
        phases = {p: float(np.mean(getattr(s, f"time_{p}")[1:])) * 1e3
                  for p in ("total", "solving", "normalizing",
                            "resampling", "mapping")}
        out[kind] = equal
        emit({"phase": f"summary_{kind}", "nvidia_smi": smi.splitlines(),
              "scans": n, "updates": len(s.time_total),
              "trajectory_equal": equal, "seconds_plain": t_plain,
              "seconds_detailed": t_det, "mean_phase_ms": phases,
              "report": s.report().splitlines()})
        print(f"{smi.splitlines()[0]} — {kind} summary:\n{s.report()}",
              flush=True)
        assert len(s.time_total) > 1 and sum(s.time_solving[1:]) > 0 \
            and sum(s.time_mapping[1:]) > 0, f"summary_{kind}: no phases"
        del drivers, plain, det
    assert all(out.values()), f"summaries change the results: {out}"


@functools.lru_cache(maxsize=None)
def room3d_workload(n_clouds: int = ROOM3D_CLOUDS,
                    azimuths: int = ROOM3D_AZIMUTHS, seed: int = 27):
    """Phase 27's clouds: a 16-ring scanner (-15 to +15 degrees,
    ``azimuths`` steps, 12 m, 1 cm range noise) 1 m above the floor of a
    12 x 8 x 3 m room with six boxes, at ``n_clouds`` SE(3) poses along
    a loop (built with the port's ``se3_*``). Returns [(points f32 [B,
    3] in the world frame, mask bool [B], origin f32 [3], pose f32 [7])].
    """
    import torch
    from iris_lama_tpu_torch.core import lie
    rng = np.random.default_rng(seed)
    hi = np.array([ROOM3D[0] / 2, ROOM3D[1] / 2, ROOM3D[2]])
    lo = np.array([-hi[0], -hi[1], 0.0])
    boxes = []
    for cx, cy in ((0.0, 0.0), (-4.6, -2.9), (4.6, 2.9), (-4.6, 2.9),
                   (4.6, -2.9), (0.0, 3.2)):
        half = rng.uniform([0.25, 0.25, 0.3], [0.5, 0.4, 1.0])
        c = np.array([cx + rng.uniform(-0.2, 0.2),
                      cy + rng.uniform(-0.1, 0.1), half[2]])
        boxes.append((c - half, c + half))
    elev = np.deg2rad(np.linspace(-15.0, 15.0, ROOM3D_RINGS))
    azim = 2 * np.pi * np.arange(azimuths) / azimuths
    e, a = np.meshgrid(elev, azim, indexing="ij")
    dirs = torch.as_tensor(np.stack([np.cos(e) * np.cos(a),
                                     np.cos(e) * np.sin(a), np.sin(e)],
                                    -1).reshape(-1, 3), dtype=torch.float32)
    out = []
    for k in range(n_clouds):
        th = 2 * np.pi * k / n_clouds
        t = np.array([3.2 * np.cos(th), 2.0 * np.sin(th), 1.0])
        yaw = np.arctan2(2.0 * np.cos(th), -3.2 * np.sin(th))
        q = lie.quat_mul(
            lie.so3_exp(torch.tensor([0.0, 0.0, yaw], dtype=torch.float32)),
            lie.so3_exp(torch.tensor([0.03 * np.sin(3 * th),
                                      0.02 * np.cos(2 * th), 0.0],
                                     dtype=torch.float32)))
        pose = lie.se3(t, q)
        o = lie.se3_translation(pose).double().numpy()
        d = (lie.se3_apply(pose, dirs) - lie.se3_translation(pose)) \
            .double().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            # the room from inside: the nearest wall ahead on each axis
            r = np.where(inv > 0, (hi - o) * inv, (lo - o) * inv).min(-1)
            for blo, bhi in boxes:
                t1, t2 = (blo - o) * inv, (bhi - o) * inv
                tmin = np.nan_to_num(np.minimum(t1, t2), nan=-np.inf).max(-1)
                tmax = np.nan_to_num(np.maximum(t1, t2), nan=np.inf).min(-1)
                r = np.where((tmax >= tmin) & (tmin > 0), np.minimum(r, tmin),
                             r)
        r = r + rng.normal(0.0, ROOM3D_NOISE, r.shape)
        mask = (r > 0.1) & (r < ROOM3D_RANGE)
        pts = (o + d * r[:, None]).astype(np.float32)
        out.append((pts, mask, o.astype(np.float32),
                    pose.numpy().astype(np.float32)))
    return out


MAPS3D = ("frequency3", "simple3", "probabilistic3", "distance3", "tsdf")


def maps3d_setup(torch):
    """(configs, init(name, device), step(name, state, cloud, device) ->
    (state, info)) of phase 27's five 3D maps."""
    import math
    from iris_lama_tpu_torch.sdm import distance3d as d3
    from iris_lama_tpu_torch.sdm import occupancy3d as o3
    from iris_lama_tpu_torch.sdm import tsdf as tsdf_mod
    from iris_lama_tpu_torch.sdm.raycast import ray_cells
    geo = o3.MapGeometry3(0.05, 4)
    dcfg = d3.Distance3Config(geo, l2_max=0.5)
    tcfg = tsdf_mod.TSDFConfig()
    steps = math.ceil(ROOM3D_RANGE / geo.resolution)
    cap = 4096

    def init(name, device):
        if name == "distance3":
            return d3.distance3_init(dcfg, cap, device)
        if name == "tsdf":
            return tsdf_mod.tsdf_init(tcfg, device)
        return getattr(o3, name + "_init")(geo, cap, device)

    def step(name, st, cloud, device):
        pts, msk, org = (torch.as_tensor(a, device=device)
                         for a in cloud[:3])
        if name == "frequency3":
            return o3.frequency3_insert_scan(st, geo, pts, msk, org,
                                             steps), {}
        if name == "tsdf":
            st, n = tsdf_mod.insert_point_cloud(st, tcfg, pts, msk, org)
            return st, {"integrated": n}
        hits = geo.w2m(pts)
        if name == "simple3":
            return o3.simple3_set(st, geo, hits[msk], 1), {}
        if name == "probabilistic3":
            # the rays' cells: a hit at each endpoint, a miss on each cell
            # before it (the masked stream's cells left out)
            frees, fmask = ray_cells(geo.w2m(org).expand(hits.shape), hits,
                                     steps)
            hit_c, free_c = hits[msk], frees[fmask & msk[:, None]]
            cells = torch.cat([hit_c, free_c])
            h = torch.cat([torch.ones_like(hit_c[:, 0]),
                           torch.zeros_like(free_c[:, 0])])
            return o3.probabilistic3_apply(st, geo, cells, h, 1 - h), {}
        st = d3.add_obstacles3(st, dcfg, hits[msk])
        n_dirty = int(d3.dirty_slots(st).numel())
        st = d3.update3(st, dcfg, DIST3_MAX_DIRTY)
        return st, {"dirty": n_dirty,
                    "carried": max(n_dirty - DIST3_MAX_DIRTY, 0)}

    return (geo, dcfg, tcfg, steps), init, step


def maps3d_compare(torch, name, a, b) -> dict:
    """CPU state ``a`` against card state ``b`` of one 3D map: integer
    arrays ``torch.equal``, log-odds within 4e-6, TSDF values within
    rtol 1e-5 (their float sums ran in another order) and the observed
    set equal. Raises on a difference."""
    tab = all(torch.equal(x, y.cpu()) for x, y in zip(a.table, b.table))
    out = {"table_equal": tab,
           "patches": int(a.table.num_patches()),
           "overflow": int(b.table.overflow)}
    assert tab, f"{name}: tables differ"
    if name == "probabilistic3":
        err = float((a.logodds - b.logodds.cpu()).abs().max())
        out["logodds_max_abs_err"] = err
        assert torch.equal(a.touched, b.touched.cpu()), f"{name}: touched"
        assert err <= LO_ATOL, f"{name}: log-odds {err}"
    elif name == "tsdf":
        wa, wb = a.weight, b.weight.cpu()
        da, db = a.dist, b.dist.cpu()
        out["observed_equal"] = torch.equal(wa > 0, wb > 0)
        out["weight_max_rel_err"] = float(((wa - wb).abs() / wa.abs()
                                           .clamp(min=1e-30)).max())
        out["dist_max_abs_err"] = float((da - db).abs().max())
        assert out["observed_equal"], f"{name}: observed cells differ"
        assert torch.allclose(wb, wa, rtol=TSDF_RTOL, atol=0), \
            f"{name}: weights {out['weight_max_rel_err']}"
        assert torch.allclose(db, da, rtol=TSDF_RTOL, atol=1e-6), \
            f"{name}: distances {out['dist_max_abs_err']}"
    else:
        for f in a._fields[1:]:
            assert torch.equal(getattr(a, f), getattr(b, f).cpu()), \
                f"{name}: {f} differs"
        out["cells_equal"] = True
    return out


def maps3d_phase(torch, dev, tmp: str) -> None:
    """Phase 27: the 3D maps at the reference's default sizes (5 cm, 16^3
    patches; frequency, simple and probabilistic states and the distance
    map at capacity 4,096, l2_max 0.5 m: R = 10, windows of 48^3; the
    TSDF at its constructor's defaults, capacity 8,192) on phase 27's
    room workload. CPU against card over the first ROOM3D_PREFIX clouds,
    then the whole workload on the card, each map alone: per-cloud ms,
    device activities and device ms a cloud, peak memory, update3's dirty
    counts and carry, to_mesh, and the .smd files of the three occupancy
    states (the same bytes as from the state moved to the CPU, read back
    equal)."""
    from iris_lama_tpu_torch.sdm import distance3d as d3
    from iris_lama_tpu_torch.sdm import occupancy3d as o3
    from iris_lama_tpu_torch.sdm import tsdf as tsdf_mod
    (geo, dcfg, tcfg, steps), init, step = maps3d_setup(torch)
    t_gen = time.perf_counter()
    clouds = room3d_workload()
    t_gen = time.perf_counter() - t_gen
    n_pts = int(clouds[0][0].shape[0])

    # 1. the CPU (plain PyTorch) against the card, first clouds
    states, secs = {}, {}
    for device in ("cpu", dev):
        for name in MAPS3D:
            st = init(name, device)
            t0 = time.perf_counter()
            for c in clouds[:ROOM3D_PREFIX]:
                st, _ = step(name, st, c, device)
            if device != "cpu":
                torch.cuda.synchronize()
            states[device, name] = st
            secs.setdefault(name, []).append(time.perf_counter() - t0)
    cmp = {n: maps3d_compare(torch, n, states["cpu", n], states[dev, n])
           for n in MAPS3D}
    hits = torch.cat([geo.w2m(torch.as_tensor(c[0][c[1]]))
                      for c in clouds[:ROOM3D_PREFIX]])
    q_cpu = o3.simple3_query(states["cpu", "simple3"], geo, hits)
    q_card = o3.simple3_query(states[dev, "simple3"], geo, hits.to(dev))
    assert torch.equal(q_cpu, q_card.cpu()), "simple3: queries differ"
    assert bool((q_cpu == 1).all()), "simple3: a hit reads unset"
    rng = np.random.default_rng(28)
    half = np.array(ROOM3D) / 2
    q = np.stack([rng.uniform(-half[0], half[0], ROOM3D_QUERIES),
                  rng.uniform(-half[1], half[1], ROOM3D_QUERIES),
                  rng.uniform(0.0, ROOM3D[2], ROOM3D_QUERIES)],
                 -1).astype(np.float32)
    reads = {}
    for name, fn, cfg in (("distance3", d3.distance3, dcfg),
                          ("tsdf", tsdf_mod.distance_interp, tcfg)):
        dc, gc = fn(states["cpu", name], cfg, torch.as_tensor(q))
        dg, gg = fn(states[dev, name], cfg, torch.as_tensor(q, device=dev))
        reads[name] = {"dist_max_abs_err": float((dc - dg.cpu()).abs().max()),
                       "grad_max_abs_err": float((gc - gg.cpu()).abs().max())}
        assert max(reads[name].values()) <= INTERP_ATOL, (name, reads[name])
    tris = [len(tsdf_mod.to_mesh(states[d, "tsdf"], tcfg)[1])
            for d in ("cpu", dev)]
    assert abs(tris[0] - tris[1]) <= MESH_TRI_RTOL * max(tris[0], 1), tris
    emit({"phase": "maps3d_prefix", "clouds": ROOM3D_PREFIX,
          "points_per_cloud": n_pts, "workload_gen_s": t_gen,
          "cpu_s": {n: v[0] for n, v in secs.items()},
          "card_s": {n: v[1] for n, v in secs.items()},
          "compare": cmp, "queries": ROOM3D_QUERIES, "reads": reads,
          "simple3_hits_read": int(hits.shape[0]),
          "mesh_triangles_cpu_card": tris})
    del states

    # 2. the whole workload on the card, one map at a time
    dp = devprof()
    out = {}
    for name in MAPS3D:
        st = init(name, dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms, infos = [], []
        for c in clouds:
            t0 = time.perf_counter()
            st, info = step(name, st, c, dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            infos.append(info)
        peak = torch.cuda.max_memory_allocated(dev)
        box = [st]

        def more():
            for c in clouds[:PROFILED_CLOUDS]:
                box[0] = step(name, box[0], c, dev)[0]

        rows = dp.cuda_rows(dp.profile_calls(more))
        top = sorted(((short_kernel_name(r.key),
                       dp.event_us(r) / PROFILED_CLOUDS, r.count)
                      for r in rows), key=lambda r: -r[1])[:6]
        rec = {"per_cloud_ms": ms, "median_ms": float(np.median(ms)),
               "first_ms": ms[0], "max_ms": max(ms),
               "clouds_per_s": len(ms) / (sum(ms) / 1e3),
               "device_ms_per_cloud": dp.device_us(rows) / 1e3
               / PROFILED_CLOUDS,
               "device_activities_per_cloud": dp.launch_count(rows)
               / PROFILED_CLOUDS,
               "top_device_us_per_cloud": top,
               "state_mib": sum(x.numel() * x.element_size()
                                for x in (*st.table, *st[1:])) / 2 ** 20,
               "peak_mib_above_state": (peak - base) / 2 ** 20,
               "patches": int(st.table.num_patches()),
               "overflow": int(st.table.overflow)}
        del box
        if name == "distance3":
            rec["dirty_per_cloud"] = [i["dirty"] for i in infos]
            rec["carried_per_cloud"] = [i["carried"] for i in infos]
            rec["max_dirty"] = DIST3_MAX_DIRTY
            rec["still_dirty"] = int(d3.dirty_slots(st).numel())
        if name == "tsdf":
            rec["integrated_per_cloud"] = [int(i["integrated"])
                                           for i in infos]
            t0 = time.perf_counter()
            verts, tri = tsdf_mod.to_mesh(st, tcfg)
            rec["to_mesh_s"] = time.perf_counter() - t0
            rec["mesh_triangles"] = int(len(tri))
            rec["mesh_vertices"] = int(len(verts))
            assert len(tri) > 0 and np.isfinite(verts).all(), "tsdf: mesh"
        if name in ("frequency3", "simple3", "probabilistic3"):
            rec["smd"] = smd3_roundtrip(torch, name, st, geo, tmp)
        out[name] = rec
        # frequency3_insert_scan allocates every cell of its [B, T + 1]
        # stream, masked or not (as the JAX package does): the rays'
        # masked extension past each hit fills the pool
        assert name == "frequency3" or rec["overflow"] == 0, \
            f"{name}: pool overflow"
        del st
    emit({"phase": "maps3d_main_path", "clouds": len(clouds),
          "points_per_cloud": n_pts, "ray_steps": steps,
          "maps": out,
          "nvidia_smi": subprocess.run(
              ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"], capture_output=True, text=True,
              timeout=60).stdout.strip()})


def short_kernel_name(key: str) -> str:
    """A profiler row's kernel name cut to the op it runs: the templated
    names of PyTorch's elementwise kernels run to kilobytes."""
    import re
    for pat in (r"(\w+_kernel_cuda)", r"(\w+_kernel_impl)\(",
                r"(\w+Functor\w*)", r"(\w+Kernel\w*)"):
        m = re.search(pat, key)
        if m:
            return m.group(1)
    return key[:80]


def smd3_roundtrip(torch, name: str, st, geo, tmp: str) -> dict:
    """A 3D state written as .smd from the card and from its copy on the
    CPU (the same bytes), read back onto the card (every allocated slot's
    cells equal: the reader inserts in slot order) and written again (the
    same bytes). Returns sizes and times."""
    from iris_lama_tpu_torch.sdm import io as sdm_io
    from iris_lama_tpu_torch.sdm import pool as pool_mod
    write = getattr(sdm_io, "write_" + name)
    read = getattr(sdm_io, "read_" + name)
    path, cpath, again = (os.path.join(tmp, f"{name}{s}.smd")
                          for s in ("", "_cpu", "_again"))
    t0 = time.perf_counter()
    write(st, geo, path)
    t_write = time.perf_counter() - t0
    cpu_state = type(st)(pool_mod.PatchTable(*(x.cpu() for x in st.table)),
                         *(x.cpu() for x in st[1:]))
    write(cpu_state, geo, cpath)
    with open(path, "rb") as f:
        data = f.read()
    with open(cpath, "rb") as f:
        assert f.read() == data, f"{name}: card and CPU files differ"
    t0 = time.perf_counter()
    loaded, _ = read(path, capacity=st.table.capacity,
                     device=st.table.keys.device)
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    slots = torch.nonzero(pool_mod.active_slot_mask(st.table)).reshape(-1)
    for f in st._fields[1:]:
        assert torch.equal(getattr(loaded, f)[slots], getattr(st, f)[slots]), \
            f"{name}: {f} read back differs"
    write(loaded, geo, again)
    with open(again, "rb") as f:
        assert f.read() == data, f"{name}: write -> read -> write differs"
    for p in (path, cpath, again):
        os.remove(p)
    return {"bytes": len(data), "write_s": t_write, "read_s": t_read,
            "cpu_bytes_equal": True, "read_back_equal": True}


class MatchRecorder:
    """Records the inputs and result of every ``solve_window`` call while
    active (the module function is wrapped, and restored on exit)."""

    def __init__(self, match_mod):
        self.mod, self.calls = match_mod, []

    def __enter__(self):
        self.orig = self.mod.solve_window

        def rec(grid, org_cell, geo, max_dist, points_xy, mask, state0,
                opts, route="generic"):
            res = self.orig(grid, org_cell, geo, max_dist, points_xy, mask,
                            state0, opts, route=route)
            self.calls.append({
                "grid": grid.clone(), "org_cell": org_cell.clone(),
                "geo": geo, "max_dist": max_dist,
                "points_xy": points_xy.clone(), "mask": mask.clone(),
                "state0": state0.clone(), "opts": opts, "route": route,
                "state": res.state.clone(),
                "iterations": res.iterations.clone(),
                "chi2": res.chi2.clone()})
            return res

        self.mod.solve_window = rec
        return self

    def __exit__(self, *exc):
        self.mod.solve_window = self.orig


def b4_slam_entries(torch, dev, calls) -> list:
    """B4 on Slam2D's own matches (phase 4's card prefix, recorded by
    :class:`MatchRecorder`): every call's operands, as
    ``match_surface_2d.solve_window`` passes them, solved by the kernel and
    by its plain version, bit-equal in state, iterations, chi2 and the
    likelihood's sum, and the kernel's state, iterations and chi2 equal to
    what the run returned; timed on the last call (the largest map). Then
    that call's window at every wider width: bit-equal to the plain version
    and to the int8 result. Returns the kernels line's entries."""
    from iris_lama_tpu_torch.match import match_surface_2d as match_mod
    from iris_lama_tpu_torch.ops import gn_solve

    def operands(c):
        geo, opts = c["geo"], c["opts"]
        args = (c["grid"][None], c["org_cell"].to(torch.int32).reshape(1, 2),
                c["state0"].reshape(1, 4), c["points_xy"].contiguous(),
                c["mask"])
        kw = dict(max_dist=c["max_dist"], res=geo.resolution,
                  scale=geo.scale, cell_offset=geo.cell_offset,
                  cauchy_c=match_mod._cauchy_c(opts), eps1=opts.eps1,
                  eps2=opts.eps2, max_iter=opts.max_iterations)
        return args, kw

    def bound_of(args, iters):
        # bytes: the window once, the scan, the start and the rows;
        # operations: ~60 per beam and evaluation (the start and each
        # iteration's candidate), as phase 9's B4 entries count them
        b = args[3].shape[0]
        return bound(args[0].numel() * args[0].element_size() + b * 9 + 56,
                     60 * b * (iters + 1))

    names = ("state", "iterations", "chi2", "sum_d2")
    iters, err = [], 0.0
    for n, c in enumerate(calls):
        assert c["route"] == "solve", f"B4 Slam2D call {n}: {c['route']}"
        args, kw = operands(c)
        got = gn_solve.solve_window_sq(*args, **kw, want_lik=True)
        want = gn_solve.solve_window_sq_plain(*args, **kw, want_lik=True)
        run = gn_solve.solve_window_sq(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, float((got[0] - want[0]).abs().max()))
        for name, a, w_ in zip(names, got, want):
            assert torch.equal(a, w_), f"B4 Slam2D call {n}: {name} differs"
        for name, a in zip(names, run[:3]):
            assert torch.equal(a[0], c[name]), \
                f"B4 Slam2D call {n}: {name} differs from the run's"
        iters.append(int(got[1][0]))
    args, kw = operands(calls[-1])
    _, h, w = args[0].shape
    b = args[3].shape[0]
    bd = bound_of(args, iters[-1])
    common = {"route": "cuda",
              "source": "iris_lama_tpu_torch/csrc/gn_solve.cu",
              "replaces": "iris_lama_tpu/ops/gn_solve.py:104",
              "library_ms": None,
              "library_call": "none: no single PyTorch call computes an "
                              "IRLS solve"}
    entries = [{
        "name": "gn_solve_batched_slam2d", **common,
        "shape": [1, h, w, b], "dtype": "int8",
        "valid_beams": int(args[4].sum()),
        "variant": "shared" if gn_solve.staged(h, w, b) else "global",
        "calls_checked": len(calls), "iters": iters, "max_abs_err": err,
        "launch_floor_ms": b5_floor_ms(torch, dev, 1, b),
        **timings(torch, "", lambda: gn_solve.solve_window_sq(*args, **kw),
                  300),
        **timings(torch, "plain_", lambda: gn_solve.solve_window_sq_plain(
            *args, **kw), 5),
        "bound_ms": bd[0], "bound_by": bd[1]}]
    ref8 = gn_solve.solve_window_sq(*args, **kw, want_lik=True)
    for width in WIDTHS:
        args_w = (widened(torch, args[0], width), *args[1:])
        got_w = gn_solve.solve_window_sq(*args_w, **kw, want_lik=True)
        want_w = gn_solve.solve_window_sq_plain(*args_w, **kw, want_lik=True)
        torch.cuda.synchronize()
        for name, a, w_, i8 in zip(names, got_w, want_w, ref8):
            assert torch.equal(a, w_) and torch.equal(a, i8), \
                f"B4 Slam2D {width} {name} differs"
        bd = bound_of(args_w, int(got_w[1][0]))
        entries.append({
            "name": f"gn_solve_batched_slam2d_{width}", **common,
            "shape": [1, h, w, b], "dtype": width, "max_abs_err": 0.0,
            **timings(torch, "", lambda: gn_solve.solve_window_sq(
                *args_w, **kw), 100),
            **timings(torch, "plain_", lambda: gn_solve.solve_window_sq_plain(
                *args_w, **kw), 3),
            "bound_ms": bd[0], "bound_by": bd[1]})
    return entries


def slam_phases(torch, dev) -> list:
    """Phases 3-5: the kernels against their plain versions at the main
    path's shapes, the CPU/card prefix, the Slam2D bench workload.
    Returns the kernels line's entries of B1, B2, B3 and B4 (the main path
    matches through B4, one launch a matched update; B2 at this shape
    serves the generic route's callers, Slam2D on the CPU or under LM, and
    reads 0 launches here)."""
    from iris_lama_tpu_torch.algos.slam2d import Slam2D
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.match import match_surface_2d as match_mod
    from iris_lama_tpu_torch.ops import edt_pallas, scatter_matmul, select4
    from iris_lama_tpu_torch.sdm import mapping
    from iris_lama_tpu_torch.utils.cloud import beam_bucket

    # the main path's data: the bench workload's scans and options
    data, opts, padded = slam_workload()
    cfg = opts.mapping_config()
    nb = beam_bucket(720)

    # 3. kernels against their plain versions --------------------------------
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    geo = cfg.geometry
    pts, msk, ori = (torch.as_tensor(a, device=dev) for a in padded[0])
    pose = lie.se2(*data.poses_gt[0], device=dev)
    wu = cfg.resident_update_cells
    org = geo.w2m(pose[:2]) - wu // 2
    idx = mapping.deposit_indices(cfg, pose, pts, msk, ori, org, wu)
    n_dep = idx.free_ly.numel()
    perm = torch.randperm(n_dep, device=dev)
    sent = torch.rand(n_dep, device=dev) < 0.3
    b1_cases = {
        "beam_ordered": (idx.free_ly, idx.free_lx),
        "shuffled": (idx.free_ly[perm].contiguous(),
                     idx.free_lx[perm].contiguous()),
        "sentinels": (torch.where(sent, wu, idx.free_ly).contiguous(),
                      idx.free_lx),
    }
    # B1 on the free-space stream as the map update sends it (beam-major),
    # shuffled and with sentinels
    b1_err = 0
    for name, (ly, lx) in b1_cases.items():
        got = scatter_matmul.deposit_counts(ly, lx, wu, wu)
        want = scatter_matmul.deposit_counts_plain(ly, lx, wu, wu)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        assert torch.equal(got, want), f"B1 {name}: max abs err {err}"
        b1_err = max(b1_err, err)
    ly, lx = b1_cases["beam_ordered"]
    b1_library = deposit_library(torch, dev, [(ly[None], lx[None], (0,))],
                                 1, wu, wu)
    b1_bound = bound(n_dep * 8 + wu * wu * 4, n_dep)
    b1 = {"name": "deposit_counts", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/deposit.cu",
          "replaces": "iris_lama_tpu/ops/scatter_matmul.py:81",
          "n": n_dep, "hw": [wu, wu], "max_abs_err": b1_err,
          "stream": "beam_ordered",
          "launch_floor_ms": memset_floor_ms(
              torch, dev, wu * wu * 4,
              scatter_matmul.launch_blocks(1, [n_dep]), 256),
          **timings(torch, "", lambda: scatter_matmul.deposit_counts(
              ly, lx, wu, wu), 300),
          **timings(torch, "plain_",
                    lambda: scatter_matmul.deposit_counts_plain(
                        ly, lx, wu, wu), 300),
          **timings(torch, "library_", b1_library, 20),
          "library_call": "zeros + index_put_(accumulate=True)",
          "bound_ms": b1_bound[0], "bound_by": b1_bound[1]}
    # the pair: the scan's hits into occ and vis, its free cells into vis,
    # one memset and one launch (the map update's call)
    hit = (idx.hit_ly, idx.hit_lx)
    n_hit = int(idx.hit_ly.numel())
    pair_err = 0
    for name, (fly, flx) in b1_cases.items():
        got = scatter_matmul.deposit_pair(*hit, fly, flx, wu, wu)
        want = scatter_matmul.deposit_pair_plain(*hit, fly, flx, wu, wu)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            pair_err = max(pair_err, int((g_ - w_).abs().max()))
            assert torch.equal(g_, w_), f"B1 pair {name}: differs"
    pair_library = deposit_library(torch, dev, [
        (idx.hit_ly[None], idx.hit_lx[None], (0, 1)),
        (ly[None], lx[None], (1,))], 1, wu, wu)
    pair_bound = bound((n_hit + n_dep) * 8 + 2 * wu * wu * 4,
                       2 * n_hit + n_dep)
    pair = {"name": "deposit_pair", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/deposit.cu",
            "replaces": "iris_lama_tpu/ops/scatter_matmul.py:81",
            "n_hit": n_hit, "n_free": n_dep, "hw": [wu, wu],
            "max_abs_err": pair_err, "stream": "beam_ordered",
            "launch_floor_ms": memset_floor_ms(
                torch, dev, 2 * wu * wu * 4,
                scatter_matmul.launch_blocks(1, [n_hit, n_dep]), 256),
            **timings(torch, "", lambda: scatter_matmul.deposit_pair(
                *hit, ly, lx, wu, wu), 300),
            **timings(torch, "plain_",
                      lambda: scatter_matmul.deposit_pair_plain(
                          *hit, ly, lx, wu, wu), 300),
            **timings(torch, "library_", pair_library, 20),
            "library_call": "zeros + index_put_(accumulate=True) over both "
                            "grids' bins",
            **timings(torch, "index_add_", deposit_library(torch, dev, [
                (idx.hit_ly[None], idx.hit_lx[None], (0, 1)),
                (ly[None], lx[None], (1,))], 1, wu, wu, add=True), 100),
            "index_add_call": "zeros + index_add_ over both grids' bins",
            "bound_ms": pair_bound[0], "bound_by": pair_bound[1]}

    wm = cfg.match_window_cells
    grid = torch.as_tensor(rng.integers(0, cfg.distance.max_sqdist + 1,
                                        (wm, wm)).astype(np.int8), device=dev)
    nbeam = nb
    sly = torch.as_tensor(rng.integers(-3, wm + 3, nbeam).astype(np.int32),
                          device=dev)
    slx = torch.as_tensor(rng.integers(-3, wm + 3, nbeam).astype(np.int32),
                          device=dev)
    got = select4.select4_sq(grid, sly, slx)
    want = select4.select4_sq_plain(grid, sly, slx)
    torch.cuda.synchronize()
    b2_err = int((got - want).abs().max())
    assert torch.equal(got, want), f"B2: max abs err {b2_err}"
    y0, y1 = sly.clamp(0, wm - 1).long(), (sly + 1).clamp(0, wm - 1).long()
    x0, x1 = slx.clamp(0, wm - 1).long(), (slx + 1).clamp(0, wm - 1).long()

    def b2_library():
        return (grid[y0, x0], grid[y0, x1], grid[y1, x0], grid[y1, x1])

    b2_bound = bound(nbeam * (8 + 4 + 16), nbeam * 8)
    b2 = {"name": "select4_sq", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/select4.cu",
          "replaces": "iris_lama_tpu/ops/select4.py:36",
          "n": nbeam, "hw": [wm, wm], "max_abs_err": b2_err,
          "launch_floor_ms": b2_floor_ms(torch, dev, nbeam),
          **timings(torch, "", lambda: select4.select4_sq(
              grid, sly, slx), 1000),
          **timings(torch, "plain_", lambda: select4.select4_sq_plain(
              grid, sly, slx), 1000),
          **timings(torch, "library_", b2_library, 1000),
          "library_call": "four advanced-index reads",
          "bound_ms": b2_bound[0], "bound_by": b2_bound[1]}
    # B2's other widths: an exact widening of the grid (the int8 corners)
    # and the width's whole non-negative range
    b2_widths = []
    for k_w, width in enumerate(WIDTHS):
        gw = width_grid(torch, grid, width, 30 + k_w)
        for g_ in (widened(torch, grid, width), gw):
            got = select4.select4_sq(g_, sly, slx)
            want = select4.select4_sq_plain(g_, sly, slx)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"B2 {width} differs"
        assert torch.equal(select4.select4_sq(widened(torch, grid, width),
                                              sly, slx),
                           select4.select4_sq(grid, sly, slx))
        bd = bound(nbeam * (8 + 4 * gw.element_size() + 16), nbeam * 8)
        b2_widths.append({
            "name": f"select4_sq_{width}", "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/select4.cu",
            "replaces": "iris_lama_tpu/ops/select4.py:36",
            "n": nbeam, "hw": [wm, wm], "dtype": width, "max_abs_err": 0,
            **timings(torch, "", lambda: select4.select4_sq(
                gw, sly, slx), 1000),
            **timings(torch, "plain_", lambda: select4.select4_sq_plain(
                gw, sly, slx), 300),
            **timings(torch, "library_", lambda: (
                gw[y0, x0], gw[y0, x1], gw[y1, x0], gw[y1, x1]), 300),
            "library_call": "four advanced-index reads",
            "bound_ms": bd[0], "bound_by": bd[1]})

    r, cap = cfg.distance.radius_cells, cfg.distance.max_sqdist
    b3_err = 0
    masks = {}
    for dens in (0.0, 0.01, 0.3, 1.0):
        m = b3_mask(torch, dev, (wu, wu), dens)
        got = edt_pallas.edt2d(m, cap, r)
        want = edt_pallas.edt2d_plain(m, cap, r)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        assert torch.equal(got, want), f"B3 density {dens}: err {err}"
        b3_err = max(b3_err, err)
        masks[dens] = m
    m = masks[0.01]
    b3_bound = bound(wu * wu * (1 + 4), wu * wu * 4 * (2 * r + 1))
    b3 = {"name": "edt2d", "route": "cuda",
          "source": "iris_lama_tpu_torch/csrc/edt.cu",
          "replaces": "iris_lama_tpu/ops/edt_pallas.py:25",
          "hw": [wu, wu], "radius": r, "max_abs_err": b3_err,
          "edge_cases": edt_edges(torch, dev, ((),)),
          **timings(torch, "", lambda: edt_pallas.edt2d(m, cap, r), 300),
          **timings(torch, "plain_", lambda: edt_pallas.edt2d_plain(
              m, cap, r), 300),
          "library_ms": None,
          "library_call": "none: no single PyTorch call computes a capped EDT",
          "bound_ms": b3_bound[0], "bound_by": b3_bound[1]}
    # B3 beyond the tile's 64-cell halo: the two-launch kernel, up to
    # R + 1 = 255 and beyond the uint8 |dy|
    big_err, big_cases = 0, 0
    for rr in (65, 100, 254):
        for dens in (0.0, 0.01, 0.3):
            cap_r = min((rr + 1) ** 2 - 1, 32767)
            got = edt_pallas.edt2d(masks[dens], cap_r, rr)
            want = edt_pallas.edt2d_plain(masks[dens], cap_r, rr)
            torch.cuda.synchronize()
            big_err = max(big_err, int((got - want).abs().max()))
            assert torch.equal(got, want), f"B3 R={rr} density {dens}"
            big_cases += 1
    rb, cap_b = 100, 101 * 101 - 1
    bd = bound(wu * wu * (1 + 4), wu * wu * 4 * (2 * rb + 1))
    b3_big = {"name": "edt2d_large_radius", "route": "cuda",
              "source": "iris_lama_tpu_torch/csrc/edt.cu",
              "replaces": "iris_lama_tpu/ops/edt_pallas.py:37",
              "hw": [wu, wu], "radius": rb, "radii_checked": [65, 100, 254],
              "cases": big_cases, "max_abs_err": big_err,
              # its two launches (csrc/edt.cu): the column sweep, a block of
              # 128 threads per 128 columns, then the row min, one per 128
              # columns of each row
              "launch_floor_ms": (
                  launch_floor_ms(torch, dev, -(-wu // 128), 128)
                  + launch_floor_ms(torch, dev, -(-wu // 128) * wu, 128)),
              **timings(torch, "", lambda: edt_pallas.edt2d(m, cap_b, rb),
                        100),
              **timings(torch, "plain_", lambda: edt_pallas.edt2d_plain(
                  m, cap_b, rb), 5),
              "library_ms": None,
              "library_call": "none: no single PyTorch call computes a "
                              "capped EDT",
              "bound_ms": bd[0], "bound_by": bd[1]}
    kernels = [b1, pair, b2, *b2_widths, b3, b3_big]
    for k in kernels:
        emit({"phase": "kernel", **k})

    # 4. prefix: CPU plain versions vs the card ----------------------------
    def run(device, scans):
        slam = Slam2D(opts, device=device)
        slam.set_prior(Pose2D(*data.poses_gt[0]))
        staged = [tuple(torch.as_tensor(a, device=device) for a in p)
                  for p in padded[:scans]]
        acc = slam.update_many_prepadded(staged, data.odometry[:scans])
        return slam, acc

    t0 = time.perf_counter()
    cpu_slam, cpu_acc = run("cpu", PREFIX_SCANS)
    t_cpu = time.perf_counter() - t0
    with MatchRecorder(match_mod) as rec:
        gpu_slam, gpu_acc = run(dev, PREFIX_SCANS)
    torch.cuda.synchronize()
    assert cpu_acc == gpu_acc, "prefix: accepted scans differ"
    tc, tg = cpu_slam.trajectory(), gpu_slam.trajectory()
    dxy = float(np.abs(tc[:, :2] - tg[:, :2]).max())
    dth = float(np.abs(np.angle(np.exp(1j * (tc[:, 2] - tg[:, 2])))).max())
    grids = {}
    for name in ("_res_occ", "_res_vis", "_res_dist"):
        a = getattr(cpu_slam, name).numpy()
        b = getattr(gpu_slam, name).cpu().numpy()
        grids[name[5:]] = int(np.sum(a != b))
    emit({"phase": "prefix", "scans": PREFIX_SCANS, "accepted": len(cpu_acc),
          "cpu_s": t_cpu, "max_dxy_m": dxy, "max_dtheta_rad": dth,
          "org_equal": bool(torch.equal(cpu_slam._res_org,
                                        gpu_slam._res_org.cpu())),
          "differing_cells": grids, "cells": gpu_slam._res_occ.numel()})
    assert dxy <= 1e-3 and dth <= 1e-3, "prefix: trajectories diverge"
    # CPU and GPU sum the normal equations in other orders and round sin/
    # cos differently, so matched poses differ by ulps; a hit that lands
    # within an ulp of a cell boundary then rounds to the neighbour cell and
    # moves its ray. Bit-equality of the map is the CPU tests' teacher-forced
    # check; here a handful of such cells may differ.
    assert sum(grids.values()) <= 1e-3 * gpu_slam._res_occ.numel(), \
        f"prefix: resident grids differ {grids}"
    # B4 on the matches the card's prefix made (one a scan after the first)
    assert len(rec.calls) == len(gpu_acc) - 1, len(rec.calls)
    b4 = b4_slam_entries(torch, dev, rec.calls)
    for k in b4:
        emit({"phase": "kernel", **k})
    kernels += b4

    # 5. the main path on the card ------------------------------------------
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]
    reads0 = host_reads("irls_stop")
    passes = []
    for p in range(bench_reps(3)):
        passes.append(slam_pass(torch, dev, data, opts, staged, p))
    stop_reads = host_reads("irls_stop") - reads0
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    # the kernels of one more pass, rep 0's, untimed (counted_pass)
    dp = devprof()
    acc, launches = counted_pass(
        lambda: fresh(Slam2D, opts, dev, data.poses_gt[0]),
        one_by_one(staged, data.odometry), len(staged),
        {"deposit_pair": dp.DEPOSIT, "select4_sq": dp.SELECT4,
         "edt2d": dp.EDT, "gn_solve_batched_slam2d": dp.GN_SOLVE}, tries=2)
    matched = len(acc) - 1          # the first scan is integrated unmatched
    rates = sorted(p["scans_per_s"] for p in passes)
    emit({"phase": "main_path", "passes": passes,
          "median_scans_per_s": rates[len(rates) // 2],
          "counted_updates": len(acc), "launches": launches,
          "launches_per_scan": {k: v / len(acc)
                                for k, v in launches.items()},
          "irls_stop_reads": stop_reads, "peak_mem_mb": peak_mb})
    for p in passes:
        assert p["ate_m"] < ATE_BOUND_M, f"ATE {p['ate_m']:.4f} m"
        assert p["escaped"] == 0, "updates escaped the resident safe zone"
    # the counted pass did rep 0's work; the map update deposits through
    # the pair; every match is one launch of B4's whole solve (no host read
    # of a stop flag), so no B2
    assert sum(k >= 2 for k in acc) == passes[0]["updates"], \
        (len(acc), passes[0]["updates"])
    assert all(launches[n] > 0 for n in ("deposit_pair", "edt2d")), \
        f"launches {launches}"
    assert launches["gn_solve_batched_slam2d"] == matched, \
        f"launches {launches}, matched updates {matched}"
    assert stop_reads == 0, f"{stop_reads} IRLS stop flags read"
    assert launches["select4_sq"] == 0, f"launches {launches}"

    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
    return kernels


# ---------------------------------------------------------------------------
# 28: the parallel paths on torch.distributed
# ---------------------------------------------------------------------------

PAR_PARTICLES = 512            # bench_pf_scale.py's and dryrun_multichip's
PAR_POOL_UPDATES = 3           # bench_pf_scale.py: 3 updates after the
#                                first (one in the run of every group); the
#                                last with its weights spread (a resample)
PAR_GLOO_WORLD = 4             # ranks that share cuda:0 over gloo
PAR_BIG_NODES = 16384          # dense [3N, 3N] f32 Hessian: 9.7 GB
PAR_BIG_LOOPS = 1024
PAR_PGO_ATOL = 1e-3            # m, GN-CG nodes, raw and aligned: card vs
#                                CPU, world W vs world 1 (sums split
#                                elsewhere)
PAR_RANK_TIMEOUT = 900         # s, one world's ranks
PAR_STEPS = ("plain", "resample", "reorg")


def par_pool_workload(n_updates: int):
    """bench_pf_scale.py's workload (SimConfig(n_steps=4, seed=5), 720
    beams padded to 768, 512 particles, 5 cm, 10 m, capacity 512,
    max_iter 16, ``resident_window=False``), its first ``n_updates``
    updates: (options, padded scans, the draws (eps [N, 3], u) of each
    update from one CPU generator, the odometry increments). Every rank
    builds the same."""
    import torch
    from iris_lama_tpu_torch.algos.pf_slam2d import PFSlam2DOptions
    from iris_lama_tpu_torch.utils import simulator
    from iris_lama_tpu_torch.utils.cloud import beam_bucket, pad_scan

    data = simulator.simulate(simulator.SimConfig(
        n_steps=PAR_POOL_UPDATES + 1, seed=5,
        laser=simulator.LaserSpec(n_beams=720, max_range=10.0)))
    opts = PFSlam2DOptions(particles=PAR_PARTICLES, resolution=0.05,
                           max_range=10.0, capacity=512, max_iter=16,
                           seed=11, resident_window=False)
    gen = torch.Generator().manual_seed(opts.seed)
    draws = [(torch.randn((PAR_PARTICLES, 3), generator=gen),
              torch.rand((), generator=gen)) for _ in range(n_updates)]
    odeltas = [np.asarray((data.odometry[i - 1]
                           - data.odometry[i]).se2_array(), np.float32)
               for i in range(1, n_updates + 1)]
    return opts, [pad_scan(c, beam_bucket(720)) for c in data.clouds], \
        draws, odeltas


def par_resident_setup(torch, dev):
    """__graft_entry__.dryrun_multichip's configuration (512 particles, 0.1
    m, 16-cell patches, 4 m, capacity 1024, max_iter 10,
    resident_extra_patches 2) with tests/test_pf_slam2d.py's sharded
    test's layout: the particles at distinct poses (uniform +-0.9 m and
    +-0.3 rad, seed 11), each with a 512-beam ring of radius 2 m deposited
    at its own pose. Returns (options, scan, particle set, the resample
    draws of the three steps)."""
    from iris_lama_tpu_torch.algos import pf_slam2d as pf_mod
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.sdm import mapping

    n = PAR_PARTICLES
    opts = pf_mod.PFSlam2DOptions(particles=n, resolution=0.1,
                                  patch_size=16, max_range=4.0,
                                  capacity=1024, max_iter=10,
                                  resident_extra_patches=2, seed=7)
    ang = np.linspace(-np.pi, np.pi, 512, endpoint=False)
    pts = np.stack([2.0 * np.cos(ang), 2.0 * np.sin(ang),
                    np.zeros(512)], -1).astype(np.float32)
    scan = (torch.as_tensor(pts, device=dev),
            torch.ones(512, dtype=torch.bool, device=dev),
            torch.zeros(3, device=dev))
    rng = np.random.default_rng(11)
    xyr = np.stack([rng.uniform(-0.9, 0.9, n) + 0.013,
                    rng.uniform(-0.9, 0.9, n) + 0.017,
                    rng.uniform(-0.3, 0.3, n)], -1)
    ps = pf_mod.particles_init(opts, np.array([0, 0, 1, 0], np.float32), dev)
    ps = ps._replace(pose=torch.as_tensor(
        np.asarray([Pose2D(*p).se2_array() for p in xyr], np.float32),
        device=dev))
    cfg = opts.mapping_config()
    mapping.resident_update(cfg, ps.res_org, ps.res_occ, ps.res_vis,
                            ps.res_dist, ps.pose, *scan)
    gen = torch.Generator().manual_seed(opts.seed)
    us = [torch.rand((), generator=gen).to(dev) for _ in PAR_STEPS]
    return opts, scan, ps, us


def par_resident_prepare(torch, opts, ps, step: str, sl):
    """The JAX sharded test's set-up of a step on rows ``sl`` of the set
    (the pool path's last update takes ``resample`` too):
    ``resample`` spreads the weights (exp(gain * spread) from 1 to e^-7:
    Neff < N/2), ``reorg`` moves every pose 20 m (out of the safe zone)."""
    from iris_lama_tpu_torch.core import lie
    if step == "resample":
        n = opts.particles
        gain = 1.0 / (opts.meas_sigma_gain * n)
        spread = (torch.arange(n, dtype=torch.float32,
                               device=ps.pose.device)
                  * np.float32(7.0 / (gain * (n - 1))))[sl]
        return ps._replace(weight=spread.clone(), weight_sum=spread.clone())
    if step == "reorg":
        shift = lie.se2(torch.tensor(20.0), torch.tensor(0.0),
                        torch.tensor(0.0), device=ps.pose.device)
        return ps._replace(pose=lie.se2_compose(ps.pose, shift.expand_as(
            ps.pose)))
    return ps


class IdxRecorder:
    """Records the resample indices of every ``weights_and_resample`` call
    while active (the module function is wrapped, and restored on exit)."""

    def __init__(self, pf_mod):
        self.mod, self.idx = pf_mod, []

    def __enter__(self):
        self.orig = self.mod.weights_and_resample

        def rec(*a, **kw):
            out = self.orig(*a, **kw)
            self.idx.append(out[0].cpu())
            return out

        self.mod.weights_and_resample = rec
        return self

    def __exit__(self, *exc):
        self.mod.weights_and_resample = self.orig


def par_named(ps) -> dict:
    """The particle set's pools (and resident grids) by name."""
    d = {f"table_{f}": getattr(ps.maps.table, f)
         for f in ps.maps.table._fields}
    d.update(occupied=ps.maps.occupied, visited=ps.maps.visited,
             dist=ps.maps.dist)
    if ps.res_org is not None:
        d.update(res_occ=ps.res_occ, res_vis=ps.res_vis,
                 res_dist=ps.res_dist, lineage=ps.lineage)
    return d


def par_diff(torch, got: dict, ref: dict, sl) -> dict:
    """Differing cells of each of this rank's arrays against its rows of
    the reference (a CPU tensor each, read from the memory-mapped file)."""
    return {k: int((t != ref[k][sl].to(t.device)).sum())
            for k, t in got.items()}


def par_pgo_problems():
    """bench_pgo.py's 512-node graph and a 16,384-node one built alike
    (1,024 Huber loop closures)."""
    return {"pgo_512": pgo_graph(),
            "pgo_16384": pgo_graph(PAR_BIG_NODES, loops=PAR_BIG_LOOPS)}


def par_align_diff(a, b) -> tuple:
    """(max raw xy difference, max after the rigid SE(2) alignment of ``a``
    onto ``b``) of two node arrays [N, 4]."""
    from iris_lama_tpu_torch.utils.evaluation import align_se2

    def xyr(x):
        x = np.asarray(x, np.float64)
        return np.stack([x[:, 0], x[:, 1], np.arctan2(x[:, 3], x[:, 2])], -1)

    xa, xb = xyr(a), xyr(b)
    return (float(np.abs(xa[:, :2] - xb[:, :2]).max()),
            float(np.abs(align_se2(xa, xb) - xb[:, :2]).max()))


def parallel_rank(r, world, spec):
    """One rank of phase 28: the four parts on this rank's share, each
    part's launches counted on the profiler's trace, every result compared
    on the rank against the unsharded reference the parent wrote (a
    memory-mapped file). Returns host values."""
    import torch
    import torch.distributed as dist
    from iris_lama_tpu_torch.algos import graph_slam2d as gmod
    from iris_lama_tpu_torch.algos import pf_slam2d as pf_mod
    from iris_lama_tpu_torch.nlls import factor_graph as fg
    from iris_lama_tpu_torch.parallel import distributed_pgo as dpgo
    from iris_lama_tpu_torch.parallel import group as G
    from iris_lama_tpu_torch.parallel import pf_sharding
    from iris_lama_tpu_torch.utils import state as state_mod

    dev = torch.device(spec["devices"][r])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    mesh = pf_sharding.particle_mesh()
    ref = torch.load(spec["ref"], mmap=True, weights_only=False)
    dp = devprof()
    kernels = {"deposit_pair": dp.DEPOSIT, "edt2d": dp.EDT,
               "gn_batch_solve": dp.GN_SOLVE}
    out, part_s = {}, {}
    n_up = spec["pool_updates"]

    def timed(fn):
        """``fn()`` and its seconds, between two barriers."""
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn()
        sync()
        dist.barrier()
        return res, time.perf_counter() - t0

    def counted(fn):
        """``fn()`` and its kernels' launches, counted on the profiler's
        trace: a call made again for them, untimed."""
        return dp.launches_by_name(fn, kernels)

    # 1. the PF pool path at bench_pf_scale.py's size
    t_part = time.perf_counter()
    opts, padded, draws, odeltas = par_pool_workload(n_up)
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]
    full = pf_mod.particles_init(opts, np.array([0, 0, 1, 0], np.float32),
                                 dev)
    pf_mod.first_step(opts, full, *staged[0])
    sl = G.rows(opts.particles, mesh)
    motion = pf_sharding.make_sharded_motion(opts, mesh)
    update = pf_sharding.make_sharded_update(opts, mesh)
    infos, poses, weights = [], [], []

    def pool_updates(ps, record=True):
        for k in range(n_up):
            eps, u = draws[k]
            ps = ps._replace(pose=motion(ps.pose, eps.to(dev),
                                         torch.as_tensor(odeltas[k],
                                                         device=dev)))
            if k == n_up - 1:
                ps = par_resident_prepare(torch, opts, ps, "resample", sl)
            ps, info = update(ps, u.to(dev), *staged[k + 1])
            if record:
                poses.append(ps.pose.cpu())
                weights.append(ps.weight.cpu())
                infos.append({"exchange_bytes": info["exchange_bytes"],
                              "resampled": bool(info["resampled"]),
                              "neff": float(info["neff"])})
        return ps

    ps = pf_sharding.shard_particles(full, mesh)
    with IdxRecorder(pf_mod) as rec:
        ps, dt = timed(lambda: pool_updates(ps))
    # the same updates again from the same start, for their launches
    _, launches = counted(lambda: pool_updates(
        pf_sharding.shard_particles(full, mesh), record=False))
    del full
    rp = ref["pool"]
    out["pool"] = {
        "seconds": dt, "updates": n_up, "infos": infos,
        "launches": launches,
        "idx_equal": [torch.equal(a, b) for a, b in zip(rec.idx, rp["idx"])],
        "pose_equal": [torch.equal(a, b[sl]) for a, b in
                       zip(poses, rp["pose"])],
        "weight_equal": [torch.equal(a, b[sl]) for a, b in
                         zip(weights, rp["weight"])],
        "differing_cells": par_diff(torch, par_named(ps), rp["final"], sl),
        "cells": {k: int(t.numel()) for k, t in par_named(ps).items()}}
    del ps, staged, update, motion
    part_s["pool"] = time.perf_counter() - t_part

    # 2. the PF resident path at dryrun_multichip's size, the JAX sharded
    # test's three steps
    t_part = time.perf_counter()
    opts, scan, full, us = par_resident_setup(torch, dev)
    sl = G.rows(opts.particles, mesh)
    ps = pf_sharding.shard_particles(full, mesh)
    update = pf_sharding.make_sharded_update(opts, mesh)
    rr, steps = ref["resident"], []
    with IdxRecorder(pf_mod) as rec:
        for k, name in enumerate(PAR_STEPS):
            ps = par_resident_prepare(torch, opts, ps, name, sl)
            (ps, info), dt = timed(lambda: update(ps, us[k], *scan))
            steps.append({
                "step": name, "seconds": dt,
                "resampled": bool(info["resampled"]),
                "reorged": bool(info["reorged"]),
                "escaped": int(info["escaped"]),
                "exchange_bytes": info["exchange_bytes"],
                "pose_equal": torch.equal(ps.pose.cpu(),
                                          rr["pose"][k][sl]),
                "weight_equal": torch.equal(ps.weight.cpu(),
                                            rr["weight"][k][sl])})
    # the same steps again from the same start, each update's launches
    launches, again = dict.fromkeys(kernels, 0), \
        pf_sharding.shard_particles(full, mesh)
    del full
    for k, name in enumerate(PAR_STEPS):
        again = par_resident_prepare(torch, opts, again, name, sl)
        (again, _), n = counted(lambda: update(again, us[k], *scan))
        launches = {c: launches[c] + n[c] for c in kernels}
    del again
    out["resident"] = {
        "steps": steps, "launches": launches,
        "idx_equal": [torch.equal(a, b) for a, b in zip(rec.idx, rr["idx"])],
        "res_org_equal": torch.equal(ps.res_org.cpu(), rr["res_org"]),
        "differing_cells": par_diff(torch, par_named(ps), rr["final"], sl)}
    del ps, update
    part_s["resident"] = time.perf_counter() - t_part

    # 3. distributed PGO: the factors over the ranks (the graphs from the
    # reference file)
    t_part = time.perf_counter()
    out["pgo"] = {}
    for name, (nodes, graph, active) in ref["pgo"].items():
        if name not in spec["pgo_graphs"]:
            continue
        graph = dpgo.shard_graph(fg.SE2Graph(*(a.to(dev) for a in graph)),
                                 mesh)
        args = (nodes.to(dev), graph, active.to(dev))
        (res, info), dt = timed(
            lambda: dpgo.optimize_distributed(*args, mesh=mesh))
        out["pgo"][name] = {"nodes": res.cpu().numpy(), "seconds": dt,
                            "chi2_history": info["chi2_history"].cpu()
                            .numpy()}

    part_s["pgo"] = time.perf_counter() - t_part

    # 4. GraphSlam2D's rebuild through generate_occupancy_map(mesh=...)
    t_part = time.perf_counter()
    gspec = ref["rebuild"]
    gs = gmod.GraphSlam2D(spec["graph_options"], device=dev)
    gs.update_prepadded(*(torch.as_tensor(a, device=dev)
                          for a in gspec["first_scan"]),
                        gspec["first_odometry"])
    state_mod.graph_from_numpy(gs, gspec["state"])
    m, dt = timed(lambda: gs.generate_occupancy_map(mesh=mesh))
    _, launches = counted(lambda: gs.generate_occupancy_map(mesh=mesh))
    got = state_mod.map_to_numpy(m)
    out["rebuild"] = {
        "seconds": dt, "launches": launches,
        "differing_cells": {k: int((a != gspec["map"][k]).sum())
                            for k, a in got.items()},
        "same_keys": set(got) == set(gspec["map"])}
    part_s["rebuild"] = time.perf_counter() - t_part
    out["part_s"] = part_s
    return out


def par_unsharded_step(torch, pf_mod, opts, ps, u, scan):
    """The unsharded resident update with the JAX package's in-step
    re-org: ``reorg`` when a particle left the safe zone, then
    ``update_step``. Returns (pset, info, reorged)."""
    from iris_lama_tpu_torch.sdm import mapping
    cfg = opts.mapping_config()
    safe = bool(torch.all(mapping.resident_safe(
        cfg, ps.res_org, cfg.geometry.w2m(ps.pose[:, :2]))))
    if not safe:
        ps = pf_mod.reorg(opts, ps)
    ps, info = pf_mod.update_step(opts, ps, u, *scan)
    return ps, info, not safe


def par_b6_entry(torch, dev, name, args, kw, source_line) -> dict:
    """A kernels-line entry of B6 at a rank's share, checked bit-equal."""
    from iris_lama_tpu_torch.ops import gn_batch
    got = gn_batch.solve_window_sq(*args, **kw)
    want = gn_batch.solve_window_sq_plain(*args, **kw)
    torch.cuda.synchronize()
    for k, a, w in zip(("state", "iterations", "chi2", "sum_d2"), got, want):
        assert torch.equal(a, w), f"B6 {name}: {k} differs"
    grids = args[0]
    n_p, b = grids.shape[0], args[3].shape[0]
    it = got[1]
    evals = int(it.sum()) + 2 * n_p
    win_bytes = b6_window_bytes(torch, grids, args[1], args[2], got[0],
                                args[3], args[4], kw)
    bd = bound(win_bytes + n_p * (8 + 16 + 32) + b * 9, 60 * b * evals)
    return {"name": name, "route": "cuda",
            "source": "iris_lama_tpu_torch/csrc/gn_solve.cu",
            "replaces": source_line,
            "shape": [n_p, grids.shape[1], grids.shape[2], b],
            "dtype": str(grids.dtype).replace("torch.", ""),
            "max_abs_err": 0.0, "iters_max": int(it.max()),
            "iters_mean": float(it.float().mean()),
            "window_bytes_read": win_bytes,
            "window_bytes": grids.numel() * grids.element_size(),
            "launch_floor_ms": b5_floor_ms(torch, dev, n_p, b),
            **timings(torch, "", lambda: gn_batch.solve_window_sq(
                *args, **kw), 50),
            **timings(torch, "plain_", lambda: gn_batch.solve_window_sq_plain(
                *args, **kw), 3),
            "library_ms": None,
            "library_call": "none: no single PyTorch call computes an IRLS "
                            "solve",
            "bound_ms": bd[0], "bound_by": bd[1]}


def par_pair_entry(torch, dev, name, hit, free, h, w, source_line,
                   **extra) -> dict:
    """B1's pair at a rank's share, checked bit-equal ([P, n] streams, or
    one grid pair from [n] streams)."""
    from iris_lama_tpu_torch.ops import scatter_matmul
    got = scatter_matmul.deposit_pair(*hit, *free, h, w)
    want = scatter_matmul.deposit_pair_plain(*hit, *free, h, w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want)), \
        f"B1 pair {name}: differs"
    p = hit[0].shape[0] if hit[0].dim() == 2 else 1
    n_hit, n_free = hit[0].shape[-1], free[0].shape[-1]
    lead = (lambda t: t) if hit[0].dim() == 2 else (lambda t: t[None])
    blocks = scatter_matmul.launch_blocks(p, [n_hit, n_free])
    return kernel_entry(
        torch, name, source_line,
        lambda: scatter_matmul.deposit_pair(*hit, *free, h, w),
        lambda: scatter_matmul.deposit_pair_plain(*hit, *free, h, w),
        p * ((n_hit + n_free) * 8 + 2 * h * w * 4), p * (2 * n_hit + n_free),
        library=deposit_library(torch, dev, [
            (lead(hit[0]), lead(hit[1]), (0, 1)),
            (lead(free[0]), lead(free[1]), (1,))], p, h, w),
        library_call="zeros + index_put_(accumulate=True) over both grids' "
                     "bins", reps=100, library_reps=3,
        shape=[p, n_hit, n_free, h, w], max_abs_err=0,
        launch_floor_ms=memset_floor_ms(torch, dev, 2 * p * h * w * 4,
                                        blocks, 256), **extra)


def par_edt_entry(torch, dev, name, obst, cap, r, **extra) -> dict:
    """B3 at a rank's share, checked bit-equal."""
    from iris_lama_tpu_torch.ops import edt_pallas
    got = edt_pallas.edt2d(obst, cap, r)
    want = edt_pallas.edt2d_plain(obst, cap, r)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"B3 {name}: differs"
    h, w = obst.shape[-2:]
    p = obst.numel() // (h * w)
    return kernel_entry(
        torch, name, "iris_lama_tpu/ops/edt_pallas.py:25",
        lambda: edt_pallas.edt2d(obst, cap, r),
        lambda: edt_pallas.edt2d_plain(obst, cap, r),
        obst.numel() * (1 + 4), obst.numel() * 4 * (2 * r + 1),
        library_call="none: no single PyTorch call computes a capped EDT",
        reps=100, shape=list(obst.shape), radius=r, max_abs_err=0,
        obstacle_share=float(obst.float().mean()),
        launch_floor_ms=launch_floor_ms(
            torch, dev, p * -(-w // 64) * -(-h // 32), 256), **extra)


def parallel_phase(torch, dev, tmp: str) -> tuple:
    """Phase 28: the parallel paths (parallel/{pf_sharding,
    distributed_pgo, map_rebuild}.py) through spawned ranks of one process
    group, at world 1 over NCCL and at world 4 over gloo with every rank on
    cuda:0 (gloo moves the collectives' bytes through the host); at world
    4 over NCCL too, one rank a card, when the machine has four cards.

    The parent first runs each part unsharded on the card (the reference,
    written to one file the ranks memory-map) and checks B1, B3 and B6
    bit-equal to their plain versions at a rank's share of the world-4
    shapes, with times and bounds. Each rank then runs the four parts,
    each part's launch counts set to 0 just before and read just after, and
    compares its rows with the reference: 1. the PF pool path at
    bench_pf_scale.py's size (updates/s, bytes the row exchanges moved,
    resample indices, poses and weights bit-equal, pools cell by cell); 2.
    the PF resident path at dryrun_multichip's size through the JAX
    sharded test's three steps (plain, forced resample, forced re-org); 3.
    GN-CG on bench_pgo.py's graph and on 16,384 nodes (world W against
    world 1 and the card against the CPU within PAR_PGO_ATOL, raw and
    after a rigid alignment, finite nodes, non-increasing chi2); 4. bench_graph.py's
    rebuild through ``generate_occupancy_map(mesh=...)``, bit-equal.
    Returns (the kernels-line entries of the new shapes, path_launches of
    the earlier entries)."""
    import dataclasses
    from iris_lama_tpu_torch.algos import graph_slam2d as gmod
    from iris_lama_tpu_torch.algos import pf_slam2d as pf_mod
    from iris_lama_tpu_torch.core.pose import Pose2D
    from iris_lama_tpu_torch.nlls import factor_graph as fg
    from iris_lama_tpu_torch.parallel import distributed_pgo as dpgo
    from iris_lama_tpu_torch.parallel import group as G
    from iris_lama_tpu_torch.parallel import map_rebuild
    from iris_lama_tpu_torch.sdm import mapping
    from iris_lama_tpu_torch.utils import state as state_mod

    n_rank = PAR_PARTICLES // PAR_GLOO_WORLD
    n_up = bench_reps(PAR_POOL_UPDATES)
    ref, entries, unsharded, ref_s = {}, [], {}, {}

    # 1. the pool path, unsharded
    t_part = time.perf_counter()
    opts, padded, draws, odeltas = par_pool_workload(n_up)
    staged = [tuple(torch.as_tensor(a, device=dev) for a in p)
              for p in padded]
    ps = pf_mod.particles_init(opts, np.array([0, 0, 1, 0], np.float32),
                               dev)
    pf_mod.first_step(opts, ps, *staged[0])
    poses, weights, secs, b6_args = [], [], 0.0, None
    with IdxRecorder(pf_mod) as rec:
        for k in range(n_up):
            eps, u = draws[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps = ps._replace(pose=pf_mod.draw_from_motion(
                opts, eps.to(dev), torch.as_tensor(odeltas[k], device=dev),
                ps.pose))
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            if k == 0:     # B6's inputs at a rank's share
                g_, o_ = pf_mod.pool_windows(opts, ps.maps,
                                             ps.pose[:n_rank])
                b6_args = (g_, o_, ps.pose[:n_rank].contiguous(),
                           staged[1][0][:, :2].contiguous(), staged[1][1])
            if k == n_up - 1:
                ps = par_resident_prepare(torch, opts, ps, "resample",
                                          slice(None))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps, info = pf_mod.pool_update_step(opts, ps, u.to(dev),
                                               *staged[k + 1])
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            poses.append(ps.pose.cpu())
            weights.append(ps.weight.cpu())
    unsharded["pool_updates_per_s"] = n_up / secs
    unsharded["pool_resampled"] = [
        not torch.equal(i, torch.arange(PAR_PARTICLES)) for i in rec.idx]
    assert unsharded["pool_resampled"][-1], "pool: no forced resample"
    ref["pool"] = {"idx": rec.idx, "pose": poses, "weight": weights,
                   "final": {k: t.cpu() for k, t in par_named(ps).items()}}
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in par_named(ps).values())
    cfg = opts.mapping_config()
    sopts = opts.solver_options()
    b6_kw = dict(max_dist=cfg.distance.max_dist, res=cfg.geometry.resolution,
                 scale=cfg.geometry.scale,
                 cell_offset=cfg.geometry.cell_offset,
                 cauchy_c=sopts.robust.param, eps1=sopts.eps1,
                 eps2=sopts.eps2, max_iter=sopts.max_iterations,
                 want_lik=True)
    entries.append(par_b6_entry(torch, dev, "gn_batch_solve_pool_rank",
                                b6_args, b6_kw,
                                "iris_lama_tpu/ops/gn_batch.py:108"))
    pool_shape = [PAR_PARTICLES, *b6_args[0].shape[1:]]
    del ps, staged, b6_args, g_, o_
    torch.cuda.empty_cache()
    ref_s["pool"] = time.perf_counter() - t_part

    # 2. the resident path, unsharded: plain, forced resample, forced re-org
    t_part = time.perf_counter()
    opts_r, scan, ps, us = par_resident_setup(torch, dev)
    cfg_r = opts_r.mapping_config()
    res_steps, poses, weights = [], [], []
    with IdxRecorder(pf_mod) as rec:
        for k, name in enumerate(PAR_STEPS):
            ps = par_resident_prepare(torch, opts_r, ps, name, slice(None))
            if k == 0:     # B6, B1's pair and B3 at a rank's share
                pose = ps.pose[:n_rank].contiguous()
                grids, orgs = pf_mod.match_windows(
                    opts_r, ps.res_org, ps.res_dist[:n_rank], pose)
                so = opts_r.solver_options()
                geo = cfg_r.geometry
                kw = dict(max_dist=cfg_r.distance.max_dist,
                          res=geo.resolution, scale=geo.scale,
                          cell_offset=geo.cell_offset,
                          cauchy_c=so.robust.param, eps1=so.eps1,
                          eps2=so.eps2, max_iter=so.max_iterations,
                          want_lik=True)
                entries.append(par_b6_entry(
                    torch, dev, "gn_batch_solve_resident_rank",
                    (grids, orgs, pose, scan[0][:, :2].contiguous(),
                     scan[1]), kw, "iris_lama_tpu/ops/gn_batch.py:108"))
                wu, w_res = cfg_r.resident_update_cells, \
                    cfg_r.resident_window_cells
                start = torch.clamp(geo.w2m(pose[:, :2]) - ps.res_org
                                    - wu // 2, 0, w_res - wu)
                idx = mapping.deposit_indices(cfg_r, pose, *scan,
                                              ps.res_org + start, wu)
                entries.append(par_pair_entry(
                    torch, dev, "deposit_pair_resident_rank",
                    (idx.hit_ly, idx.hit_lx), (idx.free_ly, idx.free_lx),
                    wu, wu, "iris_lama_tpu/ops/scatter_matmul.py:228"))
                obst = mapping.dyn_slice(ps.res_dist[:n_rank], start[:, 1],
                                         start[:, 0], wu, wu) == 0
                entries.append(par_edt_entry(
                    torch, dev, "edt2d_resident_rank", obst,
                    cfg_r.distance.max_sqdist, cfg_r.distance.radius_cells))
                del grids, orgs, idx, obst
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps, info, reorged = par_unsharded_step(torch, pf_mod, opts_r,
                                                   ps, us[k], scan)
            torch.cuda.synchronize()
            res_steps.append({"step": name,
                              "seconds": time.perf_counter() - t0,
                              "resampled": bool(info["resampled"]),
                              "reorged": reorged,
                              "escaped": int(info["escaped"])})
            poses.append(ps.pose.cpu())
            weights.append(ps.weight.cpu())
    unsharded["resident_steps"] = res_steps
    assert res_steps[1]["resampled"], f"resident: no resample {res_steps}"
    assert [s["reorged"] for s in res_steps] == [False, False, True], \
        f"resident: re-orgs {res_steps}"
    ref["resident"] = {"idx": rec.idx, "pose": poses, "weight": weights,
                       "res_org": ps.res_org.cpu(),
                       "final": {k: t.cpu() for k, t in
                                 par_named(ps).items()}}
    res_shape = list(ps.res_occ.shape)
    del ps, scan
    torch.cuda.empty_cache()
    ref_s["resident"] = time.perf_counter() - t_part

    # 3. GN-CG unsharded: bench_pgo.py's graph on the CPU and on the card,
    # the 16,384-node graph on the card; the dense LM beside
    t_part = time.perf_counter()
    problems = par_pgo_problems()
    ref["pgo"] = {name: (torch.as_tensor(nodes), b.finalize("cpu"),
                         torch.as_tensor(active))
                  for name, (b, nodes, active, _) in problems.items()}
    pgo_ref = {}
    for name, (b, nodes, active, true) in problems.items():
        devs = ("cpu", dev) if name == "pgo_512" else (dev,)
        for d in devs:
            args = (torch.as_tensor(nodes, device=d), b.finalize(d),
                    torch.as_tensor(active, device=d))
            dpgo.optimize_distributed(*args)      # warm-up
            if d != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, info = dpgo.optimize_distributed(*args)
            if d != "cpu":
                torch.cuda.synchronize()
            pgo_ref[(name, str(d))] = (res.cpu().numpy(),
                                       info["chi2_history"].cpu().numpy(),
                                       time.perf_counter() - t0)
    b, nodes, active, true = problems["pgo_512"]
    dense, _ = fg.optimize(torch.as_tensor(nodes, device=dev),
                           b.finalize(dev),
                           torch.as_tensor(active, device=dev))
    dense = dense.cpu().numpy()
    ref_s["pgo"] = time.perf_counter() - t_part

    def mean_err(x, true_):
        return float(np.mean([np.linalg.norm(x[i, :2] - true_[i].xy())
                              for i in range(0, len(true_), 16)]))

    # 4. the rebuild, unsharded, after one pass of bench_graph.py's workload
    t_part = time.perf_counter()
    data, gopts, padded_g = graph_workload()
    staged_g = [tuple(torch.as_tensor(a, device=dev) for a in p)
                for p in padded_g]
    gs = gmod.GraphSlam2D(gopts, device=dev)
    gs.set_prior(Pose2D(*data.poses_gt[0]))
    gs.update_many_prepadded(staged_g, data.odometry,
                             timestamps=[float(k) for k in
                                         range(len(staged_g))])
    kps = gs.key_poses
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = gs.generate_occupancy_map()
    torch.cuda.synchronize()
    unsharded["rebuild_s"] = time.perf_counter() - t0
    ref["rebuild"] = {"state": state_mod.graph_to_numpy(gs),
                      "map": state_mod.map_to_numpy(want),
                      "first_scan": padded_g[0],
                      "first_odometry": data.odometry[0]}
    # B1's pair over a rank's scans and B3 on a middle rank's strip with
    # its halos, at world 4
    rcfg = dataclasses.replace(gs.slam.cfg, capacity=4 * gs.slam.cfg.capacity)
    kp_poses = np.asarray([kp.pose.se2_array() for kp in kps], np.float32)
    org, h, w = map_rebuild.grid_bounds(rcfg, rcfg.geometry, kp_poses)
    org_t = torch.as_tensor(org, dtype=torch.int32, device=dev)
    k_rank = -(-len(kps) // PAR_GLOO_WORLD)
    (hy, hx), (fy, fx) = map_rebuild._scan_cells(
        rcfg, torch.as_tensor(kp_poses[:k_rank], device=dev),
        torch.stack([kp.points for kp in kps[:k_rank]]),
        torch.stack([kp.mask for kp in kps[:k_rank]]),
        torch.stack([kp.origin for kp in kps[:k_rank]]), org_t, h, w)
    entries.append(par_pair_entry(
        torch, dev, "deposit_pair_rebuild_rank", (hy, hx), (fy, fx), h, w,
        "iris_lama_tpu/ops/scatter_matmul.py:81", key_poses=k_rank))
    occ, vis = map_rebuild.rasterize_scans(
        rcfg, torch.as_tensor(kp_poses, device=dev),
        torch.stack([kp.points for kp in kps]),
        torch.stack([kp.mask for kp in kps]),
        torch.stack([kp.origin for kp in kps]), org_t, h, w)
    rad = rcfg.distance.radius_cells
    hs = -(-h // PAR_GLOO_WORLD)
    strip = ((4 * occ) > vis)[hs - rad:2 * hs + rad].contiguous()
    entries.append(par_edt_entry(torch, dev, "edt2d_rebuild_strip", strip,
                                 rcfg.distance.max_sqdist, rad))
    del gs, staged_g, want, hy, hx, fy, fx, occ, vis, strip
    torch.cuda.empty_cache()
    ref_s["rebuild"] = time.perf_counter() - t_part
    for kern in entries:
        emit({"phase": "parallel_kernel", **kern})

    path = os.path.join(tmp, "parallel_ref.pt")
    t0 = time.perf_counter()
    torch.save(ref, path)
    ref_write_s = time.perf_counter() - t0
    del ref
    spec = {"ref": path, "graph_options": gopts, "pool_updates": n_up}
    worlds = [(1, "nccl"), (PAR_GLOO_WORLD, "gloo")]
    if torch.cuda.device_count() >= 4:
        worlds.append((4, "nccl"))
    results = {}
    for world, backend in worlds:
        devices = ([f"cuda:{r}" for r in range(world)] if backend == "nccl"
                   else [str(dev)] * world)
        # the run of every group: GN-CG over gloo on bench_pgo.py's graph
        pgo_graphs = [k for k in problems if not (
            _ONE_REP[0] and backend == "gloo" and k != "pgo_512")]
        t0 = time.perf_counter()
        res = G.run_ranks(parallel_rank, world, backend,
                          timeout=PAR_RANK_TIMEOUT,
                          args=({**spec, "devices": devices,
                                 "pgo_graphs": pgo_graphs},))
        results[(world, backend)] = (res, time.perf_counter() - t0)

    # what every world showed
    launches = {}
    for (world, backend), (res, wall) in results.items():
        tag = f"world {world} {backend}"
        pool = [r_["pool"] for r_ in res]
        resd = [r_["resident"] for r_ in res]
        reb = [r_["rebuild"] for r_ in res]
        counts = {part: {k: sum(r_[part]["launches"][k] for r_ in res)
                         for k in res[0][part]["launches"]}
                  for part in ("pool", "resident", "rebuild")}
        launches[(world, backend)] = counts
        pool_diff = {k: sum(p["differing_cells"][k] for p in pool)
                     for k in pool[0]["differing_cells"]}
        emit({"phase": "parallel_pf_pool", "world": world,
              "backend": backend, "particles": PAR_PARTICLES,
              "updates": n_up,
              "updates_per_s": n_up / pool[0]["seconds"],
              "unsharded_updates_per_s": unsharded["pool_updates_per_s"],
              "exchange_bytes_per_update": [i["exchange_bytes"]
                                            for i in pool[0]["infos"]],
              "resampled": [i["resampled"] for i in pool[0]["infos"]],
              "neff": [i["neff"] for i in pool[0]["infos"]],
              "pool_bytes": pool_bytes, "pool_shape": pool_shape,
              "idx_equal": all(all(p["idx_equal"]) for p in pool),
              "pose_equal": all(all(p["pose_equal"]) for p in pool),
              "weight_equal": all(all(p["weight_equal"]) for p in pool),
              "differing_cells": pool_diff, "launches": counts["pool"],
              "world_wall_s": wall})
        assert all(len(p["idx_equal"]) == n_up for p in pool)
        assert pool[0]["infos"][-1]["resampled"] and (
            world == 1 or pool[0]["infos"][-1]["exchange_bytes"] > 0), \
            f"{tag}: the pool's forced resample moved nothing"
        assert all(all(p["idx_equal"]) for p in pool), \
            f"{tag}: pool resample indices differ"
        assert all(all(p["pose_equal"] + p["weight_equal"]) for p in pool), \
            f"{tag}: pool poses or weights differ"
        assert sum(pool_diff.values()) == 0, f"{tag}: pools {pool_diff}"
        res_diff = {k: sum(p["differing_cells"][k] for p in resd)
                    for k in resd[0]["differing_cells"]}
        emit({"phase": "parallel_pf_resident", "world": world,
              "backend": backend, "particles": PAR_PARTICLES,
              "grids": res_shape, "steps": resd[0]["steps"],
              "unsharded_steps": unsharded["resident_steps"],
              "idx_equal": all(all(p["idx_equal"]) for p in resd),
              "res_org_equal": all(p["res_org_equal"] for p in resd),
              "differing_cells": res_diff, "launches": counts["resident"]})
        for k, s in enumerate(resd[0]["steps"]):
            u_ = unsharded["resident_steps"][k]
            assert (s["resampled"], s["reorged"], s["escaped"]) == (
                u_["resampled"], u_["reorged"], u_["escaped"]), \
                f"{tag}: resident step {s['step']} decisions"
        assert all(s["pose_equal"] and s["weight_equal"]
                   for p in resd for s in p["steps"]), \
            f"{tag}: resident poses or weights differ"
        assert all(all(p["idx_equal"]) and p["res_org_equal"]
                   for p in resd), f"{tag}: resident indices or origin"
        assert sum(res_diff.values()) == 0, f"{tag}: resident {res_diff}"
        reb_diff = {k: sum(p["differing_cells"][k] for p in reb)
                    for k in reb[0]["differing_cells"]}
        emit({"phase": "parallel_rebuild", "world": world,
              "backend": backend, "key_poses": len(kps), "grid": [h, w],
              "radius": rad, "seconds": reb[0]["seconds"],
              "unsharded_s": unsharded["rebuild_s"],
              "differing_cells": reb_diff, "launches": counts["rebuild"]})
        assert all(p["same_keys"] for p in reb)
        assert sum(reb_diff.values()) == 0, f"{tag}: rebuild {reb_diff}"
        for part, c in counts.items():
            need = ("deposit_pair", "edt2d") + (
                ("gn_batch_solve",) if part != "rebuild" else ())
            assert all(c[k] > 0 for k in need), f"{tag} {part}: {c}"

    # GN-CG: card against CPU, world W against world 1
    one = results[(1, "nccl")][0][0]["pgo"]
    for name, (b, nodes, active, true) in problems.items():
        n = len(true)
        card = pgo_ref[(name, str(dev))]
        line = {"phase": "parallel_pgo", "graph": name, "nodes": n,
                "factors": len(b.betweens) + len(b.priors),
                "dense_hessian_gb": (3 * len(nodes)) ** 2 * 4 / 1e9,
                "unsharded_card_s": card[2],
                "mean_err_m": mean_err(card[0], true),
                "chi2_history_card": card[1].tolist()}
        if name == "pgo_512":
            cpu = pgo_ref[(name, "cpu")]
            line.update(cpu_s=cpu[2], dense_lm_mean_err_m=mean_err(
                dense, true),
                card_vs_cpu_m=par_align_diff(card[0][:n], cpu[0][:n]))
            assert max(line["card_vs_cpu_m"]) <= PAR_PGO_ATOL, line
        for (world, backend), (res, _) in results.items():
            if name not in res[0]["pgo"]:
                continue
            got = res[0]["pgo"][name]
            key = f"world{world}_{backend}"
            line[f"{key}_s"] = got["seconds"]
            line[f"{key}_vs_world1_m"] = par_align_diff(
                got["nodes"][:n], one[name]["nodes"][:n])
            line[f"{key}_vs_unsharded_m"] = par_align_diff(
                got["nodes"][:n], card[0][:n])
            line[f"{key}_chi2_history"] = got["chi2_history"].tolist()
            hist = got["chi2_history"]
            assert np.isfinite(got["nodes"]).all(), (key, name)
            assert (np.diff(hist) <= 0).all(), (key, name, hist)
            # raw and after the rigid alignment: a lost prior or a rigid
            # drift shows in the raw difference
            assert max(line[f"{key}_vs_world1_m"]) <= PAR_PGO_ATOL, line
            assert max(line[f"{key}_vs_unsharded_m"]) <= PAR_PGO_ATOL, line
        emit(line)
    emit({"phase": "parallel", "worlds": [list(k) for k in results],
          "pool_updates": n_up, "reference_part_s": ref_s,
          "rank0_part_s": {f"{w_}_{b_}": v[0][0]["part_s"]
                           for (w_, b_), v in results.items()},
          "reference_write_s": ref_write_s,
          "world_wall_s": {f"{w_}_{b_}": v[1]
                           for (w_, b_), v in results.items()}})

    # the kernels line: each new shape's launches in world 4's ranks (the
    # first world of four ranks); the earlier pool entries' launches at
    # their [2,512,512] window under path_launches
    w4 = launches[(PAR_GLOO_WORLD, "gloo")]
    names = {"gn_batch_solve_pool_rank": ("pool", "gn_batch_solve"),
             "gn_batch_solve_resident_rank": ("resident", "gn_batch_solve"),
             "deposit_pair_resident_rank": ("resident", "deposit_pair"),
             "edt2d_resident_rank": ("resident", "edt2d"),
             "deposit_pair_rebuild_rank": ("rebuild", "deposit_pair"),
             "edt2d_rebuild_strip": ("rebuild", "edt2d")}
    for kern in entries:
        part, fn = names[kern["name"]]
        kern["launches"] = w4[part][fn]
        kern["launches_by_world"] = {f"{w_}_{b_}": c[part][fn]
                                     for (w_, b_), c in launches.items()}
    pool_all = {fn: sum(c["pool"][fn] for c in launches.values())
                for fn in ("deposit_pair", "edt2d", "gn_batch_solve")}
    path = {"parallel": {
        "deposit_pair_pool": {"launches": pool_all["deposit_pair"],
                              "shape": "[2,512,512], one a particle"},
        "edt2d_pool": {"launches": pool_all["edt2d"],
                       "shape": "[512,512], one a particle"},
        "gn_batch_solve_pool": {
            "launches": pool_all["gn_batch_solve"],
            "shape": f"[{PAR_PARTICLES // PAR_GLOO_WORLD} or "
                     f"{PAR_PARTICLES}, {pool_shape[1]}, {pool_shape[2]}], "
                     "a rank's particles"}}}
    return entries, path


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", choices=GROUPS + ("all",), default="all",
                    help="the phase group to run (default: all of them, "
                         "each bench workload's repeats cut to one)")
    args = ap.parse_args(argv)
    _START.append(time.perf_counter())
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from iris_lama_tpu_torch.ops import _cuda

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    groups = GROUPS if args.group == "all" else (args.group,)
    _ONE_REP[0] = args.group == "all"

    # 1. device ------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi.splitlines(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "groups": list(groups),
          "bench_reps_cut_to_one": _ONE_REP[0]})

    # 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    built = _cuda.build_all(verbose=True)
    ptxas = {n: [ln.strip() for ln in b["log"].splitlines()
                 if "entry function" in ln or "registers" in ln
                 or "spill" in ln]
             for n, b in built.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {n: b["seconds"] for n, b in built.items()},
          "ptxas": ptxas})

    kernels, fine, path_launches = [], {}, {}
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for group in groups:
            t0 = time.perf_counter()
            if group == "slam":
                # 3-5. Slam2D: B1-B3 against their plain versions, the
                # CPU/card prefix, the bench workload
                kernels += slam_phases(torch, dev)
                # 12. Slam2D at 4 and 3 cm, the PF at 4 cm: the wider
                # instantiations
                fine = fine_phases(torch, dev)
                # 16. Slam2D's transient map and pool-per-scan path
                slam_option_phases(torch, dev)
            elif group == "pf":
                # 6-8. the particle filter: its kernels, the CPU/card
                # prefix, the bench workload
                kernels += pf_phases(torch, dev)
            elif group == "loc":
                # 9-11. Loc2D: its kernels, the CPU/card prefix, the bench
                # workload
                kernels += loc_phases(torch, dev)
            elif group == "lo":
                # 13-15. LidarOdometry2D: B1's pair and B3 at its shapes,
                # the CPU/card prefix, the bench_lidar.py workload
                kernels += lo_phases(torch, dev)
            elif group == "graph":
                # 17-19. GraphSlam2D: the rebuild's and the coarse
                # fallback's kernels, the CPU/card prefix, the
                # bench_graph.py workload; 20. bench_pgo.py's pose graph
                kernels += graph_phases(torch, dev)
                pgo_phase(torch, dev)
            elif group == "maps":
                # 21. the standalone occupancy states' updates; 22.
                # bench_loc.py's workload through .smd files (its kernels
                # at phase 3's and phase 9's shapes); 23. the particle
                # filter's pool path
                occupancy_phase(torch, dev)
                path_launches.update(file_workflow_phase(torch, dev, tmp))
                kernels += pf_pool_phases(torch, dev)
            elif group == "spill":
                # 24-25. Slam2D's and the particle filter's spill tier;
                # 26. the drivers' summaries
                path_launches.update(slam_spill_phase(torch, dev, tmp))
                path_launches.update(pf_spill_phase(torch, dev))
                summary_phase(torch, dev)
            elif group == "3d":
                # 27. the 3D maps
                maps3d_phase(torch, dev, tmp)
            else:
                # 28. the parallel paths on torch.distributed
                entries, path = parallel_phase(torch, dev, tmp)
                kernels += entries
                path_launches.update(path)
            emit({"phase": "group", "group": group,
                  "seconds": time.perf_counter() - t0})
    for k in kernels:
        if k["name"] in fine:
            k["launches"] = fine[k["name"]]
        for path, counts in path_launches.items():
            if k["name"] in counts:
                k.setdefault("path_launches", {})[path] = counts[k["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
