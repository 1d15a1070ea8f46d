#!/usr/bin/env python3
"""Device time of the value scatters B7 (``scatter_add_2d``) and B8
(``scatter_add_sorted``) on the H100: the kept kernels' launch sizes swept
beside a design that was measured and not kept, and the wrappers of
several checkouts in turns.

    python3 prof_torch_scatter.py                  # the sweep
    python3 prof_torch_scatter.py --roots ROOT ...  # the wrappers per root

The inputs are chip_smoke.py's kind (the one beside this script): the
Slam2D deposit's free-space stream of bench.py's first scan, its in-window
cells beam-ordered, into [448, 512] (B7 with values 1; B8 on the packed
words unsorted and sorted); every element of it on one cell (hot); the
stream moved into [768, 1024]; and 64 copies of it, moved apart, into
[2048, 2048] (16 MB).

The sweep prints one JSON line a grid: for each stream, device µs a call
(torch.profiler) of the kept kernel (csrc/deposit.cu, one cooperative
launch) at 66, 132, 264 and 528 blocks (``picked_blocks``: what
``launch_blocks`` picks), and of the design in prof_torch_scatter.cu (the
grid in a thread-block cluster's distributed shared memory) at 8 and 16
blocks a cluster, with and without __match_any_sync; each result is
checked ``torch.equal`` to the plain version. Beside them the floors: an
empty cooperative launch, one that meets at one grid barrier
(csrc/floor.cu), and an empty cluster launch of each cluster shape with
how many clusters of it the card holds at once. With ``--roots``, each
ROOT (a directory holding an ``iris_lama_tpu_torch`` package) runs in a
process of its own, in the order given (parent, change, change, parent to
compare two commits on one card): device µs and device activities a call
of each wrapper, one JSON line a root.
"""

import ctypes
import functools
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPS = 200
SMEM_BYTES = 232_448   # a block's dynamic shared memory on the H100


@functools.lru_cache(maxsize=None)
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def us(fn, reps: int = REPS) -> float:
    """Device µs per call of everything ``fn`` launches."""
    dp = chip_smoke().devprof()
    fn()
    return dp.device_us(dp.cuda_rows(dp.profile_calls(fn, reps))) / reps


def cases(torch, dev) -> list:
    """(grid label, shape, ly, lx) of the four inputs."""
    from iris_lama_tpu_torch.core import lie
    from iris_lama_tpu_torch.sdm import mapping
    data, opts, padded = chip_smoke().slam_workload()
    cfg = opts.mapping_config()
    wu = cfg.resident_update_cells
    pts, msk, ori = (torch.as_tensor(a, device=dev) for a in padded[0])
    pose = lie.se2(*data.poses_gt[0], device=dev)
    org = cfg.geometry.w2m(pose[:2]) - wu // 2
    idx = mapping.deposit_indices(cfg, pose, pts, msk, ori, org, wu)
    ok = idx.free_ly < wu
    ly, lx = idx.free_ly[ok].contiguous(), idx.free_lx[ok].contiguous()
    hot = torch.full_like(ly, 200)
    side = (wu, (wu + 127) // 128 * 128)
    return [("[448,512]", side, ly, lx),
            ("[448,512] hot", side, hot, hot + 100),
            ("[768,1024]", (768, 1024), ly + 160, lx + 300),
            ("[2048,2048] x64", (2048, 2048),
             torch.cat([ly + 200 * (k % 8) for k in range(64)]),
             torch.cat([lx + 200 * (k // 8) for k in range(64)]))]


def designs_library():
    """prof_torch_scatter.cu, built with the package's nvcc flags."""
    from iris_lama_tpu_torch.ops import _cuda
    out = _cuda.BUILD_DIR / "libprof_torch_scatter.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(out),
                    os.path.join(HERE, "prof_torch_scatter.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.dsmem_scatter_add_2d.argtypes = (p, p, p, q, i, i, i, i, i, i, p, p)
    lib.dsmem_scatter_add_sorted.argtypes = (p, q, i, i, i, i, i, i, p, p)
    lib.dsmem_active_clusters.argtypes = (i, i, p)
    lib.dsmem_floor.argtypes = (i, i, i, p)
    return lib


def slice_cells(cells: int, blocks: int) -> int:
    """A block's slice of ``cells`` over ``blocks`` blocks, in whole
    16-byte words."""
    return max(4, -(-(-(-cells // blocks)) // 4) * 4)


def sweep() -> None:
    import torch
    from iris_lama_tpu_torch.ops import _cuda, scatter_pallas as sp
    from iris_lama_tpu_torch.ops import scatter_sorted as ss
    dev = torch.device("cuda:0")
    lib, flib = _cuda.library("deposit"), _cuda.library("floor")
    dlib = designs_library()
    stream = _cuda.stream_handle(dev)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}), flush=True)

    def timed(call, want, shape):
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        _cuda.check(call(out), "scatter")
        torch.cuda.synchronize()
        assert torch.equal(out, want), "differs from the plain version"
        return us(lambda: _cuda.check(call(out), "scatter"))

    for label, shape, ly, lx in cases(torch, dev):
        h, w = shape
        n = ly.numel()
        ones = torch.ones(n, dtype=torch.int32, device=dev)
        want = sp.scatter_add_2d_plain(ly, lx, ones, shape)
        packed = ss.pack_updates(ly, lx, ones)
        row = {"grid": label, "n": n, "picked_blocks": sp.launch_blocks(n),
               "kept": {}, "dsmem": {}}
        for name, wd in (("B7", None), ("B8_unsorted", packed),
                         ("B8_sorted", torch.sort(packed).values)):
            if wd is None:
                def kept(out, blocks):
                    return lib.scatter_add_2d(
                        ly.data_ptr(), lx.data_ptr(), ones.data_ptr(), n, h,
                        w, blocks, out.data_ptr(), stream)

                def dsmem(out, plan, match):
                    return dlib.dsmem_scatter_add_2d(
                        ly.data_ptr(), lx.data_ptr(), ones.data_ptr(), n, h,
                        w, *plan, match, out.data_ptr(), stream)
            else:
                def kept(out, blocks, wd=wd):
                    return lib.scatter_add_sorted(
                        wd.data_ptr(), n, h, w, blocks, out.data_ptr(),
                        stream)

                def dsmem(out, plan, match, wd=wd):
                    return dlib.dsmem_scatter_add_sorted(
                        wd.data_ptr(), n, h, w, *plan, match, out.data_ptr(),
                        stream)
            row["kept"][name] = {
                blocks: timed(lambda out, b=blocks: kept(out, b), want, shape)
                for blocks in (66, 132, 264, 528)}
            times = {}
            for cluster in (8, 16):
                for clusters in (4, 8):
                    plan = (cluster, clusters,
                            slice_cells(h * w, cluster * clusters))
                    if plan[2] * 4 > SMEM_BYTES:
                        continue
                    for match in (1, 0):
                        times[f"{plan}{' match' if match else ''}"] = timed(
                            lambda out, p=plan, m=match: dsmem(out, p, m),
                            want, shape)
            row["dsmem"][name] = times
        floors = {}
        for blocks in (132, 264):
            for sync in (0, 1):
                floors[f"cooperative {blocks} x {sp.THREADS}"
                       f"{' + grid barrier' if sync else ''}"] = us(
                    lambda b=blocks, s=sync: _cuda.check(
                        flib.launch_floor_cooperative(b, sp.THREADS, s,
                                                      stream), "floor"),
                    1000)
        for cluster in (8, 16):
            cells = slice_cells(h * w, cluster * 8)
            if cells * 4 > SMEM_BYTES:
                continue
            count = ctypes.c_int(-1)
            _cuda.check(dlib.dsmem_active_clusters(
                cluster, cells, ctypes.byref(count)), "active clusters")
            floors[f"cluster {cluster} x 8, {cells * 4} B"] = {
                "us": us(lambda c=cluster, k=cells: _cuda.check(
                    dlib.dsmem_floor(c, 8, k, stream), "floor"), 1000),
                "active_clusters": count.value}
        row["floors"] = floors
        print(json.dumps(row), flush=True)


def run_root(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    import iris_lama_tpu_torch
    pkg = os.path.dirname(iris_lama_tpu_torch.__file__)
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    from iris_lama_tpu_torch.ops import scatter_pallas as sp
    from iris_lama_tpu_torch.ops import scatter_sorted as ss
    dev = torch.device("cuda:0")
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for label, shape, ly, lx in cases(torch, dev)[:3]:
        ones = torch.ones(ly.numel(), dtype=torch.int32, device=dev)
        sorted_words = torch.sort(ss.pack_updates(ly, lx, ones)).values
        for name, fn in (
                ("B7", lambda: sp.scatter_add_2d(ly, lx, ones, shape)),
                ("B8_sorted", lambda: ss.scatter_add_sorted(sorted_words,
                                                            shape))):
            assert torch.equal(fn(), sp.scatter_add_2d_plain(
                ly, lx, ones, shape)), f"{name} {label} differs"
            out[f"{name} {label}"] = {
                "n": ly.numel(), "us": us(fn),
                "activities": chip_smoke().device_launches(torch, fn)}
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(run_root(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    if len(sys.argv) >= 2 and sys.argv[1] == "--roots":
        for root in sys.argv[2:]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", root], check=True)
        return 0
    sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
