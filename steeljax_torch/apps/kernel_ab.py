"""Old against new, on one card: the any-hit kernels K2 and K2-dense, and
the raster tile kernel R.

The earlier kernels are built from a `csrc` directory of an earlier commit
into a library of their own, with the same nvcc flags, and called through
their own C entry on the same inputs as this tree's, each call timed in
turns (old, new, new, old): CUDA events around KERNEL_REPS launches queued
behind a device sleep (timing.queued_ms), so no host gap between launches
counts.

K2: the earlier K2 and K2-dense (commit dabca91's `traverse8.cu`,
`steeljax_trace_any8`) are the port's first one-thread
walk: scalar loads of child boxes and of the reference's 36-byte records
(in 12-record rows at a 40-byte stride, or in the dense 14-record rows),
each leaf tested as it is popped.  This tree's are csrc/alpha8.cu's ANY
policy without masks over the 48-byte Hopper record tables every chunk
carries (`tri_records`, `anyhit_records`).  Cases: K2 and K2-dense on path
L's first-bounce shadow rays (the shadow rays at the primaries' hits, of
which about 23% are live; the others carry the dead interval t_max <
t_min), and on their live subset, compacted by the caller for the timing
alone (every lane live).  Per case it prints both times, the flag
mismatches and both designs' per-ray work counts.  Then one 1280x720 frame
of path L and of path L with the dense any-hit tables, rendered with the
earlier kernels in the wrapper's place and with this tree's, whose
rays_traced must agree, and the frame's host wall time in turns (old, new,
new, old); then the ptxas registers of the earlier library's K2 instances
beside this tree's.

R: `raster_ab` builds the earlier `raster.cu` of a csrc directory (commit
c8f8491's: every candidate staged whole, a slice at a time) and times it
against this tree's on one launch's inputs, the outputs bit-equal;
chip_smoke.py phase 17 calls it on path R's frame.

Usage, on the card, from the repository root (`_archive/` is not tracked):
    mkdir -p _archive/parent
    git archive dabca91 steeljax_torch/csrc | tar -x -C _archive/parent
    python -m steeljax_torch.apps.kernel_ab \\
        --old _archive/parent/steeljax_torch/csrc
It first holds this tree's K2 and K2-dense against their plain versions
(the any-hit variants of kernel_parity).  chip_smoke.py --ab-old DIR runs
the same comparison on its prepared paths, without that step, where DIR
holds traverse8.cu, and R's where it holds raster.cu.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

from steeljax_torch.apps.timing import queued_ms, wall_ms

OLD_LIBRARY = "libsteeljax_torch_cuda_old.so"
OLD_RASTER_LIBRARY = "libsteeljax_torch_raster_old.so"
# Launches a timed turn of a kernel queues behind the device sleep.
KERNEL_REPS = 32
# Frames a turn of the frame walls times, after one warm frame.
FRAME_REPS = 5
# The parity variants of K2 and K2-dense (kernel_parity).
ANYHIT_VARIANTS = ("flat_anyhit", "flat_anyhit_dense", "sunlit_shadow",
                   "sunlit_shadow_dense")


def build_old(src_dir) -> ctypes.CDLL:
    """The earlier traverse8.cu (K2, K2-dense) of `src_dir` (commit
    dabca91's layout), built into a library of its own."""
    from steeljax_torch import native

    src = Path(src_dir) / "traverse8.cu"
    if not src.is_file():
        raise FileNotFoundError(f"{src} not found: --old names the earlier "
                                "kernels' csrc directory")
    target = native.BUILD_DIR / OLD_LIBRARY
    native.build_cuda(target, [src])
    lib = ctypes.CDLL(str(target))
    lib.steeljax_trace_any8.restype = ctypes.c_int
    lib.steeljax_trace_any8.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def build_old_raster(src_dir) -> ctypes.CDLL:
    """The earlier raster tile kernel R of `src_dir` (commit c8f8491's
    raster.cu: one block a subtile, every candidate's whole record staged a
    WINDOW-piece slice at a time and walked by the whole block), built into
    a library of its own."""
    from steeljax_torch import native

    src = Path(src_dir) / "raster.cu"
    if not src.is_file():
        raise FileNotFoundError(f"{src} not found: --old names the earlier "
                                "kernels' csrc directory")
    target = native.BUILD_DIR / OLD_RASTER_LIBRARY
    native.build_cuda(target, [src])
    lib = ctypes.CDLL(str(target))
    lib.steeljax_raster_tiles.restype = ctypes.c_int
    lib.steeljax_raster_tiles.argtypes = (
        [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    return lib


def raster_launcher(fn, recs_sorted, tile_ids, segments, ntx, order=None):
    """(launch, out) of a raster tile kernel's C entry `fn` on the inputs of
    raster.raster_tiles_launcher (WINDOW-piece slices), not counted in
    cuda_traverse.LAUNCHES: the earlier R's entry, whose blocks take the
    rows in their own order, without `order`; this tree's with its blocks
    taking the rows in `order` (int32 on the device)."""
    from steeljax_torch.render.hybrid import raster

    device = recs_sorted.device
    n = tile_ids.shape[0]
    ints = [x.to(torch.int32).contiguous() for x in (tile_ids, *segments)]
    out = tuple(torch.empty((n, raster.PX), dtype=torch.float32,
                            device=device) for _ in range(5))
    tensors = ((recs_sorted, *ints, *out) if order is None
               else (recs_sorted, ints[0], order, *ints[1:], *out))
    args = [x.data_ptr() for x in tensors]
    args += [recs_sorted.shape[0], n, ntx, raster.WINDOW]

    def launch():
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"R launch failed: CUDA error {status}")

    launch.tensors = tensors
    return launch, out


def raster_ab(old_dir, recs_sorted, tile_ids, segments, ntx,
              label: str) -> dict:
    """The earlier R built from `old_dir` against this tree's on one
    launch's inputs: both outputs bit-equal (raises otherwise), then each
    timed in turns old, new, new, old (queued_ms over KERNEL_REPS launches);
    the earlier library's ptxas table under "old_ptxas"."""
    from steeljax_torch import native
    from steeljax_torch.render.hybrid import raster

    lib = build_old_raster(old_dir)
    launchers = {
        "old": raster_launcher(lib.steeljax_raster_tiles, recs_sorted,
                               tile_ids, segments, ntx),
        "new": raster.raster_tiles_launcher(recs_sorted, tile_ids, segments,
                                            ntx)}
    for launch, _ in launchers.values():
        launch()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(launchers["old"][1],
                                                  launchers["new"][1]))
    turns = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        turns[who].append(queued_ms(launchers[who][0], KERNEL_REPS))
    print(f"A/B R {label}: {tile_ids.shape[0]} subtiles; old "
          + " / ".join(f"{x:.4f}" for x in turns["old"]) + " ms, new "
          + " / ".join(f"{x:.4f}" for x in turns["new"])
          + f" ms (old, new, new, old); old/new "
          f"{sum(turns['old']) / sum(turns['new']):.2f}x; outputs "
          + ("bit-equal" if equal else "DIFFER"))
    if not equal:
        raise RuntimeError(f"A/B R {label}: the earlier and this tree's "
                           "kernel disagree")
    return {"ms": turns, "bit_equal": equal,
            "old_ptxas": native.ptxas_table(
                native.BUILD_LOGS.get(OLD_RASTER_LIBRARY, ""))}


def old_anyhit_launcher(lib, bvh8, tris, rays, dense: bool,
                        counters: bool = False):
    """(launch, rec) of the earlier K2 (K2-dense with `dense`), as
    cuda_traverse.anyhit_launcher, over the reference's rows `tris`."""
    from steeljax_torch.accel import cuda_traverse as ct

    device = tris.device
    o, d, tmn, tmx = ct._rays_and_interval(*rays, device)
    n = o.shape[0]
    rec = {"hit": torch.empty(n, dtype=torch.bool, device=device)}
    if counters:
        rec.update(ct._telemetry(n, bvh8, tris, ct.DENSE_PER_ROW if dense
                                 else ct.TRI_PER_ROW))

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    args = (bvh8.rows.data_ptr(), tris.data_ptr(), o.data_ptr(),
            d.data_ptr(), tmn.data_ptr(), tmx.data_ptr(), ptr("hit"),
            ptr("counters"), ptr("seen_nodes"), ptr("seen_records"), n,
            bvh8.max_leaf, bvh8.depth, int(dense))

    def launch():
        status = lib.steeljax_trace_any8(
            *args, torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"earlier K2: CUDA error {status}")

    launch.tensors = (bvh8.rows, tris, o, d, tmn, tmx, *rec.values())
    return launch, rec


def new_anyhit_launcher(chunk, rays, counters: bool = False):
    """(launch, rec) of this tree's K2 (K2-dense on a chunk with dense
    tables) over the chunk's own record table, as the render path calls
    it."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel.dispatch import anyhit_tables

    bvh8, tris, records, dense = anyhit_tables(chunk)
    return ct.anyhit_launcher(bvh8, tris, *rays, dense=dense,
                              counters=counters, records=records)


def live_subset(rays):
    """The rays of (o, d, t_min, t_max) with t_max >= t_min, in order."""
    o, d, t_min, t_max = rays
    n = o.shape[0]
    tmn = torch.as_tensor(t_min, device=o.device).expand(n)
    tmx = torch.as_tensor(t_max, device=o.device).expand(n)
    live = tmx >= tmn
    return (o[live].contiguous(), d[live].contiguous(),
            tmn[live].contiguous(), tmx[live].contiguous())


def cases(scenes: dict, width: int, height: int) -> list:
    """[(label, chunk, rays)]: K2 and K2-dense (path L's chunk with dense
    tables) on path L's first-bounce shadow rays, then on their live
    subset."""
    from steeljax_torch.apps import kernel_parity as kp

    scene, flat, tables = scenes["sunlit"]
    rays = kp.sunlit_shadow_case(scene, flat, tables, width, height)
    live = live_subset(rays)
    chunks = {"K2": tables.chunks[0],
              "K2-dense": scenes["sunlit_dense"][2].chunks[0]}
    out = []
    for ray_set, case_rays in (("first-bounce shadow rays", rays),
                               ("first-bounce shadow rays, live subset",
                                live)):
        for name, chunk in chunks.items():
            out.append((f"{name} path L {ray_set}", chunk, case_rays))
    return out


def _per_ray(rec: dict) -> dict:
    from steeljax_torch.accel.cuda_traverse import COUNTERS

    mean = rec["counters"].to(torch.float64).mean(dim=0).tolist()
    return dict(zip(COUNTERS[:4], mean[:4]))


def run(scenes: dict, old_dir, width: int = 1280, height: int = 720) -> dict:
    """Build the earlier kernels from `old_dir` and time them against this
    tree's on `cases` (scenes["sunlit"] and scenes["sunlit_dense"] are
    prepare_path_scene results), in turns old, new, new, old.  Print every
    number and return {"cases": {label: ...}, "frames": ..., "old_ptxas":
    ...}; raises on a flag mismatch."""
    from steeljax_torch import native
    from steeljax_torch.accel.dispatch import anyhit_tables

    lib = build_old(old_dir)
    out = {}
    for label, chunk, rays in cases(scenes, width, height):
        bvh8, tris, _, dense = anyhit_tables(chunk)
        launchers = {
            "old": old_anyhit_launcher(lib, bvh8, tris, rays, dense),
            "new": new_anyhit_launcher(chunk, rays)}
        for launch, _ in launchers.values():
            launch()
        torch.cuda.synchronize()
        mismatches = int((launchers["old"][1]["hit"]
                          != launchers["new"][1]["hit"]).sum())
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(queued_ms(launchers[who][0], KERNEL_REPS))
        counts = {}
        for who, make in (
                ("old", lambda: old_anyhit_launcher(lib, bvh8, tris, rays,
                                                    dense, counters=True)),
                ("new", lambda: new_anyhit_launcher(chunk, rays,
                                                    counters=True))):
            launch, rec = make()
            launch()
            counts[who] = _per_ray(rec)
        n_rays = rays[0].shape[0]
        occluded = int(launchers["new"][1]["hit"].sum())
        out[label] = {"ms": turns, "per_ray": counts,
                      "flag_mismatches": mismatches, "rays": n_rays,
                      "occluded": occluded}
        print(f"A/B {label}: {n_rays} rays, {occluded} occluded; old "
              + " / ".join(f"{x:.4f}" for x in turns["old"]) + " ms, new "
              + " / ".join(f"{x:.4f}" for x in turns["new"])
              + f" ms (old, new, new, old); old/new "
              f"{sum(turns['old']) / sum(turns['new']):.2f}x; "
              f"{mismatches} flag mismatches")
        for who, per in counts.items():
            print(f"  per ray, {who}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in per.items()))
        if mismatches:
            raise RuntimeError(f"{label}: the earlier and this tree's "
                               f"kernel disagree on {mismatches} flags")
    return {"cases": out, "frames": frames(lib, scenes, width, height),
            "old_ptxas": native.ptxas_table(
                native.BUILD_LOGS.get(OLD_LIBRARY, ""))}


def frames(lib, scenes: dict, width: int, height: int) -> dict:
    """One frame (accumulation index 1) of path L and of path L with the
    dense any-hit tables through render_pixels, with the earlier K2 patched
    into cuda_traverse.anyhit_launcher's place and with this tree's:
    rays_traced of both, which must be equal, the largest pixel
    difference, and the frame's host wall ms (timing.wall_ms over
    FRAME_REPS frames) in turns old, new, new, old."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt import frame_graphs, integrator

    device = scenes["sunlit"][1].device
    paths = {"path L": scenes["sunlit"],
             "path L dense": scenes["sunlit_dense"]}
    px, py, _ = integrator.tiled_order(width, height)
    px, py = (torch.as_tensor(a, device=device) for a in (px, py))

    def old_launcher(bvh8, tris, o, d, t_min, t_max, dense=False,
                     alpha_mask=False, **kw):
        if alpha_mask:
            raise ValueError("the earlier K2 has no alpha masks")
        return old_anyhit_launcher(lib, bvh8, tris, (o, d, t_min, t_max),
                                   dense)

    out = {}
    for label, (scene, flat, tables) in paths.items():
        frame = camera_lib.make_frame(scene.camera_location,
                                      scene.camera_projection)
        view, proj = (torch.as_tensor(a, device=device) for a in (
            frame.inverse_view, frame.inverse_proj))

        def render(who):
            with contextlib.ExitStack() as stack:
                # Both kernels' frames as the host launches them: a graph
                # would replay whichever launcher it captured.
                stack.enter_context(mock.patch.object(
                    integrator, "FRAME_GRAPHS",
                    frame_graphs.FrameGraphs(frame_graphs.Eager())))
                if who == "old":
                    stack.enter_context(mock.patch.object(
                        ct, "anyhit_launcher", old_launcher))
                image, stats = integrator.render_pixels(
                    flat, tables, view, proj, frame.camera_near,
                    frame.camera_far, width, height, px, py, 1, 0,
                    RenderConfig(width=width, height=height),
                    return_stats=True)
            return image, float(stats["rays_traced"])

        got = {who: render(who) for who in ("old", "new")}
        diff = float((got["old"][0] - got["new"][0]).abs().max())
        walls = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            walls[who].append(wall_ms(lambda: render(who), FRAME_REPS))
        out[label] = {"rays_old": got["old"][1], "rays_new": got["new"][1],
                      "max_pixel_delta": diff, "wall_ms": walls}
        print(f"A/B frame {label} {width}x{height}: rays_traced old "
              f"{got['old'][1]:.0f}, new {got['new'][1]:.0f}; max pixel "
              f"|delta| {diff:.3e}; host wall ms a frame, old "
              + " / ".join(f"{x:.3f}" for x in walls["old"]) + ", new "
              + " / ".join(f"{x:.3f}" for x in walls["new"])
              + f" (old, new, new, old; {FRAME_REPS} frames each); old/new "
              f"{sum(walls['old']) / sum(walls['new']):.3f}x")
        if got["old"][1] != got["new"][1]:
            raise RuntimeError(f"{label}: the earlier K2 traces "
                               f"{got['old'][1]:.0f} rays a frame, this "
                               f"tree's {got['new'][1]:.0f}")
    return out


def compare_ptxas(old: dict, new: dict) -> None:
    """Print the earlier library's K2 instances (trace8_kernel<DENSE,
    COUNT>) beside this tree's (alpha8_kernel<1, 1, false, false, COUNT,
    0>, one instance for both row layouts)."""
    for label, table, prefix in (
            ("earlier", old, "trace8_kernel<"),
            ("this tree", new, "alpha8_kernel<1, 1, false, false, ")):
        for name, (regs, frame, st, ld, smem) in sorted(table.items()):
            if name.startswith(prefix):
                print(f"ptxas {label}: {name}: {regs} registers, {frame} B "
                      f"stack frame, spill stores {st} B, spill loads {ld} "
                      f"B, static smem {smem} B")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="csrc directory of the earlier kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab times CUDA kernels: no card")
    from steeljax_torch import native
    from steeljax_torch.apps import kernel_parity as kp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    device = torch.device("cuda", 0)
    new_ptxas = native.cuda_ptxas()
    native.cuda_library()
    scenes = {name: kp.prepare_path_scene(name, device)
              for name in ("sunlit", "sunlit_dense")}
    results = kp.run(device, scenes=scenes)
    ok = all(results["variants"][k]["ok"] for k in ANYHIT_VARIANTS)
    print("K2 and K2-dense against the plain versions: "
          + ("PASS" if ok else "FAIL: " + ", ".join(
              k for k in ANYHIT_VARIANTS
              if not results["variants"][k]["ok"])))
    result = run(scenes, args.old)
    compare_ptxas(result["old_ptxas"], new_ptxas)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
