"""Old against new for the nearest-hit kernels K1 and K3, on one card.

The earlier kernels are built from a `csrc` directory of an earlier commit
into a library of their own, with the same nvcc flags, and called through
their own C entry on the same tables and rays as this tree's, each call
timed in turns (old, new, new, old) by CUDA events over timing.REPS
launches.  The earlier K1 and K3 (commit 3f38e36's `traverse8.cu`,
`steeljax_trace_nearest8`) are the port's first one-thread walk: scalar
loads of child boxes and of the reference's 40-byte triangle records, and
each leaf tested as it is popped.  This tree's (csrc/alpha8.cu, NEAREST
without masks) reads child boxes and the 48-byte Hopper records with
16-byte loads and postpones leaves.  Cases: K1 on the Cornell primaries
and first-bounce rays, K1 in shade mode 1 on path L's primaries and
first-bounce rays, K3 on path T's.  Per case it prints both times, how far
the outputs agree (hit mismatches, tri ids equal where both hit and of
those that differ the ones at exactly equal t, |delta t|, normal and uv
deltas where the ids agree, material mismatches) and both designs' per-ray
work counts.  Then one 1280x720 frame of each of those paths, rendered
with the earlier kernels in the wrapper's place and with this tree's,
whose rays_traced must agree, and its host wall time in turns (old, new,
new, old); then the ptxas registers of the earlier library's K1-K3
instances beside this tree's, and whether the any-hit kernel K2 kept its
registers.

Usage, on the card, from the repository root (`_archive/` is not tracked):
    mkdir -p _archive/parent
    git archive 3f38e36 steeljax_torch/csrc | tar -x -C _archive/parent
    python -m steeljax_torch.apps.kernel_ab \\
        --old _archive/parent/steeljax_torch/csrc
It first holds this tree's K1 and K3 against their plain versions (the
parity variants of kernel_parity).  chip_smoke.py --ab-old DIR runs the
same comparison on its prepared paths, without that step.
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

from steeljax_torch.apps.timing import time_ms, wall_ms

OLD_LIBRARY = "libsteeljax_torch_cuda_old.so"
# Frames a turn of the frame walls times, after one warm frame.
FRAME_REPS = 5


def build_old(src_dir) -> ctypes.CDLL:
    """The earlier traverse8.cu (K1-K3) of `src_dir` (commit 3f38e36's
    layout), built into a library of its own."""
    from steeljax_torch import native

    src = Path(src_dir) / "traverse8.cu"
    if not src.is_file():
        raise FileNotFoundError(f"{src} not found: --old names the earlier "
                                "kernels' csrc directory")
    target = native.BUILD_DIR / OLD_LIBRARY
    native.build_cuda(target, [src])
    lib = ctypes.CDLL(str(target))
    lib.steeljax_trace_nearest8.restype = ctypes.c_int
    lib.steeljax_trace_nearest8.argtypes = (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return lib


def old_nearest_launcher(lib, bvh8, tris, shade, mode: int, rays,
                         cull: bool = True, counters: bool = False):
    """(launch, rec) of the earlier K1/K3, as cuda_traverse.kernel_launcher,
    over the reference's triangle rows `tris` and shade rows `shade` (None
    in shade mode 0)."""
    from steeljax_torch.accel import cuda_traverse as ct

    device = tris.device
    o, d, tmn, tmx = ct._rays_and_interval(*rays, device)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    rec = {"t": torch.empty(n, **f32), "u": torch.empty(n, **f32),
           "v": torch.empty(n, **f32),
           "tri": torch.empty(n, dtype=torch.int32, device=device)}
    if mode:
        rec["n"] = torch.empty((n, 3), **f32)
        rec["mat"] = torch.empty(n, dtype=torch.int32, device=device)
    if mode == 2:
        rec["tan"] = torch.empty((n, 3), **f32)
        rec["uv"] = torch.empty((n, 2), **f32)
        rec["uvd"] = torch.empty(n, **f32)
    if counters:
        rec.update(ct._telemetry(n, bvh8, tris, ct.TRI_PER_ROW))

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    shade = shade if mode else None
    args = (bvh8.rows.data_ptr(), tris.data_ptr(), ct._ptr(shade),
            o.data_ptr(), d.data_ptr(), tmn.data_ptr(), tmx.data_ptr(),
            ptr("t"), ptr("u"), ptr("v"), ptr("tri"), ptr("n"), ptr("mat"),
            ptr("tan"), ptr("uv"), ptr("uvd"), ptr("counters"),
            ptr("seen_nodes"), ptr("seen_records"), n, bvh8.max_leaf,
            bvh8.depth, int(cull), mode)
    keep = (bvh8.rows, tris, shade, o, d, tmn, tmx, *rec.values())

    def launch():
        status = lib.steeljax_trace_nearest8(
            *args, torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"earlier K1/K3: CUDA error {status}")

    launch.tensors = keep
    return launch, rec


def new_nearest_launcher(chunk, mode: int, rays, counters: bool = False):
    """(launch, rec) of this tree's K1/K3 over the chunk's own record
    table, as the render path calls it."""
    from steeljax_torch.accel import cuda_traverse as ct

    return ct.kernel_launcher(
        chunk.bvh8, chunk.tris_packed, *rays, True,
        chunk.shade_packed if mode else None, mode, counters=counters,
        records=chunk.tri_records)


def agreement(old: dict, new: dict) -> dict:
    """How far two nearest records agree: hit mismatches, tri ids equal
    where both hit (and of the rays whose ids differ, those at exactly the
    same t: a tie settled otherwise), the largest |delta t| where both hit,
    the largest normal and uv deltas where the ids agree, and material
    mismatches over all rays."""
    hit_o, hit_n = old["tri"] >= 0, new["tri"] >= 0
    both = hit_o & hit_n
    same = both & (old["tri"] == new["tri"])
    differ = both & ~same

    def max_delta(key, where):
        if key not in old or not bool(where.any()):
            return 0.0
        delta = (old[key] - new[key]).abs()
        if delta.dim() > 1:
            delta = delta.max(dim=-1).values
        return float(delta[where].max())

    return {"hit_mismatches": int((hit_o != hit_n).sum()),
            "hits": int(hit_o.sum()),
            "tri_equal_pct": 100.0 * int(same.sum()) / max(int(both.sum()),
                                                           1),
            "tri_differ": int(differ.sum()),
            "tri_differ_equal_t": int((differ
                                       & (old["t"] == new["t"])).sum()),
            "max_t_delta": max_delta("t", both),
            "max_normal_delta": max_delta("n", same),
            "max_uv_delta": max_delta("uv", same),
            "mat_mismatches": (int((old["mat"] != new["mat"]).sum())
                               if "mat" in old else 0)}


def _agreement_text(a: dict) -> str:
    return (f"{a['hit_mismatches']} hit mismatches of {a['hits']} hits, tri "
            f"equal on {a['tri_equal_pct']:.3f}% ({a['tri_differ']} differ, "
            f"{a['tri_differ_equal_t']} of them at equal t), max |delta t| "
            f"{a['max_t_delta']:.3e}, normal {a['max_normal_delta']:.3e}, "
            f"uv {a['max_uv_delta']:.3e}, {a['mat_mismatches']} material "
            "mismatches")


def _per_ray(rec: dict) -> dict:
    from steeljax_torch.accel.cuda_traverse import COUNTERS

    mean = rec["counters"].to(torch.float64).mean(dim=0).tolist()
    return dict(zip(COUNTERS[:4], mean[:4]))


def cases(scenes: dict, width: int, height: int) -> list:
    """[(label, chunk, shade mode, rays)]: K1 on the Cornell primaries and
    first-bounce rays (shade mode 1), K1 on path L's primaries and
    first-bounce rays (mode 1), K3 on path T's (mode 2)."""
    from steeljax_torch.apps import kernel_parity as kp

    out = []
    device = scenes["sunlit"][1].device
    _, ctables, cornell = kp.cornell_cases(device, width, height)
    for name, label in (("primary", "primaries"),
                        ("bounce1", "first-bounce rays")):
        out.append((f"K1 Cornell {label}", ctables.chunks[0], 1,
                    cornell[name]))
    for key, kernel, path in (("sunlit", "K1", "path L"),
                              ("stress_tex", "K3", "path T")):
        scene, flat, tables = scenes[key]
        chunk, mode = tables.chunks[0], tables.shade_mode
        out.append((f"{kernel} {path} primaries", chunk, mode,
                    kp.tiled_primary(scene, device, width, height)[:4]))
        out.append((f"{kernel} {path} first-bounce rays", chunk, mode,
                    kp.first_bounce_case(scene, flat, tables, width,
                                         height)))
    return out


def run(scenes: dict, old_dir, width: int = 1280, height: int = 720) -> dict:
    """Build the earlier kernels from `old_dir` and time them against this
    tree's on `cases` (scenes["sunlit"] and scenes["stress_tex"] are
    prepare_path_scene results), in turns old, new, new, old.  Print every
    number and return {"cases": {label: ...}, "old_ptxas": ...}."""
    from steeljax_torch import native

    lib = build_old(old_dir)
    out = {}
    for label, chunk, mode, rays in cases(scenes, width, height):
        old = (lib, chunk.bvh8, chunk.tris_packed, chunk.shade_packed, mode,
               rays)
        launchers = {"old": old_nearest_launcher(*old),
                     "new": new_nearest_launcher(chunk, mode, rays)}
        for launch, _ in launchers.values():
            launch()
        torch.cuda.synchronize()
        agree = agreement(launchers["old"][1], launchers["new"][1])
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_ms(launchers[who][0]))
        counts = {}
        for who, make in (
                ("old", lambda: old_nearest_launcher(*old, counters=True)),
                ("new", lambda: new_nearest_launcher(chunk, mode, rays,
                                                     counters=True))):
            launch, rec = make()
            launch()
            counts[who] = _per_ray(rec)
        out[label] = {"ms": turns, "per_ray": counts, "agree": agree}
        print(f"A/B {label}: {rays[0].shape[0]} rays; old "
              + " / ".join(f"{x:.4f}" for x in turns["old"]) + " ms, new "
              + " / ".join(f"{x:.4f}" for x in turns["new"])
              + f" ms (old, new, new, old); old/new "
              f"{sum(turns['old']) / sum(turns['new']):.2f}x; "
              + _agreement_text(agree))
        for who, per in counts.items():
            print(f"  per ray, {who}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in per.items()))
    return {"cases": out, "frames": frames(lib, scenes, width, height),
            "old_ptxas": native.ptxas_table(
                native.BUILD_LOGS.get(OLD_LIBRARY, ""))}


def frames(lib, scenes: dict, width: int, height: int) -> dict:
    """One frame (accumulation index 1) of the Cornell box and of paths L
    and T through render_pixels, with the earlier K1/K3 patched into
    cuda_traverse.kernel_launcher's place and with this tree's: rays_traced
    of both, which must be equal, the largest pixel difference, and the
    frame's host wall ms (timing.wall_ms over FRAME_REPS frames) in turns
    old, new, new, old."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt import integrator
    from steeljax_torch.render.pt.renderer import prepare_scene
    from steeljax_torch.scene.builtin import make_cornell_scene

    device = scenes["sunlit"][1].device
    cornell = make_cornell_scene(sphere_detail=12)
    paths = {"Cornell": (cornell, *prepare_scene(cornell, device,
                                                 env_resolution=64)),
             "path L": scenes["sunlit"], "path T": scenes["stress_tex"]}
    px, py, _ = integrator.tiled_order(width, height)
    px, py = (torch.as_tensor(a, device=device) for a in (px, py))

    def old_launcher(bvh8, tris, o, d, t_min, t_max, cull=True,
                     shade_rows=None, shade_mode=0, **kw):
        return old_nearest_launcher(lib, bvh8, tris, shade_rows, shade_mode,
                                    (o, d, t_min, t_max), cull)

    out = {}
    for label, (scene, flat, tables) in paths.items():
        frame = camera_lib.make_frame(scene.camera_location,
                                      scene.camera_projection)
        view, proj = (torch.as_tensor(a, device=device) for a in (
            frame.inverse_view, frame.inverse_proj))

        def render(who):
            with contextlib.ExitStack() as stack:
                if who == "old":
                    stack.enter_context(mock.patch.object(
                        ct, "kernel_launcher", old_launcher))
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
            raise RuntimeError(f"{label}: the earlier K1/K3 trace "
                               f"{got['old'][1]:.0f} rays a frame, this "
                               f"tree's {got['new'][1]:.0f}")
    return out


def compare_ptxas(old: dict, new: dict) -> None:
    """Print the earlier library's K1-K3 instances beside this tree's K1
    and K3 instances, and whether the any-hit instances of K2 kept their
    registers (earlier trace8_kernel<true, DENSE, false, COUNT>, now
    trace8_kernel<DENSE, COUNT>)."""
    same, changed = 0, []
    for name, entry in sorted(old.items()):
        if not name.startswith("trace8_kernel<true, "):
            continue
        flags = name[len("trace8_kernel<"):-1].split(", ")
        key = f"trace8_kernel<{flags[1]}, {flags[3]}>"
        if key not in new:
            changed.append(f"{key} missing")
        elif new[key][:2] == entry[:2]:
            same += 1
        else:
            changed.append(f"{name} {entry[0]} -> {key} {new[key][0]}")
    print(f"ptxas, K2 instances against the earlier library: {same} with "
          "the same registers and stack frame"
          + ("; " + "; ".join(changed) if changed else ""))
    for label, table, prefix in (
            ("earlier", old, "trace8_kernel<false, "),
            ("this tree", new, "alpha8_kernel<0, 1, false, ")):
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
              for name in ("sunlit", "stress_tex")}
    results = kp.run(device, scenes=scenes)
    nearest = [k for k in results["variants"]
               if k.startswith(("flat_shade", "flat_deterministic",
                                "cornell_", "stress_tex_primary"))]
    ok = all(results["variants"][k]["ok"] for k in nearest)
    print("K1 and K3 against the plain versions: "
          + ("PASS" if ok else "FAIL: " + ", ".join(
              k for k in nearest if not results["variants"][k]["ok"])))
    result = run(scenes, args.old)
    compare_ptxas(result["old_ptxas"], new_ptxas)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
