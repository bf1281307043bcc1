"""Old against new for the alpha-masked trace kernels K4 and K5 on path F.

csrc/alpha8.cu replaced two earlier kernels: the ALPHA/FINE instances of
traverse8.cu's one-thread-per-ray walk (K4, nearest and any-hit) and
multihit8.cu (K5), both with scalar 4-byte table loads and a 2 KB stack per
thread in local memory (their sources as of commit 2ae8a91).  This module
builds those sources from a directory into a library of their own, with the
same nvcc flags, and calls them through their own C entries on the same
tables and rays as alpha8.cu, on one card, each call timed in turns (old,
new, new, old) with CUDA events over REPS launches:
  * every K4 call of one 1280x720 frame of path F, captured once from the
    integrator: per bounce the material rays' first trace and its four
    alpha re-trace passes (pass 0 of bounce 0 is the primaries in tile
    order; the passes carry the rejected rays first and the resolved ones
    with the dead interval), then the sun rays' (culling off);
  * K4 any-hit on the first-bounce sun rays (held in parity only);
  * every K5 call (K = 4) of one frame of path F with multihit_k = 4.
Per call it prints both times and how far the two kernels' outputs agree,
for the first bounce's first passes also the per-ray work counts of both
(their COUNT instances); per frame the sums.  Then the ptxas registers of
the earlier library's instances beside this tree's.

Usage, on the card, from the repository root (`_archive/` is not tracked):
    mkdir -p _archive/parent
    git archive 2ae8a91 steeljax_torch/csrc | tar -x -C _archive/parent
    python -m steeljax_torch.apps.alpha_ab \\
        --old _archive/parent/steeljax_torch/csrc
It first holds alpha8.cu against the plain versions (kernel_parity's alpha
and foliage variants).  chip_smoke.py --ab-old DIR runs the same comparison
on its prepared paths, without the parity step.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPS = 10
OLD_LIBRARY = "libsteeljax_torch_cuda_old.so"


def time_ms(fn, reps: int = REPS) -> float:
    """Mean ms of `fn()` over `reps` calls between two CUDA events, after
    one warm call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_old(src_dir) -> ctypes.CDLL:
    """The earlier traverse8.cu and multihit8.cu of `src_dir` (with the
    header beside them), built into a library of their own."""
    from steeljax_torch import native

    src_dir = Path(src_dir)
    sources = [src_dir / "traverse8.cu", src_dir / "multihit8.cu"]
    for src in sources:
        if not src.is_file():
            raise FileNotFoundError(f"{src} not found: --old names the "
                                    "earlier kernels' csrc directory")
    target = native.BUILD_DIR / OLD_LIBRARY
    native.build_cuda(target, sources)
    lib = ctypes.CDLL(str(target))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for entry, n_ptr, n_int in (("steeljax_trace_nearest8", 21, 6),
                                ("steeljax_trace_any8", 12, 5),
                                ("steeljax_trace_multihit8", 15, 6)):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
    return lib


def old_launcher(lib, query: str, chunk, rays, cull: bool, k_hits: int = 4,
                 counters: bool = False):
    """(launch, rec) of the earlier kernel, as cuda_traverse.alpha_launcher:
    `query` "nearest", "any" or "multihit" over the chunk's reference rows
    and fine rows."""
    from steeljax_torch.accel import cuda_traverse as ct

    bvh8, tris, fine = chunk.bvh8, chunk.tris_packed, chunk.fine_mask_rows
    device = tris.device
    o, d, tmn, tmx = ct._rays_and_interval(*rays, device)
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    if query == "any":
        rec = {"hit": torch.empty(n, dtype=torch.bool, device=device)}
    else:
        shape = (k_hits, n) if query == "multihit" else (n,)
        rec = {"t": torch.empty(shape, **f32), "u": torch.empty(shape, **f32),
               "v": torch.empty(shape, **f32),
               "tri": torch.empty(shape, dtype=torch.int32, device=device)}
    if counters:
        rec.update(ct._telemetry(n, bvh8, tris, ct.TRI_PER_ROW, fine=True))

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    head = (bvh8.rows.data_ptr(), tris.data_ptr())
    rays_in = (o.data_ptr(), d.data_ptr(), tmn.data_ptr(), tmx.data_ptr())
    seen = (ptr("counters"), ptr("seen_nodes"), ptr("seen_records"),
            ptr("seen_fine"))
    tree = (n, bvh8.max_leaf, bvh8.depth)
    fine_ptr = ct._ptr(fine)
    if query == "nearest":
        fn = lib.steeljax_trace_nearest8
        args = (*head, None, fine_ptr, *rays_in, ptr("t"), ptr("u"),
                ptr("v"), ptr("tri"), None, None, None, None, None, *seen,
                *tree, int(cull), 0, 1)
    elif query == "any":
        fn = lib.steeljax_trace_any8
        args = (*head, fine_ptr, *rays_in, ptr("hit"), *seen, *tree, 0, 1)
    else:
        fn = lib.steeljax_trace_multihit8
        args = (*head, fine_ptr, *rays_in, ptr("t"), ptr("u"), ptr("v"),
                ptr("tri"), *seen, *tree, k_hits, int(cull), 1)
    keep = (bvh8.rows, tris, fine, o, d, tmn, tmx, *rec.values())

    def launch():
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"earlier {query} kernel: CUDA error {status}")

    launch.tensors = keep
    return launch, rec


def new_launcher(query: str, chunk, rays, cull: bool, k_hits: int = 4,
                 counters: bool = False):
    """(launch, rec) of alpha8.cu through cuda_traverse.alpha_launcher."""
    from steeljax_torch.accel import cuda_traverse as ct

    return ct.alpha_launcher(query, chunk.bvh8, chunk.tris_packed, *rays,
                             cull, k_hits=k_hits, counters=counters,
                             fine_rows=chunk.fine_mask_rows,
                             records=chunk.tri_records)


def capture_frame(scene, flat, tables, width: int, height: int) -> list:
    """[(label, query, rays, cull)] of every K4 or K5 call of one frame of
    path F (render_pixels, accumulation index 0), in order, each call's
    (o, d, t_min, t_max) as the kernel receives it: per bounce the material
    rays' bounded alpha re-trace (the first trace and max_alpha_retrace
    passes past rejected hits; the passes carry the rejected rays first
    and the resolved ones with the dead interval), then the sun rays'."""
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt import integrator

    config = RenderConfig(width=width, height=height)
    passes = 1 + config.max_alpha_retrace
    calls = []
    bounce = [-1]

    def record(query, o, d, t_min, t_max, cull):
        # Every trace runs all its passes; a bounce's material rays (culling
        # on) come before its sun rays.
        step = len(calls) % passes
        bounce[0] += cull and step == 0
        calls.append((f"bounce {bounce[0]} {'material' if cull else 'sun'} "
                      f"pass {step}", query,
                      tuple(x.clone() if isinstance(x, torch.Tensor) else x
                            for x in (o, d, t_min, t_max)), cull))

    real = integrator.trace_nearest, integrator.trace_multihit

    def nearest(tables_, o, d, t_min, t_max, cull_backface=True):
        record("nearest", o, d, t_min, t_max, cull_backface)
        return real[0](tables_, o, d, t_min, t_max,
                       cull_backface=cull_backface)

    def multihit(tables_, o, d, t_min, t_max, k_hits, cull_backface=True):
        record("multihit", o, d, t_min, t_max, cull_backface)
        return real[1](tables_, o, d, t_min, t_max, k_hits,
                       cull_backface=cull_backface)

    device = flat.device
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    px, py, _ = integrator.tiled_order(width, height)
    px, py, inverse_view, inverse_proj = (
        torch.as_tensor(x, device=device)
        for x in (px, py, frame.inverse_view, frame.inverse_proj))
    integrator.trace_nearest, integrator.trace_multihit = nearest, multihit
    try:
        integrator.render_pixels(flat, tables, inverse_view, inverse_proj,
                                 frame.camera_near, frame.camera_far, width,
                                 height, px, py, 0, 0, config)
    finally:
        integrator.trace_nearest, integrator.trace_multihit = real
    return calls


def _live(rays) -> int:
    o, _, t_min, t_max = rays
    t_min = torch.as_tensor(t_min, device=o.device)
    t_max = torch.as_tensor(t_max, device=o.device)
    return int((t_max >= t_min).expand(o.shape[0]).sum())


def _agreement(query: str, old: dict, new: dict) -> str:
    """How far two kernels' outputs agree: hit (or slot) mismatches, tri
    ids equal where both hit, and the largest |delta t| there."""
    if query == "any":
        return f"{int((old['hit'] != new['hit']).sum())} flag mismatches"
    hit_o, hit_n = old["tri"] >= 0, new["tri"] >= 0
    both = hit_o & hit_n
    same = both & (old["tri"] == new["tri"])
    dt = (old["t"] - new["t"]).abs()[both]
    kind = "slot" if query == "multihit" else "hit"
    return (f"{int((hit_o != hit_n).sum())} {kind} mismatches of "
            f"{int(hit_o.sum())} hits, tri equal on "
            f"{100.0 * int(same.sum()) / max(int(both.sum()), 1):.3f}%, max "
            f"|delta t| {float(dt.max()) if dt.numel() else 0.0:.3e}")


def _per_ray(rec: dict) -> dict:
    from steeljax_torch.accel.cuda_traverse import COUNTERS

    mean = rec["counters"].to(torch.float64).mean(dim=0).tolist()
    return dict(zip(COUNTERS, mean))


def _ab(lib, chunk, label, query, rays, cull, counts: bool) -> dict:
    """One call of the earlier kernel and of alpha8.cu, timed in turns (old,
    new, new, old), their outputs compared; with `counts` the per-ray work
    counts of both."""
    launches = {"old": old_launcher(lib, query, chunk, rays, cull),
                "new": new_launcher(query, chunk, rays, cull)}
    for launch, _ in launches.values():
        launch()
    torch.cuda.synchronize()
    agree = _agreement(query, launches["old"][1], launches["new"][1])
    turns = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        turns[who].append(time_ms(launches[who][0]))
    out = {"old_ms": turns["old"], "new_ms": turns["new"],
           "rays": rays[0].shape[0], "live_rays": _live(rays)}
    old_ms, new_ms = sum(turns["old"]) / 2, sum(turns["new"]) / 2
    print(f"A/B {label}: {out['rays']} rays, {out['live_rays']} live; old "
          f"{turns['old'][0]:.4f} / {turns['old'][1]:.4f} ms, new "
          f"{turns['new'][0]:.4f} / {turns['new'][1]:.4f} ms (old, new, new, "
          f"old); old/new {old_ms / new_ms:.2f}x; {agree}")
    if counts:
        for who, make in (("old", lambda: old_launcher(
                lib, query, chunk, rays, cull, counters=True)),
                ("new", lambda: new_launcher(query, chunk, rays, cull,
                                             counters=True))):
            launch, rec = make()
            launch()
            out[f"{who}_per_ray"] = _per_ray(rec)
            print(f"  per ray, {who}: " + ", ".join(
                f"{k} {v:.2f}" for k, v in out[f"{who}_per_ray"].items()))
    return out


def run(scenes: dict, old_dir, width: int = 1280, height: int = 720) -> dict:
    """Build the earlier kernels from `old_dir`; time them against
    alpha8.cu, in turns, on every K4 call of one frame of path F
    (scenes["foliage"]), K4 any-hit on its first-bounce sun rays and every
    K5 call of one frame of path F with multihit_k = 4
    (scenes["foliage_multihit"]).  Print every number and return {"calls":
    {label: {...}}, "frames": {kernel: {"old", "new"}}, "old_ptxas":
    {...}}."""
    from steeljax_torch import native
    from steeljax_torch.apps import kernel_parity as kp

    lib = build_old(old_dir)
    result = {"calls": {}, "frames": {},
              "old_ptxas": native.ptxas_table(
                  native.BUILD_LOGS.get(OLD_LIBRARY, ""))}
    todo = []
    for kernel, name in (("K4", "foliage"), ("K5", "foliage_multihit")):
        scene, flat, tables = scenes[name]
        chunk = tables.chunks[0]
        for label, query, rays, cull in capture_frame(scene, flat, tables,
                                                      width, height):
            todo.append((kernel, f"{kernel} {label}", query, chunk, rays,
                         cull))
        if kernel == "K4":
            sun = kp.foliage_shadow_case(scene, flat, tables, width, height)
            todo.append(("K4_anyhit", "K4 any-hit bounce 0 sun", "any",
                         chunk, sun, False))
    for kernel, label, query, chunk, rays, cull in todo:
        # Work counts of the first bounce's first passes (the primaries and
        # the sun rays: the rays of phase 3b's bounds).
        counts = "bounce 0" in label and label.endswith("pass 0")
        entry = _ab(lib, chunk, label, query, rays, cull,
                    counts or query == "any")
        result["calls"][label] = entry
        if kernel != "K4_anyhit":
            frame = result["frames"].setdefault(kernel, {"old": 0.0,
                                                         "new": 0.0})
            frame["old"] += sum(entry["old_ms"]) / 2
            frame["new"] += sum(entry["new_ms"]) / 2
    for kernel, frame in result["frames"].items():
        print(f"A/B {kernel} frame: old {frame['old']:.4f} ms, new "
              f"{frame['new']:.4f} ms over its calls (each the mean of its "
              f"two turns); old/new {frame['old'] / frame['new']:.2f}x")
    return result


def compare_ptxas(old: dict, new: dict) -> None:
    """Print the registers of every earlier trace8_kernel instance that
    this tree still has (the FINE flag dropped from the old names) beside
    this tree's."""
    same, changed = 0, []
    for name, entry in sorted(old.items()):
        if not name.startswith("trace8_kernel<"):
            continue
        flags = name[len("trace8_kernel<"):-1].split(", ")
        if len(flags) != 7 or flags[5] == "true" or (
                flags[4] == "true" and flags[6] == "false"):
            continue  # the alpha8.cu instances' forerunners
        key = "trace8_kernel<" + ", ".join(flags[:5] + flags[6:]) + ">"
        if key not in new:
            changed.append(f"{key} missing")
        elif new[key][0] == entry[0]:
            same += 1
        else:
            changed.append(f"{key} {entry[0]} -> {new[key][0]}")
    print(f"ptxas, K1-K3 and K7 instances against the earlier library: "
          f"{same} with the same registers"
          + ("; " + "; ".join(changed) if changed else ""))
    for name, (regs, frame, st, ld, smem) in sorted(old.items()):
        if "multihit8_kernel" in name or (
                name.startswith("trace8_kernel<")
                and name.split(", ")[4] == "true"):
            print(f"ptxas earlier: {name}: {regs} registers, {frame} B stack "
                  f"frame, spill stores {st} B, spill loads {ld} B")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True,
                    help="csrc directory of the earlier kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("alpha_ab times CUDA kernels: no card")
    from steeljax_torch import native
    from steeljax_torch.apps import kernel_parity as kp

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    device = torch.device("cuda", 0)
    native.cuda_library()
    new_ptxas = native.ptxas_table(
        native.BUILD_LOGS.get("libsteeljax_torch_cuda.so", ""))
    for name, (regs, frame, st, ld, smem) in sorted(new_ptxas.items()):
        if name.startswith("alpha8_kernel<"):
            print(f"ptxas this tree: {name}: {regs} registers, {frame} B "
                  f"stack frame, spill stores {st} B, spill loads {ld} B")
    scenes = {name: kp.prepare_path_scene(name, device)
              for name in ("foliage", "foliage_multihit")}
    variants: dict = {}
    soup, _, o, d = kp.soup_case(30000, 10240, device)
    ok = kp._alpha_variants(device, soup, torch.as_tensor(o, device=device),
                            torch.as_tensor(d, device=device), 30000,
                            variants)
    ok &= kp._foliage_variants(device, scenes, 1280, 720, variants)
    print("alpha8.cu against the plain versions: "
          + ("PASS" if ok else "FAIL: " + ", ".join(
              k for k, v in variants.items() if not v["ok"])))
    result = run(scenes, args.old)
    compare_ptxas(result["old_ptxas"], new_ptxas)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
