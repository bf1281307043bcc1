"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's paths through their user entry points (prepare_scene,
render_pixels) at 1280x720, 1 spp per frame, at most 4 bounces, roulette
after bounce 2, irradiance clamp 8, and holds every hand-written trace
kernel against its plain PyTorch version:
  * the Cornell box (kernel K1: nearest hit with fused mode-1 shading);
  * path L, the sunlit stress scene (208,084 triangles and a directional
    sun): K1 and, for the shadow rays of next-event estimation, the
    any-hit kernel K2; once more with the dense any-hit tables (K2-dense);
  * path T, the textured stress scene (1,320,868 triangles): K3, nearest
    hit with textured fused shading;
  * paths F and S, the JAX bench's foliage scenes (500,000 alpha-tested
    leaf cards over a ground quad, 1,000,002 triangles, a sun; serrated and
    solid leaves, coarse and fine alpha masks): K4, nearest hit with
    in-kernel alpha masks, for every material and shadow ray and each of
    their re-trace passes; and path F once more with multihit_k = 4: K5,
    the K-nearest multi-hit kernel, in K4's place.
Paths L, T, F and S are above the repack threshold, so their rays are
repacked before every secondary bounce, and the alpha paths' re-traces
compact their rejected rays first.  Every phase raises on failure, so the
script exits non-zero; it refuses to run without a card.

Phases:
  1. device and toolchain (nvidia-smi, torch, CUDA, nvcc, g++);
  2. build of the BVH builder and the CUDA kernel library from the sources,
     with ptxas' registers and spills for every kernel instance;
  3. preparation of paths L, T, F, S and F with multihit_k = 4 (host
     seconds by step); kernel parity, kernel against plain version
     (apps.kernel_parity); each kernel's time alone at its path's shapes,
     its plain version's time, its work counts (mask tests included) and
     the least time the card could take for the same work;
  4. the Cornell main path: one warm and 4 timed frames, K1's launches, the
     kernel's share of a frame, the render CLI;
  5. path L: the same frames and checks, K1 and K2 launches, then the
     frames with the dense any-hit tables (K2-dense launches);
  6. path T: the same frames and checks, K3 launches;
  7. paths F, S and F with multihit_k = 4: the same frames and checks, K4
     and K5 launches, and the rays still to re-trace before and after each
     re-trace pass of the first timed frame;
  8. 32x18 tiles on the card against the CPU: Cornell, the lit parity
     scene (next-event estimation) and a small foliage scene (alpha
     re-trace).
The second-to-last line is the kernels' JSON summary, the last line the
device JSON.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT = 1280, 720
TIMED_FRAMES = 4
TILE_W, TILE_H = 32, 18
PIXEL_ATOL = 1e-4
# The card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s and fp32
# operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# fp32 operations of the kernels' work units (csrc/traverse8.cu): a
# supernode pop slab-tests 8 children (6 subtractions, 6 products, 6
# min/max, 4 min/max reductions, 3 comparisons each); a triangle test is
# Moller-Trumbore (two cross products, three dot products, a reciprocal,
# the accept comparisons: 53); the epilogue interpolates and normalizes the
# winner's attributes once per ray.  The alpha kernels add a mask test for
# each candidate that reaches one (the kernels' own counts: the coarse test
# runs only for a candidate inside its triangle and its interval, the fine
# test only past the coarse one); a test finds the cell of (u, v) and reads
# its bit (2 products, 2 casts, 4 clamps, 5 index operations, 2 shifts and
# masks, 1 domain test: 16).
OPS_PER_SUPERNODE_POP = 8 * 25
OPS_PER_TRIANGLE_TEST = 53
OPS_PER_MASK_TEST = 16
OPS_EPILOGUE = {"K1": 25, "K3": 60, "K2": 0, "K2_dense": 0, "K4": 0,
                "K4_anyhit": 0, "K5": 0}
# Bytes each ray reads (o, d, t_min, t_max) and writes, by kernel (K5
# writes K = 4 slots of t, u, v and tri).
RAY_IN_BYTES = 32
RAY_OUT_BYTES = {"K1": 32, "K3": 56, "K2": 1, "K2_dense": 1, "K4": 16,
                 "K4_anyhit": 1, "K5": 64}
# Table bytes a kernel reads per distinct entry its walk touches: a
# supernode pop reads floats 0-7 of each of the row's 8 children; a triangle
# test reads one record (nearest: v0, e1, e2 and the double-sided flag;
# any-hit: v0, e1, e2; alpha kernels: v0, e1, e2 and the AUX word); a fine
# mask test reads the record's PASS word (K4) or its PASS and OPAQUE words
# (K5); the epilogue reads the winner's shade record (mode 1: 10 floats,
# mode 2: 26).
SNODE_ROW_BYTES = 8 * 8 * 4
TRI_RECORD_BYTES = {"K1": 40, "K3": 40, "K2": 36, "K2_dense": 36,
                    "K4": 40, "K4_anyhit": 40, "K5": 40}
FINE_WORD_BYTES = {"K4": 4, "K4_anyhit": 4, "K5": 8}
SHADE_RECORD_BYTES = {"K1": 40, "K3": 104, "K2": 0, "K2_dense": 0, "K4": 0,
                      "K4_anyhit": 0, "K5": 0}
# Runtime calls counted per profiled frame: the host waits for the device
# in the first two, and in a copy from or to pageable host memory.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync")


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def phase_device() -> str:
    from steeljax_torch.native import find_nvcc

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    nvcc = _run([find_nvcc(), "--version"])
    print("nvcc:", [ln for ln in nvcc.splitlines() if "release" in ln][0])
    print("g++:", _run(["g++", "--version"]).splitlines()[0])
    return smi


def phase_build() -> None:
    from steeljax_torch import native

    for name, build in (("BVH builder (g++)", native.bvh_library),
                        ("CUDA kernels (nvcc)", native.cuda_library)):
        t0 = time.perf_counter()
        build()
        print(f"built {name} in {time.perf_counter() - t0:.3f} s")
    log = native.BUILD_LOGS.get("libsteeljax_torch_cuda.so", "")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            print("ptxas:", line.strip())


def _time_ms(fn, reps: int) -> float:
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


def _bound(kernel: str, rec: dict) -> dict:
    """The least time the card could take for one call, from a counting
    launch's `rec`: the larger of the bytes it must move over the HBM rate
    and the fp32 operations this run's walk did (the kernel's own counters)
    over the fp32 peak.  The bytes are each ray's inputs and outputs once
    and, of the tables, only what this run's walks read, each entry once:
    the distinct supernode rows popped, triangle records tested and records
    whose fine words were read (the kernel's seen flags), and the distinct
    winners' shade records."""
    n_rays = rec["counters"].shape[0]
    pops, rows, leaves, tests, mask_tests, fine_tests = (
        rec["counters"].to(torch.int64).sum(dim=0).tolist())
    winners = (int(torch.unique(rec["tri"][rec["tri"] >= 0]).numel())
               if SHADE_RECORD_BYTES[kernel] else 0)
    touched = {"supernode_rows": int(rec["seen_nodes"].sum()),
               "triangle_records": int(rec["seen_records"].sum()),
               "fine_records": int(rec["seen_fine"].sum()),
               "shade_records": winners}
    table_bytes = (SNODE_ROW_BYTES * touched["supernode_rows"]
                   + TRI_RECORD_BYTES[kernel] * touched["triangle_records"]
                   + FINE_WORD_BYTES.get(kernel, 0) * touched["fine_records"]
                   + SHADE_RECORD_BYTES[kernel] * winners)
    moved = n_rays * (RAY_IN_BYTES + RAY_OUT_BYTES[kernel]) + table_bytes
    ops = (OPS_PER_SUPERNODE_POP * pops + OPS_PER_TRIANGLE_TEST * tests
           + OPS_PER_MASK_TEST * (mask_tests + fine_tests)
           + OPS_EPILOGUE[kernel] * n_rays)
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": moved, "table_bytes": table_bytes, "ops": ops,
            "touched": touched,
            "per_ray": {"supernode_pops": pops / n_rays,
                        "row_bodies": rows / n_rays,
                        "leaf_pops": leaves / n_rays,
                        "triangle_tests": tests / n_rays,
                        "mask_tests": mask_tests / n_rays,
                        "fine_tests": fine_tests / n_rays}}


def _timed_kernel(name, launcher, plain, n_rays, plain_rays):
    """Time the kernel alone over 50 launches of `launcher(False)`
    (kernel_launcher or anyhit_launcher with fixed arguments and
    counters=False) and `plain` over 3 calls; take the work counts from one
    launch of `launcher(True)`.  Print and return the kernel's entry."""
    kernel_ms = _time_ms(launcher(False)[0], 50)
    plain_ms = _time_ms(plain, 3)
    launch, rec = launcher(True)
    launch()
    bound = _bound(name, rec)
    print(f"{name}: {n_rays} rays, kernel {kernel_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms on {plain_rays} rays"
          f"{'' if plain_rays == n_rays else ' (a strided subset)'}; bound "
          f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
          f"({bound['bytes']:.4e} B, of them {bound['table_bytes']:.4e} B "
          "of tables: distinct "
          + ", ".join(f"{k} {v}" for k, v in bound["touched"].items())
          + f"; {bound['ops']:.4e} fp32 ops; per ray "
          + ", ".join(f"{k} {v:.2f}" for k, v in bound["per_ray"].items())
          + ")")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "plain_rays": plain_rays,
            "rays": n_rays, **bound}


def phase_prepare(device) -> dict:
    """Prepare paths L, T, F, S and F with multihit_k = 4 through
    prepare_scene, each under a host-only torch.profiler window that reads
    the host seconds of its steps (the `prepare_scene.*` and
    `prepare_tables.*` ranges)."""
    from torch.profiler import ProfilerActivity, profile

    from steeljax_torch.apps import kernel_parity

    scenes = {}
    for name in kernel_parity.PATH_SCENES + kernel_parity.FOLIAGE_SCENES:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            scenes[name] = kernel_parity.prepare_path_scene(name, device)
            total = time.perf_counter() - t0
        steps = {evt.key.split(".", 1)[1]: evt.cpu_time_total / 1e6
                 for evt in prof.key_averages()
                 if evt.key.startswith(("prepare_scene.", "prepare_tables."))}
        _, flat, tables = scenes[name]
        chunk = tables.chunks[0]
        print(f"prepare_scene {name}: {flat.source_tri_count} triangles, "
              f"{chunk.rows} padded, {chunk.bvh8.rows.shape[0]} BVH8 rows, "
              f"BVH8 depth {chunk.bvh8.depth}, shade mode "
              f"{tables.shade_mode}, alpha masked {tables.alpha_masked}, "
              f"multihit_k {tables.multihit_k}, fine mask rows "
              f"{chunk.fine_mask_rows is not None}, {total:.3f} s (scene "
              "construction included): "
              + ", ".join(f"{k} {v:.3f}" for k, v in steps.items()))
    return scenes


def phase_parity(device, scenes) -> dict:
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.apps import kernel_parity as kp

    results = kp.run(device, width=WIDTH, height=HEIGHT, scenes=scenes)
    if not results["ok"]:
        raise RuntimeError("kernel parity failed: " + ", ".join(
            k for k, v in results["variants"].items() if not v["ok"]))
    var = results["variants"]

    def max_err(names, fields=("max_t_delta", "max_normal_delta",
                               "max_tan_delta", "max_uv_delta")):
        return max(var[n].get(f, 0.0) for n in names for f in fields)

    kernels = {
        "K1": {"max_abs_err": max_err(
            ["flat_shade0_cull1", "flat_shade0_cull0", "flat_shade1",
             "flat_deterministic_exact", f"cornell_primary_{WIDTH}x{HEIGHT}",
             "cornell_bounce1"]),
            "tolerance": "|dt| < 2e-3, |dn| < 5e-3, hit mismatches <= "
                         "max(2, N/5000)"},
        "K3": {"max_abs_err": max_err(["flat_shade2", "stress_tex_primary"]),
               "tolerance": "|dt| < 2e-3, |dn|, |dtan|, |duv| < 5e-3, 0 "
                            "material mismatches"},
    }
    # An occlusion flag is 0 or 1: its error is the mismatch count, held to
    # max(2, N/5000).
    for name, names in (("K2", ("flat_anyhit", "sunlit_shadow")),
                        ("K2_dense", ("flat_anyhit_dense",
                                      "sunlit_shadow_dense"))):
        kernels[name] = {
            "max_abs_err": float(max(var[n]["hit_mismatches"] > 0
                                     for n in names)),
            "mismatches": {n: var[n]["hit_mismatches"] for n in names},
            "tolerance": "hit mismatches <= max(2, N/5000)"}
    kernels["K4"] = {
        "max_abs_err": max_err(["flat_alpha_mask", "flat_fine_mask",
                                "foliage_primary", "foliage_shadow"]),
        "tolerance": "|dt| < 2e-3, hit mismatches <= max(2, N/5000)"}
    names = ("flat_alpha_mask_anyhit", "flat_fine_mask_anyhit")
    kernels["K4_anyhit"] = {
        "max_abs_err": float(max(var[n]["hit_mismatches"] > 0
                                 for n in names)),
        "mismatches": {n: var[n]["hit_mismatches"] for n in names},
        "tolerance": "hit mismatches <= max(2, N/5000)"}
    kernels["K5"] = {
        "max_abs_err": max_err(["flat_multihit", "flat_multihit_masked",
                                "flat_multihit_fine", "foliage_multihit"],
                               ("max_t_delta", "max_uv_delta_same_tri")),
        "slot_mismatches": {n: var[n]["slot_mismatches"] for n in (
            "flat_multihit", "flat_multihit_masked", "flat_multihit_fine",
            "foliage_multihit")},
        "tolerance": "|dt| < 2e-3, |du|, |dv| < 5e-3 on equal tri ids, "
                     "slot mismatches <= max(2, N K/5000)"}

    # K1 on the Cornell primary rays (as the first slice measured it).
    _, ctables, cases = kp.cornell_cases(device, WIDTH, HEIGHT)
    chunk = ctables.chunks[0]
    o, d, tmn, tmx = cases["primary"]
    args = (chunk.bvh8, chunk.tris_packed, o, d, tmn, tmx, True,
            chunk.shade_packed, 1)
    kernels["K1"].update(_timed_kernel(
        "K1", lambda counters: ct.kernel_launcher(*args, counters=counters),
        lambda: ct.trace_nearest_bvh8_plain(*args), o.shape[0],
        o.shape[0]))
    kernels["K1"]["shapes"] = "Cornell primary rays, 1280x720"

    # K2 and K2-dense on path L's first-bounce shadow rays.
    scene, flat, tables = scenes["sunlit"]
    rays = kp.sunlit_shadow_case(scene, flat, tables, WIDTH, HEIGHT)
    subset = kp.strided_subset(rays, kp.SHADOW_SUBSET)
    for name, chunk, dense in (
            ("K2", tables.chunks[0], False),
            ("K2_dense", scenes["sunlit_dense"][2].chunks[0], True)):
        bvh8 = chunk.anyhit_bvh8 if dense else chunk.bvh8
        tris = chunk.anyhit_tris if dense else chunk.tris_packed
        kernels[name].update(_timed_kernel(
            name, lambda counters: ct.anyhit_launcher(
                bvh8, tris, *rays, dense=dense, counters=counters),
            lambda: ct.trace_any_bvh8_plain(bvh8, tris, *subset, dense),
            rays[0].shape[0], subset[0].shape[0]))
        kernels[name]["shapes"] = ("path L first-bounce shadow rays, "
                                   "1280x720")

    # K3 on path T's primary rays.
    scene, flat, tables = scenes["stress_tex"]
    chunk = tables.chunks[0]
    rays = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    subset = kp.strided_subset(rays, kp.TEX_SUBSET)
    args = (chunk.bvh8, chunk.tris_packed)
    kernels["K3"].update(_timed_kernel(
        "K3", lambda counters: ct.kernel_launcher(
            *args, *rays, True, chunk.shade_packed, 2, counters=counters),
        lambda: ct.trace_nearest_bvh8_plain(*args, *subset, True,
                                            chunk.shade_packed, 2),
        rays[0].shape[0], subset[0].shape[0]))
    kernels["K3"]["shapes"] = "path T primary rays, 1280x720"

    # K4, K4_anyhit and K5 on path F: its primaries, and for the any-hit
    # instance its first-bounce sun rays (the path traces those with K4's
    # nearest instance; the any-hit instance is held in parity only).
    scene, flat, tables = scenes["foliage"]
    chunk = tables.chunks[0]
    kw = dict(alpha_mask=True, fine_rows=chunk.fine_mask_rows)
    args = (chunk.bvh8, chunk.tris_packed)
    rays = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    cases = kp.foliage_cases(scene, flat, tables, WIDTH, HEIGHT)
    subset = cases["primary"]
    kernels["K4"].update(_timed_kernel(
        "K4", lambda counters: ct.kernel_launcher(
            *args, *rays, True, None, 0, counters=counters, **kw),
        lambda: ct.trace_nearest_bvh8_plain(*args, *subset, True, None, 0,
                                            **kw),
        rays[0].shape[0], subset[0].shape[0]))
    kernels["K4"]["shapes"] = ("path F primary rays, 1280x720, coarse and "
                               "fine masks")
    k_hits = kp.FOLIAGE_MULTIHIT_K
    kernels["K5"].update(_timed_kernel(
        "K5", lambda counters: ct.multihit_launcher(
            *args, *rays, k_hits, True, counters=counters, **kw),
        lambda: ct.trace_multihit_bvh8_plain(*args, *subset, k_hits, True,
                                             **kw),
        rays[0].shape[0], subset[0].shape[0]))
    kernels["K5"]["shapes"] = (f"path F primary rays, 1280x720, K = "
                               f"{k_hits}, coarse and fine masks")
    shadow = kp.foliage_shadow_case(scene, flat, tables, WIDTH, HEIGHT)
    kernels["K4_anyhit"].update(_timed_kernel(
        "K4_anyhit", lambda counters: ct.anyhit_launcher(
            *args, *shadow, counters=counters, **kw),
        lambda: ct.trace_any_bvh8_plain(*args, *cases["shadow"], **kw),
        shadow[0].shape[0], cases["shadow"][0].shape[0]))
    kernels["K4_anyhit"]["shapes"] = ("path F first-bounce sun rays, "
                                      "1280x720, coarse and fine masks")
    return kernels


def _png_pixels(path: Path) -> np.ndarray:
    """Decode an 8-bit RGB PNG with filter type 0 rows (io.image.write_png
    output)."""
    data = path.read_bytes()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"),
                    int.from_bytes(body[0:4], "big"))
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        size[0], -1)
    if (rows[:, 0] != 0).any():
        raise ValueError("unexpected PNG row filter")
    return rows[:, 1:].reshape(size[0], size[1], 3)


def _kernel_of(key: str) -> str | None:
    """The trace kernel a profiler event belongs to, from the kernel's name
    and the template arguments of its instance (trace8_kernel: ANY_HIT,
    DENSE, SHADE2, COUNT, ALPHA, FINE)."""
    if "multihit8_kernel" in key:
        return "K5"
    if "trace8_kernel<" not in key:
        return None
    args = key.split("trace8_kernel<", 1)[1].split(">", 1)[0]
    flags = [a.strip() == "true" for a in args.split(",")]
    if len(flags) != 6:
        return "trace"
    any_hit, dense, shade2, _, alpha, _ = flags
    if alpha:
        return "K4_anyhit" if any_hit else "K4"
    if any_hit:
        return "K2_dense" if dense else "K2"
    return "K3" if shade2 else "K1"


def _profile_frames(run_frame, frames: int = 2) -> dict:
    """Device time of `frames` frames under torch.profiler: per frame, the
    summed device time of all kernels, of each trace kernel and of the
    largest device kernels, the number of device kernels, the calls of
    SYNC_CALLS (the window's closing synchronize adds one cudaDeviceSynchronize
    per `frames`), and the host wall time under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            run_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0 / frames
    busy = 0.0
    kernels = 0
    syncs = dict.fromkeys(SYNC_CALLS, 0.0)
    trace: dict = {}
    top = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and \
                not evt.is_user_annotation:
            busy += evt.self_device_time_total
            kernels += evt.count
            top.append((evt.self_device_time_total / 1000.0 / frames,
                        evt.count / frames, evt.key))
            kernel = _kernel_of(evt.key)
            if kernel:
                trace[kernel] = (trace.get(kernel, 0.0)
                                 + evt.self_device_time_total / 1000.0
                                 / frames)
        elif evt.key in syncs:
            syncs[evt.key] += evt.count / frames
    return {"wall_ms": wall_ms, "busy_ms": busy / 1000.0 / frames,
            "kernels": kernels / frames, "syncs": syncs,
            "trace_ms": trace, "top": sorted(top, reverse=True)[:6]}


def _reset_launches() -> None:
    from steeljax_torch.accel import cuda_traverse

    for name in cuda_traverse.LAUNCHES:
        cuda_traverse.LAUNCHES[name] = 0


def drive_path(label, scene, flat, tables, expected: dict,
               frames: int = TIMED_FRAMES) -> dict:
    """Render one warm and `frames` timed 1280x720 frames of a prepared
    scene through render_pixels, with the launch counts set to 0 just
    before and read just after; check the launches (each kernel of
    `expected` launches that many times per bounce, every other kernel
    never), rays_traced, the image and, above the repack threshold, the
    sorts (the repack before every secondary bounce and, in alpha-tested
    scenes, the rejected-first compaction of every material and shadow
    ray's re-trace); profile 2 more frames.  In alpha-tested scenes print
    the rays still to re-trace before and after each re-trace pass of the
    first timed frame.  Returns the launches, ms/frame and rays/s."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt import integrator

    device = flat.device
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    config = RenderConfig(width=WIDTH, height=HEIGHT)
    px, py, _ = integrator.tiled_order(WIDTH, HEIGHT)
    px, py, inverse_view, inverse_proj = (
        torch.as_tensor(a, device=device)
        for a in (px, py, frame.inverse_view, frame.inverse_proj))

    def step(accum_index):
        return integrator.render_pixels(
            flat, tables, inverse_view, inverse_proj, frame.camera_near,
            frame.camera_far, WIDTH, HEIGHT, px, py, accum_index, 0, config,
            return_stats=True)

    # Count the repacks through the module attribute trace_paths calls.
    repack = integrator.repack_rays
    sorts = [0]

    def counting_repack(*args):
        sorts[0] += 1
        return repack(*args)

    integrator.repack_rays = counting_repack
    try:
        _reset_launches()
        result, stats = step(0)  # warm frame
        torch.cuda.synchronize()
        rays = []
        t0 = time.perf_counter()
        for i in range(frames):
            result, stats = step(i + 1)
            if i == 0:
                retraces = stats["alpha_retrace"]
            rays.append(stats["rays_traced"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = dict(cuda_traverse.LAUNCHES)
    finally:
        integrator.repack_rays = repack

    total = 1 + frames
    bounces = config.max_bounce_count
    for name, count in launches.items():
        want = total * bounces * expected.get(name, 0)
        if count != want:
            raise RuntimeError(f"{label}: {name} launched {count} times "
                               f"over {total} frames, expected {want}")
    repacks = integrator._total_triangles(tables) > integrator.REPACK_MIN_TRIS
    traced = 1 + (flat.light_count > 0)  # material and shadow rays
    compacts = (flat.any_alpha_test
                and integrator._Compaction(tables, WIDTH * HEIGHT).active)
    want_sorts = total * ((bounces - 1 if repacks else 0)
                          + (bounces * traced if compacts else 0))
    if sorts[0] != want_sorts:
        raise RuntimeError(f"{label}: {sorts[0]} repacks over {total} "
                           f"frames, expected {want_sorts}")
    pixels = WIDTH * HEIGHT
    per_frame = [float(r) for r in rays]
    for r in per_frame:
        if not 0.5 * pixels <= r <= 40 * pixels:
            raise RuntimeError(f"{label}: rays_traced implausible: {r} for "
                               f"{pixels} pixels")
    image = result.cpu().numpy()
    if image.shape != (pixels, 3) or not np.isfinite(image).all():
        raise RuntimeError(f"{label}: bad frame {image.shape}")
    if float(image.std()) <= 0.0:
        raise RuntimeError(f"{label}: constant frame")
    ms_frame = elapsed * 1000.0 / frames
    rays_per_s = sum(per_frame) / elapsed
    print(f"{label} {WIDTH}x{HEIGHT}: {ms_frame:.3f} ms/frame, "
          f"{rays_per_s:.6e} rays/s ({sum(per_frame) / frames:.0f} "
          f"rays/frame, rays_traced counting shadow rays), launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f" over {total} frames x {config.max_bounce_count} bounces ("
          + ", ".join(f"{k} {launches[k] / total:.0f}" for k in expected)
          + f" per frame), {sorts[0]} sorts, image mean "
          f"{float(image.mean()):.4f}")
    if flat.any_alpha_test:
        # One entry per material or shadow trace: the rays still rejected
        # before pass 1, then after each pass.
        calls = [(name, [int(c) for c in counts])
                 for name, counts in retraces]
        print(f"{label} first timed frame, rays to re-trace before and "
              f"after each of the {config.max_alpha_retrace} passes, by "
              "trace call in bounce order: "
              + "; ".join(f"{name} {counts}" for name, counts in calls))

    prof = _profile_frames(lambda: step(total))
    if prof["busy_ms"] > 0.0:
        share = sum(prof["trace_ms"].values())
        print(f"{label} torch.profiler, per frame: device busy "
              f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall "
              f"under the profiler (idle share "
              f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.3f}); "
              f"{prof['kernels']:.0f} device kernels, "
              + ", ".join(f"{k} {v:.1f}" for k, v in prof["syncs"].items())
              + "; trace "
              f"kernels {share:.3f} ms = "
              f"{100.0 * share / prof['busy_ms']:.1f}% of device time, "
              f"{100.0 * share / ms_frame:.1f}% of the unprofiled frame ("
              + ", ".join(f"{k} {v:.3f} ms" for k, v in
                          sorted(prof["trace_ms"].items())) + ")")
        for ms, count, key in prof["top"]:
            print(f"  {ms:8.3f} ms/frame in {count:6.0f} launches: "
                  f"{key[:90]}")
    else:
        print(f"{label}: torch.profiler recorded no device time: kernel "
              "share and idle share not measured")
    return {"launches": launches, "ms_frame": ms_frame,
            "rays_per_s": rays_per_s}


def phase_cornell(device) -> dict:
    from steeljax_torch.apps import render_cli
    from steeljax_torch.render.pt.renderer import prepare_scene
    from steeljax_torch.scene.builtin import make_cornell_scene

    t0 = time.perf_counter()
    scene = make_cornell_scene(sphere_detail=12)
    flat, tables = prepare_scene(scene, device, env_resolution=64)
    print(f"prepare_scene: {flat.source_tri_count} triangles, "
          f"{tables.bvh8.rows.shape[0]} BVH8 rows, depth "
          f"{tables.bvh8.depth}, {time.perf_counter() - t0:.3f} s")
    out = drive_path("Cornell", scene, flat, tables, {"K1": 1})

    with tempfile.TemporaryDirectory() as tmp:
        png_path = Path(tmp) / "cornell.png"
        render_cli.main(["builtin:cornell", "-o", str(png_path), "--size",
                         "64x36", "--spp", "2", "--device", "cuda"])
        png = _png_pixels(png_path)
        if png.shape != (36, 64, 3) or png.std() == 0:
            raise RuntimeError(f"render_cli PNG bad: {png.shape}, "
                               f"std {png.std()}")
        print(f"render_cli: 64x36 PNG, mean {png.mean():.2f}, "
              f"std {png.std():.2f}")
    return out


def phase_cross_device(device) -> None:
    """32x18 tiles on the card against the port on the CPU: the
    __graft_entry__ Cornell tile, the lit parity scene, and a small foliage
    scene (300 serrated leaf cards in a 6 x 6 region, coarse and fine
    masks) seen from inside the canopy, as tests/test_torch_foliage_slice.py
    renders it."""
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt.integrator import render_pixels
    from steeljax_torch.render.pt.renderer import prepare_scene
    from steeljax_torch.scene.builtin import (make_cornell_scene,
                                              make_foliage_scene,
                                              make_parity_scene)

    def foliage():
        scene = make_foliage_scene(cards=300, region=3.0)
        scene.camera_location = camera_lib.CameraLocation(
            position=np.array([0.0, 1.5, 6.0], np.float32),
            direction=np.array([0.0, 0.0, -1.0], np.float32),
            up=camera_lib.UP)
        return scene

    ys, xs = np.meshgrid(np.arange(TILE_H), np.arange(TILE_W), indexing="ij")
    # A diverging pixel may trace up to `per_pixel` rays more or fewer: 4
    # segments, and with a light 4 shadow rays too.
    for label, make, per_pixel in (
            ("Cornell", lambda: make_cornell_scene(6), 4),
            ("parity (lit)", lambda: make_parity_scene(4), 8),
            ("foliage (alpha)", foliage, 8)):
        outs = {}
        prepared = {}
        for dev in (device, "cpu"):
            scene = make()
            flat, tables = prepare_scene(scene, dev, env_resolution=16)
            prepared[str(dev)] = tables.chunks[0]
            frame = camera_lib.make_frame(scene.camera_location,
                                          scene.camera_projection)
            result, stats = render_pixels(
                flat, tables, frame.inverse_view, frame.inverse_proj, 0.01,
                100.0, TILE_W, TILE_H, xs.reshape(-1), ys.reshape(-1), 0, 0,
                RenderConfig(width=TILE_W, height=TILE_H),
                return_stats=True)
            outs[str(dev)] = (result.cpu().numpy(),
                              float(stats["rays_traced"]))
        # Both devices build the same tables (the alpha masks are computed
        # on each device).
        for name in ("tris_packed", "fine_mask_rows"):
            a, b = (getattr(prepared[k], name) for k in (str(device), "cpu"))
            if (a is None) != (b is None) or (
                    a is not None and not torch.equal(a.cpu(), b)):
                raise RuntimeError(f"{label}: {name} differ between the "
                                   "card and the CPU")
        (gpu, gpu_rays), (cpu, cpu_rays) = outs[str(device)], outs["cpu"]
        diverging = int((np.abs(gpu - cpu).max(axis=-1) > PIXEL_ATOL).sum())
        n = TILE_W * TILE_H
        print(f"{label} tile {TILE_W}x{TILE_H}: card vs CPU max |delta| "
              f"{float(np.abs(gpu - cpu).max()):.3e}, {diverging} of {n} "
              f"pixels beyond {PIXEL_ATOL}, rays_traced {gpu_rays} vs "
              f"{cpu_rays}")
        if diverging > max(2, n // 200) or \
                abs(gpu_rays - cpu_rays) > per_pixel * diverging:
            raise RuntimeError(f"the card's {label} tile diverges from the "
                               "CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on the GPU")
    import steeljax_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    seconds = {}

    def phase(title, fn, *args):
        print(f"== {title}")
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[title] = time.perf_counter() - t0
        print(f"-- {title}: {seconds[title]:.1f} s")
        return out

    smi = phase("1. device and toolchain", phase_device)
    phase("2. build", phase_build)
    scenes = phase("3a. prepare paths L, T, F, S and F multihit",
                   phase_prepare, device)
    kernels = phase("3b. parity and kernel times", phase_parity, device,
                    scenes)
    cornell = phase("4. Cornell main path", phase_cornell, device)
    path_l = phase("5a. path L (sunlit stress)", drive_path, "path L",
                   *scenes["sunlit"], {"K1": 1, "K2": 1})
    path_l_dense = phase("5b. path L, dense any-hit tables", drive_path,
                         "path L dense", *scenes["sunlit_dense"],
                         {"K1": 1, "K2_dense": 1})
    path_t = phase("6. path T (textured stress)", drive_path, "path T",
                   *scenes["stress_tex"], {"K3": 1})
    # Each bounce traces its material rays and its sun rays, each in one
    # pass and max_alpha_retrace = 4 re-trace passes.
    alpha_passes = 2 * (1 + 4)
    path_f = phase("7a. path F (foliage, serrated leaves)", drive_path,
                   "path F", *scenes["foliage"], {"K4": alpha_passes})
    path_s = phase("7b. path S (foliage, solid leaves)", drive_path,
                   "path S", *scenes["foliage_solid"], {"K4": alpha_passes})
    path_fm = phase("7c. path F, multihit_k = 4", drive_path,
                    "path F multihit", *scenes["foliage_multihit"],
                    {"K5": alpha_passes})
    phase("8. cross-device tiles", phase_cross_device, device)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items()))

    launches = {"K1": cornell["launches"]["K1"],
                "K2": path_l["launches"]["K2"],
                "K2_dense": path_l_dense["launches"]["K2_dense"],
                "K3": path_t["launches"]["K3"],
                "K4": path_f["launches"]["K4"],
                "K4_anyhit": max(p["launches"]["K4_anyhit"] for p in (
                    path_f, path_s, path_fm)),
                "K5": path_fm["launches"]["K5"]}
    sources = {k: "steeljax_torch/csrc/traverse8.cu" for k in launches}
    sources["K5"] = "steeljax_torch/csrc/multihit8.cu"
    titles = {
        "K1": "K1 trace_nearest8 (BVH8 nearest hit, cull, shade mode 1)",
        "K2": "K2 trace_any8 (BVH8 any-hit occlusion, 12-record rows)",
        "K2_dense": "K2-dense trace_any8 (any-hit occlusion, dense "
                    "14-record rows)",
        "K3": "K3 trace_nearest8 (nearest hit, textured shade mode 2)",
        "K4": "K4 trace_nearest8 (nearest hit with alpha masks, coarse and "
              "fine)",
        "K4_anyhit": "K4 trace_any8 (any-hit occlusion with alpha masks)",
        "K5": "K5 trace_multihit8 (K nearest hits with alpha masks and the "
              "opaque bound)"}
    replaces = {
        "K1": "steeljax/accel/pallas_traverse.py:249",
        "K2": "steeljax/accel/pallas_traverse.py:506",
        "K2_dense": "steeljax/accel/pallas_traverse.py:781",
        "K3": "steeljax/accel/pallas_traverse.py:548",
        "K4": "steeljax/accel/pallas_traverse.py:457",
        "K4_anyhit": "steeljax/accel/pallas_traverse.py:506",
        "K5": "steeljax/accel/pallas_traverse.py:812"}
    print(json.dumps({"kernels": [{
        "name": titles[k], "route": "cuda", "source": sources[k],
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": kernels[k]["max_abs_err"],
        "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"],
        "bound_ms": kernels[k]["bound_ms"],
        "bound_by": kernels[k]["bound_by"], "library_ms": None,
        "tolerance": kernels[k]["tolerance"],
        "shapes": kernels[k]["shapes"], "rays": kernels[k]["rays"],
        "plain_rays": kernels[k]["plain_rays"]}
        for k in launches]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
