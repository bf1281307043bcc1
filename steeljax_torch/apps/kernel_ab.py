"""Old against new for the two-level kernel K6 and the treelet kernel K7,
on one card.

The earlier kernels are built from a `csrc` directory of an earlier commit
into a library of their own, with the same nvcc flags, and called through
their own C entries on the same tables and rays as this tree's, each call
timed in turns (old, new, new, old); per call it prints both times and how
far the outputs agree (hit or flag mismatches, tri ids equal where both
hit, and of those that differ the ones at exactly equal t, |delta t|).

  * K6 (csrc/instanced8.cu) against the earlier two-level kernel (scalar
    4-byte loads of child boxes, 40-byte records and instance rows): path
    I's primaries and first-bounce shadow rays and path J's primaries, by
    CUDA events over timing.REPS launches, with the per-ray work counts of
    both.
  * K7 (csrc/treelet8.cu) and its scheduler against the earlier ones (the
    reference's loop in torch code over all N rays every round, one host
    read of the packets-left flag per round, every ray launched every
    round, 4,096-ray packets) with the earlier round kernel: one whole trace
    of path U's and of path UL's primaries and of path UL's first-bounce
    shadow rays, wall ms per trace ending in a synchronize, and this tree's
    device ms of the trace (timing.trace_device_ms).
Then the ptxas registers of the earlier library's K6 and K7 instances
beside this tree's, and whether K1-K3 kept theirs.

Usage, on the card, from the repository root (`_archive/` is not tracked):
    mkdir -p _archive/parent
    git archive 233eaca steeljax_torch/csrc | tar -x -C _archive/parent
    python -m steeljax_torch.apps.kernel_ab \\
        --old _archive/parent/steeljax_torch/csrc
It first holds this tree's K6 and K7 against their plain versions
(kernel_parity's instanced and treelet variants).  chip_smoke.py --ab-old
DIR runs the same comparison on its prepared paths, without that step.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from steeljax_torch.apps.timing import time_ms, trace_device_ms, wall_ms

OLD_LIBRARY = "libsteeljax_torch_cuda_old.so"


def build_old(src_dir) -> ctypes.CDLL:
    """The earlier traverse8.cu (K1-K3 and the treelet round K7) and
    instanced8.cu (K6) of `src_dir` (commit 233eaca's layout), built into a
    library of their own."""
    from steeljax_torch import native

    src_dir = Path(src_dir)
    sources = [src_dir / "traverse8.cu", src_dir / "instanced8.cu"]
    for src in sources:
        if not src.is_file():
            raise FileNotFoundError(f"{src} not found: --old names the "
                                    "earlier kernels' csrc directory")
    target = native.BUILD_DIR / OLD_LIBRARY
    native.build_cuda(target, sources)
    lib = ctypes.CDLL(str(target))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for entry, n_ptr, n_int in (("steeljax_trace_inst8", 23, 8),
                                ("steeljax_trace_treelet8", 21, 11)):
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
    return lib


def _agreement(query: str, old: dict, new: dict) -> str:
    """How far two kernels' outputs agree: hit (or slot) mismatches, tri
    ids equal where both hit (and of the rays whose ids differ, those at
    exactly the same t: a tie settled otherwise), and the largest |delta t|
    there."""
    if query == "any":
        return f"{int((old['hit'] != new['hit']).sum())} flag mismatches"
    hit_o, hit_n = old["tri"] >= 0, new["tri"] >= 0
    both = hit_o & hit_n
    same = both & (old["tri"] == new["tri"])
    differ = both & ~same
    dt = (old["t"] - new["t"]).abs()[both]
    kind = "slot" if query == "multihit" else "hit"
    return (f"{int((hit_o != hit_n).sum())} {kind} mismatches of "
            f"{int(hit_o.sum())} hits, tri equal on "
            f"{100.0 * int(same.sum()) / max(int(both.sum()), 1):.3f}% "
            f"({int(differ.sum())} differ, "
            f"{int((differ & (old['t'] == new['t'])).sum())} of them at "
            f"equal t), max |delta t| "
            f"{float(dt.max()) if dt.numel() else 0.0:.3e}")


def _per_ray(rec: dict, names=None) -> dict:
    from steeljax_torch.accel.cuda_traverse import COUNTERS

    mean = rec["counters"].to(torch.float64).mean(dim=0).tolist()
    return dict(zip(names or COUNTERS, mean))


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def old_inst_launcher(lib, tables, rays, cull: bool, any_hit: bool,
                      counters: bool = False):
    """(launch, rec) of the earlier two-level kernel, as
    cuda_traverse.inst_launcher, over the reference's 40-byte records."""
    from steeljax_torch.accel import cuda_traverse as ct

    device = tables.tris_packed.device
    o, d, tmn, tmx = ct._rays_and_interval(*rays, device)
    n = o.shape[0]
    mode = 0 if any_hit else tables.shade_mode
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    if any_hit:
        rec = {"hit": torch.empty(n, dtype=torch.bool, device=device)}
    else:
        rec = {"t": torch.empty(n, **f32), "u": torch.empty(n, **f32),
               "v": torch.empty(n, **f32), "tri": torch.empty(n, **i32),
               "inst": torch.empty(n, **i32)}
    if mode:
        rec["n"] = torch.empty((n, 3), **f32)
        rec["mat"] = torch.empty(n, **i32)
    if mode == 2:
        rec["tan"] = torch.empty((n, 3), **f32)
        rec["uv"] = torch.empty((n, 2), **f32)
        rec["uvd"] = torch.empty(n, **f32)
    if counters:
        rec.update(ct._telemetry_sized(n, tables.snode_rows.shape[0],
                                       tables.tris_packed.shape[0]
                                       * ct.TRI_PER_ROW, device))
        rec["seen_inst"] = torch.zeros(tables.inst_trace.shape[0],
                                       dtype=torch.uint8, device=device)

    def ptr(name):
        return rec[name].data_ptr() if name in rec else None

    args = (tables.snode_rows.data_ptr(), tables.tris_packed.data_ptr(),
            tables.inst_trace.data_ptr(),
            ct._ptr(tables.shade_rows if mode else None), o.data_ptr(),
            d.data_ptr(), tmn.data_ptr(), tmx.data_ptr(), ptr("t"), ptr("u"),
            ptr("v"), ptr("tri"), ptr("inst"), ptr("n"), ptr("mat"),
            ptr("tan"), ptr("uv"), ptr("uvd"), ptr("hit"), ptr("counters"),
            ptr("seen_nodes"), ptr("seen_records"), ptr("seen_inst"), n,
            int(tables.n_tlas), tables.inst_trace.shape[0], tables.max_leaf,
            tables.depth, int(cull), mode, int(any_hit))
    keep = (tables.snode_rows, tables.tris_packed, tables.inst_trace,
            tables.shade_rows, o, d, tmn, tmx, *rec.values())

    def launch():
        status = lib.steeljax_trace_inst8(
            *args, torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"earlier K6: CUDA error {status}")

    launch.tensors = keep
    return launch, rec


def k6_cases(scenes: dict, width: int, height: int) -> list:
    """[(label, tables, rays, cull, any_hit)]: path I's primaries and
    first-bounce shadow rays, path J's primaries."""
    from steeljax_torch.apps import kernel_parity as kp

    scene, flat, tables = scenes["sunlit_inst"]
    device = flat.device
    scene_j, _, tables_j = scenes["stress_tex_inst"]
    return [
        ("K6 path I primaries", tables,
         kp.tiled_primary(scene, device, width, height)[:4], True, False),
        ("K6 any-hit path I first-bounce shadow rays", tables,
         kp.sunlit_shadow_case(scene, flat, tables, width, height), False,
         True),
        ("K6 mode 2 path J primaries", tables_j,
         kp.tiled_primary(scene_j, device, width, height)[:4], True, False)]


def run_k6(lib, scenes: dict, width: int, height: int) -> dict:
    """K6 against the earlier kernel on k6_cases, timed in turns (old, new,
    new, old); per-ray work counts of both designs."""
    from steeljax_torch.accel import cuda_traverse as ct

    out = {}
    for label, tables, rays, cull, any_hit in k6_cases(scenes, width,
                                                        height):
        query = "any" if any_hit else "nearest"
        launches = {
            "old": old_inst_launcher(lib, tables, rays, cull, any_hit),
            "new": ct.inst_launcher(tables, *rays, cull, any_hit)}
        for launch, _ in launches.values():
            launch()
        torch.cuda.synchronize()
        agree = _agreement(query, launches["old"][1], launches["new"][1])
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(time_ms(launches[who][0]))
        counts = {}
        for who, make in (("old", lambda: old_inst_launcher(
                lib, tables, rays, cull, any_hit, counters=True)),
                ("new", lambda: ct.inst_launcher(
                    tables, *rays, cull, any_hit, counters=True))):
            launch, rec = make()
            launch()
            counts[who] = _per_ray(rec, ct.INST_COUNTERS)
        out[label] = {"ms": turns, "per_ray": counts, "agree": agree}
        print(f"A/B {label}: {rays[0].shape[0]} rays; old "
              + " / ".join(f"{x:.4f}" for x in turns["old"]) + " ms, new "
              + " / ".join(f"{x:.4f}" for x in turns["new"])
              + f" ms (old, new, new, old); old/new "
              f"{sum(turns['old']) / sum(turns['new']):.2f}x; {agree}")
        for who, per in counts.items():
            print(f"  per ray, {who}: " + ", ".join(
                f"{k} {v:.2f}" for k, v in per.items()))
    return out


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def old_treelet_trace(lib, tt, rays, cull: bool, any_hit: bool,
                      block: int = 4096) -> dict:
    """One trace through the earlier scheduler (its loop as of commit
    233eaca: the reference's, in torch code over all N rays every round,
    with a host read of the packets-left flag before every round) with the
    earlier round kernel."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel import treelets
    from steeljax_torch.core.constants import RAY_DEAD_T

    o, d, t_min, t_max = rays
    device = o.device
    n = o.shape[0]
    state = treelets.treelet_state(tt, o, d, t_min, t_max, any_hit, block)
    o, d, t_min, t_far = state.o, state.d, state.t_min, state.t_far
    padded, k = o.shape[0], tt.count
    mode = 0 if any_hit else tt.shade_mode
    entry = state.entry
    visited = ~torch.isfinite(entry)
    rec = {key: value.clone() for key, value in state.rec.items()}
    if not any_hit:
        rec["hit"] = torch.zeros(padded, dtype=torch.bool, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    shade = tt.shade_stack if mode else None
    tri_rows = tt.tri_stack.shape[1]

    def round_kernel(pid, t_max):
        if any_hit:
            rk = {"hit": torch.empty(padded, dtype=torch.bool,
                                     device=device)}
        else:
            rk = {"t": torch.empty(padded, **f32),
                  "u": torch.empty(padded, **f32),
                  "v": torch.empty(padded, **f32),
                  "tri": torch.empty(padded, **i32)}
        if mode:
            rk["n"] = torch.empty((padded, 3), **f32)
            rk["mat"] = torch.empty(padded, **i32)
        if mode == 2:
            rk["tan"] = torch.empty((padded, 3), **f32)
            rk["uv"] = torch.empty((padded, 2), **f32)
            rk["uvd"] = torch.empty(padded, **f32)

        def ptr(name):
            return rk[name].data_ptr() if name in rk else None

        status = lib.steeljax_trace_treelet8(
            tt.node_stack.data_ptr(), tt.tri_stack.data_ptr(),
            ct._ptr(shade), pid.data_ptr(), o.data_ptr(), d.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), ptr("t"), ptr("u"),
            ptr("v"), ptr("tri"), ptr("n"), ptr("mat"), ptr("tan"),
            ptr("uv"), ptr("uvd"), ptr("hit"), None, None, None, padded,
            block, k, tt.node_stack.shape[1], tri_rows, tt.max_leaf,
            tt.depth, int(cull), mode, int(tt.alpha_mask), int(any_hit),
            torch.cuda.current_stream(device).cuda_stream)
        if status != 0:
            raise RuntimeError(f"earlier K7: CUDA error {status}")
        if not any_hit:
            rk["hit"] = rk["tri"] >= 0
        return rk

    treelet_ids = torch.arange(k, dtype=torch.int32, device=device)
    pid = treelets._next_pid(entry, visited, t_far, block)
    for _ in range(k):
        if not bool((pid < k).any()):
            break
        pid_safe = pid.clamp(max=k - 1)
        done_ray = (pid >= k).repeat_interleave(block)
        rk = round_kernel(pid_safe, torch.where(done_ray, RAY_DEAD_T, t_far))
        if any_hit:
            rec["hit"] = rec["hit"] | rk["hit"]
            t_far = torch.where(rec["hit"], RAY_DEAD_T, t_far)
        else:
            off = tt.tri_offsets[pid_safe.long()].repeat_interleave(block)
            rk["tri"] = torch.where(rk["hit"], rk["tri"] + off, -1)
            better = rk["hit"] & (~rec["hit"] | (rk["t"] < rec["t"]))
            rec = {key: torch.where(
                better if rec[key].dim() == 1 else better[:, None],
                rk[key], rec[key]) for key in rec}
            t_far = torch.where(better, rk["t"], t_far)
        pid_ray = pid_safe.repeat_interleave(block)
        visited = visited | (pid_ray[:, None] == treelet_ids[None, :])
        pid = treelets._next_pid(entry, visited, t_far, block)
    return {key: value[:n] for key, value in rec.items()}


def k7_cases(scenes: dict, width: int, height: int) -> list:
    """[(label, tables, rays, cull, any_hit)]: one whole trace of path U's
    primaries, of path UL's primaries and of path UL's first-bounce shadow
    rays."""
    from steeljax_torch.apps import kernel_parity as kp

    scene_u, flat_u, tables_u = scenes["stress_tex_treelets"]
    scene, flat, tables = scenes["sunlit_treelets"]
    device = flat.device
    return [
        ("K7 mode 2 path U primaries", tables_u.treelets,
         kp.tiled_primary(scene_u, device, width, height)[:4], True, False),
        ("K7 mode 1 path UL primaries", tables.treelets,
         kp.tiled_primary(scene, device, width, height)[:4], True, False),
        ("K7 any-hit path UL first-bounce shadow rays", tables.treelets,
         kp.sunlit_shadow_case(scene, flat, tables, width, height), False,
         True)]


def run_k7(lib, scenes: dict, width: int, height: int) -> dict:
    """K7 and its scheduler against the earlier ones on k7_cases: wall ms
    of one trace in turns (old, new, new, old), the records compared, and
    this tree's device ms of the trace."""
    from steeljax_torch.accel import treelets

    out = {}
    for label, tt, rays, cull, any_hit in k7_cases(scenes, width, height):
        query = "any" if any_hit else "nearest"
        traces = {
            "old": lambda: old_treelet_trace(lib, tt, rays, cull, any_hit),
            "new": lambda: treelets.trace_treelets(tt, *rays, cull,
                                                   any_hit)}
        agree = _agreement(query, traces["old"](), traces["new"]())
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            turns[who].append(wall_ms(traces[who]))
        device = trace_device_ms(tt, rays, cull, any_hit)
        out[label] = {"wall_ms": turns, "device_ms": device, "agree": agree}
        print(f"A/B {label}: {rays[0].shape[0]} rays, {tt.count} treelets; "
              "wall ms of one trace: old "
              + " / ".join(f"{x:.4f}" for x in turns["old"]) + ", new "
              + " / ".join(f"{x:.4f}" for x in turns["new"])
              + f" (old, new, new, old); old/new "
              f"{sum(turns['old']) / sum(turns['new']):.2f}x; new device "
              f"{device:.4f} ms (pick and {tt.count} rounds); {agree}")
    return out


def run(scenes: dict, old_dir, width: int = 1280, height: int = 720) -> dict:
    """Build the earlier kernels from `old_dir` and time them against this
    tree's: K6 on paths I and J (scenes["sunlit_inst"],
    scenes["stress_tex_inst"]), K7 on paths U and UL
    (scenes["stress_tex_treelets"], scenes["sunlit_treelets"]).  Print
    every number and return {"K6": ..., "K7": ..., "old_ptxas": ...}."""
    from steeljax_torch import native

    lib = build_old(old_dir)
    return {"old_ptxas": native.ptxas_table(
                native.BUILD_LOGS.get(OLD_LIBRARY, "")),
            "K6": run_k6(lib, scenes, width, height),
            "K7": run_k7(lib, scenes, width, height)}


def compare_ptxas(old: dict, new: dict) -> None:
    """Print the earlier library's K6 and K7 instances beside this tree's,
    and whether the K1-K3 instances of traverse8.cu kept their
    registers."""
    same, changed = 0, []
    for name, entry in sorted(old.items()):
        if not name.startswith("trace8_kernel<"):
            continue
        flags = name[len("trace8_kernel<"):-1].split(", ")
        # The earlier K1-K3 instances, with their TREELET flag false.
        if any(f == "true" for f in flags[4:]):
            continue
        key = "trace8_kernel<" + ", ".join(flags[:4]) + ">"
        if key not in new:
            changed.append(f"{key} missing")
        elif new[key][0] == entry[0]:
            same += 1
        else:
            changed.append(f"{key} {entry[0]} -> {new[key][0]}")
    print(f"ptxas, K1-K3 instances against the earlier library: {same} "
          "with the same registers"
          + ("; " + "; ".join(changed) if changed else ""))
    for label, table in (("earlier", old), ("this tree", new)):
        for name, (regs, frame, st, ld, smem) in sorted(table.items()):
            earlier_k7 = (name.startswith("trace8_kernel<")
                          and name[:-1].split(", ")[-1] == "true")
            if "inst8_kernel" in name or "treelet" in name or earlier_k7:
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
    native.cuda_library()
    new_ptxas = native.ptxas_table(
        native.BUILD_LOGS.get("libsteeljax_torch_cuda.so", ""))
    scenes = {name: kp.prepare_path_scene(name, device)
              for name in kp.INSTANCED_SCENES + kp.TREELET_SCENES}
    variants: dict = {}
    soup, _, o, d = kp.soup_case(30000, 10240, device)
    o = torch.as_tensor(o, device=device)
    d = torch.as_tensor(d, device=device)
    ok = kp._instanced_variants(device, 10240, variants)
    ok &= kp._treelet_variants(device, o, d, 30000, variants)
    ok &= kp._k6_k7_path_variants(device, scenes, 1280, 720, variants)
    print("K6 and K7 against the plain versions: "
          + ("PASS" if ok else "FAIL: " + ", ".join(
              k for k, v in variants.items() if not v["ok"])))
    result = run(scenes, args.old)
    compare_ptxas(result["old_ptxas"], new_ptxas)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
