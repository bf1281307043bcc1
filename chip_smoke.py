"""Smoke test of the PyTorch port on one CUDA card (an H100).

Drives the port's paths through their user entry points (prepare_scene,
render_pixels, HybridRenderer) at 1280x720, 1 spp per frame, at most 4
bounces, roulette after bounce 2, irradiance clamp 8 (the hybrid frame at
1920x1080), and holds every hand-written trace kernel against its plain
PyTorch version (and, on every ray of the big paths, against the
reference's BVH walk: phase 20):
  * the Cornell box (kernel K1: nearest hit with fused mode-1 shading);
  * path L, the sunlit stress scene (208,084 triangles and a directional
    sun): K1 and, for the shadow rays of next-event estimation, the
    any-hit kernel K2; once more with the dense any-hit tables (K2-dense);
    every path-traced frame also runs each bounce's next-event estimation
    and BRDF sampling as the two path stage kernels of csrc/pathstage.cu
    (nee and sample), held on path L's frame bit for bit against their
    plain versions (phase 5c);
  * path T, the textured stress scene (1,320,868 triangles): K3, nearest
    hit with textured fused shading;
  * paths F and S, the JAX bench's foliage scenes (500,000 alpha-tested
    leaf cards over a ground quad, 1,000,002 triangles, a sun; serrated and
    solid leaves, coarse and fine alpha masks): K4, nearest hit with
    in-kernel alpha masks, for every material and shadow ray and each of
    their re-trace passes, each followed by the exact alpha test as the
    kernel of csrc/alphatest.cu, held on path F's frame bit for bit
    against its plain version (phase 5d); and path F once more with
    multihit_k = 4: K5, the K-nearest multi-hit kernel, in K4's place;
  * paths I and J, path L's and path T's scenes through the two-level
    structure (PathTracingRenderer(instancing=True): 310 and 490
    instances of three BLAS): K6, the two-level kernel, with fused mode-1
    shading and its any-hit query for the shadow rays on I, fused mode 2 on
    J; after path I's frames one entity moves and refresh_scene() rebuilds
    the instance tables alone;
  * path H, the hybrid frame (G-buffer, deferred lighting with the sun's
    shadow rays, forward composite) of path L's scene at the JAX bench's
    1920x1080: K1 for the G-buffer and K2 for the sun rays, one launch
    each a frame;
  * paths U and UL, path T's and path L's scenes prepared with
    treelets=True: K7, the treelet kernel, one launch per round of the
    treelet scheduler and K rounds per trace with no host read, after one
    launch of the scheduler's pick kernel (mode 2 on U; mode 1 and any-hit
    on UL);
  * path C, the sunlit stress scene at 960 instances of sphere detail 32
    (2,633,508 triangles: two chunks at dispatch.MAX_CHUNK_TRIS): K1 and
    K2 once per chunk per trace, through dispatch's chunk sweep, its frame
    held to the same scene prepared as one chunk;
  * path L16, path L's scene with 16-wide supernode rows
    (prepare_scene(snode_width=16)): K1 and K2 reading 16 children a pop;
  * a GLTF file of the Cornell box, written here, through render_cli
    --device cuda --validate;
  * the engine: Engine(instancing=True) over path L's scene with the
    TestSystem's prefab (that GLTF Cornell box) through the TestSystem's
    timeline, hybrid then path traced (K6 and its any-hit query only), the
    default engine (K1, K2), a checkpoint, and the apps (render_cli's
    flags, testsystem_demo, the viewer) in subprocesses;
  * path G, the light-volume GI on path L's scene at the reference's
    defaults (925 probes, 5,683,200 probe rays a sample, 8 spp): K1 and K2
    once a bounce of every sample of the probe capture, then path H's
    frame lit by the volume (the tet walk in the deferred lighting);
  * path R, path H's frame with STEELJAX_RASTER=1: the G-buffer's primary
    visibility rasterized, R (csrc/raster.cu, the tile stage of
    render/hybrid/raster.py: one thread block a 32x24 subtile) once a
    frame in K1's place, K2 for the sun rays;
  * paths LS, FS, IS and US, path L's, path F's, path I's and path U's
    scenes prepared with STEELJAX_SBVH=1 (the reference's switch: spatial
    splits, so a triangle may sit under several leaves, one record a
    slot): K1 and K2 on LS, K4 on FS and, with multihit_k = 4, K5 over the
    reference-list tables, K6 on IS (whose BLAS take no split) and on
    opaque leaf cards whose BLAS does, K7 on US;
  * STEELJAX_SHADE_MODE (the reference's cap on the flat nearest trace's
    fused shading) unset and at 0 on Cornell and paths L, T and H: K1 in
    shade mode 0 with the tri_shade row gather after it (on path T in
    K3's place), and the textured tables' cap of 1 refused.
Paths L, T, F, S, J, U, UL, C, L16, LS and FS are above the repack threshold
(path I's 310 instances of 544 records on average are not), so their rays
are repacked before every secondary bounce, and the alpha paths' re-traces
compact their rejected rays first.  Every phase raises on failure, so the
script exits non-zero; it refuses to run without a card.

Phases:
  1. device and toolchain (nvidia-smi, torch, CUDA, nvcc, g++);
  2. build of the BVH builder and the CUDA kernel library from the sources
     (the CUDA library even where a current one was built before), with
     ptxas' registers and spills for every kernel instance, a check that
     every instance of csrc/alpha8.cu's walk (K1-K5) and the raster
     kernel R spill no byte, and K2's and R's registers;
  3. preparation of paths L, T, F, S, F with multihit_k = 4, U, UL, C, C as
     one chunk and L16 through prepare_scene and of paths I and J through the
     renderer, each of these two with a refresh_scene() after an edit (host
     seconds by step); kernel parity, kernel against plain version
     (apps.kernel_parity, all 46 variants); each kernel's time alone at its
     path's shapes (K1 and K3 on primaries and on first-bounce rays, K1 on
     path H's G-buffer rays and K2 on its sun rays, K1 on path L16's
     primaries and first-bounce rays and K2 on its shadow rays, K1 on path
     C's primaries and K2 on its shadow rays over both chunks as the sweep
     launches them, each also held against its plain version on those rays;
     path L16's rows trace path L's rays, and path C's rows are timed beside
     one launch over the one-chunk tables), its plain version's time, its
     work counts (mask tests and instance enters included) and the least time
     the card could take for the same work (a dead ray, t_max < t_min, is
     charged its interval alone; the rows of paths L16 and C take the smaller
     of their own bound and that of path L's row or of the one-chunk launch
     on the same rays), for K7 the K rounds of one whole trace against the
     bound of that trace as one function (the trace's first pick is the pick
     kernel's entry);
  4. the Cornell main path: two warm frames (eager, then the CUDA graph's
     capture) and 4 timed ones (replays), K1's launches in the frames the
     host ran, the last replay bit-equal to the same frame run eagerly,
     the kernel's share of a frame, the render CLI;
  5. path L: the same frames and checks, K1 and K2 launches, then the
     frames with the dense any-hit tables (K2-dense launches); in every
     path-traced drive the stage kernels nee and sample launch once a
     bounce of the frames the host ran; 5c: the stage kernels on the
     inputs of each bounce of one eager path L frame (921,600 rays), held
     bit for bit against their plain versions (render/pt/stages.py run on
     the card), each timed beside its plain version captured as a CUDA
     graph, with the least time the bytes it reads and writes allow;
     5d: the alpha test kernel on the records of the 40 tests of one eager
     path F frame, held bit for bit against its plain version, timed over
     its 40 launches behind a device sleep beside the plain tests captured
     as one CUDA graph, with the least time its bytes allow;
  6. path T: the same frames and checks, K3 launches;
  7. paths F, S and F with multihit_k = 4: the same frames and checks, K4
     and K5 launches, and the rays still to re-trace before and after each
     re-trace pass of the first timed frame;
  8. 32x18 tiles on the card against the CPU: Cornell, the lit parity
     scene (next-event estimation), a small foliage scene (alpha
     re-trace), and the lit parity scene through the two-level structure
     and through treelets; the IBL bake at the tiles' budgets on the card
     against the CPU's (tables, SH order); 48x27 hybrid frames of Cornell,
     the lit parity scene (K2 sun rays) and the small foliage scene (the
     G-buffer's alpha re-trace through K4);
  9. paths I and J: the same frames and checks, K6 and K6 any-hit launches,
     the image against path L's and path T's; then path I's edit and
     refresh_scene() (no BLAS rebuilt, the same triangle tensor), its
     seconds beside a flat prepare_scene of the edited scene, and the
     refreshed frame against the flat one, then the scene put back;
  10. paths U and UL: the same frames and checks, K launches of K7 and one
     of the pick kernel per trace and no host read of the scheduler, the
     rounds and launches per frame, the image against path T's and path
     L's;
  11. path H, the JAX bench's hybrid frame (bench.py:213-260): path L's
     scene, its environment baked at the bench's budgets on the card and
     held to the same bake on the CPU, one warm and 3
     timed 1920x1080 frames of HybridRenderer.render_frame_device() with
     exactly one K1 and one K2 launch a frame, busy and idle share, the
     stage split of tools/probe_hybrid_stages.py, the reflection lookup in
     its two bit-exact forms, the environment bake's seconds at the bench
     budgets and at the defaults, and render_cli --mode hybrid's PNG;
  12. path C: the same frames and checks as path L, with K1 and K2 launched
     once per chunk per trace (twice path L's launches), ms/frame, device
     busy and device kernels beside path L's; then the same scene as one
     chunk, the same frames, and path C's frame held to its frame;
  13. path L16: the same frames and checks, its frame held to path L's,
     ms/frame and device busy beside path L's;
  14. a GLTF file of the Cornell box (buffers as a data URI, no image
     textures) rendered by render_cli --device cuda --validate in a
     subprocess, its PNG not constant, and load_scene of the file
     flattening to make_cornell_scene()'s triangle count;
  15. the engine: Engine(scene, 1280, 720, instancing=True) over path L's
     scene with the TestSystem's prefab and spawn point, the environment
     baked at the bench budgets, TestSystem and CameraSystem; hybrid ticks
     of 1 s through t = 19 (one K6 launch a tick and one K6 any-hit launch
     a light, no other kernel), then T and 4 path-traced ticks; at t = 7,
     9, 13, 15, 19 and after the last tick the frame is held to a fresh
     instanced SceneRenderer (0 pixels beyond 1e-4, equal rays_traced) and
     to a flat one (as phase 9a); the construction seconds, each
     refresh_scene() with the BLAS built, the median tick of each mode and
     device busy over 2 profiled ticks a mode; then the default engine
     (instancing=False: K1 and K2, no K6) through R, T, a resize to
     640x360 and a minimize; 3 path-traced frames checkpointed, loaded into
     a new renderer and continued, bit-equal to 5 frames in one run; and
     five subprocesses started together: render_cli --profile (the trace
     names trace_kernel.K1 and K1's kernel), --mode hybrid --debug-view
     normals --overlay, --override-material --force-forward --sample-count,
     testsystem_demo on write_testsystem_gltf's files (5 PNGs) and the
     viewer's scripted session (mode=PATH_TRACING after t);
  16. path G: path L's scene baked at the GI defaults (gi.light_volume),
     once cold and then by step with host seconds (placement and tets,
     the capture with exactly 32 K1 and 32 K2 launches and its peak
     memory, the SH projection) and whole, the capture under
     torch.profiler (device busy, K1 and K2); the tiny capture (two
     probes, resolution 4, spp 2) of Cornell and the lit parity scene on
     the card against the CPU; path H's 1920x1080 frame lit by the
     volume (one warm and 3 timed frames, one K1 and one K2 launch a
     frame, 2 profiled frames with the walk's device span) and the walk
     alone at the frame's 2,073,600 points under the profiler; a
     checkpoint round trip of the volume (bit-equal, the same frame);
     render_cli --mode hybrid --gi --show-probes --lv-checkpoint F at
     320x180 twice in subprocesses (985 probes baked, then loaded; equal
     PNGs); one- and two-shard meshes over the card (path-traced frame,
     hybrid GI frame, capture within 1e-5 of the unsharded run),
     entry.dryrun_multichip(2) over the card twice and entry()'s tile
     against the CPU's;
  17. path R: path H's frame with STEELJAX_RASTER=1 (one warm and 3 timed
     frames, one R and one K2 launch a frame, no K1), the frame against
     the traced one (RMSE < 0.02), ms/frame of both in turns, 2 profiled
     frames of each (the raster adds no synchronizing call), the G-buffer
     stage alone both ways, the raster record against K1's traced
     G-buffer record on all 2,073,600 pixels (tests/test_raster.py's 3%
     budget), R alone over the frame's 2,700 subtiles with its bound at
     strip granularity from the bytes its work reads (and the first
     design's bound at subtile granularity beside it), its work split
     (candidates by segment, covering, rejected by the strip test, the
     densest subtile, bytes staged) and bit-equal to its plain version on
     every subtile; a tie-heavy launch (path R's records with quantized
     depths) bit-equal at WINDOW 1, 3, 16 and 256; R's registers; the
     Cornell box at 1280x720 with the raster, R bit-equal to its plain
     version there; and fit_env_surrogate's sample gathering on a
     synthetic image on the card against the CPU;
  18. paths LS and FS (phase_sbvh): path L's and path F's scenes prepared
     with STEELJAX_SBVH=1 (restored after): source triangles, references,
     padded slots, binary and BVH8 depth, BVH8 rows, the walk's stack
     against MAX_STACK, the host seconds of the build and the collapse
     with splits and without (phase 3a); K1 and K2 on path L's primaries
     and first-bounce shadow rays, K4 and K5 (K = 4) on path F's primaries,
     each alone as phase 3b's rows over the spatial-split tables (the
     plain version timed over one call after a warm one), held to its
     plain version on a strided subset by source triangle (K5's lists
     without repeats of one triangle: kernel_parity.
     _compare_slots_by_source), its bound the smaller of its own and the
     object-SAH row's; the frames of LS, FS and FS with multihit_k = 4
     (launches, busy time, kernels a frame) beside paths L, F and F
     multihit of this call, the pixels beyond 1e-4 against them, each
     held to it (as path L16 to path L); likewise paths IS and US (path
     I's and path U's scenes: the pool's references and BLAS build
     seconds, the treelets' references, count and depth) with K6 and its
     any-hit query on path I's rays over IS's tables, K7 on path U's
     primaries over US's, and K6 both ways over the cards case's split
     BLAS (make_foliage_scene(cards=CARDS_IS) opaque and untextured, no
     frame), the frames of IS and US beside paths I and U;
  19. STEELJAX_SHADE_MODE (phase_shade_mode): tri_shade on the card for
     every path; K1 in shade mode 0 alone on the primaries of Cornell,
     path L and path T and on path H's G-buffer rays, against its plain
     version, beside phase 3b's K1 and K3 rows; Cornell, paths L and T
     (drive_path, two warm and 2 timed frames) and path H with the switch
     unset and at 0 in turns (unset, 0, 0, unset): launches (capped, path
     T launches K1 for K3), the integrator's material branch by its
     ranges, ms/frame, device busy, kernels a frame, the trace kernels,
     rays_traced, and each capped frame held to the uncapped one beside
     it (SHADE_PIXEL_DIVISOR, SHADE_RAYS_PER_PIXEL); path T at 1 raises;
  20. every ray against the walk (phase_walk): the reference's BVH walk
     (accel.traverse, through dispatch.trace_nearest_walk / trace_any_walk
     and instances.trace_nearest_instanced_walk) on the card over the same
     tables, each kernel launch held against it on every ray of phases
     3a/3b's ray sets by kernel_parity's budgets: K1 mode 1 on Cornell's
     primaries, K1 on path L's primaries and first-bounce rays, K2 and
     K2-dense on its shadow rays, K3 on path T's primaries, K4 with coarse
     masks on path F's primaries and (any-hit) sun rays, K1 and K2 on path
     H's G-buffer and sun rays, path C's two-chunk sweep, K6 on path I's
     and K7 on path U's primaries, K1 over path LS's and K4 over path FS's
     spatial-split tables (by source triangle too); rays both hit on other
     surfaces count with the hit mismatches only at a grazing edge
     (float64 barycentric margin below GRAZING_MARGIN); one line each with
     the rays, the hit mismatches and their budget, max |dt|, the walk's
     seconds, steps, host reads and peak memory, and the walk itself
     against phase 3b's (or 18's) plain version on that row's strided
     subset.  K5 keeps phase 3b's strided check (the reference has no
     K-nearest walk).
The second-to-last line is the kernels' JSON summary (K1's and K2's
entries carry their rows of paths H, C and L16 and their launches a frame
there under "path_h", "path_c" and "path_l16"; a kernel that phase 15's
engines launched carries those launches under "engine_launches": the
TestSystem engine's hybrid ticks as "testsystem", its path-traced ticks
as "pt", the default engine's ticks as "default"; K1 and K2 carry path
G's launches under "path_g": the capture's and a GI frame's; K1, K2, K4
and K5 carry phase 18's rows under "sbvh", with the launches a frame of
paths LS, FS and FS multihit and their tables' counts, K6, K6_anyhit and
K7 theirs of paths IS and US, and K6 and K6_anyhit the cards case's
under "sbvh_cards"; K1 carries phase 19's rows under "shade_mode0", with
its launches a frame under STEELJAX_SHADE_MODE=0; the kernels phase 20
held carry its comparisons under "walk"; R's bound_ms is
counted at strip granularity from the bytes its work reads, its entry
carries the bound at subtile granularity as "subtile_bound_ms", its
(subtile, winner) pairs, its work split, the tie-heavy launch, the Cornell
check and its registers), the last line the device JSON.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
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
# fp32 operations of the kernels' work units (csrc/alpha8.cu): a
# supernode pop slab-tests 8 children, 16 on 16-wide rows (6 subtractions,
# 6 products, 6 min/max, 4 min/max reductions, 3 comparisons each: 25); a
# triangle test is
# Moller-Trumbore (two cross products, three dot products, a reciprocal,
# the accept comparisons: 53); the epilogue interpolates and normalizes the
# winner's attributes once per ray.  The alpha kernels add a mask test for
# each candidate that reaches one (the kernels' own counts: the coarse test
# runs only for a candidate inside its triangle and its interval, the fine
# test only past the coarse one); a test finds the cell of (u, v) and reads
# its bit (2 products, 2 casts, 4 clamps, 5 index operations, 2 shifts and
# masks, 1 domain test: 16).
OPS_PER_CHILD_TEST = 25
OPS_PER_TRIANGLE_TEST = 53
OPS_PER_MASK_TEST = 16
# K6 also rotates the winner's normal (and tangent) by an instance matrix
# (9 products, 6 sums each) and scales the uv density; entering an instance
# transforms the ray (origin 9 products and 9 sums, direction 9 and 6) and
# takes three guarded reciprocals: 45.
OPS_EPILOGUE = {"K1": 25, "K1_shade0": 0, "K3": 60, "K2": 0,
                "K2_dense": 0, "K4": 0, "K4_anyhit": 0, "K5": 0, "K6": 40,
                "K6_shade2": 91, "K6_anyhit": 0, "K7": 60, "K7_shade1": 25,
                "K7_anyhit": 0}
# The treelet pick reads each ray's K entry distances, its t_far and its
# visited words and writes one key per packet; per (ray, treelet) it tests
# a visited bit and compares twice (4 operations).
OPS_PER_PICK_ENTRY = 4
OPS_PER_INSTANCE_ENTER = 45
# Phase 3b's rows, (kernel, path, ray set): each kernel timed alone on one
# path's rays.  A row's printed label joins its three names;
# EARLIER_PER_RAY is keyed by rows and _timed_kernel refuses any other.
PRIMARIES = "primaries"
BOUNCE1 = "first-bounce rays"
SHADOW = "first-bounce shadow rays"
GBUFFER = "G-buffer rays"
SUN = "sun rays"
PROBE = "probe rays"
PROBE_SHADOW = "probe rays' shadow rays"
ROWS = (("K1", "Cornell", PRIMARIES), ("K1", "path L", PRIMARIES),
        ("K1", "path L", BOUNCE1), ("K1", "path H", GBUFFER),
        ("K2", "path H", SUN), ("K3", "path T", PRIMARIES),
        ("K3", "path T", BOUNCE1), ("K2", "path L", SHADOW),
        ("K2_dense", "path L", SHADOW), ("K4", "path F", PRIMARIES),
        ("K5", "path F", PRIMARIES),
        ("K4_anyhit", "path F", "first-bounce sun rays"),
        ("K6", "path I", PRIMARIES), ("K6_anyhit", "path I", SHADOW),
        ("K6_shade2", "path J", PRIMARIES),
        ("K1", "path C", PRIMARIES), ("K2", "path C", SHADOW),
        ("K1", "path L16", PRIMARIES), ("K1", "path L16", BOUNCE1),
        ("K2", "path L16", SHADOW), ("K1", "path G", PROBE),
        ("K2", "path G", PROBE_SHADOW), ("K1", "path LS", PRIMARIES),
        ("K2", "path LS", SHADOW), ("K4", "path FS", PRIMARIES),
        ("K5", "path FS", PRIMARIES), ("K6", "path IS", PRIMARIES),
        ("K6_anyhit", "path IS", SHADOW), ("K6", "cards IS", PRIMARIES),
        ("K6_anyhit", "cards IS", SHADOW),
        ("K1_shade0", "Cornell", PRIMARIES),
        ("K1_shade0", "path L", PRIMARIES),
        ("K1_shade0", "path T", PRIMARIES),
        ("K1_shade0", "path H", GBUFFER))
# The earlier designs of K1-K5 (one thread per ray, scalar loads, a stack
# in local memory, each leaf tested as it is popped), per ray on the same
# rays as phase 3b: counted by their COUNT instances on the H100 (K4, K5:
# apps/alpha_ab.py at commit 233eaca; K1, K3: apps/kernel_ab.py at commit
# dabca91, with commit 3f38e36's traverse8.cu; K2, K2-dense: apps/
# kernel_ab.py with commit dabca91's traverse8.cu), by phase 3b row.
# The bounds take the smaller of these and the new kernel's counts: a walk
# order that pops more nodes does not raise the least time of the
# function.
EARLIER_PER_RAY = {
    ("K4", "path F", PRIMARIES): {
        "supernode_pops": 28.61, "triangle_tests": 449.69,
        "mask_tests": 8.45, "fine_tests": 5.56},
    ("K4_anyhit", "path F", "first-bounce sun rays"): {
        "supernode_pops": 5.43, "triangle_tests": 56.47,
        "mask_tests": 1.12, "fine_tests": 0.80},
    ("K5", "path F", PRIMARIES): {
        "supernode_pops": 34.52, "triangle_tests": 641.19,
        "mask_tests": 52.88, "fine_tests": 39.20},
    ("K1", "Cornell", PRIMARIES): {"supernode_pops": 1.041,
                                   "triangle_tests": 13.804},
    ("K1", "path L", PRIMARIES): {"supernode_pops": 4.342,
                                  "triangle_tests": 13.279},
    ("K1", "path L", BOUNCE1): {"supernode_pops": 4.525,
                                "triangle_tests": 19.814},
    ("K3", "path T", PRIMARIES): {"supernode_pops": 3.804,
                                  "triangle_tests": 15.855},
    ("K3", "path T", BOUNCE1): {"supernode_pops": 4.556,
                                "triangle_tests": 23.461},
    ("K2", "path L", SHADOW): {"supernode_pops": 0.4516,
                               "triangle_tests": 0.4384},
    ("K2_dense", "path L", SHADOW): {"supernode_pops": 0.4516,
                                     "triangle_tests": 0.4384},
}
# K1 in shade mode 0 (STEELJAX_SHADE_MODE=0, phase 19) walks as K1 and K3
# do on the same rays and tables: the same earlier counts cap its bound.
for _path, _row in (("Cornell", ("K1", "Cornell", PRIMARIES)),
                    ("path L", ("K1", "path L", PRIMARIES)),
                    ("path T", ("K3", "path T", PRIMARIES))):
    EARLIER_PER_RAY[("K1_shade0", _path, PRIMARIES)] = EARLIER_PER_RAY[_row]
assert set(EARLIER_PER_RAY) <= set(ROWS)
# The walk of csrc/alpha8.cu (K1-K5) in ptxas' report: every instance's
# name starts so, and K2's (ANY, K = 1, no masks; COUNT either way) so.
WALK_INSTANCE = "alpha8_kernel<"
K2_INSTANCE = "alpha8_kernel<1, 1, false, false, "
# Bytes each ray reads (o, d, t_min, t_max; a dead ray, t_max < t_min, only
# its interval: the function needs no more to reject it) and writes, by
# kernel (K5 writes K = 4 slots of t, u, v and tri).
RAY_IN_BYTES = 32
DEAD_RAY_IN_BYTES = 8
RAY_OUT_BYTES = {"K1": 32, "K1_shade0": 16, "K3": 56, "K2": 1,
                 "K2_dense": 1, "K4": 16, "K4_anyhit": 1, "K5": 64,
                 "K6": 36, "K6_shade2": 60, "K6_anyhit": 1, "K7": 56,
                 "K7_shade1": 32, "K7_anyhit": 1}
# Table bytes a kernel reads per distinct entry its walk touches: a
# supernode pop reads floats 0-7 of each of the row's 8 (or 16) children
# (SNODE_CHILD_BYTES each); a triangle
# test reads one record (nearest: v0, e1, e2 and the double-sided flag;
# any-hit: v0, e1, e2; alpha kernels: v0, e1, e2 and the AUX word); a fine
# mask test reads the record's PASS word (K4) or its PASS and OPAQUE words
# (K5); the epilogue reads the winner's shade record (mode 1: 10 floats,
# mode 2: 26).
SNODE_CHILD_BYTES = 8 * 4
TRI_RECORD_BYTES = {"K1": 40, "K1_shade0": 40, "K3": 40, "K2": 36,
                    "K2_dense": 36, "K4": 40, "K4_anyhit": 40, "K5": 40,
                    "K6": 40, "K6_shade2": 40, "K6_anyhit": 36, "K7": 40,
                    "K7_shade1": 40, "K7_anyhit": 36}
FINE_WORD_BYTES = {"K4": 4, "K4_anyhit": 4, "K5": 8}
SHADE_RECORD_BYTES = {"K1": 40, "K1_shade0": 0, "K3": 104, "K2": 0,
                      "K2_dense": 0, "K4": 0, "K4_anyhit": 0, "K5": 0,
                      "K6": 40, "K6_shade2": 104, "K6_anyhit": 0, "K7": 104,
                      "K7_shade1": 40, "K7_anyhit": 0}
# K6 reads of an instance row: entering it, the inverse 3x4, the BLAS root
# and the double-sided flag (14 floats); shading a winner, the material id
# and the normal matrix (10 floats), in mode 2 also 1 / scale and the world
# linear matrix (20 floats).  K7 reads one treelet id per packet.
INST_ENTER_BYTES = 56
INST_SHADE_BYTES = {"K6": 40, "K6_shade2": 80, "K6_anyhit": 0}
# A path through another acceleration structure renders the flat path's
# frame: the same seeds and the same transport, and only exact-t ties and
# last-bit differences of t (object space against world space) can part two
# paths of one pixel.  The frames' means must agree within IMAGE_MEAN_RTOL,
# rays_traced per frame within RAYS_RTOL, and at most IMAGE_PIXEL_FRACTION
# of the pixels may differ by more than IMAGE_PIXEL_ATOL (on the H100 the
# instanced paths part in 0.001-0.002% of the pixels, the treelet paths in
# none).
IMAGE_MEAN_RTOL = 1e-3
IMAGE_PIXEL_ATOL = 1e-2
IMAGE_PIXEL_FRACTION = 1e-3
RAYS_RTOL = 1e-4
# Path H, the JAX bench's hybrid frame: its timed frames (bench.py uses 3)
# and its environment bake budgets (bench.py:239-245).
HYBRID_TIMED_FRAMES = 3
# The variants of apps.kernel_parity.run, every one of which must pass.
PARITY_VARIANTS = 46
BENCH_ENV = dict(irradiance_resolution=16, reflection_resolution=32,
                 lut_resolution=64, lut_samples=256, reflection_samples=128,
                 irradiance_delta=0.1)
# The hybrid tiles of phase 8, and their environment's budgets (the
# reference's test fixture, tests/test_hybrid.py:21-27).
HYBRID_TILE_W, HYBRID_TILE_H = 48, 27
TILE_ENV = dict(cube_resolution=16, irradiance_resolution=4,
                reflection_resolution=8, lut_resolution=16, lut_samples=32,
                reflection_samples=16, irradiance_delta=0.4)
# Phase 5c, the path stage kernels (csrc/pathstage.cu): the tensors each
# kernel reads, by the names of its stage's arguments (stages.nee_stage,
# sample_stage; `surface` keys and the (t, b, n) frame inline), and the
# launches timed a call.
STAGE_INPUTS = {
    "nee": ("base_color", "roughness", "metallic", "emission", "tbn", "o",
            "d", "t_hit", "hit", "throughput", "ray_pdf", "alive", "miss",
            "irradiance", "seed"),
    "sample": ("base_color", "roughness", "metallic", "tbn", "p", "wo", "d",
               "direct", "throughput", "ray_pdf", "alive", "irradiance",
               "seed")}
STAGE_TIMED_LAUNCHES = 8
# Runtime calls counted per profiled frame: the host waits for the device
# in the first two, and in a copy from or to pageable host memory.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaMemcpyAsync")
# Phase 15: the path-traced ticks after the TestSystem's timeline.
ENGINE_PT_TICKS = 4
# Phase 17, the raster tile kernel R (csrc/raster.cu): fp32 operations per
# pair of a pixel and a candidate piece that covers the pixel's subtile
# (four linear forms, E0, E1, E2 and Z, at two products and two sums each;
# five comparisons of the inside test and one against the slice's best z:
# 22), and per hit pixel the winner's Fu, Fv and Fw once (12).  Bytes: each
# candidate record a subtile reads (24 floats), each subtile's id and six
# segment ints, and five floats written a pixel.
OPS_PER_RASTER_TEST = 22
OPS_PER_RASTER_WINNER = 12
RASTER_RECORD_BYTES = 96
RASTER_TILE_IN_BYTES = 7 * 4
RASTER_PIXEL_OUT_BYTES = 5 * 4
# What the kernel stages (csrc/raster.cu): each candidate's two bbox words,
# and of each covering candidate the 12 floats its walk reads; and what it
# reads of a winner at the end: Fw, Fu, Fv and the triangle id.
RASTER_BBOX_BYTES = 8
RASTER_STAGED_BYTES = 48
RASTER_WINNER_BYTES = 40
# The kernel in ptxas' report (phase 2 refuses a spill).
RASTER_INSTANCE = "raster_tiles_kernel"
# Phase 17's tie-heavy launch: path R's records with their depth forms
# replaced by RASTER_TIE_PLANES (three constant depths and two shared
# slanted planes, drawn per record from a generator seeded with
# RASTER_TIE_SEED), at each of RASTER_TIE_WINDOWS.
RASTER_TIE_PLANES = ((0.0, 0.0, 0.25), (0.0, 0.0, 0.5), (0.0, 0.0, 0.75),
                     (2.0 ** -12, -2.0 ** -13, 0.4), (-2.0 ** -12, 0.0, 0.9))
RASTER_TIE_SEED = 17
RASTER_TIE_WINDOWS = (1, 3, 16, 256)


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


def _print_ptxas(label: str, table: dict) -> None:
    for name, (regs, frame, st, ld, smem) in sorted(table.items()):
        print(f"ptxas {label}: {name}: {regs} registers, {frame} B stack "
              f"frame, spill stores {st} B, spill loads {ld} B, static smem "
              f"{smem} B")


def check_spills(table: dict) -> dict:
    """Raise unless a ptxas table holds instances of csrc/alpha8.cu's walk,
    K2's among them, and none of them spills a byte (a spill puts the walk's
    registers in local memory); raises on an empty table (no build's
    report).  Returns K2's instances' (registers, stack frame bytes)."""
    if not table:
        raise RuntimeError("no ptxas report: the CUDA library was not built "
                           "from the sources in this run")
    walk = {name: entry for name, entry in table.items()
            if name.startswith(WALK_INSTANCE)}
    k2 = {name: entry[:2] for name, entry in walk.items()
          if name.startswith(K2_INSTANCE)}
    if not k2:
        raise RuntimeError("the ptxas report has no instance of K2 "
                           f"({K2_INSTANCE}...)")
    spills = {name: entry[2:4] for name, entry in walk.items()
              if entry[2] or entry[3]}
    if spills:
        raise RuntimeError("instances of alpha8.cu's walk spill (store, "
                           f"load bytes): {spills}")
    return k2


def check_raster_ptxas(table: dict) -> tuple:
    """Raise unless a ptxas table holds the raster kernel R and it spills
    no byte; returns its (registers, stack frame, spill stores, spill
    loads, static shared memory bytes)."""
    entry = table.get(RASTER_INSTANCE)
    if entry is None:
        raise RuntimeError(f"the ptxas report has no {RASTER_INSTANCE}")
    if entry[2] or entry[3]:
        raise RuntimeError(f"{RASTER_INSTANCE} spills (store, load bytes): "
                           f"{entry[2:4]}")
    return entry


def phase_build() -> dict:
    """Build both libraries, the CUDA library from the sources even where a
    current one was built before (native.cuda_ptxas); print ptxas'
    registers, stack frame, spills and static shared memory of every kernel
    instance, check that no instance of alpha8.cu's walk spills
    (check_spills), print K2's registers, and return that table."""
    from steeljax_torch import native

    for name, build in (("BVH builder (g++)", native.bvh_library),
                        ("CUDA kernels (nvcc)", native.cuda_ptxas)):
        t0 = time.perf_counter()
        build()
        print(f"built {name} in {time.perf_counter() - t0:.3f} s")
    native.cuda_library()
    table = native.cuda_ptxas()
    _print_ptxas("this tree", table)
    k2 = check_spills(table)
    print(f"ptxas: no instance of alpha8.cu's walk spills; K2's instances "
          f"(registers, stack frame bytes): {k2}")
    regs, _, _, _, smem = check_raster_ptxas(table)
    print(f"ptxas: R ({RASTER_INSTANCE}) {regs} registers, no spill, "
          f"{smem} B static shared memory")
    return table


def _live_rays(n_rays: int, t_min, t_max) -> int:
    """The rays of a call with t_max >= t_min (a scalar bound holds for
    every ray)."""
    if isinstance(t_min, torch.Tensor) or isinstance(t_max, torch.Tensor):
        return int((t_max >= t_min).expand(n_rays).sum())
    return n_rays if t_max >= t_min else 0


def _bound(kernel: str, rec: dict, live_rays: int, tri_base=None,
           cap: dict | None = None, width: int = 8) -> dict:
    """The least time the card could take for one call, from a counting
    launch's `rec`: the larger of the bytes it must move over the HBM rate
    and the fp32 operations this run's walk did (the kernel's own counters)
    over the fp32 peak.  The bytes are each ray's inputs and outputs once
    (of the `live_rays` with t_max >= t_min origin, direction and interval,
    of a dead ray the interval alone; every ray's outputs are written)
    and, of the tables, only what this run's walks read, each entry once:
    the distinct supernode rows popped, triangle records tested and records
    whose fine words were read (the kernel's seen flags), and the distinct
    winners' shade records.  The two-level kernel K6 (a `rec` with
    "seen_inst") counts instance enters where the flat kernels count mask
    tests, and adds the rows of the distinct instances entered and of the
    distinct winners' instances.  `tri_base` ((N,), the treelet kernel K7)
    is each ray's offset from its treelet-local triangle id to an id over
    the whole stack.  `cap` ({counter: per-ray mean}, EARLIER_PER_RAY)
    caps each summed counter at that mean times the rays, so that a walk
    that does more work than an earlier design did on the same rays does
    not raise its own bound.  `width` is the supernode rows' (8 or 16): a
    pop reads and slab-tests that many children."""
    n_rays = rec["counters"].shape[0]
    raw = rec["counters"].to(torch.int64).sum(dim=0).tolist()
    sums = raw
    if cap:
        from steeljax_torch.accel.cuda_traverse import COUNTERS

        sums = [min(total, cap[name] * n_rays) if name in cap else total
                for name, total in zip(COUNTERS, raw)]
    pops, rows, leaves, tests, col4, col5 = sums
    instanced = "seen_inst" in rec
    hit = rec["tri"] >= 0 if "tri" in rec else None
    winners = 0
    if SHADE_RECORD_BYTES[kernel]:
        ids = rec["tri"].to(torch.int64)
        if tri_base is not None:
            ids = ids + tri_base
        winners = int(torch.unique(ids[hit]).numel())
    touched = {"supernode_rows": int(rec["seen_nodes"].sum()),
               "triangle_records": int(rec["seen_records"].sum()),
               "fine_records": (int(rec["seen_fine"].sum())
                                if "seen_fine" in rec else 0),
               "shade_records": winners}
    table_bytes = (width * SNODE_CHILD_BYTES * touched["supernode_rows"]
                   + TRI_RECORD_BYTES[kernel] * touched["triangle_records"]
                   + FINE_WORD_BYTES.get(kernel, 0) * touched["fine_records"]
                   + SHADE_RECORD_BYTES[kernel] * winners)
    ops = (width * OPS_PER_CHILD_TEST * pops + OPS_PER_TRIANGLE_TEST * tests
           + OPS_EPILOGUE[kernel] * n_rays)
    if instanced:
        touched["instances_entered"] = int(rec["seen_inst"].sum())
        touched["winner_instances"] = (
            int(torch.unique(rec["inst"][hit]).numel())
            if INST_SHADE_BYTES[kernel] else 0)
        table_bytes += (INST_ENTER_BYTES * touched["instances_entered"]
                        + INST_SHADE_BYTES[kernel]
                        * touched["winner_instances"])
        ops += OPS_PER_INSTANCE_ENTER * col4
        names = ("instance_enters", "tlas_pops")
    else:
        ops += OPS_PER_MASK_TEST * (col4 + col5)
        names = ("mask_tests", "fine_tests")
    moved = (live_rays * RAY_IN_BYTES
             + (n_rays - live_rays) * DEAD_RAY_IN_BYTES
             + n_rays * RAY_OUT_BYTES[kernel] + table_bytes)
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bytes": moved,
            "table_bytes": table_bytes, "ops": ops,
            "live_rays": live_rays, "touched": touched,
            "capped": sums != raw,
            "per_ray": dict(zip(("supernode_pops", "row_bodies", "leaf_pops",
                                 "triangle_tests") + names,
                                (x / n_rays for x in raw)))}


def _timed_kernel(row, launcher, plain, rays, plain_rays, check=None,
                  width: int = 8, plain_calls: int = 3):
    """Time the kernel of `row` (one of ROWS) alone over 50 launches of
    `launcher(False)` (kernel_launcher, anyhit_launcher, multihit_launcher
    or inst_launcher with fixed arguments, the `rays` (o, d, t_min, t_max)
    among them, and counters=False) and `plain` over `plain_calls` calls
    after a warm one; take the work
    counts from one launch of `launcher(True)`, capped by the row's
    EARLIER_PER_RAY entry where it has one.  `check(plain_rec)`, where
    given, runs the kernel on the plain version's rays and returns
    kernel_parity's comparison with the last plain call's result; the row
    raises unless it passes.  `width` is the supernode rows' (the bound's
    bytes and operations of a pop).  Print and return the row's entry."""
    from steeljax_torch.apps.timing import time_ms

    if row not in ROWS:
        raise ValueError(f"{row} is not a phase 3b row (ROWS)")
    label = " ".join(row)
    n_rays = rays[0].shape[0]
    kernel_ms = time_ms(launcher(False)[0], 50)
    kept = {}

    def plain_kept():
        kept["rec"] = plain()

    plain_ms = time_ms(plain_kept, plain_calls)
    launch, rec = launcher(True)
    launch()
    bound = _bound(row[0], rec, _live_rays(n_rays, rays[2], rays[3]),
                   cap=EARLIER_PER_RAY.get(row), width=width)
    entry = {"ms": kernel_ms, "plain_ms": plain_ms, "plain_rays": plain_rays,
             "rays": n_rays, **bound,
             # The row's rays and plain record, for phase 20 (not printed).
             "held": {"rays": rays, "plain": kept["rec"]}}
    if check is not None:
        parity = check(kept["rec"])
        entry["parity"] = parity
        entry["parity_max_abs_err"] = max(parity.get(f, 0.0) for f in (
            "max_t_delta", "max_normal_delta", "max_tan_delta",
            "max_uv_delta"))
        if not parity["ok"]:
            raise RuntimeError(f"{label}: the kernel disagrees with its "
                               f"plain version: {parity}")
    if check is None:
        held = ""
    elif "max_t_delta" in entry["parity"]:
        held = f", max |kernel - plain| {entry['parity_max_abs_err']:.3e}"
    else:
        held = (f", {entry['parity']['hit_mismatches']} flag mismatches "
                "against plain")
    print(f"{label}: {n_rays} rays, kernel {kernel_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms on {plain_rays} rays"
          f"{'' if plain_rays == n_rays else ' (a strided subset)'}"
          + held + "; " + _bound_text(bound))
    return entry


def _bound_text(bound: dict) -> str:
    return (f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"({bound['bytes']:.4e} B for {bound['live_rays']} live rays, of "
            f"them {bound['table_bytes']:.4e} B of tables: distinct "
            + ", ".join(f"{k} {v}" for k, v in bound["touched"].items())
            + f"; {bound['ops']:.4e} fp32 ops"
            + (" from the counts capped by EARLIER_PER_RAY"
               if bound.get("capped") else "") + "; per ray "
            + ", ".join(f"{k} {v:.2f}" for k, v in bound["per_ray"].items())
            + ")")


def _least_bound(row, entry: dict, other: dict, source: str) -> None:
    """Lower the bound of phase 3b's `row` (its `entry`) to `other`'s, the
    bound of the same function on the same rays through other tables of
    the same scene (path L's 8-wide rows, the one-chunk tables), where
    that is smaller: the least time of the function does not depend on the
    tables a design reads, and a design that does more work does not raise
    it.  The row keeps its own as own_bound_ms and own_bound_by."""
    entry["own_bound_ms"] = entry["bound_ms"]
    entry["own_bound_by"] = entry["bound_by"]
    if other["bound_ms"] < entry["bound_ms"]:
        entry["bound_ms"], entry["bound_by"] = (other["bound_ms"],
                                                other["bound_by"])
        entry["bound_from"] = source
    print(f"{' '.join(row)}: bound {entry['bound_ms']:.4f} ms by "
          f"{entry['bound_by']}, the smaller of its own "
          f"{entry['own_bound_ms']:.4f} ms and {other['bound_ms']:.4f} ms "
          f"({source})")


def _timed_treelet_trace(name, tt, rays, subset, cull, any_hit, check=None,
                         label=None) -> dict:
    """The treelet kernel K7 over one trace of `rays` through the scheduler:
    the device time of the trace's K rounds, and of the whole trace, its
    first pick included (timing.trace_device_ms: the host queues every
    launch before the first starts), the work counts of one counting trace
    (summed over its rounds) and the bound of the trace as one function:
    every ray read and written once, the table entries the rounds touched,
    each once, the rounds' operations.  The plain version's time is one
    trace of the strided `subset` through the scheduler with the plain
    round and pick.  `check(plain_rec)`, where given, holds the kernels'
    trace of the subset against that plain trace and returns
    kernel_parity's comparison; the row raises unless it passes.  `label`
    names the row in the printout (default `name`)."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel import treelets as treelets_lib
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.apps.timing import time_ms, trace_device_ms

    n_rays, k = rays[0].shape[0], tt.count
    block = treelets_lib.PACKET_RAYS
    state = treelets_lib.treelet_state(tt, *rays, any_hit)
    telemetry = ct.treelet_telemetry(tt, state)
    ct.treelet_pick_launcher(tt, state)()
    live = []
    for r in range(k):
        live.append(int((ct.key_treelets(state.keys[r % 3], block, k)
                         < k).sum()))
        ct.treelet_launcher(tt, state, r, cull, any_hit,
                            telemetry=telemetry)[0]()
    rec = {"counters": telemetry["counters"][:n_rays],
           "seen_nodes": telemetry["seen_nodes"],
           "seen_records": telemetry["seen_records"]}
    if not any_hit:
        rec["tri"] = state.rec["tri"][:n_rays]  # ids over the whole stack
    bound = _bound(name, rec, _live_rays(n_rays, rays[2], rays[3]))
    kernel_ms = trace_device_ms(tt, rays, cull, any_hit, pick=False)
    trace_ms = trace_device_ms(tt, rays, cull, any_hit)
    plain = kp.plain_round(tt, cull, any_hit)
    kept = {}

    def plain_kept():
        kept["rec"] = treelets_lib.trace_treelets(tt, *subset, cull,
                                                  any_hit, trace_fn=plain)

    plain_ms = time_ms(plain_kept, 1)
    entry = {"ms": kernel_ms, "trace_ms": trace_ms, "plain_ms": plain_ms,
             "plain_rays": subset[0].shape[0], "rays": n_rays,
             "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
             "trace_bound_ms": bound["bound_ms"], "rounds": k,
             "live_packets": live,
             "held": {"rays": rays, "plain": kept["rec"]}}
    held = ""
    if check is not None:
        parity = check(kept["rec"])
        entry["parity"] = parity
        entry["parity_max_abs_err"] = max(parity.get(f, 0.0) for f in (
            "max_t_delta", "max_normal_delta", "max_tan_delta",
            "max_uv_delta"))
        if not parity["ok"]:
            raise RuntimeError(f"{label or name}: the kernels disagree with "
                               f"the plain trace: {parity}")
        held = (f", max |kernel - plain| {entry['parity_max_abs_err']:.3e}"
                f" ({parity['hit_mismatches']} hit mismatches)")
    print(f"{label or name}: {n_rays} rays, {k} treelets, the {k} rounds of "
          f"one trace: device {kernel_ms:.4f} ms; the whole trace (first pick "
          f"and {k} rounds) {trace_ms:.4f} ms; plain {plain_ms:.4f} ms "
          f"for one trace of {subset[0].shape[0]} rays (a strided subset) "
          f"through the scheduler{held}; live packets of "
          f"{-(-n_rays // block)} by round {live}; the trace as one "
          "function: " + _bound_text(bound))
    return entry


def _timed_treelet_pick(tt, rays, any_hit) -> dict:
    """The scheduler's pick kernel on the first pick of one trace of
    `rays`: its device time, its keys against pick_keys_plain's (the
    packets whose keys differ are its error), the plain version's time, and
    the bound: the entry rows, t_far and visited words read once, a key
    written per packet, OPS_PER_PICK_ENTRY per entry."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel import treelets as treelets_lib
    from steeljax_torch.apps.timing import device_ms, time_ms

    state = treelets_lib.treelet_state(tt, *rays, any_hit)
    launch = ct.treelet_pick_launcher(tt, state)

    def reset():
        state.keys.fill_(ct.EMPTY_KEY)

    ms = device_ms(reset, [launch])
    reset()
    launch()

    def plain():
        return ct.pick_keys_plain(state.entry, state.visited, state.t_far,
                                  state.block)

    keys = plain()
    mismatches = int((keys != state.keys[0]).sum())
    plain_ms = time_ms(plain, 3)
    n, k = state.entry.shape
    moved = (n * k * 4 + n * 4 + state.visited.numel() * 4
             + state.keys.shape[1] * 8)
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = n * k * OPS_PER_PICK_ENTRY / PEAK_FP32_PER_S * 1e3
    print(f"K7_pick: {n} rays (padded), {k} treelets, {state.keys.shape[1]} "
          f"packets, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; keys "
          f"differing from the plain pick's: {mismatches}; bound "
          f"{max(bytes_ms, ops_ms):.4f} ms by "
          f"{'bytes' if bytes_ms >= ops_ms else 'operations'} ({moved:.4e} "
          "B)")
    return {"ms": ms, "plain_ms": plain_ms, "plain_rays": n, "rays": n,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "max_abs_err": float(mismatches),
            "tolerance": "0 packets whose key differs from the plain pick's"}


def _profiled_steps(fn) -> tuple:
    """Run `fn()` under a host-only torch.profiler window: (its result, its
    host seconds, {step: host seconds} of the `prepare_scene.*`,
    `prepare_tables.*` and `instances.*` ranges)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    steps = {evt.key: evt.cpu_time_total / 1e6 for evt in prof.key_averages()
             if evt.key.startswith(("prepare_scene.", "prepare_tables.",
                                    "instances."))}
    return out, total, steps


def _steps_text(steps: dict) -> str:
    return ", ".join(f"{k.split('.', 1)[1]} {v:.3f}" for k, v in steps.items())


def _describe_tables(tables) -> str:
    from steeljax_torch.accel.instances import InstancedTables

    if isinstance(tables, InstancedTables):
        return (f"{tables.instance_count} instances of "
                f"{len(tables.blas_tri_offset)} BLAS, "
                f"{tables.tris_packed.shape[0] * 12} pooled records, "
                f"{tables.snode_rows.shape[0]} supernode rows ("
                f"{tables.n_tlas} of the TLAS), two-level depth "
                f"{tables.depth}, shade mode {tables.shade_mode}")
    chunk = tables.chunks[0]
    if tables.treelets is not None:
        tt = tables.treelets
        return (f"{chunk.rows} padded, {tt.count} treelets of at most "
                f"{tt.node_stack.shape[1]} BVH8 rows and "
                f"{tt.tri_stack.shape[1] * 12} records, BVH8 depth "
                f"{tt.depth}, shade mode {tables.shade_mode}, alpha masked "
                f"{tables.alpha_masked}")
    chunks = "; ".join(
        f"{c.rows} padded at row {c.row_offset}, {c.bvh8.rows.shape[0]} "
        f"BVH{c.bvh8.width} rows, depth {c.bvh8.depth}"
        for c in tables.chunks)
    return (f"{len(tables.chunks)} chunk(s): {chunks}; shade mode "
            f"{tables.shade_mode}, alpha masked {tables.alpha_masked}, "
            f"multihit_k {tables.multihit_k}, fine mask rows "
            f"{chunk.fine_mask_rows is not None}")


def phase_prepare(device) -> tuple[dict, dict, dict, dict]:
    """Prepare paths L, T, F, S, F with multihit_k = 4, U, UL, C, C as one
    chunk and L16 through prepare_scene, and paths I and J through
    PathTracingRenderer(instancing=True), each under a host-only
    torch.profiler window that reads the host seconds of its steps.  Each
    instanced path is then edited (one entity moved), refreshed through
    refresh_scene() with the seconds of that re-preparation, and put
    back.  Returns ({name: (scene,
    flat, tables)}, {name: renderer} of the instanced paths, {name: host
    seconds of the preparation}, {name: {step: host seconds}} of the first
    preparations)."""
    from steeljax_torch.apps import kernel_parity
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt.renderer import PathTracingRenderer

    scenes, renderers, seconds, steps_by = {}, {}, {}, {}
    for name in (kernel_parity.PATH_SCENES + kernel_parity.FOLIAGE_SCENES
                 + kernel_parity.TREELET_SCENES
                 + kernel_parity.CHUNKED_SCENES):
        scenes[name], seconds[name], steps = _profiled_steps(
            lambda: kernel_parity.prepare_path_scene(name, device))
        steps_by[name] = steps
        _, flat, tables = scenes[name]
        print(f"prepare_scene {name}: {flat.source_tri_count} triangles, "
              f"{_describe_tables(tables)}, {seconds[name]:.3f} s (scene "
              f"construction included): {_steps_text(steps)}")

    config = RenderConfig(width=WIDTH, height=HEIGHT)
    for name in kernel_parity.INSTANCED_SCENES:
        scene = kernel_parity.make_path_scene(name)
        renderer, seconds[name], steps = _profiled_steps(
            lambda: PathTracingRenderer(scene, WIDTH, HEIGHT, config,
                                        instancing=True, device=device))
        renderers[name] = renderer
        steps_by[name] = steps
        first = renderer.tables
        scenes[name] = (scene, renderer.flat, first)
        print(f"PathTracingRenderer(instancing=True) {name}: "
              f"{renderer.flat.source_tri_count} triangles when flattened, "
              f"{_describe_tables(first)}, {seconds[name]:.3f} s (the "
              f"renderer's prepare_scene): {_steps_text(steps)}")
        # An edit and its re-preparation, then the scene as it was.  The
        # refresh rewrites the instance rows in place (the same tables), so
        # the rows before it are compared from a copy.
        entity = scene.entities[scene.renderable_entities()[-1]]
        before = entity.local_transform
        builds = renderer._accel.blas_builds
        first_rows = first.inst_trace.clone()
        kernel_parity.move_entity(scene)
        _, again, steps = _profiled_steps(renderer.refresh_scene)
        edited = renderer.tables
        if renderer._accel.blas_builds != builds or \
                edited.tris_packed is not first.tris_packed or \
                torch.equal(edited.inst_trace, first_rows):
            raise RuntimeError(f"{name}: the re-preparation after an edit "
                               "rebuilt a BLAS or changed nothing")
        print(f"  refresh_scene() after moving one entity: {again:.4f} s "
              f"against {seconds[name]:.3f} s, {builds} BLAS built before "
              f"and after, the same triangle tensor: {_steps_text(steps)}")
        entity.local_transform = before
        scene.revision += 1
        renderer.refresh_scene()
        if not torch.equal(renderer.tables.inst_trace, first_rows):
            raise RuntimeError(f"{name}: the scene put back gives other "
                               "instance rows")
        scenes[name] = (scene, renderer.flat, renderer.tables)
    return scenes, renderers, seconds, steps_by


def _chunked_row(row, flat, tables, one_chunk, rays, any_hit: bool) -> dict:
    """K1 (nearest, the tables' shade mode, culling on) or K2 (any-hit) of
    `row` over every chunk of multi-chunk `tables`, as dispatch's sweep
    launches them: each chunk's kernel at the interval the sweep gives it
    (recorded from one sweep on the card; the t_max of a later chunk is the
    best t so far, of an occluded ray dead), timed as one closure that
    launches every chunk.  The work counts are summed over the chunks, the
    seen flags joined, the winners the sweep's global ids.  The plain
    version runs the same sweep over the chunks' plain versions on a strided
    subset (kernel_parity.TEX_SUBSET), and the kernels' sweep is held to it
    with kernel_parity's tolerances.  The same kernel is then timed over
    the same rays in one launch over `one_chunk`, the scene's one-chunk
    tables, and the row's bound is the smaller of the two (_least_bound)."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel import dispatch
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.apps.timing import time_ms

    mode = tables.shade_mode
    o, d, t_min, t_max = rays
    subset = kp.strided_subset(rays, kp.TEX_SUBSET)
    sweep = dispatch.sweep_any if any_hit else dispatch.sweep_nearest

    def kernel(chunk, o, d, t_min, chunk_tmax, counters=False):
        if any_hit:
            return ct.anyhit_launcher(chunk.bvh8, chunk.tris_packed, o, d,
                                      t_min, chunk_tmax, counters=counters,
                                      records=chunk.tri_records)
        return ct.kernel_launcher(chunk.bvh8, chunk.tris_packed, o, d, t_min,
                                  chunk_tmax, True, chunk.shade_packed, mode,
                                  counters=counters,
                                  records=chunk.tri_records)

    def traced(o, d, t_min, t_max, intervals=None):
        def trace(chunk, chunk_tmax):
            if intervals is not None:
                intervals.append(chunk_tmax)
            launch, rec = kernel(chunk, o, d, t_min, chunk_tmax)
            launch()
            if any_hit:
                return rec["hit"]
            rec["hit"] = rec["tri"] >= 0
            return rec
        return sweep(tables.chunks, trace, o, d, t_min, t_max)

    intervals = []
    swept = traced(o, d, t_min, t_max, intervals)

    def launcher(counters):
        parts = [kernel(chunk, o, d, t_min, tmx, counters)
                 for chunk, tmx in zip(tables.chunks, intervals)]
        rec = {}

        def launch():
            for part, _ in parts:
                part()
            if counters:
                recs = [r for _, r in parts]
                rec["counters"] = sum(r["counters"] for r in recs)
                for key in ("seen_nodes", "seen_records", "seen_fine"):
                    rec[key] = torch.cat([r[key] for r in recs])
                if not any_hit:
                    rec["tri"] = swept["tri"]

        return launch, rec

    def plain():
        def trace(chunk, chunk_tmax):
            if any_hit:
                return ct.trace_any_bvh8_plain(
                    chunk.bvh8, chunk.tris_packed, *subset[:3], chunk_tmax)
            return ct.trace_nearest_bvh8_plain(
                chunk.bvh8, chunk.tris_packed, *subset[:3], chunk_tmax, True,
                chunk.shade_packed, mode)
        return sweep(tables.chunks, trace, *subset)

    def check(plain_rec):
        rec = traced(*subset)
        torch.cuda.synchronize()
        results = {}
        label = " ".join(row)
        if any_hit:
            kp._compare_hits(label, rec, plain_rec, results)
        else:
            kp._compare(label, rec, plain_rec, flat.tri_pos.cpu().numpy(),
                        results, attrs={"nrm": flat.tri_nrm.cpu().numpy(),
                                        "mat": flat.tri_mat.cpu().numpy()},
                        d=subset[1].cpu().numpy())
        return results[label]

    live = [int((tmx >= t_min).sum()) for tmx in intervals]
    print(f"{' '.join(row)}: {len(tables.chunks)} chunks of "
          f"{[c.rows for c in tables.chunks]} rows; live rays by chunk after "
          f"the AABB pre-cull {live} of {o.shape[0]}")
    entry = _timed_kernel(row, launcher, plain, rays, subset[0].shape[0],
                          check)
    entry["chunks"] = len(tables.chunks)
    entry["live_by_chunk"] = live
    entry["shapes"] = (f"path C {row[2]}, 1280x720, {len(tables.chunks)} "
                       "chunks, one launch a chunk")
    whole = one_chunk.chunks[0]
    entry["one_chunk_ms"] = time_ms(kernel(whole, *rays)[0], 50)
    launch, rec = kernel(whole, *rays, counters=True)
    launch()
    one = _bound(row[0], rec, _live_rays(o.shape[0], t_min, t_max))
    print(f"{' '.join(row)}: the same rays in one launch over the one-chunk "
          f"tables ({whole.rows} rows): kernel {entry['one_chunk_ms']:.4f} "
          f"ms against the sweep's {entry['ms']:.4f}; " + _bound_text(one))
    _least_bound(row, entry, one, "one launch over the one-chunk tables")
    return entry


def _nearest_row(row, chunk, flat, mode, rays, subset, source=None,
                 plain_calls: int = 3):
    """Phase 3b's row of K1 or K3 (by shade `mode`, 0 to 2) through the
    chunk's record tables, as the render path calls it, on `rays`, held
    against its plain version on `subset` with kernel_parity's tolerances
    (`source`: the slots' source triangles, kernel_parity.source_ids, for
    spatial-split tables; `plain_calls` as _timed_kernel's)."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.apps import kernel_parity as kp

    args = (chunk.bvh8, chunk.tris_packed)
    shade = chunk.shade_packed if mode else None
    fields = {"nrm": flat.tri_nrm, "mat": flat.tri_mat} if mode else None
    if mode == 2:
        fields.update(tan=flat.tri_tan, uv=flat.tri_uv)

    def check(plain_rec):
        rec = ct.trace_nearest_bvh8(*args, *subset, True, shade, mode,
                                    records=chunk.tri_records)
        torch.cuda.synchronize()
        results = {}
        kp._compare(" ".join(row), rec, plain_rec,
                    flat.tri_pos.cpu().numpy(), results,
                    attrs=fields and {k: v.cpu().numpy()
                                      for k, v in fields.items()},
                    d=subset[1].cpu().numpy(), source=source)
        return results[" ".join(row)]

    return _timed_kernel(
        row, lambda counters: ct.kernel_launcher(
            *args, *rays, True, shade, mode, counters=counters,
            records=chunk.tri_records),
        lambda: ct.trace_nearest_bvh8_plain(*args, *subset, True, shade,
                                            mode),
        rays, subset[0].shape[0], check, width=chunk.bvh8.width,
        plain_calls=plain_calls)


def _anyhit_row(row, chunk, rays, plain_calls: int = 3):
    """Phase 3b's row of K2 (or K2-dense, by the chunk's tables) alone on
    `rays`, held against its plain version on a strided subset
    (`plain_calls` as _timed_kernel's)."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel.dispatch import anyhit_tables
    from steeljax_torch.apps import kernel_parity as kp

    bvh8, tris, records, dense = anyhit_tables(chunk)
    subset = kp.strided_subset(rays, kp.SHADOW_SUBSET)

    def check(plain_hit):
        hit = ct.trace_any_bvh8(bvh8, tris, *subset, dense, records=records)
        results = {}
        kp._compare_hits(row[0], hit, plain_hit, results)
        return results[row[0]]

    return _timed_kernel(
        row, lambda counters: ct.anyhit_launcher(
            bvh8, tris, *rays, dense=dense, counters=counters,
            records=records),
        lambda: ct.trace_any_bvh8_plain(bvh8, tris, *subset, dense),
        rays, subset[0].shape[0], check, width=bvh8.width,
        plain_calls=plain_calls)


def phase_parity(device, scenes) -> dict:
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.apps import kernel_parity as kp

    results = kp.run(device, width=WIDTH, height=HEIGHT, scenes=scenes)
    if not results["ok"]:
        raise RuntimeError("kernel parity failed: " + ", ".join(
            k for k, v in results["variants"].items() if not v["ok"]))
    var = results["variants"]
    if len(var) != PARITY_VARIANTS:
        raise RuntimeError(f"kernel parity ran {len(var)} variants, "
                           f"expected {PARITY_VARIANTS}")
    print(f"kernel parity: all {len(var)} variants PASS")

    def max_err(names, fields=("max_t_delta", "max_normal_delta",
                               "max_tan_delta", "max_uv_delta")):
        return max(var[n].get(f, 0.0) for n in names for f in fields)

    kernels = {
        "K1": {"max_abs_err": max_err(
            ["flat_shade0_cull1", "flat_shade0_cull0", "flat_shade1",
             "flat_deterministic_exact", f"cornell_primary_{WIDTH}x{HEIGHT}",
             "cornell_bounce1", "flat_shade0_shared_origin",
             f"hybrid_gbuffer_{kp.HYBRID_WIDTH}x{kp.HYBRID_HEIGHT}",
             "chunked_shade0", "flat_shade0_width16"]),
            "tolerance": "|dt| < 2e-3, |dn| < 5e-3, hit mismatches <= "
                         "max(2, N/5000)"},
        "K3": {"max_abs_err": max_err(["flat_shade2", "stress_tex_primary"]),
               "tolerance": "|dt| < 2e-3, |dn|, |dtan|, |duv| < 5e-3, 0 "
                            "material mismatches"},
    }
    # An occlusion flag is 0 or 1: its error is the mismatch count, held to
    # max(2, N/5000).
    for name, names in (("K2", ("flat_anyhit", "sunlit_shadow",
                                "hybrid_sun_shadow", "chunked_anyhit",
                                "anyhit_width16")),
                        ("K2_dense", ("flat_anyhit_dense",
                                      "sunlit_shadow_dense"))):
        kernels[name] = {
            "max_abs_err": float(max(var[n]["hit_mismatches"] > 0
                                     for n in names)),
            "mismatches": {n: var[n]["hit_mismatches"] for n in names},
            "tolerance": "hit mismatches <= max(2, N/5000)"}
    kernels["K4"] = {
        "max_abs_err": max_err(["flat_alpha_mask", "flat_fine_mask",
                                "foliage_primary", "foliage_shadow",
                                "alpha_width16"]),
        "tolerance": "|dt| < 2e-3, hit mismatches <= max(2, N/5000)"}
    names = ("flat_alpha_mask_anyhit", "flat_fine_mask_anyhit")
    kernels["K4_anyhit"] = {
        "max_abs_err": float(max(var[n]["hit_mismatches"] > 0
                                 for n in names)),
        "mismatches": {n: var[n]["hit_mismatches"] for n in names},
        "tolerance": "hit mismatches <= max(2, N/5000)"}
    kernels["K5"] = {
        "max_abs_err": max_err(["flat_multihit", "flat_multihit_masked",
                                "flat_multihit_fine", "foliage_multihit",
                                "multihit_width16"],
                               ("max_t_delta", "max_uv_delta_same_tri")),
        "slot_mismatches": {n: var[n]["slot_mismatches"] for n in (
            "flat_multihit", "flat_multihit_masked", "flat_multihit_fine",
            "foliage_multihit", "multihit_width16")},
        "tolerance": "|dt| < 2e-3, |du|, |dv| < 5e-3 on equal tri ids, "
                     "slot mismatches <= max(2, N K/5000)"}

    # K1 on the Cornell primary rays (as the first slice measured it), K1 on
    # path L's primaries and first-bounce rays, where its frames spend 2.4
    # ms (the later bounces carry most of it), and K3 on path T's (below):
    # each through the chunk's record tables, as the render path calls it,
    # and each held against its plain version on the plain version's rays
    # with kernel_parity's tolerances.
    cflat, ctables, cases = kp.cornell_cases(device, WIDTH, HEIGHT)
    kernels["K1"].update(_nearest_row(("K1", "Cornell", PRIMARIES),
                                      ctables.chunks[0], cflat, 1,
                                      cases["primary"], cases["primary"]))
    kernels["K1"]["shapes"] = "Cornell primary rays, 1280x720"
    scene, flat, tables = scenes["sunlit"]
    path_l_rays = {
        PRIMARIES: kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4],
        BOUNCE1: kp.first_bounce_case(scene, flat, tables, WIDTH, HEIGHT),
        SHADOW: kp.sunlit_shadow_case(scene, flat, tables, WIDTH, HEIGHT)}
    for key, ray_set in (("path_l", PRIMARIES), ("path_l_bounce1", BOUNCE1)):
        rays = path_l_rays[ray_set]
        kernels["K1"][key] = _nearest_row(
            ("K1", "path L", ray_set), tables.chunks[0], flat,
            tables.shade_mode, rays,
            kp.strided_subset(rays, kp.SHADOW_SUBSET))

    # K2 and K2-dense on path L's first-bounce shadow rays.
    rays = path_l_rays[SHADOW]
    for name, chunk in (("K2", tables.chunks[0]),
                        ("K2_dense", scenes["sunlit_dense"][2].chunks[0])):
        kernels[name].update(_anyhit_row((name, "path L", SHADOW), chunk,
                                         rays))
        kernels[name]["mismatches"][f"path L {SHADOW}"] = (
            kernels[name]["parity"]["hit_mismatches"])
        kernels[name]["max_abs_err"] = float(
            max(kernels[name]["mismatches"].values()) > 0)
        kernels[name]["shapes"] = ("path L first-bounce shadow rays, "
                                   "1280x720")

    # K1 and K2 at the hybrid frame's shapes (path H: path L's scene at the
    # JAX bench's 1920x1080): the G-buffer's pixel-centre rays in shade
    # mode 1, and the lighting stage's sun rays, sky and unlit pixels dead.
    hw, hh = kp.HYBRID_WIDTH, kp.HYBRID_HEIGHT
    rays = kp.hybrid_rays(scene, device, hw, hh)[:4]
    kernels["K1"]["path_h"] = _nearest_row(
        ("K1", "path H", GBUFFER), tables.chunks[0], flat,
        tables.shade_mode, rays, kp.strided_subset(rays, kp.SHADOW_SUBSET))
    kernels["K1"]["path_h"]["shapes"] = (f"path H G-buffer rays, {hw}x{hh}, "
                                         "shade mode 1")
    kernels["K2"]["path_h"] = _anyhit_row(
        ("K2", "path H", SUN), tables.chunks[0],
        kp.hybrid_shadow_case(scene, flat, tables, hw, hh))
    kernels["K2"]["path_h"]["shapes"] = (f"path H sun rays, {hw}x{hh}, sky "
                                         "and unlit pixels dead")
    kernels["K2"]["mismatches"][f"path H {SUN}"] = (
        kernels["K2"]["path_h"]["parity"]["hit_mismatches"])

    # Path L at supernode width 16 (path L16): K1 on path L's primaries and
    # first-bounce rays, K2 on its first-bounce shadow rays, each row's
    # bound no larger than path L's row on the same rays.
    _, flat, tables = scenes["sunlit_w16"]
    chunk = tables.chunks[0]
    if chunk.bvh8.width != 16:
        raise RuntimeError("path L16's tables are not 16 wide")
    same_rays = "path L's row on the same rays, 8-wide rows"
    for key, ray_set, l_key in (("path_l16", PRIMARIES, "path_l"),
                                ("path_l16_bounce1", BOUNCE1,
                                 "path_l_bounce1")):
        rays = path_l_rays[ray_set]
        row = ("K1", "path L16", ray_set)
        kernels["K1"][key] = _nearest_row(
            row, chunk, flat, tables.shade_mode, rays,
            kp.strided_subset(rays, kp.SHADOW_SUBSET))
        _least_bound(row, kernels["K1"][key], kernels["K1"][l_key],
                     same_rays)
        kernels["K1"][key]["shapes"] = (f"path L16 {ray_set} (path L's), "
                                        "1280x720, 16-wide supernode rows")
    row = ("K2", "path L16", SHADOW)
    kernels["K2"]["path_l16"] = _anyhit_row(row, chunk, path_l_rays[SHADOW])
    _least_bound(row, kernels["K2"]["path_l16"], kernels["K2"], same_rays)
    kernels["K2"]["path_l16"]["shapes"] = ("path L16 first-bounce shadow "
                                           "rays (path L's), 1280x720, "
                                           "16-wide rows")
    kernels["K2"]["mismatches"][f"path L16 {SHADOW}"] = (
        kernels["K2"]["path_l16"]["parity"]["hit_mismatches"])

    # Path C, above one chunk: K1 and K2 over both chunks, as the sweep
    # launches them (_chunked_row).
    scene, flat, tables = scenes["sunlit_chunked"]
    rays = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    one_chunk = scenes["sunlit_one_chunk"][2]
    kernels["K1"]["path_c"] = _chunked_row(
        ("K1", "path C", PRIMARIES), flat, tables, one_chunk, rays, False)
    rays = kp.sunlit_shadow_case(scene, flat, tables, WIDTH, HEIGHT)
    kernels["K2"]["path_c"] = _chunked_row(
        ("K2", "path C", SHADOW), flat, tables, one_chunk, rays, True)
    kernels["K2"]["mismatches"][f"path C {SHADOW}"] = (
        kernels["K2"]["path_c"]["parity"]["hit_mismatches"])
    kernels["K2"]["max_abs_err"] = float(
        max(kernels["K2"]["mismatches"].values()) > 0)

    scene, flat, tables = scenes["stress_tex"]
    rays = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    kernels["K3"].update(_nearest_row(("K3", "path T", PRIMARIES),
                                      tables.chunks[0], flat, 2, rays,
                                      kp.strided_subset(rays,
                                                        kp.TEX_SUBSET)))
    kernels["K3"]["shapes"] = "path T primary rays, 1280x720"
    rays = kp.first_bounce_case(scene, flat, tables, WIDTH, HEIGHT)
    kernels["K3"]["bounce1"] = _nearest_row(
        ("K3", "path T", BOUNCE1), tables.chunks[0], flat, 2, rays,
        kp.strided_subset(rays, kp.TEX_SUBSET))
    nearest_rows = {("K1", "Cornell", PRIMARIES): kernels["K1"],
                    ("K1", "path L", PRIMARIES): kernels["K1"]["path_l"],
                    ("K1", "path L", BOUNCE1):
                        kernels["K1"]["path_l_bounce1"],
                    ("K1", "path H", GBUFFER): kernels["K1"]["path_h"],
                    ("K1", "path L16", PRIMARIES): kernels["K1"]["path_l16"],
                    ("K1", "path L16", BOUNCE1):
                        kernels["K1"]["path_l16_bounce1"],
                    ("K1", "path C", PRIMARIES): kernels["K1"]["path_c"],
                    ("K3", "path T", PRIMARIES): kernels["K3"],
                    ("K3", "path T", BOUNCE1): kernels["K3"]["bounce1"]}
    for name in ("K1", "K3"):
        kernels[name]["max_abs_err"] = max(
            kernels[name]["max_abs_err"],
            *(entry["parity_max_abs_err"]
              for row, entry in nearest_rows.items() if row[0] == name))
    print("per-ray counts of K1 and K3 (alpha8.cu NEAREST without masks): "
          + "; ".join(f"{' '.join(row)}: " + ", ".join(
              f"{c} {v:.3f}" for c, v in entry["per_ray"].items()
              if c in ("supernode_pops", "leaf_pops", "triangle_tests"))
              for row, entry in nearest_rows.items()))

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
        ("K4", "path F", PRIMARIES), lambda counters: ct.kernel_launcher(
            *args, *rays, True, None, 0, counters=counters, **kw),
        lambda: ct.trace_nearest_bvh8_plain(*args, *subset, True, None, 0,
                                            **kw),
        rays, subset[0].shape[0]))
    kernels["K4"]["shapes"] = ("path F primary rays, 1280x720, coarse and "
                               "fine masks")
    k_hits = kp.FOLIAGE_MULTIHIT_K
    kernels["K5"].update(_timed_kernel(
        ("K5", "path F", PRIMARIES), lambda counters: ct.multihit_launcher(
            *args, *rays, k_hits, True, counters=counters, **kw),
        lambda: ct.trace_multihit_bvh8_plain(*args, *subset, k_hits, True,
                                             **kw),
        rays, subset[0].shape[0]))
    kernels["K5"]["shapes"] = (f"path F primary rays, 1280x720, K = "
                               f"{k_hits}, coarse and fine masks")
    shadow = kp.foliage_shadow_case(scene, flat, tables, WIDTH, HEIGHT)
    kernels["K4_anyhit"].update(_timed_kernel(
        ("K4_anyhit", "path F", "first-bounce sun rays"), lambda counters: ct.anyhit_launcher(
            *args, *shadow, counters=counters, **kw),
        lambda: ct.trace_any_bvh8_plain(*args, *cases["shadow"], **kw),
        shadow, cases["shadow"][0].shape[0]))
    kernels["K4_anyhit"]["shapes"] = ("path F first-bounce sun rays, "
                                      "1280x720, coarse and fine masks")
    print("per-ray counts of alpha8.cu: " + "; ".join(
        f"{k} ({kernels[k]['shapes'].split(',')[0]}): " + ", ".join(
            f"{c} {v:.2f}" for c, v in kernels[k]["per_ray"].items())
        for k in ("K4", "K4_anyhit", "K5")))
    kernels.update(_k6_k7_kernels(device, scenes, var, max_err))
    return kernels


def _k6_k7_kernels(device, scenes, var, max_err) -> dict:
    """The entries of the two-level kernel K6 and the treelet kernel K7:
    parity errors of their variants, and their times alone at their paths'
    shapes.  K6 in shade mode 1 and its any-hit query on path I's primaries
    and first-bounce shadow rays, K6 in mode 2 ("K6_shade2") on path J's
    primaries; K7 in mode 2 on path U's primaries, in mode 1 ("K7_shade1")
    and as the any-hit query on path UL's primaries and shadow rays.  Each
    entry's error comes from variants of its own mode, the path's own rays
    and tables among them (K7_shade1: treelets_shade1 on the soup and
    treelets_lit_primary on path UL's primaries; K7_anyhit: treelets_anyhit
    and treelets_shadow on path UL's first-bounce shadow rays)."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.apps import kernel_parity as kp

    fused = ("max_t_delta", "max_normal_delta", "max_tan_delta",
             "max_uv_delta", "max_uvd_rel_delta")
    nearest_tol = ("|dt| < 2e-3, |dn|, |dtan|, |duv| < 5e-3, uv density "
                   "within 5e-3 relative, 0 material mismatches, hit "
                   "mismatches <= max(2, N/5000)")
    flags_tol = "hit mismatches <= max(2, N/5000)"

    def flags(names):
        return {"max_abs_err": float(max(var[n]["hit_mismatches"] > 0
                                         for n in names)),
                "mismatches": {n: var[n]["hit_mismatches"] for n in names},
                "tolerance": flags_tol}

    kernels = {
        "K6": {"max_abs_err": max_err(
            ["instanced_fused", "instanced_shade0", "instanced_primary"],
            fused), "tolerance": nearest_tol},
        "K6_shade2": {"max_abs_err": max_err(
            ["instanced_shade2", "instanced_tex_primary"], fused),
            "tolerance": nearest_tol},
        "K6_anyhit": flags(["instanced_anyhit", "instanced_shadow"]),
        "K7": {"max_abs_err": max_err(
            ["treelets_shade0", "treelets_alpha_mask", "treelets_shade2",
             "treelets_primary"], fused),
            "tolerance": nearest_tol},
        "K7_shade1": {"max_abs_err": max_err(
            ["treelets_shade1", "treelets_lit_primary"], fused),
            "tolerance": nearest_tol},
        "K7_anyhit": flags(["treelets_anyhit", "treelets_shadow"]),
    }

    scene, flat, tables = scenes["sunlit_inst"]
    rays = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    subset = kp.strided_subset(rays, kp.SHADOW_SUBSET)
    kernels["K6"].update(_timed_kernel(
        ("K6", "path I", PRIMARIES), lambda counters: ct.inst_launcher(
            tables, *rays, True, counters=counters),
        lambda: ct.trace_nearest_bvh8_inst_plain(tables, *subset, True),
        rays, subset[0].shape[0]))
    kernels["K6"]["shapes"] = ("path I primary rays, 1280x720, shade mode "
                               f"1, {tables.instance_count} instances")
    shadow = kp.sunlit_shadow_case(scene, flat, tables, WIDTH, HEIGHT)
    subset = kp.strided_subset(shadow, kp.SHADOW_SUBSET)
    kernels["K6_anyhit"].update(_timed_kernel(
        ("K6_anyhit", "path I", SHADOW), lambda counters: ct.inst_launcher(
            tables, *shadow, False, True, counters=counters),
        lambda: ct.trace_nearest_bvh8_inst_plain(tables, *subset, False,
                                                 True),
        shadow, subset[0].shape[0]))
    kernels["K6_anyhit"]["shapes"] = ("path I first-bounce shadow rays, "
                                      "1280x720")

    scene, flat, tables_j = scenes["stress_tex_inst"]
    rays_j = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    subset_j = kp.strided_subset(rays_j, kp.TEX_SUBSET)
    kernels["K6_shade2"].update(_timed_kernel(
        ("K6_shade2", "path J", PRIMARIES), lambda counters: ct.inst_launcher(
            tables_j, *rays_j, True, counters=counters),
        lambda: ct.trace_nearest_bvh8_inst_plain(tables_j, *subset_j, True),
        rays_j, subset_j[0].shape[0]))
    kernels["K6_shade2"]["shapes"] = (
        "path J primary rays, 1280x720, shade mode 2, "
        f"{tables_j.instance_count} instances")

    scene, flat, tables_u = scenes["stress_tex_treelets"]
    rays_u = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    kernels["K7"].update(_timed_treelet_trace(
        "K7", tables_u.treelets, rays_u,
        kp.strided_subset(rays_u, kp.TEX_SUBSET), True, False))
    kernels["K7"]["shapes"] = ("path U primary rays, 1280x720, shade mode "
                               "2, every round of one trace")
    kernels["K7_pick"] = _timed_treelet_pick(tables_u.treelets, rays_u,
                                             False)
    kernels["K7_pick"]["shapes"] = ("the first pick of one trace of path U's "
                                    "primary rays, 1280x720")
    scene, flat, tables_ul = scenes["sunlit_treelets"]
    rays_ul = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    kernels["K7_shade1"].update(_timed_treelet_trace(
        "K7_shade1", tables_ul.treelets, rays_ul,
        kp.strided_subset(rays_ul, kp.TEX_SUBSET), True, False))
    kernels["K7_shade1"]["shapes"] = ("path UL primary rays, 1280x720, "
                                      "shade mode 1, every round of one "
                                      "trace")
    shadow = kp.sunlit_shadow_case(scene, flat, tables_ul, WIDTH, HEIGHT)
    kernels["K7_anyhit"].update(_timed_treelet_trace(
        "K7_anyhit", tables_ul.treelets, shadow,
        kp.strided_subset(shadow, kp.TEX_SUBSET), False, True))
    kernels["K7_anyhit"]["shapes"] = ("path UL first-bounce shadow rays, "
                                      "1280x720, every round of one trace")
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


def _profile_frames(run_frame, frames: int = 2, spans=(),
                    top: int = 6) -> dict:
    """Device time of `frames` frames under torch.profiler: per frame, the
    summed device time of all kernels, of each trace kernel (the kernels in
    its launches' profiler ranges, cuda_traverse.PROFILER_RANGE and the
    LAUNCHES key; of each path stage kernel, stages.PROFILER_RANGE, under
    "stage_ms") and of the largest device kernels, the number of device
    kernels, the calls of SYNC_CALLS (the window's closing synchronize adds
    one cudaDeviceSynchronize per `frames`), and the host wall time under
    the profiler.  For each
    record_function range named in `spans`, its device span per frame
    (first kernel's start to last kernel's end, gaps included) under
    "span_ms"; the `top` largest device kernels under "top"; the device's
    copies per frame by kind (the profiler's "Memcpy DtoD (Device ->
    Device)", "Memcpy HtoD (Pageable -> Device)", ...) under "copies": a
    copy from or to pageable host memory waits for the host, a copy
    between device buffers does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from steeljax_torch.accel.cuda_traverse import PROFILER_RANGE
    from steeljax_torch.render.pt import stages

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
    stage: dict = {}
    span: dict = {}
    copies: dict = {}
    largest = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.key.startswith(
                "Memcpy"):
            copies[evt.key] = copies.get(evt.key, 0.0) + evt.count / frames
        if evt.key in spans:
            if evt.device_type == DeviceType.CUDA:
                span[evt.key] = evt.device_time_total / 1000.0 / frames
        elif evt.key.startswith(PROFILER_RANGE):
            # The range's device side spans the one kernel it launched.
            if evt.device_type == DeviceType.CUDA:
                trace[evt.key[len(PROFILER_RANGE):]] = (
                    evt.self_device_time_total / 1000.0 / frames)
        elif evt.key.startswith(stages.PROFILER_RANGE):
            if evt.device_type == DeviceType.CUDA:
                stage[evt.key[len(stages.PROFILER_RANGE):]] = (
                    evt.self_device_time_total / 1000.0 / frames)
        elif evt.device_type == DeviceType.CUDA and \
                not evt.is_user_annotation:
            busy += evt.self_device_time_total
            kernels += evt.count
            largest.append((evt.self_device_time_total / 1000.0 / frames,
                        evt.count / frames, evt.key))
        elif evt.key in syncs:
            syncs[evt.key] += evt.count / frames
    return {"wall_ms": wall_ms, "busy_ms": busy / 1000.0 / frames,
            "kernels": kernels / frames, "syncs": syncs,
            "trace_ms": trace, "stage_ms": stage, "span_ms": span,
            "copies": copies,
            "top": sorted(largest, reverse=True)[:top]}


def _reset_launches() -> None:
    from steeljax_torch.accel import cuda_traverse, treelets
    from steeljax_torch.render import surface
    from steeljax_torch.render.pt import stages

    for counts in (cuda_traverse.LAUNCHES, treelets.SCHEDULER,
                   stages.LAUNCHES, surface.COUNTS):
        for name in counts:
            counts[name] = 0


def drive_path(label, scene, flat, tables, expected: dict,
               frames: int = TIMED_FRAMES, spans=()) -> dict:
    """Render two warm and `frames` timed 1280x720 frames of a prepared
    scene through render_pixels, with fresh frame graphs (the first warm
    frame runs eagerly, the second captures, the timed frames replay) and
    the launch counts set to 0 just before and read just after; check the
    launches of the frames the host ran (each kernel of `expected` launches
    that many times per bounce, and each path stage kernel, nee and sample,
    once, every other kernel never, the alpha test's kernel included; a
    replay launches from the host nothing that the counters see),
    rays_traced, the image
    and, above the repack threshold, the sorts (the repack before every
    secondary bounce and, in alpha-tested scenes, the rejected-first
    compaction of every material and shadow ray's re-trace); hold the last
    timed frame bit for bit against the same frame run eagerly; profile 2
    more frames (eager, as every frame under a profiler).  In alpha-tested
    scenes print the rays still to re-trace before and after each re-trace
    pass of the first timed frame.  A kernel whose `expected` count is None
    launches as often as the data asks (the treelet kernel: once per round
    of the scheduler): it must launch at least once per bounce of a frame
    the host ran, and the scheduler must have traced once per material and
    per shadow trace, with one launch of the pick kernel and K rounds per
    trace and no host read; the traces, rounds (the launches) and host
    reads per frame are printed.  The profiled frames also give the device
    span of each record_function range named in `spans`.  Returns the
    launches, ms/frame, rays/s, rays per frame, the last frame, and the
    profiled frames' busy time, device kernels, trace kernels' times and
    spans."""
    from steeljax_torch.accel import cuda_traverse, treelets
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core import profiling
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render import surface
    from steeljax_torch.render.pt import frame_graphs, integrator, stages

    expected = {"nee": 1, "sample": 1, **expected}
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

    graphs = integrator.FRAME_GRAPHS
    integrator.repack_rays = counting_repack
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(
        frame_graphs.CudaGraphs())
    warm = 2  # eager, then the capture
    try:
        _reset_launches()
        for i in range(warm):
            step(i)
        torch.cuda.synchronize()
        rays = []
        t0 = time.perf_counter()
        for i in range(warm, warm + frames):
            result, stats = step(i)
            if i == warm:
                retraces = stats["alpha_retrace"]
            rays.append(stats["rays_traced"])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {**cuda_traverse.LAUNCHES, **stages.LAUNCHES,
                    "alpha": surface.COUNTS["alpha"]}
        scheduler = dict(treelets.SCHEDULER)
    finally:
        integrator.repack_rays = repack
        integrator.FRAME_GRAPHS = graphs
    ran = [row["ran"] for row in
           profiling.record()["rows"][-(warm + frames):]]
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.Eager())
    try:
        eager, eager_stats = step(warm + frames - 1)
    finally:
        integrator.FRAME_GRAPHS = graphs
    if not (torch.equal(eager, result) and torch.equal(
            eager_stats["rays_traced"], stats["rays_traced"])):
        raise RuntimeError(f"{label}: the last timed frame ({ran[-1]}) "
                           "differs from the same frame run eagerly")

    # Frames the host ran; a replay launches nothing the counters see.
    total = len(ran) - ran.count("replay")
    print(f"{label}: frames ran " + ", ".join(
        f"{how} {ran.count(how)}" for how in ("eager", "capture", "replay")))
    bounces = config.max_bounce_count
    for name, count in launches.items():
        if name in expected and expected[name] is None:
            if count < total * bounces:
                raise RuntimeError(
                    f"{label}: {name} launched {count} times over {total} "
                    f"frames of {bounces} bounces")
            continue
        want = total * bounces * expected.get(name, 0)
        if count != want:
            raise RuntimeError(f"{label}: {name} launched {count} times "
                               f"over {total} frames, expected {want}")
    repacks = integrator._total_triangles(tables) > integrator.REPACK_MIN_TRIS
    traced = 1 + (flat.light_count > 0)  # material and shadow rays
    if getattr(tables, "treelets", None) is not None:
        k = tables.treelets.count
        rounds = launches["K7"] + launches["K7_anyhit"]
        traces, reads = scheduler["traces"], scheduler["host_reads"]
        if traces != total * bounces * traced or rounds != k * traces or \
                launches["K7_pick"] != traces or reads != 0:
            raise RuntimeError(
                f"{label}: the treelet scheduler counted {traces} traces "
                f"and {reads} host reads for {rounds} round launches and "
                f"{launches['K7_pick']} picks ({k} treelets)")
        print(f"{label} treelet scheduler over {total} frames: "
              f"{traces} traces, rounds (= launches) "
              + ", ".join(f"{k} {launches[k]}" for k in ("K7", "K7_anyhit"))
              + f", {launches['K7_pick']} picks, {reads} host reads; per "
              f"frame {traces / total:.1f} traces, {rounds / total:.1f} "
              f"rounds ({k} per trace), {reads / total:.1f} host reads")
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

    prof = _profile_frames(lambda: step(warm + frames), spans=spans)
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
                          sorted(prof["trace_ms"].items())) + "); stage "
              "kernels " + ", ".join(f"{k} {v:.3f} ms" for k, v in
                                     sorted(prof["stage_ms"].items()))
              + "".join(f"; range {k} {prof['span_ms'].get(k, 0.0):.3f} ms"
                        for k in spans))
        for ms, count, key in prof["top"]:
            print(f"  {ms:8.3f} ms/frame in {count:6.0f} launches: "
                  f"{key[:90]}")
    else:
        print(f"{label}: torch.profiler recorded no device time: kernel "
              "share and idle share not measured")
    return {"launches": launches, "host_frames": total,
            "ms_frame": ms_frame, "rays_per_s": rays_per_s, "rays_frame": sum(per_frame) / frames,
            "image": image, "scheduler": scheduler,
            "busy_ms": prof["busy_ms"], "device_kernels": prof["kernels"],
            "trace_ms": prof["trace_ms"], "stage_ms": prof["stage_ms"],
            "span_ms": prof["span_ms"]}


def _same_frame(label, ours: dict, ref_label, ref: dict) -> None:
    """Hold a path's last frame and rays_traced against the flat path of
    the same scene (IMAGE_MEAN_RTOL, IMAGE_PIXEL_ATOL, IMAGE_PIXEL_FRACTION,
    RAYS_RTOL)."""
    image, flat_image = ours["image"], ref["image"]
    mean, flat_mean = float(image.mean()), float(flat_image.mean())
    beyond = float((np.abs(image - flat_image).max(axis=-1)
                    > IMAGE_PIXEL_ATOL).mean())
    rays, flat_rays = ours["rays_frame"], ref["rays_frame"]
    print(f"{label} against {ref_label}: image mean {mean:.6f} vs "
          f"{flat_mean:.6f}, {100.0 * beyond:.4f}% of the pixels differ by "
          f"more than {IMAGE_PIXEL_ATOL}, max |delta| "
          f"{float(np.abs(image - flat_image).max()):.3e}; rays per frame "
          f"{rays:.0f} vs {flat_rays:.0f}")
    if abs(mean - flat_mean) > IMAGE_MEAN_RTOL * flat_mean or \
            beyond > IMAGE_PIXEL_FRACTION or \
            abs(rays - flat_rays) > RAYS_RTOL * flat_rays:
        raise RuntimeError(f"{label} does not render {ref_label}'s frame")


def _stage_tensors(value) -> list:
    """The tensors of a stage argument or output: a tensor, a tuple of them
    (the (t, b, n) frame, the direct term, the shadow ray with its float
    t_min) or None."""
    if value is None:
        return []
    if isinstance(value, (tuple, list)):
        return [x for x in value if torch.is_tensor(x)]
    return [value]


def _stage_bytes(stage: str, args: dict, out: dict) -> int:
    """The bytes a path stage kernel must move in one call: each tensor it
    reads (STAGE_INPUTS) once, a broadcast one (row stride 0, the primary
    rays' origin) one row in all, and each output it writes once (an output
    that is an input, such as sample's o, is not written)."""
    n = args["seed"].shape[0]

    def size(x, rows):
        return x.element_size() * (x.shape[1] if x.dim() == 2 else 1) * rows

    inputs = []
    for name in STAGE_INPUTS[stage]:
        inputs += _stage_tensors(args["surface"][name] if name in
                                 args["surface"] else args[name])
    read = {x.data_ptr() for x in inputs}
    written = {x.data_ptr(): x for value in out.values()
               for x in _stage_tensors(value) if x.data_ptr() not in read}
    return (sum(size(x, n if x.stride(0) else 1) for x in inputs)
            + sum(size(x, n) for x in written.values()))


def _graph_ms(fn, reps: int = 5) -> float:
    """Device ms of `fn()` captured once as a CUDA graph and replayed, as
    the frame graph runs it: the host's gaps between its launches do not
    count."""
    from steeljax_torch.apps.timing import time_ms

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, reps)
    del graph
    return ms


def phase_stages(scenes) -> dict:
    """Phase 5c, the path stage kernels nee and sample (csrc/pathstage.cu)
    on path L's scene: one eager 1280x720 frame's stage calls are
    recorded, and on each bounce's inputs (921,600 rays) each kernel is held
    against its plain version (render/pt/stages.py, run on the card): flags,
    seeds and every float output bit-equal, or the phase raises.  Each
    kernel's device ms is the mean of STAGE_TIMED_LAUNCHES launches queued
    behind a device sleep, its plain version's that of one call captured as
    a CUDA graph and replayed, so the host's launch gaps count in neither;
    its bound is the bytes it reads and writes (_stage_bytes) over
    PEAK_BYTES_PER_S.  Returns {stage: its row}, the times and bounds summed
    over the frame's bounces, with each bounce's under "bounces"."""
    import inspect

    from steeljax_torch.apps.timing import queued_ms
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt import frame_graphs, integrator, stages

    scene, flat, tables = scenes["sunlit"]
    device = flat.device
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    config = RenderConfig(width=WIDTH, height=HEIGHT)
    px, py, _ = integrator.tiled_order(WIDTH, HEIGHT)
    px, py, inverse_view, inverse_proj = (
        torch.as_tensor(a, device=device)
        for a in (px, py, frame.inverse_view, frame.inverse_proj))
    real = {"nee": stages.nee_stage, "sample": stages.sample_stage}
    plain = {"nee": stages._nee_stage_plain,
             "sample": stages._sample_stage_plain}
    seen = {name: [] for name in real}

    def recording(name):
        def run(*args, **kwargs):
            bound = inspect.signature(real[name]).bind(*args, **kwargs)
            bound.apply_defaults()
            seen[name].append(dict(bound.arguments))
            return real[name](*args, **kwargs)
        return run

    graphs = integrator.FRAME_GRAPHS
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.Eager())
    stages.nee_stage, stages.sample_stage = (recording("nee"),
                                             recording("sample"))
    try:
        integrator.render_pixels(
            flat, tables, inverse_view, inverse_proj, frame.camera_near,
            frame.camera_far, WIDTH, HEIGHT, px, py, 0, 0, config)
    finally:
        stages.nee_stage, stages.sample_stage = real["nee"], real["sample"]
        integrator.FRAME_GRAPHS = graphs
    torch.cuda.synchronize()
    if flat.light_count < 1 or any(len(calls) != config.max_bounce_count
                                   for calls in seen.values()):
        raise RuntimeError(f"path stages: {flat.light_count} lights, calls "
                           + ", ".join(f"{k} {len(v)}"
                                       for k, v in seen.items()))

    rows = {}
    for name in real:
        bounces = []
        for bounce, args in enumerate(seen[name]):
            out = real[name](**args)
            got = {k: _stage_tensors(v) for k, v in out.items()}
            want = {k: _stage_tensors(v)
                    for k, v in plain[name](**args).items()}
            torch.cuda.synchronize()
            if set(got) != set(want):
                raise RuntimeError(f"path stage {name} bounce {bounce}: "
                                   f"outputs {sorted(got)} against "
                                   f"{sorted(want)}")
            differ = {}
            for key in want:
                for i, (a, b) in enumerate(zip(got[key], want[key])):
                    same = a == b
                    if b.dtype.is_floating_point:
                        same = same | (torch.isnan(a) & torch.isnan(b))
                    if a.shape != b.shape or a.dtype != b.dtype:
                        differ[f"{key}[{i}]"] = 1.0
                    elif not bool(same.all()):
                        differ[f"{key}[{i}]"] = float(
                            (~same).float().mean())
            if differ:
                raise RuntimeError(f"path stage {name} bounce {bounce}: the "
                                   "kernel differs from its plain version "
                                   f"(share of values by output) {differ}")
            kernel_ms = queued_ms(lambda: real[name](**args),
                                  STAGE_TIMED_LAUNCHES)
            plain_ms = _graph_ms(lambda: plain[name](**args))
            moved = _stage_bytes(name, args, out)
            bound_ms = moved / PEAK_BYTES_PER_S * 1e3
            rays = args["seed"].shape[0]
            print(f"path stage {name} bounce {bounce}: {rays} rays, every "
                  f"output bit-equal to the plain version; kernel "
                  f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms (a CUDA "
                  f"graph), bound {bound_ms:.4f} ms by bytes "
                  f"({moved / rays:.0f} B a ray), kernel/bound "
                  f"{kernel_ms / bound_ms:.2f}x")
            bounces.append({"ms": kernel_ms, "plain_ms": plain_ms,
                            "bound_ms": bound_ms, "bytes": moved,
                            "rays": rays})
        row = {k: sum(b[k] for b in bounces)
               for k in ("ms", "plain_ms", "bound_ms", "bytes")}
        rays = bounces[0]["rays"]
        row.update(bound_by="bytes", max_abs_err=0.0, bit_equal=True,
                   tolerance="bit-equal: flags, seeds and floats",
                   rays=rays, plain_rays=rays, bounces=bounces,
                   shapes=f"path L, {len(bounces)} bounces of {rays} rays, "
                          f"{flat.light_count} light")
        print(f"path stage {name} a frame: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms, "
              f"kernel/bound {row['ms'] / row['bound_ms']:.2f}x, plain/"
              f"kernel {row['plain_ms'] / row['ms']:.1f}x")
        rows[name] = row
    return rows


def _alpha_bytes(flat, rec) -> int:
    """The least bytes one alpha test of `rec` moves, each byte once: each
    ray's hit flag read and its verdict written (2 B; a miss reads nothing
    more); each hit's triangle id (4 B); of each distinct triangle hit, the
    32-byte sector of its shading row that holds the flags, the sector of
    alpha and cutoff where its material is alpha-tested, and the uv sector
    where it also samples a texture; and each hit on a triangle that
    samples, its (u, v) (8 B) and a 16-byte quad row of the texel pool, at
    most the whole pool."""
    from steeljax_torch.scene.flatten import TriShade
    from steeljax_torch.scene.material import MaterialFlags

    hit = rec["hit"]
    tri = rec["tri"][hit].long()
    distinct, count = torch.unique(tri, return_counts=True)
    rows = flat.tri_shade[distinct]
    tested = (rows[:, TriShade.FLAGS].to(torch.int32)
              & int(MaterialFlags.ALPHA_TEST)) != 0
    sampled = tested & (rows[:, TriShade.TEX_IDS.start].to(torch.int32)
                        >= 0) if flat.has_textures else torch.zeros_like(
                            tested)
    sampled_hits = int(count[sampled].sum())
    return (2 * hit.shape[0] + 4 * tri.numel()
            + 32 * (distinct.numel() + int(tested.sum())
                    + int(sampled.sum()))
            + 8 * sampled_hits + min(16 * sampled_hits, flat.atlas.numel()))


def phase_alpha(scenes) -> dict:
    """Phase 5d, the exact alpha test's kernel (csrc/alphatest.cu) on path
    F's scene: the records of one eager 1280x720 frame's 40 alpha tests
    ((1 trace + 4 re-trace passes) x (material + shadow) x 4 bounces) are
    recorded, each of which must have launched the kernel, and on each the
    kernel (surface.alpha_test) is held against
    its plain version (surface.alpha_rejected over surface.shade_rows, run
    on the card), bit for bit, or the phase raises.  Times a frame: the
    kernel's 40 launches queued behind a device sleep; the plain version's
    40 tests captured as one CUDA graph and replayed; the bound, the least
    bytes the tests move (_alpha_bytes) over PEAK_BYTES_PER_S.  Returns
    {"alpha": its row}."""
    from steeljax_torch.apps.timing import device_ms
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render import surface
    from steeljax_torch.render.pt import frame_graphs, integrator

    scene, flat, tables = scenes["foliage"]
    device = flat.device
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    config = RenderConfig(width=WIDTH, height=HEIGHT)
    px, py, _ = integrator.tiled_order(WIDTH, HEIGHT)
    px, py, inverse_view, inverse_proj = (
        torch.as_tensor(a, device=device)
        for a in (px, py, frame.inverse_view, frame.inverse_proj))
    real = integrator.alpha_test
    recs = []

    def recording(scene_, tables_, rec):
        recs.append({k: rec[k].clone() for k in ("hit", "tri", "u", "v")})
        return real(scene_, tables_, rec)

    graphs = integrator.FRAME_GRAPHS
    integrator.FRAME_GRAPHS = frame_graphs.FrameGraphs(frame_graphs.Eager())
    integrator.alpha_test = recording
    frame_launches = surface.COUNTS["alpha"]
    try:
        integrator.render_pixels(
            flat, tables, inverse_view, inverse_proj, frame.camera_near,
            frame.camera_far, WIDTH, HEIGHT, px, py, 0, 0, config)
    finally:
        integrator.alpha_test = real
        integrator.FRAME_GRAPHS = graphs
    torch.cuda.synchronize()
    want_tests = (config.max_bounce_count * (1 + (flat.light_count > 0))
                  * (1 + config.max_alpha_retrace))
    frame_launches = surface.COUNTS["alpha"] - frame_launches
    if len(recs) != want_tests or frame_launches != want_tests:
        raise RuntimeError(f"alpha test: {len(recs)} tests and "
                           f"{frame_launches} kernel launches in a frame, "
                           f"expected {want_tests}")

    def plain(rec):
        return surface.alpha_rejected(flat, rec,
                                      surface.shade_rows(flat, tables, rec))

    launches = []
    for i, rec in enumerate(recs):
        before = surface.COUNTS["alpha"]
        got = surface.alpha_test(flat, tables, rec)
        want = plain(rec)
        torch.cuda.synchronize()
        if surface.COUNTS["alpha"] != before + 1:
            raise RuntimeError(f"alpha test {i}: the kernel did not launch")
        if not torch.equal(got, want):
            raise RuntimeError(
                f"alpha test {i}: the kernel differs from its plain version "
                f"on {int((got != want).sum())} of {want.shape[0]} rays")
        launches.append(surface.alpha_launcher(flat, tables, rec)[0])
    hits = [int(rec["hit"].sum()) for rec in recs]
    kernel_ms = device_ms(lambda: None, launches)
    plain_ms = _graph_ms(lambda: [plain(rec) for rec in recs])
    moved = sum(_alpha_bytes(flat, rec) for rec in recs)
    bound_ms = moved / PEAK_BYTES_PER_S * 1e3
    rays = recs[0]["hit"].shape[0]
    print(f"alpha test: {len(recs)} tests of {rays} rays a frame, "
          f"{sum(hits)} hits ({min(hits)}-{max(hits)} a test), every "
          f"verdict equal to the plain version's; a frame: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms (a CUDA graph), "
          f"bound {bound_ms:.4f} ms by bytes ({moved} B), kernel/bound "
          f"{kernel_ms / bound_ms:.2f}x, plain/kernel "
          f"{plain_ms / kernel_ms:.1f}x")
    row = {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bytes": moved, "bound_by": "bytes", "max_abs_err": 0.0,
           "bit_equal": True, "tolerance": "bit-equal: every verdict",
           "rays": rays, "plain_rays": rays, "launches": len(recs),
           "hits": hits,
           "shapes": f"path F, the {len(recs)} tests of one frame of "
                     f"{rays} rays"}
    return {"alpha": row}


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
    out["prepared"] = (scene, flat, tables)

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
    __graft_entry__ Cornell tile, the lit parity scene, a small foliage
    scene (300 serrated leaf cards in a 6 x 6 region, coarse and fine
    masks) seen from inside the canopy, as tests/test_torch_foliage_slice.py
    renders it, and the lit parity scene through the two-level structure
    and through treelets (cut at 16 triangles, leaf size 8, so that the
    tile's rays cross several treelets); then 48x27 hybrid frames of
    Cornell, the lit parity scene and the small foliage scene."""
    from steeljax_torch.accel.instances import InstancedAccel
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

    def flat_tables(scene, dev):
        flat, tables = prepare_scene(scene, dev, env_resolution=16)
        chunk = tables.chunks[0]
        return flat, tables, {"tris_packed": chunk.tris_packed,
                              "fine_mask_rows": chunk.fine_mask_rows}

    def instanced_tables(scene, dev):
        flat, tables = prepare_scene(scene, dev, env_resolution=16,
                                     accel=InstancedAccel(device=dev))
        return flat, tables, {name: getattr(tables, name) for name in (
            "snode_rows", "tris_packed", "inst_trace", "shade_rows")}

    def treelet_tables(scene, dev):
        flat, tables = prepare_scene(scene, dev, env_resolution=16,
                                     leaf_size=8, treelets=True,
                                     treelet_tris=16)
        tt = tables.treelets
        if tt.count < 4:
            raise RuntimeError(f"only {tt.count} treelets in the tile's "
                               "scene")
        return flat, tables, {name: getattr(tt, name) for name in (
            "node_stack", "tri_stack", "shade_stack")}

    ys, xs = np.meshgrid(np.arange(TILE_H), np.arange(TILE_W), indexing="ij")
    # A diverging pixel may trace up to `per_pixel` rays more or fewer: 4
    # segments, and with a light 4 shadow rays too.
    for label, make, prepare, per_pixel in (
            ("Cornell", lambda: make_cornell_scene(6), flat_tables, 4),
            ("parity (lit)", lambda: make_parity_scene(4), flat_tables, 8),
            ("foliage (alpha)", foliage, flat_tables, 8),
            ("parity (lit, instanced)", lambda: make_parity_scene(4),
             instanced_tables, 8),
            ("parity (lit, treelets)", lambda: make_parity_scene(4),
             treelet_tables, 8)):
        outs = {}
        prepared = {}
        # One scene for both devices: the two-level structure pools its BLAS
        # in the order of the primitives' identities.
        scene = make()
        for dev in (device, "cpu"):
            flat, tables, prepared[str(dev)] = prepare(scene, dev)
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
        for name in prepared["cpu"]:
            a, b = (prepared[k][name] for k in (str(device), "cpu"))
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

    # Hybrid tiles (48x27 frames of HybridRenderer) on the card against the
    # CPU, both lit from one environment baked on the CPU: Cornell (K1),
    # the lit parity scene (K1 and K2 for the sun rays) and the small
    # foliage scene (the G-buffer's alpha re-trace and the sun rays through
    # K4).  The same bake on the card is held to the CPU's first.
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.env.environment import load_environment
    from steeljax_torch.render.hybrid.renderer import HybridRenderer

    env = load_environment(device="cpu", **TILE_ENV)
    _same_bake("tile budgets", load_environment(device=device, **TILE_ENV),
               env, TILE_ENV)
    hw, hh = HYBRID_TILE_W, HYBRID_TILE_H
    for label, make, kernels in (
            ("Cornell (hybrid)", lambda: make_cornell_scene(6), ("K1",)),
            ("parity (lit, hybrid)", lambda: make_parity_scene(4),
             ("K1", "K2")),
            ("foliage (alpha, hybrid)", foliage, ("K4",))):
        scene = make()
        frames = {}
        for dev in (device, "cpu"):
            flat, tables = prepare_scene(scene, dev, env_resolution=16)
            _reset_launches()
            frames[str(dev)] = HybridRenderer(
                scene, hw, hh, RenderConfig(width=hw, height=hh),
                environment=env.to(dev), prepared=(flat, tables),
                device=dev).render_frame()
            if dev == device:
                launched = {k: v for k, v in cuda_traverse.LAUNCHES.items()
                            if v}
        gpu, cpu = frames[str(device)], frames["cpu"]
        delta = np.abs(gpu - cpu).max(axis=-1)
        diverging = int((delta > PIXEL_ATOL).sum())
        n = hw * hh
        print(f"{label} tile {hw}x{hh}: card vs CPU max |delta| "
              f"{float(delta.max()):.3e}, {diverging} of {n} pixels beyond "
              f"{PIXEL_ATOL}; the card's launches {launched}")
        if diverging > max(2, n // 200) or float(gpu.std()) <= 0.0 or \
                any(not launched.get(k) for k in kernels):
            raise RuntimeError(f"the card's {label} tile diverges from the "
                               f"CPU's or skipped one of {kernels}")


# The card's IBL bake against the CPU's, with tests/test_torch_ibl.py's
# tolerances against the reference (another float32 evaluation of the same
# sums): 1e-5 of the table's largest value, the split-sum LUT's rows at
# roughness^4 < 1e-3 and reflection mip 0 (ill-conditioned GGX samples) to
# 1e-3 and 1e-4, the SH coefficients to 1e-4 and of the same order.  A
# reflection mip may also be held to SEAM_FACTOR times its seam
# sensitivity (_seam_sensitivity), where that is larger.
BAKE_RTOL, ILL_LUT_RTOL, MIP0_RTOL, SH_RTOL, ILL_A2 = (1e-5, 1e-3, 1e-4,
                                                       1e-4, 1e-3)
SEAM_PATTERNS, SEAM_FACTOR = 4, 2.0


def _seam_sensitivity(cpu, samples: int) -> list:
    """Per reflection mip of the CPU's bake `cpu` (`samples` samples a
    texel), the largest relative
    change when every sample direction moves by one float32 ulp (a seeded
    +-2^-23 pattern, SEAM_PATTERNS of them).  A 1-texel face's direction
    is a face's centre and the Hammersley azimuths hit multiples of pi/4,
    so some samples lie exactly on a face seam, where the face a sample
    reads is decided by the last bit of its direction; a 16-texel source
    changes by a few percent across a seam near the horizon.  At the tile
    budgets the last mip moves by 1e-3-3e-3 this way, at the bench budgets
    no mip by more than 4e-6 (a 64-texel source, 128 samples): the card's
    own last bits may flip other seam samples than the CPU's."""
    from unittest import mock

    from steeljax_torch.env import ibl

    sample = ibl.sample_flat_mips
    resolution = cpu.reflection_mips[0].shape[1]
    worst = [0.0] * len(cpu.reflection_mips)
    for seed in range(SEAM_PATTERNS):
        g = torch.Generator().manual_seed(seed)

        def nudged(data, offsets, sizes, direction, lod):
            sign = torch.randint(0, 2, direction.shape, generator=g) * 2 - 1
            return sample(data, offsets, sizes,
                          direction * (1.0 + 2.0 ** -23 * sign), lod)

        with mock.patch.object(ibl, "sample_flat_mips", nudged):
            mips = ibl.generate_reflection_mips(
                cpu.cube, resolution, samples)
        for m, (a, b) in enumerate(zip(mips, cpu.reflection_mips)):
            worst[m] = max(worst[m], float((a - b).abs().max())
                           / max(float(b.abs().max()), 1e-30))
    return worst


def _same_bake(label, card, cpu, budgets: dict) -> None:
    """Raise unless the environment `card` baked on the card holds to the
    one `cpu` baked on the CPU at the same `budgets` (the tolerances
    above)."""
    def rel(a, b):
        a, b = a.cpu().double(), b.double()
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    res = cpu.specular_lut.shape[0]
    good = ((torch.arange(res) + 0.5) / res) ** 4 >= ILL_A2
    errors = {
        "cube": (rel(card.cube, cpu.cube), 0.0),
        "irradiance": (rel(card.irradiance, cpu.irradiance), BAKE_RTOL),
        "specular_lut": (rel(card.specular_lut, cpu.specular_lut),
                         ILL_LUT_RTOL),
        "specular_lut (a2 >= 1e-3)": (rel(card.specular_lut[good],
                                          cpu.specular_lut[good]),
                                      BAKE_RTOL)}
    if len(card.reflection_mips) != len(cpu.reflection_mips):
        raise RuntimeError("the card's bake has another reflection chain")
    seams = _seam_sensitivity(cpu, budgets["reflection_samples"])
    for m, (a, b) in enumerate(zip(card.reflection_mips,
                                   cpu.reflection_mips)):
        errors[f"reflection mip {m}"] = (rel(a, b), max(
            MIP0_RTOL if m == 0 else BAKE_RTOL, SEAM_FACTOR * seams[m]))
    if (card.irradiance_sh is None) != (cpu.irradiance_sh is None) or (
            cpu.irradiance_sh is not None
            and card.irradiance_sh.shape != cpu.irradiance_sh.shape):
        raise RuntimeError("the card's SH fit picked another order than the "
                           "CPU's")
    if cpu.irradiance_sh is not None:
        errors["irradiance_sh"] = (rel(card.irradiance_sh,
                                       cpu.irradiance_sh), SH_RTOL)
    order = (0 if cpu.irradiance_sh is None
             else round(cpu.irradiance_sh.shape[0] ** 0.5))
    print(f"IBL bake at the {label}: card vs CPU, SH order {order} on both; "
          "largest difference / largest value: " + ", ".join(
              f"{k} {e:.2e} (<= {t:.2e})" for k, (e, t) in errors.items())
          + "; seam sensitivity of the reflection mips "
          + ", ".join(f"{v:.2e}" for v in seams))
    bad = [k for k, (e, t) in errors.items() if e > t]
    if bad:
        raise RuntimeError(f"the card's IBL bake differs from the CPU's: "
                           f"{bad}")


def phase_instanced_edit(device, scenes, renderers, flat_prepare_s) -> None:
    """Path I's edit: after its frames, one entity moves, the scene's
    revision is bumped and refresh_scene() re-prepares.  No BLAS may be
    rebuilt and the triangle tensor must be the same object.  The seconds of
    the re-preparation are printed beside a flat prepare_scene of the edited
    scene (and of path L in phase 3a), and the refreshed renderer's frame
    is held against the flat renderer's.  Then the scene is put back: the
    refresh rewrites path I's tables in place, and phases 18 and 20 hold
    those tables to rays and records taken before the edit."""
    from steeljax_torch.apps import kernel_parity
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.pt.renderer import (PathTracingRenderer,
                                                   prepare_scene)

    scene = scenes["sunlit_inst"][0]
    renderer = renderers["sunlit_inst"]
    before = renderer.render_frame()
    builds = renderer._accel.blas_builds
    tris = renderer.tables.tris_packed
    rows = renderer.tables.inst_trace.clone()  # rewritten in place
    entity = scene.entities[scene.renderable_entities()[-1]]
    kept = entity.local_transform
    kernel_parity.move_entity(scene)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.refresh_scene()
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    if renderer._accel.blas_builds != builds:
        raise RuntimeError("refresh_scene() rebuilt a BLAS")
    if renderer.tables.tris_packed is not tris:
        raise RuntimeError("refresh_scene() replaced the triangle tensor")
    if torch.equal(renderer.tables.inst_trace, rows):
        raise RuntimeError("refresh_scene() left the instance rows as they "
                           "were")
    if renderer.state.index != 0:
        raise RuntimeError("refresh_scene() kept the accumulation")
    t0 = time.perf_counter()
    prepared = prepare_scene(scene, device, env_resolution=64)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    print(f"path I edit: refresh_scene() {refresh_s:.4f} s "
          f"({renderer.tables.instance_count} instances, {builds} BLAS "
          "built before and after, the same triangle tensor); a flat "
          f"prepare_scene of the edited scene {flat_s:.3f} s, path L's in "
          f"phase 3a {flat_prepare_s:.3f} s")
    after = renderer.render_frame()
    flat_frame = PathTracingRenderer(
        scene, WIDTH, HEIGHT, RenderConfig(width=WIDTH, height=HEIGHT),
        prepared=prepared, device=device).render_frame()
    moved = float(np.abs(after - before).max())
    beyond = float((np.abs(after - flat_frame).max(axis=-1)
                    > IMAGE_PIXEL_ATOL).mean())
    print(f"path I edit: the refreshed frame differs from the frame before "
          f"by up to {moved:.3f}; against the flat renderer's frame of the "
          f"edited scene mean {float(after.mean()):.6f} vs "
          f"{float(flat_frame.mean()):.6f}, {100.0 * beyond:.4f}% of the "
          f"pixels beyond {IMAGE_PIXEL_ATOL} (display values)")
    if moved <= IMAGE_PIXEL_ATOL:
        raise RuntimeError("the edit does not show in the refreshed frame")
    if abs(float(after.mean()) - float(flat_frame.mean())) > \
            IMAGE_MEAN_RTOL * float(flat_frame.mean()) or \
            beyond > IMAGE_PIXEL_FRACTION:
        raise RuntimeError("the refreshed frame is not the flat renderer's")
    entity.local_transform = kept
    scene.revision += 1
    renderer.refresh_scene()
    if not torch.equal(renderer.tables.inst_trace, rows):
        raise RuntimeError("path I: the scene put back gives other instance "
                           "rows")


def _timed_bake(**kwargs):
    """load_environment(**kwargs) on the card and its host seconds, ending
    in a synchronize."""
    from steeljax_torch.env.environment import load_environment

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env = load_environment(**kwargs)
    torch.cuda.synchronize()
    return env, time.perf_counter() - t0


def _hybrid_frames(renderer, frames: int) -> tuple:
    """One warm and `frames` timed frames of render_frame_device: (ms per
    timed frame, the last frame)."""
    renderer.render_frame_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        image = renderer.render_frame_device()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1000.0 / frames, image


def phase_hybrid(device, scenes) -> dict:
    """Path H, the JAX bench's hybrid frame (bench.py:213-260): path L's
    scene (prepared in phase 3a by prepare_scene(scene, device,
    env_resolution=64)), its environment baked by load_environment at the
    bench's budgets, HybridRenderer(...).render_frame_device() at
    1920x1080: one warm and HYBRID_TIMED_FRAMES timed frames with the launch
    counts set to 0 just before and read just after (one K1 and one K2
    launch a frame, no other kernel), the frame's checks (finite, not
    constant), 2 frames under torch.profiler (device busy, K1 and K2, the
    stages' device spans), the stage split of tools/probe_hybrid_stages.py
    (full, ray_tracing_enabled=False, debug_view="normals"), the
    reflection lookup's two forms, the bake's host seconds at the bench
    budgets and at load_environment's defaults (the bench bake held to the
    CPU's), and render_cli --mode hybrid's PNG."""
    import dataclasses

    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.apps import render_cli
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.env.environment import load_environment
    from steeljax_torch.render.hybrid.renderer import HybridRenderer

    scene, flat, tables = scenes["sunlit"]
    width, height = kp.HYBRID_WIDTH, kp.HYBRID_HEIGHT
    env, bench_s = _timed_bake(cube=flat.env_cube,
                               analytic=flat.env_analytic, device=device,
                               **BENCH_ENV)
    default_env, default_s = _timed_bake(device=device)
    sh_order = (0 if env.irradiance_sh is None
                else round(env.irradiance_sh.shape[0] ** 0.5))
    print(f"load_environment: bench budgets {bench_s:.3f} s (reflection "
          f"mips {len(env.reflection_mips)}, SH irradiance "
          f"{env.irradiance_sh is not None}, of order {sh_order}); "
          f"defaults (256-texel "
          f"sky, 2,048-sample reflection, 256x256 LUT at 4,096 samples) "
          f"{default_s:.3f} s (mips {len(default_env.reflection_mips)}, SH "
          f"irradiance {default_env.irradiance_sh is not None})")
    del default_env
    _same_bake("bench budgets", env, load_environment(
        cube=flat.env_cube.cpu(), analytic=flat.env_analytic, device="cpu",
        **BENCH_ENV), BENCH_ENV)
    config = RenderConfig(width=width, height=height)

    def renderer_for(**changes):
        return HybridRenderer(scene, width, height,
                              dataclasses.replace(config, **changes),
                              environment=env, prepared=(flat, tables),
                              device=device)

    renderer = renderer_for()
    _reset_launches()
    ms_frame, image = _hybrid_frames(renderer, HYBRID_TIMED_FRAMES)
    launches = dict(cuda_traverse.LAUNCHES)
    total = 1 + HYBRID_TIMED_FRAMES
    want = {name: total if name in ("K1", "K2") else 0 for name in launches}
    if launches != want:
        raise RuntimeError(f"path H launched {launches} over {total} "
                           f"frames, expected {want}")
    image = image.cpu().numpy()
    if image.shape != (width * height, 3) or not np.isfinite(image).all():
        raise RuntimeError(f"path H: bad frame {image.shape}")
    if float(image.std()) <= 0.0:
        raise RuntimeError("path H: constant frame")
    print(f"path H {width}x{height}: {ms_frame:.3f} ms/frame over "
          f"{HYBRID_TIMED_FRAMES} timed frames; launches over {total} "
          "frames " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                if v) + f" (K1 {launches['K1'] / total:.0f}"
          f", K2 {launches['K2'] / total:.0f} a frame, no other kernel); "
          f"image mean {float(image.mean()):.4f}")

    stages = ("gbuffer_stage", "lighting_stage", "forward_stage")
    prof = _profile_frames(renderer.render_frame_device, spans=stages,
                           top=12)
    trace_ms = {}
    if prof["busy_ms"] > 0.0:
        trace_ms = prof["trace_ms"]
        share = sum(trace_ms.values())
        print(f"path H torch.profiler, per frame: device busy "
              f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall "
              f"under the profiler (idle share "
              f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.3f}); "
              f"{prof['kernels']:.0f} device kernels, "
              + ", ".join(f"{k} {v:.1f}" for k, v in prof["syncs"].items())
              + f"; trace kernels {share:.3f} ms = "
              f"{100.0 * share / prof['busy_ms']:.1f}% of device time ("
              + ", ".join(f"{k} {v:.3f} ms" for k, v in
                          sorted(trace_ms.items())) + "); stage device "
              "spans " + ", ".join(f"{k} {prof['span_ms'].get(k, 0.0):.3f} "
                                   "ms" for k in stages))
        for ms, count, key in prof["top"]:
            print(f"  {ms:8.3f} ms/frame in {count:6.0f} launches: "
                  f"{key[:90]}")
    else:
        print("path H: torch.profiler recorded no device time: busy and "
              "idle share not measured")

    # The operators behind the device time, by input shapes (one frame).
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as shapes_prof:
        renderer.render_frame_device()
        torch.cuda.synchronize()
    ops = sorted((e for e in shapes_prof.key_averages(
        group_by_input_shape=True) if e.self_device_time_total > 0),
        key=lambda e: e.self_device_time_total, reverse=True)[:10]
    for e in ops:
        print(f"  path H operator {e.key} {str(e.input_shapes)[:110]}: "
              f"{e.self_device_time_total / 1000.0:.3f} ms device in "
              f"{e.count} calls")

    split = {}
    for name, changes in (("full", {}),
                          ("no_shadows", {"ray_tracing_enabled": False}),
                          ("gbuffer_only", {"debug_view": "normals"})):
        split[name], _ = _hybrid_frames(renderer_for(**changes),
                                        HYBRID_TIMED_FRAMES)
    print(f"path H stage split (tools/probe_hybrid_stages.py's variants, "
          f"{HYBRID_TIMED_FRAMES} timed frames each): "
          + ", ".join(f"{k} {v:.3f} ms/frame" for k, v in split.items())
          + f"; shadow trace and its lighting "
          f"{split['full'] - split['no_shadows']:.3f} ms, primary trace and "
          f"G-buffer {split['gbuffer_only']:.3f} ms, lighting, IBL and "
          f"forward {split['no_shadows'] - split['gbuffer_only']:.3f} ms")

    reflection = _reflection_forms(renderer, env)

    with tempfile.TemporaryDirectory() as tmp:
        png_path = Path(tmp) / "hybrid.png"
        render_cli.main(["builtin:cornell", "--mode", "hybrid", "-o",
                         str(png_path), "--size", "64x36", "--device",
                         "cuda"])
        png = _png_pixels(png_path)
        if png.shape != (36, 64, 3) or png.std() == 0:
            raise RuntimeError(f"render_cli --mode hybrid PNG bad: "
                               f"{png.shape}, std {png.std()}")
        print(f"render_cli --mode hybrid: 64x36 PNG, mean {png.mean():.2f}, "
              f"std {png.std():.2f}")
    return {"launches": launches, "ms_frame": ms_frame, "trace_ms": trace_ms,
            "split": split, "bake_s": {"bench": bench_s,
                                       "default": default_s},
            "reflection_ms": reflection, "env": env}


def _reflection_forms(renderer, env) -> dict:
    """The lighting stage's reflection lookup of one path H frame, on the
    frame's own directions and levels, in the two bit-exact forms of the
    reflection chain: the mip-pair rows it reads (sample_flat_mips_tri,
    one 48-float gather a pixel) and the quad rows (sample_flat_mips, two
    16-float gathers).  Raises unless they agree bit for bit; returns the
    device ms of each (timing.time_ms)."""
    from unittest import mock

    from steeljax_torch.apps.timing import time_ms
    from steeljax_torch.env import cubemap
    from steeljax_torch.render.hybrid import lighting

    seen = []

    def record(*args):
        seen.append(args)
        return cubemap.sample_flat_mips_tri(*args)

    with mock.patch.object(lighting, "sample_flat_mips_tri", record):
        renderer.render_frame_device()
    (*tri, direction, lod), = seen
    quads = cubemap.pack_mips(env.reflection_mips, direction.device)
    if not torch.equal(cubemap.sample_flat_mips(*quads, direction, lod),
                       cubemap.sample_flat_mips_tri(*tri, direction, lod)):
        raise RuntimeError("path H: the mip-pair rows differ from the quad "
                           "rows")
    ms = {"mip_pair_rows": time_ms(lambda: cubemap.sample_flat_mips_tri(
        *tri, direction, lod)),
        "quad_rows": time_ms(lambda: cubemap.sample_flat_mips(
            *quads, direction, lod))}
    print(f"path H reflection lookup ({direction.shape[0]} pixels, "
          f"{len(env.reflection_mips)} mips), equal bit for bit: mip-pair "
          f"rows ({tri[0].shape[0]}, 48) {ms['mip_pair_rows']:.4f} ms, quad "
          f"rows ({quads[0].shape[0]}, 16) {ms['quad_rows']:.4f} ms")
    return ms


def phase_chunked(scenes, path_l) -> dict:
    """Path C: the sunlit stress scene above one chunk (2,633,508
    triangles, two chunks at MAX_CHUNK_TRIS), two warm and TIMED_FRAMES
    frames through render_pixels, K1 and K2 launched once per chunk per
    trace: twice path L's launches.  Prints the launches a frame, ms/frame,
    device busy and device kernels a frame beside path L's (the difference
    in kernels is the sweep's pre-cull and merge).  Then the same scene
    prepared as one chunk renders the same frames (one K1 and one K2
    launch a trace), and path C's frame is held to its frame: an
    independent check of the sweep's merge, its global ids and its
    shrinking t_max."""
    scene, flat, tables = scenes["sunlit_chunked"]
    n = len(tables.chunks)
    if n != 2:
        raise RuntimeError(f"path C has {n} chunks, expected 2")
    out = drive_path("path C", scene, flat, tables, {"K1": n, "K2": n})
    frames = out["host_frames"]
    for k in ("K1", "K2"):
        if out["launches"][k] * path_l["host_frames"] != \
                n * path_l["launches"][k] * frames:
            raise RuntimeError(f"path C launched {k} {out['launches'][k]} "
                               f"times in {frames} frames, path L "
                               f"{path_l['launches'][k]} in "
                               f"{path_l['host_frames']}")
    print(f"path C: {n} chunks of {[c.rows for c in tables.chunks]} rows; "
          f"K1 {out['launches']['K1'] / frames:.0f} and K2 "
          f"{out['launches']['K2'] / frames:.0f} launches a frame ({n}x path "
          f"L's); {out['ms_frame']:.3f} ms/frame against path L's "
          f"{path_l['ms_frame']:.3f}; device busy {out['busy_ms']:.3f} ms "
          f"against {path_l['busy_ms']:.3f}; {out['device_kernels']:.0f} "
          f"device kernels a frame against {path_l['device_kernels']:.0f}")
    scene, flat, one_chunk = scenes["sunlit_one_chunk"]
    if len(one_chunk.chunks) != 1:
        raise RuntimeError(f"path C's one-chunk tables have "
                           f"{len(one_chunk.chunks)} chunks")
    whole = drive_path("path C one chunk", scene, flat, one_chunk,
                       {"K1": 1, "K2": 1})
    _same_frame("path C", out, "path C one chunk", whole)
    print(f"path C against one chunk ({one_chunk.chunks[0].rows} rows): "
          f"{out['ms_frame']:.3f} against {whole['ms_frame']:.3f} ms/frame, "
          f"device busy {out['busy_ms']:.3f} against {whole['busy_ms']:.3f} "
          f"ms, {out['device_kernels']:.0f} against "
          f"{whole['device_kernels']:.0f} device kernels a frame")
    out["one_chunk"] = {k: whole[k] for k in ("ms_frame", "busy_ms",
                                              "device_kernels")}
    return out


def phase_wide(scenes, path_l) -> dict:
    """Path L16: path L's scene with 16-wide supernode rows
    (prepare_scene(snode_width=16)), the same frames and checks as path L,
    its frame held to path L's, its ms/frame and device busy beside path
    L's."""
    out = drive_path("path L16", *scenes["sunlit_w16"], {"K1": 1, "K2": 1})
    _same_frame("path L16", out, "path L", path_l)
    print(f"path L16 against path L (width 16 against 8): "
          f"{out['ms_frame']:.3f} against {path_l['ms_frame']:.3f} ms/frame, "
          f"device busy {out['busy_ms']:.3f} against "
          f"{path_l['busy_ms']:.3f} ms")
    return out


def write_cornell_gltf(path: Path) -> None:
    """make_cornell_scene() as a GLTF file: its primitives (positions,
    normals, tangents, uvs, uint32 indices), its materials (the lamp's
    emission as emissiveFactor), one node per entity with its matrix and a
    mesh of its render objects, and its camera; the buffer as a base64 data
    URI.  No image textures (the Cornell box has none)."""
    import base64

    from steeljax_torch.scene.builtin import make_cornell_scene

    scene = make_cornell_scene()
    blob, views, accessors = bytearray(), [], []

    def accessor(array, kind, component):
        array = np.ascontiguousarray(array)
        blob.extend(b"\0" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": array.nbytes})
        blob.extend(array.tobytes())
        accessors.append({"bufferView": len(views) - 1,
                          "componentType": component, "type": kind,
                          "count": len(array)})
        return len(accessors) - 1

    prims = []
    for prim in scene.primitives:
        tangents = np.concatenate(
            [prim.tangents, np.ones((len(prim.tangents), 1), np.float32)], 1)
        prims.append(({"POSITION": accessor(prim.positions, "VEC3", 5126),
                       "NORMAL": accessor(prim.normals, "VEC3", 5126),
                       "TANGENT": accessor(tangents, "VEC4", 5126),
                       "TEXCOORD_0": accessor(prim.tex_coords, "VEC2",
                                              5126)},
                      accessor(prim.indices, "SCALAR", 5125)))
    materials = [{"pbrMetallicRoughness": {
        "baseColorFactor": [float(v) for v in m.base_color_factor],
        "metallicFactor": float(m.metallic_factor),
        "roughnessFactor": float(m.roughness_factor)},
        "emissiveFactor": [float(v) for v in m.emission_factor[:3]],
        "doubleSided": bool(m.double_sided)} for m in scene.materials]
    meshes, nodes = [], []
    for entity in scene.entities:
        node = {"name": entity.name, "matrix": [
            float(v) for v in np.asarray(entity.local_transform).T.ravel()]}
        if entity.render_objects:
            node["mesh"] = len(meshes)
            meshes.append({"primitives": [
                {"attributes": prims[ro.primitive][0],
                 "indices": prims[ro.primitive][1],
                 "material": ro.material} for ro in entity.render_objects]})
        nodes.append(node)
    proj = scene.camera_projection
    nodes.append({"name": "camera", "camera": 0, "translation": [
        float(v) for v in scene.camera_location.position]})
    doc = {"asset": {"version": "2.0"}, "scene": 0,
           "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
           "meshes": meshes, "materials": materials,
           "cameras": [{"type": "perspective", "perspective": {
               "yfov": proj.y_fov, "aspectRatio": proj.width / proj.height,
               "znear": proj.z_near, "zfar": proj.z_far}}],
           "accessors": accessors, "bufferViews": views,
           "buffers": [{"byteLength": len(blob),
                        "uri": "data:application/octet-stream;base64,"
                        + base64.b64encode(bytes(blob)).decode()}]}
    path.write_text(json.dumps(doc))


def write_testsystem_gltf(directory: Path) -> Path:
    """The TestSystem's scene as GLTF files in `directory`: cornell.gltf
    (write_cornell_gltf), which is also the `damaged_helmet` prefab (1,188
    triangles), and host.gltf, the Cornell box with a node named
    `damaged_helmet` that declares that prefab (its `scene_prefab` extras)
    and a `damaged_helmet_spawn` node that places it, at a fifth of its
    size, on the floor of the box.  Returns host.gltf's path."""
    prefab = directory / "cornell.gltf"
    write_cornell_gltf(prefab)
    doc = json.loads(prefab.read_text())
    spawn = np.diag([0.2, 0.2, 0.2, 1.0]).astype(np.float32)
    spawn[:3, 3] = (0.5, -4.0, 1.0)
    doc["nodes"] += [
        {"name": "damaged_helmet", "extras": {"scene_prefab": prefab.name}},
        {"name": "damaged_helmet_spawn",
         "matrix": [float(v) for v in spawn.T.ravel()]}]
    doc["scenes"][0]["nodes"] += [len(doc["nodes"]) - 2,
                                  len(doc["nodes"]) - 1]
    host = directory / "host.gltf"
    host.write_text(json.dumps(doc))
    return host


def phase_gltf() -> None:
    """A GLTF file of the Cornell box (write_cornell_gltf) rendered by
    `python -m steeljax_torch.apps.render_cli FILE --device cuda
    --validate` in a subprocess; its PNG must be 64x36 and not constant,
    and load_scene of the file must flatten to make_cornell_scene()'s
    triangle count."""
    from steeljax_torch.scene import load_scene
    from steeljax_torch.scene.builtin import make_cornell_scene
    from steeljax_torch.scene.flatten import flatten_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cornell.gltf"
        write_cornell_gltf(path)
        loaded = flatten_scene(load_scene(path), "cpu").source_tri_count
        built = flatten_scene(make_cornell_scene(), "cpu").source_tri_count
        if loaded != built:
            raise RuntimeError(f"the GLTF Cornell box flattens to {loaded} "
                               f"triangles, make_cornell_scene to {built}")
        png_path = Path(tmp) / "cornell_gltf.png"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "steeljax_torch.apps.render_cli",
             str(path), "-o", str(png_path), "--size", "64x36", "--spp",
             "2", "--device", "cuda", "--validate"],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600)
        print(proc.stdout.strip())
        if proc.returncode != 0:
            raise RuntimeError(f"render_cli on the GLTF file failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        png = _png_pixels(png_path)
        if png.shape != (36, 64, 3) or png.std() == 0:
            raise RuntimeError(f"GLTF render_cli PNG bad: {png.shape}, std "
                               f"{png.std()}")
        print(f"GLTF Cornell box ({path.stat().st_size} bytes, {loaded} "
              f"triangles, as make_cornell_scene) through render_cli "
              f"--device cuda --validate in {time.perf_counter() - t0:.1f} s "
              f"(the subprocess's start included): 64x36 PNG, mean "
              f"{png.mean():.2f}, std {png.std():.2f}")


def _engine_scene(prefab_path: Path):
    """Path L's scene with the TestSystem's `damaged_helmet` prefab (the
    GLTF Cornell box at `prefab_path`, loaded through scene.load_scene) and
    a `damaged_helmet_spawn` entity that places it, at a quarter of its
    size, before the box's open side."""
    from steeljax_torch.scene import load_scene
    from steeljax_torch.scene.builtin import make_sunlit_stress_scene
    from steeljax_torch.scene.scene import Entity

    scene = make_sunlit_stress_scene()
    scene.emplace_scene_prefab(load_scene(prefab_path), "damaged_helmet")
    spawn = np.diag([0.25, 0.25, 0.25, 1.0]).astype(np.float32)
    spawn[:3, 3] = (2.0, -2.0, 6.5)
    scene.add_entity(Entity(name="damaged_helmet_spawn",
                            local_transform=spawn))
    return scene


def _engine_launches(label, launches: dict, want: dict) -> None:
    """Raise unless each kernel of `want` launched (a count, or None for
    any count above 0) and no other did."""
    bad = {k: v for k, v in launches.items()
           if (k not in want and v) or (k in want and (
               v == 0 if want[k] is None else v != want[k]))}
    if bad:
        raise RuntimeError(f"{label}: launches {launches}, expected {want}")


def _timed_tick(engine, dt: float) -> tuple:
    """(frame, host seconds) of one Engine.tick: the tick ends with the
    frame on the host."""
    t0 = time.perf_counter()
    frame = engine.tick(dt)
    return frame, time.perf_counter() - t0


def _held_to_fresh(label, frame, scene, config, env, mode, device,
                   frames: int = 1, pt_rays=None) -> None:
    """Hold the engine's `frame` to a fresh instanced SceneRenderer of the
    scene as it stands (the same mode and environment, `frames` frames since
    its accumulation began): 0 pixels beyond PIXEL_ATOL, and in path
    tracing `pt_rays`, the engine's rays_traced of its last frame, equal;
    then to a flat SceneRenderer of the same state by IMAGE_MEAN_RTOL,
    IMAGE_PIXEL_ATOL and IMAGE_PIXEL_FRACTION."""
    from steeljax_torch.render.scene_renderer import SceneRenderer

    images, rays = [], []
    for instancing in (True, False):
        fresh = SceneRenderer(scene, config.width, config.height, config,
                              environment=env, mode=mode,
                              instancing=instancing, device=device)
        for _ in range(frames):
            image = fresh.render_frame()
        images.append(image)
        if pt_rays is not None:
            rays.append(_last_frame_rays(fresh.path_tracer))
    fresh_image, flat_image = images
    delta = np.abs(frame - fresh_image).max(axis=-1)
    beyond = int((delta > PIXEL_ATOL).sum())
    flat_beyond = float((np.abs(frame - flat_image).max(axis=-1)
                         > IMAGE_PIXEL_ATOL).mean())
    mean, flat_mean = float(frame.mean()), float(flat_image.mean())
    print(f"{label}: against a fresh instanced SceneRenderer max |delta| "
          f"{float(delta.max()):.3e}, {int((delta > 0).sum())} pixels "
          f"differ, {beyond} beyond {PIXEL_ATOL}"
          + (f", rays_traced {pt_rays:.0f} vs {rays[0]:.0f}"
             if pt_rays is not None else "")
          + f"; against a flat SceneRenderer mean {mean:.6f} vs "
          f"{flat_mean:.6f}, {100.0 * flat_beyond:.4f}% of the pixels "
          f"beyond {IMAGE_PIXEL_ATOL}"
          + (f", rays_traced {rays[1]:.0f}" if pt_rays is not None else ""))
    if beyond or (pt_rays is not None and pt_rays != rays[0]):
        raise RuntimeError(f"{label}: the engine's frame is not a fresh "
                           "renderer's")
    if abs(mean - flat_mean) > IMAGE_MEAN_RTOL * flat_mean or \
            flat_beyond > IMAGE_PIXEL_FRACTION:
        raise RuntimeError(f"{label}: the engine's frame is not the flat "
                           "renderer's")


def _last_frame_rays(pt) -> float:
    """rays_traced of a PathTracingRenderer's last frame, rendered again
    through render_pixels(return_stats=True) at its accumulation index."""
    from steeljax_torch.render.pt.integrator import render_pixels

    ys, xs = np.meshgrid(np.arange(pt.height), np.arange(pt.width),
                         indexing="ij")
    _, stats = render_pixels(
        pt.flat, pt.tables, pt.inverse_view, pt.inverse_proj,
        pt.camera_near, pt.camera_far, pt.width, pt.height, xs.reshape(-1),
        ys.reshape(-1), pt.state.index - 1, 0, pt.config, return_stats=True)
    return float(stats["rays_traced"])


def _profiled_ticks(label, engine) -> None:
    prof = _profile_frames(lambda: engine.tick(0.0))
    if prof["busy_ms"] <= 0.0:
        print(f"{label}: torch.profiler recorded no device time: busy not "
              "measured")
        return
    print(f"{label} torch.profiler, per tick: device busy "
          f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall under "
          f"the profiler (idle share "
          f"{1.0 - prof['busy_ms'] / prof['wall_ms']:.3f}); "
          f"{prof['kernels']:.0f} device kernels; trace kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      sorted(prof["trace_ms"].items())))


def phase_engine_testsystem(device, prefab_path: Path) -> dict:
    """The TestSystem's engine: Engine(scene, instancing=True) over path L's
    scene with the prefab (_engine_scene), the environment baked at the
    bench budgets, TestSystem and CameraSystem attached; hybrid ticks of 1 s
    through t = 19, then `T` and ENGINE_PT_TICKS path-traced ticks.  At each
    capture time of apps.testsystem_demo and after the last path-traced
    tick the frame is held to fresh renderers (_held_to_fresh).  Prints the
    construction seconds, each refresh_scene() with the BLAS built before
    and after, the median tick of each mode without an edit, the launches
    per tick (K6 and its any-hit query only) and device busy over 2
    profiled ticks a mode.  Returns {"launches": the hybrid ticks', "env":
    the environment, "scene": the scene after t = 19}."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.apps.testsystem_demo import CAPTURE_TIMES
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.engine import CameraSystem, Engine, TestSystem
    from steeljax_torch.env.sky import procedural_sky_cube
    from steeljax_torch.render.scene_renderer import RenderMode
    from steeljax_torch.scene import load_scene

    scene = _engine_scene(prefab_path)
    width, height, pt_frames = WIDTH, HEIGHT, ENGINE_PT_TICKS
    env, bake_s = _timed_bake(cube=procedural_sky_cube(64), analytic=True,
                              device=device, **BENCH_ENV)
    config = RenderConfig(width=width, height=height)
    t0 = time.perf_counter()
    engine = Engine(scene, width, height, config, environment=env,
                    instancing=True, device=device)
    build_s = time.perf_counter() - t0
    accel = engine.renderer._accel
    print(f"engine (instancing=True) {width}x{height}: constructed in "
          f"{build_s:.3f} s ({accel.blas_builds} BLAS, "
          f"{engine.renderer.path_tracer.tables.instance_count} instances; "
          f"the environment baked at the bench budgets before, "
          f"{bake_s:.3f} s)")
    engine.add_system(TestSystem(
        prefab_loader=lambda: load_scene(prefab_path)))
    engine.add_system(CameraSystem(engine.bus))

    refreshes = []
    refresh = engine.renderer.refresh_scene

    def timed_refresh():
        builds = accel.blas_builds
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        refresh()
        if device.type == "cuda":
            torch.cuda.synchronize()
        refreshes.append((engine.global_time, time.perf_counter() - t0,
                          builds, accel.blas_builds))
    engine.renderer.refresh_scene = timed_refresh

    engine.inject_key("t")
    if engine.renderer.mode is not RenderMode.HYBRID:
        raise RuntimeError("T did not switch the engine to hybrid")
    ticks, lights = [], 0
    _reset_launches()
    while engine.global_time < CAPTURE_TIMES[-1]:
        edits = len(refreshes)
        frame, seconds = _timed_tick(engine, 1.0)
        lights += int(engine.renderer.hybrid.flat.light_count)
        if len(refreshes) == edits and engine.frame_index > 1:
            ticks.append(seconds)
        if round(engine.global_time) in CAPTURE_TIMES:
            launches = dict(cuda_traverse.LAUNCHES)
            _held_to_fresh(f"engine t={engine.global_time:.0f} s hybrid",
                           frame, scene, config, env, RenderMode.HYBRID,
                           device)
            cuda_traverse.LAUNCHES.update(launches)   # the engine's only
    hybrid_launches = dict(cuda_traverse.LAUNCHES)
    frames = engine.frame_index
    print(f"engine hybrid: {frames} ticks, launches "
          + ", ".join(f"{k} {v} ({v / frames:.2f} a tick)"
                      for k, v in hybrid_launches.items() if v)
          + f"; {lights} light-ticks; median tick without an edit "
          f"{1000.0 * float(np.median(ticks)):.3f} ms over {len(ticks)} "
          "(the frame on the host)")
    _engine_launches("engine hybrid", hybrid_launches,
                     {"K6": frames, "K6_anyhit": lights})
    for t, seconds, before, after in refreshes:
        print(f"engine refresh_scene() at t={t:.0f} s: {seconds:.4f} s, "
              f"BLAS built {before} before, {after} after")
    if len(refreshes) != 4:
        raise RuntimeError(f"{len(refreshes)} refreshes, expected the "
                           "TestSystem's 4 edits")
    _profiled_ticks("engine hybrid", engine)

    engine.inject_key("t")
    _reset_launches()
    ticks = [_timed_tick(engine, 1.0) for _ in range(pt_frames)]
    pt_launches = dict(cuda_traverse.LAUNCHES)
    frame = ticks[-1][0]
    median_ms = 1000.0 * float(np.median([s for _, s in ticks[1:]]))
    print(f"engine path tracing: {pt_frames} ticks, launches "
          + ", ".join(f"{k} {v} ({v / pt_frames:.2f} a tick)"
                      for k, v in pt_launches.items() if v)
          + f"; median tick after the first {median_ms:.3f} ms")
    _engine_launches("engine path tracing", pt_launches,
                     {"K6": None, "K6_anyhit": None})
    _held_to_fresh(f"engine t={engine.global_time:.0f} s path tracing, "
                   f"frame {pt_frames}", frame, scene, config, env,
                   RenderMode.PATH_TRACING, device, frames=pt_frames,
                   pt_rays=_last_frame_rays(engine.renderer.path_tracer))
    _profiled_ticks("engine path tracing", engine)
    return {"launches": hybrid_launches, "pt_launches": pt_launches,
            "env": env, "scene": scene}


def phase_engine_default(device, scene, env) -> dict:
    """The viewer's engine (instancing=False) over the same scene: a hybrid
    tick, `R` (the next hybrid frame equals it), `T` and a path-traced tick,
    `R` (the accumulation restarts: the next frame equals the first), a
    resize to half the extent (the camera's aspect follows) and a minimize
    (the last frame comes back and nothing is drawn).  K1 and K2 launch,
    K6 does not.  Returns the launches."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.engine import Engine

    width, height = WIDTH, HEIGHT
    engine = Engine(scene, width, height, RenderConfig(width=width,
                                                       height=height),
                    environment=env, device=device)
    engine.inject_key("t")
    _reset_launches()
    hybrid = engine.tick(0.1)
    engine.inject_key("r")
    if not np.array_equal(engine.tick(0.1), hybrid):
        raise RuntimeError("R changed the hybrid frame")
    engine.inject_key("t")
    first = engine.tick(0.1)
    engine.inject_key("r")
    if engine.renderer.path_tracer.state.index != 0:
        raise RuntimeError("R kept the path tracer's accumulation")
    if not np.array_equal(engine.tick(0.1), first):
        raise RuntimeError("the frame after R is not the first frame")
    engine.inject_resize(width // 2, height // 2)
    small = engine.tick(0.1)
    proj = engine.scene.camera_projection
    if small.shape != (height // 2, width // 2, 3) or \
            abs(proj.width / proj.height - width / height) > 1e-6:
        raise RuntimeError(f"resize: frame {small.shape}, aspect "
                           f"{proj.width / proj.height}")
    drawn = engine.frame_index
    engine.inject_resize(0, 0)
    if engine.tick(0.1) is not small or engine.frame_index != drawn:
        raise RuntimeError("a minimized engine drew")
    launches = dict(cuda_traverse.LAUNCHES)
    print(f"default engine (instancing=False): hybrid, R, T, path tracing, "
          f"R, resize to {width // 2}x{height // 2}, minimize: {drawn} "
          "frames drawn, launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items() if v))
    _engine_launches("default engine", launches, {"K1": None, "K2": None})
    return launches


def phase_checkpoint(device) -> None:
    """3 path-traced Cornell frames, the accumulation saved, loaded into a
    new renderer and 2 frames more: bit-equal to 5 frames in one run."""
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.io import checkpoint
    from steeljax_torch.render.pt.renderer import (PathTracingRenderer,
                                                   prepare_scene)
    from steeljax_torch.scene.builtin import make_cornell_scene

    scene = make_cornell_scene()
    prepared = prepare_scene(scene, device)
    config = RenderConfig(width=WIDTH, height=HEIGHT)

    def renderer():
        return PathTracingRenderer(scene, WIDTH, HEIGHT, config,
                                   prepared=prepared, device=device)
    whole = renderer().render(5)
    first = renderer()
    first.render(3)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "accum.npz"
        checkpoint.save_accumulation(path, first.state)
        second = renderer()
        second.state = checkpoint.load_accumulation(path, device)
    resumed = second.render(2)
    print(f"checkpoint: 3 frames, saved, loaded into a new renderer, 2 "
          f"more: index {second.state.index}, max |delta| against 5 frames "
          f"in one run {float(np.abs(resumed - whole).max()):.3e}")
    if second.state.index != 5 or not np.array_equal(resumed, whole):
        raise RuntimeError("the resumed accumulation is not the whole run's")


def phase_apps(gltf_dir: Path) -> None:
    """The front ends in subprocesses on the card, all started together:
    render_cli with --profile (the trace names a trace_kernel.K1 range and
    K1's CUDA kernel), with --mode hybrid --debug-view normals --overlay and
    with --override-material --force-forward --sample-count (each PNG
    finite and not constant), testsystem_demo on the TestSystem GLTF at its
    default 320x180 (5 PNGs) and the viewer's scripted session (the ANSI
    stream shows mode=PATH_TRACING after the toggle).  Each must exit 0."""
    root = Path(__file__).resolve().parent
    out = gltf_dir / "apps"
    cli = [sys.executable, "-m", "steeljax_torch.apps.render_cli",
           "builtin:cornell", "--size", "320x180", "--device", "cuda"]
    runs = {
        "render_cli --profile": cli + [
            "--spp", "2", "-o", str(out / "profile.png"), "--profile",
            str(out / "trace")],
        "render_cli hybrid normals overlay": cli + [
            "--mode", "hybrid", "--debug-view", "normals", "--overlay", "-o",
            str(out / "normals.png")],
        "render_cli override force-forward sample-count": cli + [
            "--spp", "2", "--override-material", "0.5,0", "--force-forward",
            "--sample-count", "2", "-o", str(out / "override.png")],
        "testsystem_demo": [
            sys.executable, "-m", "steeljax_torch.apps.testsystem_demo",
            str(gltf_dir / "host.gltf"), "--prefab",
            str(gltf_dir / "cornell.gltf"), "-o", str(out / "timeline")],
        "viewer": [sys.executable, "-m", "steeljax_torch.apps.viewer",
                   "builtin:cornell", "--size", "64x36", "--frames", "3",
                   "--keys", "t,w+w,arrow_C"]}
    out.mkdir()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in runs.items()}
    results = {name: proc.communicate(timeout=600)
               for name, proc in procs.items()}
    print(f"apps: {len(runs)} subprocesses in {time.perf_counter() - t0:.1f} "
          "s, started together")
    for name, proc in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"{name} exited {proc.returncode}:\n"
                               f"{results[name][1][-4000:]}")
    for name in ("profile", "normals", "override"):
        png = _png_pixels(out / f"{name}.png")
        if png.shape != (180, 320, 3) or png.std() == 0:
            raise RuntimeError(f"{name}.png bad: {png.shape}, std "
                               f"{png.std()}")
        print(f"render_cli {name}.png: mean {png.mean():.2f}, std "
              f"{png.std():.2f}")
    traces = list((out / "trace").glob("*.pt.trace.json"))
    names = {e.get("name", "") for e in json.loads(traces[0].read_text())[
        "traceEvents"]} if len(traces) == 1 else set()
    k1 = sorted(n for n in names if "alpha8_kernel<0, 1, false, false" in n)
    print(f"render_cli --profile: {len(traces)} trace, {len(names)} event "
          f"names, trace_kernel.K1 {'trace_kernel.K1' in names}, K1's CUDA "
          f"kernel {k1[:1]}")
    if "trace_kernel.K1" not in names or not k1:
        raise RuntimeError("the --profile trace lacks K1's range or kernel")
    pngs = sorted(p.name for p in (out / "timeline").glob("*.png"))
    print(f"testsystem_demo: {pngs}")
    if len(pngs) != 5:
        raise RuntimeError(f"testsystem_demo wrote {pngs}")
    huds = [line for line in results["viewer"][0].split("\n")
            if "mode=" in line]
    print(f"viewer: {len(huds)} frames, modes "
          f"{[h[h.index('mode='):].split()[0] for h in huds]}")
    if len(huds) != 3 or "mode=PATH_TRACING" not in huds[0]:
        raise RuntimeError("the viewer did not toggle to path tracing")


def phase_engine(device) -> dict:
    """Phase 15: the TestSystem's engine, the default engine, the
    checkpoint on the card and the apps.  Returns the launches of the
    engines' ticks by engine."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_testsystem_gltf(tmp)
        out = phase_engine_testsystem(device, tmp / "cornell.gltf")
        default = phase_engine_default(device, out["scene"], out["env"])
        phase_checkpoint(device)
        phase_apps(tmp)
    return {"testsystem": out["launches"], "pt": out["pt_launches"],
            "default": default}


# Phase 16, path G: the light-volume GI bake at the reference's defaults
# (gi.light_volume: spp 8, 32x32 faces, min edge 0.5, at most 1,024 probes)
# on path L's scene, and its use in path H's frame.
GI_BAKE = dict(spp=8, resolution=32, min_edge=0.5, max_probes=1024)
PATH_G_PROBES = 925          # the reference's placement on path L's scene
CORNELL_GI_PROBES = 985      # and on make_cornell_scene(12)
GI_TILE_PROBES = np.array([[0.0, 1.0, 0.0], [0.4, 1.4, 0.4]], np.float32)
GI_TILE = dict(resolution=4, spp=2)
SHARD_ATOL = 1e-5
SHARD_SIZE = (320, 180)


def _synced(fn):
    """(fn(), host seconds) with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _within_budget(label, card, cpu) -> None:
    """Phase 8's rule: at most max(2, n / 200) values of the n pixels or
    texels beyond PIXEL_ATOL."""
    card, cpu = (np.asarray(x).reshape(-1, 3) for x in (card, cpu))
    delta = np.abs(card - cpu).max(axis=-1)
    over = int((delta > PIXEL_ATOL).sum())
    print(f"{label}: card vs CPU max |delta| {float(delta.max()):.3e}, "
          f"{over} of {len(delta)} beyond {PIXEL_ATOL}")
    if over > max(2, len(delta) // 200) or not np.isfinite(card).all():
        raise RuntimeError(f"{label}: the card diverges from the CPU")


def _bake_path_g(flat, tables) -> dict:
    """Path G's bake once cold (the first calls of its torch operators),
    then step by step, then whole, then its capture under torch.profiler;
    the launches of the step-by-step capture."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.gi import light_volume as lv_lib
    from steeljax_torch.gi import probes, sh, tets

    def bake():
        return lv_lib.generate_light_volume(flat, tables, **GI_BAKE)

    cold, cold_s = _synced(bake)
    boxes = []  # the boxes of each octree level the oracle tests
    overlaps = probes.GeometryOracle.overlaps

    def place():
        def counted(oracle, lo, hi):
            boxes.append(len(lo))
            return overlaps(oracle, lo, hi)

        probes.GeometryOracle.overlaps = counted
        try:
            positions = probes.generate_probe_positions(
                flat.tri_pos, min_edge=GI_BAKE["min_edge"],
                max_probes=GI_BAKE["max_probes"])
        finally:
            probes.GeometryOracle.overlaps = overlaps
        return positions, tets.tetrahedralize(positions)

    (positions, mesh), place_s = _synced(place)
    positions = mesh[3]
    if len(positions) != PATH_G_PROBES:
        raise RuntimeError(f"path G: {len(positions)} probes, the "
                           f"reference places {PATH_G_PROBES}")
    rays = len(positions) * 6 * GI_BAKE["resolution"] ** 2

    def capture():
        return lv_lib.capture_probes(flat, tables, positions,
                                     GI_BAKE["resolution"], GI_BAKE["spp"])

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cubes, capture_s = _synced(capture)
    launches = dict(cuda_traverse.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 4 * GI_BAKE["spp"] if k in ("K1", "K2") else 0
            for k in launches}
    if launches != want:
        raise RuntimeError(f"path G capture launched {launches}, expected "
                           f"{want}")
    coefficients, sh_s = _synced(lambda: sh.project_sh9(cubes))
    cubes_host = cubes.cpu().numpy()
    if not np.isfinite(cubes_host).all() or cubes_host.min() < 0.0 or \
            cubes_host.std() <= 0.0:
        raise RuntimeError("path G: the probe cubes are not finite, "
                           "non-negative and varied")
    volume, bake_s = _synced(bake)
    if not all(torch.equal(v.coefficients, coefficients)
               and torch.equal(v.positions.cpu(), torch.as_tensor(positions))
               for v in (volume, cold)):
        raise RuntimeError("path G: the whole bake differs from its steps")
    prof = _profile_frames(capture, frames=1)
    print(f"path G bake ({len(positions)} probes, {len(mesh[0])} tets, "
          f"{rays:,} probe rays a sample, {GI_BAKE['spp']} spp): placement "
          f"({sum(boxes):,} boxes tested in {len(boxes)} octree levels: "
          f"{boxes}) and tets {place_s:.3f} s, capture {capture_s:.3f} s "
          f"(peak "
          f"{peak_gib:.2f} GiB allocated), SH projection {sh_s:.4f} s, "
          f"whole bake {bake_s:.3f} s (the first, cold, {cold_s:.3f} s); "
          f"launches of the capture "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f" ({4 * GI_BAKE['spp']} = 4 bounces x {GI_BAKE['spp']} spp)")
    print(f"path G capture under torch.profiler: device busy "
          f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall (idle "
          f"share {1.0 - prof['busy_ms'] / prof['wall_ms']:.3f}), "
          f"{prof['kernels']:.0f} device kernels, "
          + ", ".join(f"{k} {v:.1f}" for k, v in prof["syncs"].items())
          + "; trace kernels " + ", ".join(
              f"{k} {v:.3f} ms ({v / (4 * GI_BAKE['spp']):.3f} a launch)"
              for k, v in sorted(prof["trace_ms"].items())))
    for ms, count, key in prof["top"]:
        print(f"  {ms:8.3f} ms in {count:6.0f} launches: {key[:90]}")
    return {"volume": volume, "launches": launches, "positions": positions}


def _path_g_rows(flat, tables, positions) -> dict:
    """K1 and K2 at the capture's shapes, as phase 3b's rows: K1 on the
    first bounce of sample 0 of every probe-face-pixel ray of path G (the
    rays, seeds and interval of light_volume.capture_probes), K2 on that
    bounce's next-event shadow rays, every lane as trace_paths traces it;
    each timed alone and held against its plain version on a strided
    subset.  Run after the bake's timings, so that its first call stays
    the cold one."""
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.gi import light_volume as lv_lib
    from steeljax_torch.render.pt.integrator import (trace_material_ray,
                                                     unpack_material)
    from steeljax_torch.render.pt.stages import sample_light, shadow_rays

    res = GI_BAKE["resolution"]
    o, base_d, t_ax, b_ax, ids = lv_lib.probe_rays(positions, res,
                                                   flat.device)
    d, seed = lv_lib.sample_directions(base_d, t_ax, b_ax, ids, 0, 2.0 / res)
    rays = (o.contiguous(), d.contiguous(),
            torch.full_like(o[:, 0], lv_lib.CAPTURE_T_MIN),
            torch.full_like(o[:, 0], lv_lib.CAPTURE_T_MAX))
    chunk = tables.chunks[0]
    rows = {"K1": _nearest_row(("K1", "path G", PROBE), chunk, flat,
                               tables.shade_mode, rays,
                               kp.strided_subset(rays, kp.SHADOW_SUBSET))}
    rows["K1"]["shapes"] = (f"path G probe rays, {len(positions)} probes x "
                            f"6 faces x {res}x{res}, the first bounce of "
                            "sample 0, shade mode 1")
    rec = trace_material_ray(flat, tables, *rays, cull_backface=True)
    _, tbn = unpack_material(flat, tables, rec, d)
    p = o + d * rec["t"][:, None]
    light, _ = sample_light(flat, tbn[2], p, seed)
    so, sd, t_min, t_max = shadow_rays(p, tbn[2], light)
    rows["K2"] = _anyhit_row(("K2", "path G", PROBE_SHADOW), chunk,
                             (so.contiguous(), sd.contiguous(), t_min,
                              t_max))
    rows["K2"]["shapes"] = ("path G probe rays' next-event shadow rays at "
                            "the first bounce of sample 0")
    return rows


def _gi_tiles(device) -> None:
    """The tiny capture (two probes, resolution 4, spp 2) of Cornell and
    the lit parity scene on the card against the port on the CPU (the
    plain versions), with the card's K1 (and K2) launches."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.gi.light_volume import capture_probes
    from steeljax_torch.render.pt.renderer import prepare_scene
    from steeljax_torch.scene.builtin import (make_cornell_scene,
                                              make_parity_scene)

    for label, make, kernels in (
            ("Cornell", lambda: make_cornell_scene(6), ("K1",)),
            ("parity (lit)", lambda: make_parity_scene(4), ("K1", "K2"))):
        scene = make()
        cubes = {}
        for dev in (device, "cpu"):
            flat, tables = prepare_scene(scene, dev, env_resolution=16)
            _reset_launches()
            cubes[str(dev)] = capture_probes(
                flat, tables, GI_TILE_PROBES, **GI_TILE).cpu().numpy()
            if dev == device:
                launched = {k: v for k, v in cuda_traverse.LAUNCHES.items()
                            if v}
        _within_budget(f"GI capture tile {label} ({launched})",
                       cubes[str(device)], cubes["cpu"])
        if any(not launched.get(k) for k in kernels):
            raise RuntimeError(f"GI capture tile {label} skipped one of "
                               f"{kernels}")


def _gi_frames(device, scene, flat, tables, env, volume, path_h) -> dict:
    """Path H's frame at 1920x1080 lit by path G's volume, as the bake of a
    renderer built with a GI config gives it (held bit-equal to `volume`):
    one warm and HYBRID_TIMED_FRAMES timed frames (one K1 and one K2
    launch a frame), 2 profiled frames, the walk alone at the frame's
    inputs under the profiler, and a checkpoint round trip of the
    volume."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.gi import sample
    from steeljax_torch.io import checkpoint
    from steeljax_torch.render.hybrid import lighting
    from steeljax_torch.render.hybrid.renderer import HybridRenderer

    width, height = kp.HYBRID_WIDTH, kp.HYBRID_HEIGHT
    # The renderer's own bake (RenderConfig.global_illumination_enabled, as
    # SceneRenderer and the Engine build it) at the GI defaults, held to
    # the step-by-step bake.
    renderer, init_s = _synced(lambda: HybridRenderer(
        scene, width, height, RenderConfig(
            width=width, height=height, global_illumination_enabled=True),
        environment=env, prepared=(flat, tables), device=device))
    for key in ("positions", "tet_vertices", "tet_neighbors",
                "tet_matrices", "coefficients"):
        if not torch.equal(getattr(renderer.light_volume, key),
                           getattr(volume, key)):
            raise RuntimeError(f"the GI config's bake differs from path G's "
                               f"in {key}")
    print(f"HybridRenderer(RenderConfig(global_illumination_enabled=True)) "
          f"built in {init_s:.3f} s with its bake; its volume bit-equal to "
          "the step-by-step bake's")
    _reset_launches()
    ms_frame, image = _hybrid_frames(renderer, HYBRID_TIMED_FRAMES)
    launches = dict(cuda_traverse.LAUNCHES)
    total = 1 + HYBRID_TIMED_FRAMES
    want = {k: total if k in ("K1", "K2") else 0 for k in launches}
    if launches != want:
        raise RuntimeError(f"path G frame launched {launches} over {total} "
                           f"frames, expected {want}")
    host = image.cpu().numpy()
    if host.shape != (width * height, 3) or not np.isfinite(host).all() \
            or host.min() < 0.0 or host.std() <= 0.0:
        raise RuntimeError(f"path G frame: bad frame {host.shape}")
    stages = ("gbuffer_stage", "lighting_stage", "forward_stage",
              "light_volume_sample")
    prof = _profile_frames(renderer.render_frame_device, spans=stages)
    print(f"path G frame {width}x{height} (path H lit by the light volume):"
          f" {ms_frame:.3f} ms/frame over {HYBRID_TIMED_FRAMES} timed "
          f"frames (path H {path_h['ms_frame']:.3f} in phase 11); launches "
          f"over {total} frames " + ", ".join(
              f"{k} {v}" for k, v in launches.items() if v)
          + f"; image mean {float(host.mean()):.4f}")
    print(f"path G frame torch.profiler, per frame: device busy "
          f"{prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms wall (idle "
          f"share {1.0 - prof['busy_ms'] / prof['wall_ms']:.3f}), "
          f"{prof['kernels']:.0f} device kernels; trace kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      sorted(prof["trace_ms"].items()))
          + "; device spans " + ", ".join(
              f"{k} {prof['span_ms'].get(k, 0.0):.3f} ms" for k in stages))
    for ms, count, key in prof["top"]:
        print(f"  {ms:8.3f} ms/frame in {count:6.0f} launches: {key[:90]}")

    # The walk alone, at the inputs the frame hands it.
    inputs = []
    original = lighting.sample_light_volume

    def keep(lv, position, n):
        inputs.append((position, n))
        return original(lv, position, n)

    lighting.sample_light_volume = keep
    try:
        renderer.render_frame_device()
    finally:
        lighting.sample_light_volume = original
    position, normal = inputs[0]
    walk = _profile_frames(
        lambda: sample.sample_light_volume(volume, position, normal))
    print(f"light-volume walk at {position.shape[0]:,} points "
          f"({sample.MAX_WALK_STEPS} masked steps): device busy "
          f"{walk['busy_ms']:.3f} ms in {walk['kernels']:.0f} device kernels "
          f"a call, {walk['wall_ms']:.3f} ms wall under the profiler")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "path_g_lv.npz"
        checkpoint.save_light_volume(path, volume)
        loaded = checkpoint.load_light_volume(path, device)
    for key in ("positions", "tet_vertices", "tet_neighbors",
                "tet_matrices", "coefficients"):
        a, b = getattr(volume, key), getattr(loaded, key)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(f"light-volume checkpoint: {key} differs")
    renderer.light_volume = loaded
    again = renderer.render_frame_device()
    if not torch.equal(again, image):
        raise RuntimeError("the frame from the loaded volume differs")
    print("light-volume checkpoint: the five arrays bit-equal after the "
          "round trip, the frame from the loaded volume equal to the baked "
          "one's")
    return {"launches": launches}


def _gi_cli() -> None:
    """render_cli --mode hybrid --gi --show-probes --lv-checkpoint F at
    320x180 at the default bake, twice in subprocesses: the first bakes
    and saves F, the second loads it; the PNGs are equal."""
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lines = []
        for run in range(2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "steeljax_torch.apps.render_cli",
                 "builtin:cornell", "--mode", "hybrid", "--gi",
                 "--show-probes", "--lv-checkpoint", str(tmp / "lv.npz"),
                 "--size", "320x180", "--device", "cuda", "-o",
                 str(tmp / f"gi{run}.png")], cwd=root, capture_output=True,
                text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"render_cli --gi run {run} exited "
                                   f"{proc.returncode}:\n"
                                   f"{proc.stderr[-4000:]}")
            volume = [l for l in proc.stdout.split("\n")
                      if l.startswith(("light volume:", "loaded"))]
            lines.append(f"run {run} {time.perf_counter() - t0:.1f} s: "
                         + "; ".join(volume))
        first, second = (_png_pixels(tmp / f"gi{run}.png") for run in (0, 1))
        print("render_cli --gi --show-probes --lv-checkpoint: "
              + " | ".join(lines))
        if f"{CORNELL_GI_PROBES} probes" not in lines[0] or \
                "loaded" not in lines[1]:
            raise RuntimeError("render_cli --gi: the first run did not bake "
                               f"{CORNELL_GI_PROBES} probes or the second "
                               "did not load the checkpoint")
        if first.shape != (180, 320, 3) or first.std() == 0 or \
                not np.array_equal(first, second):
            raise RuntimeError("render_cli --gi: the two PNGs differ or are "
                               "bad")


def _gi_parallel(device, scene, flat, tables, env, volume) -> None:
    """A one-device mesh and a two-shard mesh over the same card, each
    held to the unsharded run within SHARD_ATOL: the path-traced frame and
    the hybrid GI frame of path L's scene at SHARD_SIZE, a two-probe
    capture; dryrun_multichip(2) over the card twice; entry()'s tile on
    the card against the CPU's."""
    from steeljax_torch import entry
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.gi.light_volume import capture_probes
    from steeljax_torch.parallel import (make_mesh, render_frame_sharded,
                                         render_hybrid_frame_sharded)
    from steeljax_torch.render.hybrid.renderer import render_hybrid_pixels
    from steeljax_torch.render.pt.integrator import render_pixels

    width, height = SHARD_SIZE
    frame = camera_lib.make_frame(scene.camera_location,
                                  scene.camera_projection)
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    px, py = (torch.as_tensor(a.reshape(-1), device=device) for a in (xs, ys))
    mats = [torch.as_tensor(m, device=device) for m in (
        frame.inverse_view, frame.inverse_proj, frame.view_proj)]
    single = {
        "pt": render_pixels(flat, tables, *mats[:2], frame.camera_near,
                            frame.camera_far, width, height, px, py, 0, 0),
        "hybrid GI": render_hybrid_pixels(
            flat, tables, env, *mats, frame.camera_near, frame.camera_far,
            width, height, px, py, light_volume=volume),
        "capture": capture_probes(flat, tables, GI_TILE_PROBES, 8, 1)}
    single = {k: v.cpu().numpy().reshape(
        (height, width, 3) if k != "capture" else v.shape)
        for k, v in single.items()}
    for shards in (1, 2):
        mesh = make_mesh([device] * shards)
        split = {
            "pt": render_frame_sharded(
                flat, tables, frame.inverse_view, frame.inverse_proj,
                frame.camera_near, frame.camera_far, width, height, mesh),
            "hybrid GI": render_hybrid_frame_sharded(
                flat, tables, env, frame.inverse_view, frame.inverse_proj,
                frame.view_proj, frame.camera_near, frame.camera_far, width,
                height, mesh, light_volume=volume),
            "capture": capture_probes(flat, tables, GI_TILE_PROBES, 8, 1,
                                      devices=mesh).cpu().numpy()}
        deltas = {k: float(np.abs(split[k] - single[k]).max())
                  for k in single}
        print(f"parallel, {shards}-shard mesh on {device}: max |delta| "
              "against the unsharded run " + ", ".join(
                  f"{k} {v:.3e}" for k, v in deltas.items()))
        if max(deltas.values()) > SHARD_ATOL:
            raise RuntimeError(f"the {shards}-shard mesh diverges")
    print(f"dryrun_multichip(2) over {device} twice: max |delta| "
          + ", ".join(f"{k} {v:.3e}" for k, v in entry.dryrun_multichip(
              2, devices=[device, device]).items()))
    tiles = {}
    for dev in (device, "cpu"):
        fn, args = entry.entry(dev)
        tiles[str(dev)] = fn(*args).cpu().numpy()
    _within_budget("entry() tile", tiles[str(device)], tiles["cpu"])


def phase_gi(device, scenes, path_h) -> dict:
    """Phase 16, path G: path L's scene baked at the reference's GI
    defaults (placement and tets, the capture with its launches, device
    busy and peak memory, the SH projection, the whole bake); K1 and K2
    alone at the capture's shapes against their plain versions; the tiny
    capture on the card against the CPU; path H's frame lit by the volume
    of a renderer built with a GI config, with the walk alone; the
    checkpoint round trip; render_cli --gi twice; the pixel split over the
    card."""
    scene, flat, tables = scenes["sunlit"]
    bake = _bake_path_g(flat, tables)
    rows = _path_g_rows(flat, tables, bake["positions"])
    _gi_tiles(device)
    frames = _gi_frames(device, scene, flat, tables, path_h["env"],
                        bake["volume"], path_h)
    _gi_cli()
    _gi_parallel(device, scene, flat, tables, path_h["env"], bake["volume"])
    return {"capture_launches": bake["launches"],
            "frame_launches": frames["launches"],
            "frames": 1 + HYBRID_TIMED_FRAMES, "rows": rows}


def _raster_work(recs_sorted, tile_ids, segments, ntx) -> dict:
    """The work of one raster kernel launch on these inputs, counted from
    the records alone: the candidate records its subtiles read (each
    subtile its three segments), by segment; of them those whose bbox
    covers the subtile (whose forms every pixel of the subtile evaluates,
    but for the strip test); of the (covering candidate, 32x3 strip) pairs,
    those raster.strip_rejects skips; the densest subtile; and the bytes the
    kernel stages (every candidate's bbox words, every covering record's
    walk columns)."""
    from steeljax_torch.render.hybrid import raster

    sa, la, sb, lb, gs, gl = (x.to(torch.int64) for x in segments)
    tiles = tile_ids.to(torch.int64).repeat(3)
    starts = torch.cat([sa, sb, gs])
    lengths = torch.cat([la, lb, gl])
    seg = torch.repeat_interleave(torch.arange(lengths.shape[0],
                                               device=lengths.device),
                                  lengths)
    first = torch.cumsum(lengths, 0) - lengths
    rows = starts[seg] + torch.arange(seg.shape[0],
                                      device=seg.device) - first[seg]
    bmin = recs_sorted[rows, raster._BMIN].to(torch.int64)
    bmax = recs_sorted[rows, raster._BMAX].to(torch.int64)
    ty, tx = tiles[seg] // ntx, tiles[seg] % ntx
    covers = ((tx >= bmin % 4096) & (tx <= bmax % 4096)
              & (ty >= bmin // 4096) & (ty <= bmax // 4096))
    strips = torch.arange(raster.TILE_H // raster.STRIP_ROWS,
                          device=rows.device)
    rejected = raster.strip_rejects(recs_sorted[rows[covers]][:, None, :],
                                    tx[covers][:, None], ty[covers][:, None],
                                    strips[None, :])
    local = la + lb
    dense = int(local.argmax())
    candidates, covering = int(seg.shape[0]), int(covers.sum())
    return {"candidates": candidates,
            "by_segment": {"row above": int(la.sum()),
                           "own row": int(lb.sum()), "big": int(gl.sum())},
            "covering": covering, "strip_pairs": int(rejected.numel()),
            "strip_rejected": int(rejected.sum()),
            "strip_live": int((~rejected).sum()),
            "densest": {"row": dense, "local": int(local[dense]),
                        "candidates": int(local[dense] + gl[dense])},
            "bbox_bytes": RASTER_BBOX_BYTES * candidates,
            "staged_bytes": RASTER_STAGED_BYTES * covering}


def _raster_bound(work: dict, tiles: int, hits: int, winners: int = 0,
                  strips: bool = False) -> dict:
    """The least time of the raster kernel's work: its bytes over the
    card's memory rate against its operations over its fp32 rate.  At
    subtile granularity (the tile stage's first bound, kept so the designs
    compare): every candidate's whole record read, every pixel's forms for
    each candidate covering its subtile.  With `strips`, what the work
    needs: every candidate's bbox words, every covering record's walk
    columns and the attribute columns of each of the `winners` (subtile,
    winning triangle) pairs read, and the forms of the (candidate, strip)
    pairs the strip test keeps (raster.STRIP_ROWS x 32 pixels each), the
    strip tests themselves not counted.  Both count the subtiles' ids and
    segments read and their five outputs written."""
    from steeljax_torch.render.hybrid import raster

    records = (work["bbox_bytes"] + work["staged_bytes"]
               + RASTER_WINNER_BYTES * winners if strips
               else RASTER_RECORD_BYTES * work["candidates"])
    n_bytes = (records + RASTER_TILE_IN_BYTES * tiles
               + RASTER_PIXEL_OUT_BYTES * raster.PX * tiles)
    tests = (raster.STRIP_ROWS * raster.TILE_W * work["strip_live"]
             if strips else raster.PX * work["covering"])
    ops = OPS_PER_RASTER_TEST * tests + OPS_PER_RASTER_WINNER * hits
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes, "ops": ops}


def _work_text(work: dict) -> str:
    seg = work["by_segment"]
    dense = work["densest"]
    return (f"{work['candidates']:,} candidates ({seg['row above']:,} row "
            f"above, {seg['own row']:,} own row, {seg['big']:,} big), "
            f"{work['covering']:,} covering; of {work['strip_pairs']:,} "
            f"(covering, strip) pairs {work['strip_rejected']:,} rejected by "
            f"the strip test, {work['strip_live']:,} walked; densest "
            f"subtile row {dense['row']} with {dense['local']:,} local, "
            f"{dense['candidates']:,} candidates; staged "
            f"{work['bbox_bytes']:,} B of bbox words and "
            f"{work['staged_bytes']:,} B of records")


def _raster_held(label, recs_sorted, tile_ids, segments, ntx) -> dict:
    """One launch of R against _raster_tiles_plain on every subtile of
    these inputs: raises unless the five outputs are bit-equal."""
    from steeljax_torch.render.hybrid import raster

    launch, out = raster.raster_tiles_launcher(recs_sorted, tile_ids,
                                               segments, ntx)
    launch()
    plain = raster._raster_tiles_plain(recs_sorted, tile_ids, segments, ntx)
    parity = _tile_parity(out, plain)
    print(f"{label}: R against its plain version on all "
          f"{tile_ids.shape[0]} subtiles at WINDOW {raster.WINDOW}: "
          + ("bit-equal" if parity["bit_equal"] else f"DIFFERENT {parity}")
          + f" ({parity['hits']:,} hit pixels)")
    if not parity["bit_equal"]:
        raise RuntimeError(f"{label}: R differs from its plain version")
    return {"parity": parity, "out": out}


def _raster_ties(recs_sorted, tile_ids, segments, ntx) -> dict:
    """R against its plain version on path R's records with tie-heavy
    depths (RASTER_TIE_PLANES) at each of RASTER_TIE_WINDOWS, bit-equal;
    the pixels whose triangle differs between WINDOW 1 and 256 (the slices
    decide them)."""
    from steeljax_torch.render.hybrid import raster

    gen = torch.Generator(device=recs_sorted.device)
    gen.manual_seed(RASTER_TIE_SEED)
    planes = torch.tensor(RASTER_TIE_PLANES, dtype=torch.float32,
                          device=recs_sorted.device)
    pick = torch.randint(len(RASTER_TIE_PLANES), (recs_sorted.shape[0],),
                         generator=gen, device=recs_sorted.device)
    recs = recs_sorted.clone()
    recs[:, raster._Z:raster._Z + 3] = planes[pick]
    window = raster.WINDOW
    tri = {}
    try:
        for w in RASTER_TIE_WINDOWS:
            raster.WINDOW = w
            tri[w] = _raster_held("tie-heavy launch (path R's records, "
                                  "quantized depths)", recs, tile_ids,
                                  segments, ntx)["out"][4]
    finally:
        raster.WINDOW = window
    decided = int((tri[1] != tri[256]).sum())
    print(f"tie-heavy launch: {decided:,} pixels take another triangle at "
          "WINDOW 1 than at 256")
    return {"windows": list(RASTER_TIE_WINDOWS), "decided_by_slices": decided}


def _tile_parity(out, plain) -> dict:
    """The raster kernel's outputs (bz, fu, fv, fw, ft) against its plain
    version's, per pixel as kernel_parity._compare judges records: the hit
    flags (bz > 0), and where both hit w_eye = 1 / Fw against its
    |dt| < 2e-3 and, where the triangle is the same, u = Fu / Fw and v =
    Fv / Fw against 5e-3; max_abs_err over the five outputs (0 when the
    two agree bit for bit, as the kernel is written to)."""
    (bz, fu, fv, fw, ft), (pz, pu, pv, pw, pt) = out, plain
    hit, phit = bz > 0.0, pz > 0.0
    both = hit & phit
    same = both & (ft == pt)
    n = bz.numel()
    entry = {"pixels": n, "hit_mismatches": int((hit != phit).sum()),
             "hits": int(hit.sum()),
             "max_abs_err": max(float((a - b).abs().max()) for a, b in
                                zip(out, plain)),
             "bit_equal": all(torch.equal(a, b) for a, b in zip(out, plain))}
    if both.any():
        entry["max_t_delta"] = float((1.0 / fw - 1.0 / pw)[both].abs().max())
    if same.any():
        entry["max_uv_delta"] = float(max(
            (fu / fw - pu / pw)[same].abs().max(),
            (fv / fw - pv / pw)[same].abs().max()))
    entry["ok"] = bool(entry["hit_mismatches"] <= max(2, n // 5000)
                       and entry.get("max_t_delta", 0.0) < 2e-3
                       and entry.get("max_uv_delta", 0.0) < 5e-3)
    return entry


def _raster_vs_trace(label, rec_r, rec_t, budget: float) -> dict:
    """tests/test_raster.py's comparison of a raster record with the traced
    one, as a budget: a pixel disagrees where one side alone hits, where
    both hit another triangle at another depth (|dt| > 5e-3 max(t, 1)), or
    where the same triangle wins with t beyond atol 5e-4 and rtol 5e-3 or u
    or v beyond 5e-3; at most `budget` of the pixels may.  (The last kind
    is counted, not refused: the screen-space forms of a triangle about a
    pixel wide cancel in float32, so its t, u and v move by up to a few
    percent, in the reference's raster as in the port's.)"""
    hit_r, hit_t = rec_r["hit"], rec_t["hit"]
    both = hit_r & hit_t
    dt = (rec_r["t"] - rec_t["t"]).abs()
    same = both & (rec_r["tri"] == rec_t["tri"])
    same_depth = dt <= 5e-3 * torch.clamp(rec_t["t"], min=1.0)
    duv = torch.maximum((rec_r["u"] - rec_t["u"]).abs(),
                        (rec_r["v"] - rec_t["v"]).abs())
    off = same & ((dt > 5e-4 + 5e-3 * rec_t["t"].abs()) | (duv >= 5e-3))
    counts = {"one side hits": int((hit_r != hit_t).sum()),
              "other triangle, other depth": int(
                  (both & ~same & ~same_depth).sum()),
              "same triangle, t/u/v off": int(off.sum())}
    frac = sum(counts.values()) / hit_r.numel()
    print(f"{label}: {frac:.5f} of {hit_r.numel():,} pixels disagree "
          f"(budget {budget}: " + ", ".join(
              f"{k} {v:,}" for k, v in counts.items())
          + f"); hits {int(hit_r.sum()):,} raster / {int(hit_t.sum()):,} "
          f"traced, the same triangle on {int(same.sum()):,}, max |du|, "
          f"|dv| there {float(duv[same].max()):.3e}, within 5e-3 on "
          f"{float((duv[same] < 5e-3).float().mean()):.5f} of them")
    if frac > budget or not bool(same.any()):
        raise RuntimeError(f"{label}: the raster record disagrees with the "
                           "traced one")
    return {"disagree": frac, **counts}


def _raster_frames(renderer, rscene, frames: int) -> tuple:
    """_hybrid_frames of `renderer` with the raster scene `rscene` (None:
    the traced G-buffer)."""
    renderer.raster_scene = rscene
    return _hybrid_frames(renderer, frames)


def _raster_renderer(scene, width, height, env, device, prepared=None):
    """HybridRenderer(...) built with STEELJAX_RASTER=1 (the variable as it
    was afterwards); raises unless it engaged the raster."""
    import os

    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.hybrid.renderer import HybridRenderer

    previous = os.environ.get("STEELJAX_RASTER")
    os.environ["STEELJAX_RASTER"] = "1"
    try:
        renderer = HybridRenderer(scene, width, height,
                                  RenderConfig(width=width, height=height),
                                  environment=env, prepared=prepared,
                                  device=device)
    finally:
        if previous is None:
            del os.environ["STEELJAX_RASTER"]
        else:
            os.environ["STEELJAX_RASTER"] = previous
    if renderer.raster_scene is None or renderer.tile is None:
        raise RuntimeError(f"STEELJAX_RASTER=1 did not engage the raster at "
                           f"{width}x{height}")
    return renderer


def _raster_cornell(device, env) -> dict:
    """The Cornell box at 1280x720 with the raster: one R and no K1 launch
    a frame, the frame beside the traced one, R held bit-equal to its
    plain version on the frame's subtiles and timed alone (CUDA events, 50
    launches)."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.apps.timing import time_ms
    from steeljax_torch.render.hybrid import raster
    from steeljax_torch.scene.builtin import make_cornell_scene

    renderer = _raster_renderer(make_cornell_scene(), WIDTH, HEIGHT, env,
                                device)
    rscene = renderer.raster_scene
    _reset_launches()
    ms, image = _raster_frames(renderer, rscene, HYBRID_TIMED_FRAMES)
    launches = dict(cuda_traverse.LAUNCHES)
    total = 1 + HYBRID_TIMED_FRAMES
    if launches["R"] != total or launches["K1"] != 0:
        raise RuntimeError(f"Cornell raster frames launched {launches}")
    traced_ms, traced = _raster_frames(renderer, None, HYBRID_TIMED_FRAMES)
    image, traced = image.cpu().numpy(), traced.cpu().numpy()
    if not np.isfinite(image).all() or image.std() <= 0.0:
        raise RuntimeError("Cornell raster frame: bad frame")
    rmse = float(np.sqrt(np.mean((image - traced) ** 2)))
    print(f"Cornell {WIDTH}x{HEIGHT} with the raster: {ms:.3f} ms/frame "
          f"(traced G-buffer {traced_ms:.3f}); launches over {total} frames "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; RMSE against the traced frame {rmse:.3e}")
    if rmse >= 0.02:
        raise RuntimeError(f"Cornell raster frame: RMSE {rmse} against the "
                           "traced frame")
    recs_sorted, _, tile_ids, segments = raster._binned(
        rscene, renderer.matrices[2], WIDTH, HEIGHT,
        renderer.frame.camera_near)
    ntx = WIDTH // raster.TILE_W
    held = _raster_held(f"Cornell {WIDTH}x{HEIGHT} raster frame",
                        recs_sorted, tile_ids, segments, ntx)
    launch, _ = raster.raster_tiles_launcher(recs_sorted, tile_ids, segments,
                                             ntx)
    kernel_ms = time_ms(launch, 50)
    work = _raster_work(recs_sorted, tile_ids, segments, ntx)
    print(f"R raster_tiles Cornell {WIDTH}x{HEIGHT}: {tile_ids.shape[0]} "
          f"subtiles, kernel {kernel_ms:.4f} ms; {_work_text(work)}")
    return {"bit_equal": held["parity"]["bit_equal"],
            "hits": held["parity"]["hits"], "ms": kernel_ms, "work": work,
            "ms_frame": ms, "traced_ms_frame": traced_ms}


def _surrogate_on_card(device) -> None:
    """fit_env_surrogate's sample gathering (samples_from_image, the part
    after the PNG decode) on a synthetic 96x54 image and the GLTF Cornell
    box, on the card against the CPU."""
    from steeljax_torch.apps import fit_env_surrogate
    from steeljax_torch.scene import load_scene

    rng = np.random.default_rng(5)
    img = np.clip(np.linspace(0.1, 0.9, 54)[:, None, None]
                  + rng.normal(0.0, 0.1, (54, 96, 3)), 0.0, 1.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cornell.gltf"
        write_cornell_gltf(path)
        card = fit_env_surrogate.samples_from_image(img, load_scene(path),
                                                    device)
        cpu = fit_env_surrogate.samples_from_image(img, load_scene(path),
                                                   "cpu")
    counts = [[int((s[2] == k).sum()) for k in (0, 1)] for s in (card, cpu)]
    off = sum(abs(a - b) for a, b in zip(*counts))
    budget = max(2, img.shape[0] * img.shape[1] // 5000)
    err = None
    if counts[0] == counts[1]:
        err = max(float(np.abs(a - b).max()) for a, b in zip(card[:2],
                                                             cpu[:2]))
    print(f"fit_env_surrogate.samples_from_image 96x54 on the card: "
          f"background, mirror samples {counts[0]} (CPU {counts[1]}); max "
          f"|card - CPU| of directions and radiance "
          + ("not compared (other counts)" if err is None else f"{err:.3e}"))
    if off > budget or (err is not None and err > 1e-4):
        raise RuntimeError("fit_env_surrogate samples on the card differ "
                           "from the CPU's")


def phase_raster(device, scenes, path_h, ptxas: dict) -> dict:
    """Path R: path H's frame (path L's scene, the bench's 1920x1080 hybrid
    config, path H's environment) with STEELJAX_RASTER=1, the G-buffer's
    primary visibility rasterized (csrc/raster.cu, R).  One warm and
    HYBRID_TIMED_FRAMES timed frames with the launch counts set to 0 just
    before and read just after (one R and one K2 launch a frame, no K1);
    the frame against the traced one; ms/frame of both in turns (traced,
    raster, raster, traced); 2 profiled frames of each (device busy, the
    stages' spans, the runtime's synchronizing calls, which the raster
    must not add); the G-buffer stage alone both ways; the raster record
    against K1's traced G-buffer record on all pixels within
    tests/test_raster.py's 3% budget; the kernel alone over the frame's
    subtiles (CUDA events, 50 launches) with its bound (and the bound at
    strip granularity), its work split (_raster_work), bit-equal to
    _raster_tiles_plain on every subtile; the tie-heavy launch
    (_raster_ties); R's registers from the build's `ptxas` table; then the
    Cornell box at 1280x720 with the raster (R bit-equal to its plain version
    there too), and fit_env_surrogate's sample gathering on the card
    against the CPU."""
    from steeljax_torch.accel import cuda_traverse
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.apps.timing import REPS, wall_ms
    from steeljax_torch.render.hybrid import gbuffer, raster
    from steeljax_torch.render.hybrid.renderer import pixel_center_rays

    scene, flat, tables = scenes["sunlit"]
    width, height = kp.HYBRID_WIDTH, kp.HYBRID_HEIGHT
    renderer = _raster_renderer(scene, width, height, path_h["env"], device,
                                prepared=(flat, tables))
    rscene = renderer.raster_scene
    _reset_launches()
    ms_frame, image = _raster_frames(renderer, rscene, HYBRID_TIMED_FRAMES)
    launches = dict(cuda_traverse.LAUNCHES)
    total = 1 + HYBRID_TIMED_FRAMES
    want = {k: total if k in ("R", "K2") else 0 for k in launches}
    if launches != want:
        raise RuntimeError(f"path R launched {launches} over {total} "
                           f"frames, expected {want}")
    traced_ms, traced = _raster_frames(renderer, None, HYBRID_TIMED_FRAMES)
    image, traced = image.cpu().numpy(), traced.cpu().numpy()
    if image.shape != (width * height, 3) or not np.isfinite(image).all() \
            or image.std() <= 0.0:
        raise RuntimeError(f"path R: bad frame {image.shape}")
    rmse = float(np.sqrt(np.mean((image - traced) ** 2)))
    turns = {"traced": [], "raster": []}
    for name in ("traced", "raster", "raster", "traced"):
        turns[name].append(_raster_frames(
            renderer, rscene if name == "raster" else None,
            HYBRID_TIMED_FRAMES)[0])
    turns = {k: sum(v) / len(v) for k, v in turns.items()}
    print(f"path R {width}x{height} (path H with STEELJAX_RASTER=1): "
          f"{ms_frame:.3f} ms/frame over {HYBRID_TIMED_FRAMES} timed frames "
          f"(traced G-buffer {traced_ms:.3f} in this phase, path H "
          f"{path_h['ms_frame']:.3f} in phase 11); launches over {total} "
          "frames " + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f" (R {launches['R'] / total:.0f}, K2 {launches['K2'] / total:.0f}"
          f" a frame, no K1); RMSE against the traced frame {rmse:.3e}; in "
          f"turns (traced, raster, raster, traced): raster "
          f"{turns['raster']:.3f}, traced {turns['traced']:.3f} ms/frame")
    if rmse >= 0.02:
        raise RuntimeError(f"path R: RMSE {rmse} against the traced frame")

    stages = ("gbuffer_stage", "lighting_stage", "forward_stage")
    profiles = {}
    for name, rs in (("raster", rscene), ("traced", None)):
        renderer.raster_scene = rs
        profiles[name] = _profile_frames(renderer.render_frame_device,
                                         spans=stages, top=10)
    renderer.raster_scene = rscene
    for name, prof in profiles.items():
        busy = prof["busy_ms"]
        print(f"path R {name} frame torch.profiler, per frame: device busy "
              f"{busy:.3f} ms of {prof['wall_ms']:.3f} ms wall (idle share "
              + (f"{1.0 - busy / prof['wall_ms']:.3f}" if busy > 0.0
                 else "not measured")
              + f"), {prof['kernels']:.0f} device kernels, "
              + ", ".join(f"{k} {v:.1f}" for k, v in prof["syncs"].items())
              + "; trace kernels " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in sorted(
                      prof["trace_ms"].items()))
              + "; stage device spans " + ", ".join(
                  f"{k} {prof['span_ms'].get(k, 0.0):.3f} ms"
                  for k in stages))
    for ms, count, key in profiles["raster"]["top"]:
        print(f"  path R raster frame {ms:8.3f} ms/frame in {count:6.0f} "
              f"launches: {key[:90]}")
    # A host synchronization: a stream or device synchronize, or a copy
    # from or to pageable host memory (a cudaMemcpyAsync between device
    # buffers does not wait for the host).
    added = {k: profiles["raster"]["syncs"][k] - profiles["traced"]["syncs"][k]
             for k in SYNC_CALLS}
    kinds = set(profiles["raster"]["copies"]) | set(
        profiles["traced"]["copies"])
    copies = {k: profiles["raster"]["copies"].get(k, 0.0)
              - profiles["traced"]["copies"].get(k, 0.0) for k in kinds}
    waits = {k: v for k, v in added.items() if k != "cudaMemcpyAsync"}
    waits.update({k: v for k, v in copies.items() if "Pageable" in k})
    print("path R calls and copies added a frame by the raster: "
          + ", ".join(f"{k} {v:+.1f}" for k, v in added.items())
          + "; device copies " + (", ".join(
              f"{k} {v:+.1f}" for k, v in sorted(copies.items()))
              or "none") + "; host synchronizations added "
          + f"{sum(waits.values()):+.1f}")
    if any(v > 0.0 for v in waits.values()):
        raise RuntimeError(f"the raster adds host synchronizations: {waits}")

    # The rays, the records and the G-buffer stage alone, both ways.
    inverse_view, inverse_proj, view_proj = renderer.matrices
    o, d, _ = pixel_center_rays(inverse_view, inverse_proj, width, height,
                                *renderer.pixels)
    near, far = renderer.frame.camera_near, renderer.frame.camera_far
    spread = 2.0 * inverse_proj[1, 1].abs() / height
    raster_args = (rscene, width, height, renderer.tile)

    def stage(raster_arg):
        return lambda: gbuffer.generate_gbuffer(
            flat, tables, o, d, near, far, view_proj, inverse_view[:3, 3],
            pixel_spread=spread, raster=raster_arg)

    stage_ms = {"raster": [], "traced": []}
    for name in ("raster", "traced", "traced", "raster"):
        stage_ms[name].append(wall_ms(stage(
            raster_args if name == "raster" else None)))
    print(f"path R G-buffer stage alone (generate_gbuffer, host ms a call "
          f"ending in a synchronize, {REPS} calls, in turns raster, traced, "
          f"traced, raster): raster " + " / ".join(
              f"{v:.3f}" for v in stage_ms["raster"]) + ", traced (K1) "
          + " / ".join(f"{v:.3f}" for v in stage_ms["traced"]))
    rec_r = raster.raster_rec(rscene, view_proj, width, height,
                              renderer.tile, d, near)
    rec_t = gbuffer.trace_opaque(flat, tables, o, d, near, far, 4)
    versus = _raster_vs_trace("path R raster record against K1's traced "
                              "G-buffer record", rec_r, rec_t, 0.03)

    kernel = _raster_kernel(rscene, view_proj, width, height, near, ptxas)
    kernel["cornell"] = _raster_cornell(device, path_h["env"])
    _surrogate_on_card(device)
    return {"launches": launches, "ms_frame": ms_frame,
            "traced_ms_frame": traced_ms, "turns": turns,
            "stage_ms": stage_ms, "versus_trace": versus,
            "syncs_added": waits, "kernel": kernel}


def _raster_kernel(rscene, view_proj, width, height, near,
                   ptxas: dict) -> dict:
    """Phase 17's rows of R on one frame's inputs: the kernel alone (CUDA
    events, 50 launches) with its bound and its bound at strip
    granularity, its work split, bit-equal to _raster_tiles_plain on every
    subtile (the plain version timed over 3 calls), the tie-heavy launch
    and its registers from the build's `ptxas` table.  Returns the kernels
    line's entry of R."""
    from steeljax_torch.apps.timing import time_ms
    from steeljax_torch.render.hybrid import raster

    recs_sorted, _, tile_ids, segments = raster._binned(
        rscene, view_proj, width, height, near)
    ntx = width // raster.TILE_W
    n_tiles = tile_ids.shape[0]
    launch, out = raster.raster_tiles_launcher(recs_sorted, tile_ids,
                                               segments, ntx)
    kernel_ms = time_ms(launch, 50)
    work = _raster_work(recs_sorted, tile_ids, segments, ntx)
    kept = {}

    def plain():
        kept["out"] = raster._raster_tiles_plain(recs_sorted, tile_ids,
                                                 segments, ntx)

    plain_ms = time_ms(plain, 3)
    parity = _tile_parity(out, kept["out"])
    # The (subtile, winning triangle) pairs of the plain version's output.
    pz, ptri = kept["out"][0], kept["out"][4]
    hit = pz > 0.0
    row = torch.arange(n_tiles, device=pz.device)[:, None].expand_as(pz)
    hits = int(hit.sum())
    winners = int(torch.unique(torch.stack(
        [row[hit], ptri[hit].to(torch.int64)]), dim=1).shape[1])
    bound = _raster_bound(work, n_tiles, hits, winners, strips=True)
    subtile_bound = _raster_bound(work, n_tiles, hits)
    stats = raster.raster_stats(rscene, view_proj, width, height, near)
    print(f"R raster_tiles path R: {n_tiles} subtiles ({width}x{height}), "
          f"kernel {kernel_ms:.4f} ms; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']} ({bound['bytes']:.4e} B: "
          f"{work['candidates']:,} candidates' bbox words, "
          f"{work['covering']:,} covering records' walk columns, {winners:,} "
          f"(subtile, winner) pairs' attributes; {bound['ops']:.4e} fp32 "
          f"ops: {work['strip_live']:,} (covering, strip) pairs x "
          f"{raster.STRIP_ROWS * raster.TILE_W} pixels), R takes "
          f"{kernel_ms / bound['bound_ms']:.2f}x it; at subtile granularity "
          f"(whole records, every pixel of a covering candidate) "
          f"{subtile_bound['bound_ms']:.4f} ms by "
          f"{subtile_bound['bound_by']} ({subtile_bound['bytes']:.4e} B, "
          f"{subtile_bound['ops']:.4e} fp32 ops); binning {stats}; plain "
          f"{plain_ms:.4f} ms on all {n_tiles} subtiles; against plain "
          + ("bit-equal" if parity["bit_equal"] else f"DIFFERENT {parity}"))
    print(f"R work split path R: {_work_text(work)}")
    if kernel_ms < subtile_bound["bound_ms"]:
        print(f"R runs under its subtile-granularity bound ({kernel_ms:.4f} "
              f"< {subtile_bound['bound_ms']:.4f} ms): the kernel reads "
              "whole records of covering candidates only, and the strip "
              f"test skips {work['strip_rejected']:,} of "
              f"{work['strip_pairs']:,} (covering, strip) pairs that that "
              "bound charges")
    if not parity["bit_equal"]:
        raise RuntimeError(f"R: the kernel differs from its plain version: "
                           f"{parity}")
    ties = _raster_ties(recs_sorted, tile_ids, segments, ntx)
    registers = check_raster_ptxas(ptxas)
    print(f"ptxas this tree: {RASTER_INSTANCE}: {registers[0]} registers, "
          f"{registers[1]} B stack frame, spill stores {registers[2]} B, "
          f"spill loads {registers[3]} B, static smem {registers[4]} B")

    return {"ms": kernel_ms, "plain_ms": plain_ms,
              "max_abs_err": parity["max_abs_err"], "library_ms": None,
              "tolerance": "bit-equal: torch.equal of all five outputs on "
                           "every subtile of path R, of the Cornell raster "
                           "frame and of the tie-heavy launch at WINDOW "
                           + ", ".join(map(str, RASTER_TIE_WINDOWS)),
              "shapes": f"{n_tiles} subtiles of {raster.PX} pixels, "
                        f"{recs_sorted.shape[0]} records of "
                        f"{raster._REC_COLS} floats",
              "rays": width * height, "plain_rays": width * height,
              "parity": parity, "bit_equal": parity["bit_equal"],
              **bound, "subtile_bound_ms": subtile_bound["bound_ms"],
              "subtile_bound_by": subtile_bound["bound_by"],
              "winners": winners, "work": work, "ties": ties,
              "registers": registers[0]}


# Phase 18, paths LS and FS: path L's and path F's scenes prepared with
# STEELJAX_SBVH=1, the reference's switch (steeljax/accel/bvh.py:120-143:
# spatial splits at alpha 1e-5, the reference list at most 1.5x the
# triangles), which bvh.build_bvh's "auto" method reads at the build.
SBVH_SCENES = {"path LS": "sunlit", "path FS": "foliage",
               "path IS": "sunlit_inst", "path US": "stress_tex_treelets"}
# Path IS's three BLAS (a sphere, a box, a quad) take no split at any
# alpha, so its trees are path I's.  The two-level kernel K6 meets a
# reference list in phase 18's cards case: path F's leaf cards at
# CARDS_IS cards, opaque and untextured (shade mode 1), one split BLAS
# beside the ground quad, under STEELJAX_SBVH=1.
CARDS_IS = 50_000
# Phase 18 times each plain version over one call after a warm one (the
# brute-force calls take 2-6 s each; phase 3b's rows take 3).
PLAIN_CALLS_SBVH = 1


def _sbvh_tables(label, flat, tables, steps, sah_steps) -> dict:
    """Print and return what the spatial splits did to one path's tables:
    source triangles, references (real slots), padded slots, binary and
    BVH8 depth, BVH8 rows, the stack the walk needs against
    cuda_traverse.MAX_STACK, and the host seconds of the build and the
    collapse both ways (this preparation's steps and phase 3a's)."""
    from steeljax_torch.accel.cuda_traverse import MAX_STACK

    chunk = tables.chunks[0]
    nodes = chunk.bvh.nodes
    refs = int(nodes[nodes[:, 7] > 0, 7].sum())
    stack = chunk.bvh8.width * chunk.bvh8.depth + 16
    out = {"source_triangles": flat.source_tri_count, "references": refs,
           "padded": chunk.rows, "binary_nodes": len(nodes),
           "binary_depth": chunk.bvh.depth,
           "bvh8_rows": int(chunk.bvh8.rows.shape[0]),
           "bvh8_depth": chunk.bvh8.depth, "stack": stack,
           "max_stack": MAX_STACK}
    for way, st in (("sbvh", steps), ("sah", sah_steps)):
        for step in ("build_bvh", "collapse_bvh8"):
            out[f"{way}_{step}_s"] = st.get(f"prepare_tables.{step}", 0.0)
    print(f"{label}: {out['source_triangles']} source triangles, "
          f"{refs} references ({refs / out['source_triangles']:.4f}x), "
          f"{chunk.rows} padded slots, {len(nodes)} binary nodes of depth "
          f"{chunk.bvh.depth}, {out['bvh8_rows']} BVH8 rows of depth "
          f"{chunk.bvh8.depth}: a stack of {stack} of MAX_STACK {MAX_STACK} "
          f"(margin {MAX_STACK - stack}); host seconds of the build "
          f"{out['sbvh_build_bvh_s']:.3f} with splits, "
          f"{out['sah_build_bvh_s']:.3f} object SAH (phase 3a), of the "
          f"collapse {out['sbvh_collapse_bvh8_s']:.3f} and "
          f"{out['sah_collapse_bvh8_s']:.3f}")
    if stack > MAX_STACK:
        raise RuntimeError(f"{label}: the walk needs a stack of {stack}")
    if refs <= out["source_triangles"]:
        raise RuntimeError(f"{label}: the spatial splits made no reference")
    return out


def _pool_sources(tables) -> np.ndarray:
    """The source triangle of every record of a two-level pool
    (kernel_parity.source_ids over its Hopper records' v0, e1, e2): the
    slots of one triangle in a split BLAS have identical records."""
    from steeljax_torch.apps import kernel_parity as kp

    rec = tables.tri_records.cpu().numpy()
    return kp.source_ids(np.stack([rec[:, 0:3], rec[:, 4:7], rec[:, 8:11]],
                                  axis=1))


def _sbvh_pool(label, tables, steps, sah_label, sah_tables, sah_steps
               ) -> dict:
    """Print and return what the spatial splits did to two-level tables:
    the pool's real records (references) and the distinct triangles among
    them, both ways, the supernode rows and depth, and the host seconds of
    the BLAS builds (instances.blas) both ways.  A BLAS that takes no split
    keeps the object-SAH tree (the split search finds no split worth its cost
    in a closed, finely tessellated mesh)."""
    def counts(t):
        real = t.tri_records[:, 0].cpu().numpy() < 1e37
        return int(real.sum()), int(np.unique(_pool_sources(t)[real]).size)

    refs, source = counts(tables)
    sah_refs, sah_source = counts(sah_tables)
    out = {"source_triangles": source, "references": refs,
           "sah_references": sah_refs, "blas": len(tables.blas_tri_offset),
           "instances": tables.instance_count,
           "supernode_rows": int(tables.snode_rows.shape[0]),
           "depth": tables.depth,
           "sbvh_blas_s": steps.get("instances.blas", 0.0),
           "sah_blas_s": sah_steps.get("instances.blas", 0.0)}
    print(f"{label}: {tables.instance_count} instances of {out['blas']} "
          f"BLAS, {refs} references for {source} distinct triangles "
          f"({sah_refs} for {sah_source} on {sah_label}), "
          f"{out['supernode_rows']} supernode rows, two-level depth "
          f"{tables.depth}; "
          + ("split" if refs > source
             else "no BLAS split (the object-SAH trees)")
          + f"; host seconds of the BLAS builds {out['sbvh_blas_s']:.3f} "
          f"with splits, {out['sah_blas_s']:.3f} object SAH")
    return out


def _sbvh_treelets(label, flat, tables, steps, sah_label, sah_tables,
                   sah_steps) -> dict:
    """Print and return what the spatial splits did to treelet tables:
    references against source triangles, treelets and BVH8 depth both
    ways, and the host seconds of the one global build both ways."""
    def refs(t):
        nodes = t.chunks[0].bvh.nodes
        return int(nodes[nodes[:, 7] > 0, 7].sum())

    tt, sah_tt = tables.treelets, sah_tables.treelets
    out = {"source_triangles": flat.source_tri_count,
           "references": refs(tables), "padded": tables.chunks[0].rows,
           "treelets": tt.count, "bvh8_depth": tt.depth,
           "sah_references": refs(sah_tables), "sah_treelets": sah_tt.count,
           "sah_bvh8_depth": sah_tt.depth,
           "sbvh_build_bvh_s": steps.get("prepare_tables.build_bvh", 0.0),
           "sah_build_bvh_s": sah_steps.get("prepare_tables.build_bvh",
                                            0.0)}
    print(f"{label}: {out['source_triangles']} source triangles, "
          f"{out['references']} references "
          f"({out['references'] / out['source_triangles']:.4f}x), "
          f"{out['padded']} padded slots, {tt.count} treelets, BVH8 depth "
          f"{tt.depth} ({sah_label}: {out['sah_references']} references, "
          f"{sah_tt.count} treelets, depth {sah_tt.depth}); host seconds "
          f"of the build {out['sbvh_build_bvh_s']:.3f} with splits, "
          f"{out['sah_build_bvh_s']:.3f} object SAH")
    if out["references"] <= out["source_triangles"]:
        raise RuntimeError(f"{label}: the spatial splits made no reference")
    return out


def _inst_row(row, tables, rays, any_hit: bool, source=None,
              plain_calls: int = PLAIN_CALLS_SBVH) -> dict:
    """Phase 3b's row of K6 (nearest, culling on) or its any-hit query on
    `rays` through two-level `tables`, held against its plain version on a
    strided subset (`source`: the pool's source triangles, _pool_sources,
    for split BLAS)."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.apps import kernel_parity as kp

    subset = kp.strided_subset(rays, kp.SHADOW_SUBSET)
    label = " ".join(row)

    def check(plain_rec):
        rec = ct.trace_nearest_bvh8_inst(tables, *subset, not any_hit,
                                         any_hit)
        torch.cuda.synchronize()
        results = {}
        if any_hit:
            kp._compare_hits(label, rec["hit"], plain_rec["hit"], results)
        else:
            kp._compare(label, rec, plain_rec, None, results, direct=True,
                        source=source)
        return results[label]

    return _timed_kernel(
        row, lambda counters: ct.inst_launcher(
            tables, *rays, not any_hit, any_hit, counters=counters),
        lambda: ct.trace_nearest_bvh8_inst_plain(tables, *subset,
                                                 not any_hit, any_hit),
        rays, subset[0].shape[0], check, plain_calls=plain_calls)


def _opaque_cards(device):
    """Phase 18's cards case: make_foliage_scene(cards=CARDS_IS) with its
    leaves opaque and untextured, prepared through the two-level structure
    under STEELJAX_SBVH=1 (the caller sets it): (scene, flat, tables)."""
    from steeljax_torch.accel.instances import InstancedAccel
    from steeljax_torch.render.pt.renderer import prepare_scene
    from steeljax_torch.scene.builtin import make_foliage_scene
    from steeljax_torch.scene.material import MaterialFlags

    scene = make_foliage_scene(cards=CARDS_IS)
    scene.textures = []
    for material in scene.materials:
        material.base_color_texture = -1
        material.flags &= ~MaterialFlags.ALPHA_TEST
    flat, tables = prepare_scene(scene, device, env_resolution=64,
                                 accel=InstancedAccel(device=device))
    return scene, flat, tables


def phase_sbvh(device, scenes, kernels, prepare_steps, sah_paths) -> dict:
    """Paths LS, FS, IS and US: path L's, path F's, path I's and path U's
    scenes prepared as a user would (kernel_parity.prepare_path_scene) with
    STEELJAX_SBVH=1, which is restored afterwards, and the cards case
    (_opaque_cards); FS multihit is path FS's tables with multihit_k = 4.
    Prints each tree's counts and build seconds (_sbvh_tables, _sbvh_pool,
    _sbvh_treelets).  Times,
    as phase 3b's rows, K1 and K2 on path L's primaries and first-bounce
    shadow rays and K4 and K5 (K = 4) on path F's primaries, over the
    spatial-split tables, each against its plain version on a strided
    subset by source triangle (kernel_parity.source_ids: a hit on a
    duplicated triangle may come from either slot; K5's lists compared
    without repeats, kernel_parity._compare_slots_by_source), its bound the
    smaller of its own and the object-SAH row's on the same rays
    (_least_bound); K6 and its any-hit query on path I's primaries and
    first-bounce shadow rays over IS's tables and on the cards' own, K7 on
    path U's primaries over US's tables, likewise.  Then the frames of LS,
    FS, FS multihit, IS and US (drive_path: launches, busy time, kernels a
    frame) beside the object-SAH frames of phases 5a, 7a, 7c, 9a and 10a in
    this call, the pixels beyond 1e-4 against them, each held to it
    (_same_frame).  Returns {"tables", "rows" (by kernel), "cards_rows" (K6
    and K6_anyhit on the cards), "frames", "prepared" (the paths' (scene,
    flat, tables) by label, for phase 20)}."""
    import os

    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel import treelets as treelets_lib
    from steeljax_torch.apps import kernel_parity as kp

    prepared, info = {}, {}
    before = os.environ.get("STEELJAX_SBVH")
    os.environ["STEELJAX_SBVH"] = "1"
    try:
        for label, name in SBVH_SCENES.items():
            prepared[label], seconds, steps = _profiled_steps(
                lambda: kp.prepare_path_scene(name, device))
            print(f"prepare_scene {label} (STEELJAX_SBVH=1): {seconds:.3f} "
                  f"s (scene construction included): {_steps_text(steps)}")
            sah_label = label[:-1]
            if name in kp.INSTANCED_SCENES:
                info[label] = _sbvh_pool(label, prepared[label][2], steps,
                                         sah_label, scenes[name][2],
                                         prepare_steps[name])
            elif name in kp.TREELET_SCENES:
                info[label] = _sbvh_treelets(
                    label, *prepared[label][1:], steps, sah_label,
                    scenes[name][2], prepare_steps[name])
            else:
                info[label] = _sbvh_tables(label, *prepared[label][1:],
                                           steps, prepare_steps[name])
        cards, seconds, steps = _profiled_steps(lambda: _opaque_cards(device))
    finally:
        if before is None:
            del os.environ["STEELJAX_SBVH"]
        else:
            os.environ["STEELJAX_SBVH"] = before
    cards_tables = cards[2]
    real = cards_tables.tri_records[:, 0].cpu().numpy() < 1e37
    cards_source = _pool_sources(cards_tables)
    info["cards"] = {"references": int(real.sum()),
                     "source_triangles": int(np.unique(
                         cards_source[real]).size),
                     "blas": len(cards_tables.blas_tri_offset),
                     "depth": cards_tables.depth,
                     "shade_mode": cards_tables.shade_mode,
                     "prepare_s": seconds,
                     "blas_s": steps.get("instances.blas", 0.0)}
    print(f"cards IS (make_foliage_scene(cards={CARDS_IS}), opaque, "
          f"untextured, instancing, STEELJAX_SBVH=1): {seconds:.3f} s, "
          f"BLAS builds {info['cards']['blas_s']:.3f} s; "
          f"{info['cards']['references']} references for "
          f"{info['cards']['source_triangles']} distinct triangles in "
          f"{info['cards']['blas']} BLAS, two-level depth "
          f"{cards_tables.depth}, shade mode {cards_tables.shade_mode}")
    if info["cards"]["references"] <= info["cards"]["source_triangles"] or \
            cards_tables.shade_mode != 1:
        raise RuntimeError("cards IS: no split BLAS in shade mode 1")

    rows = {}
    # K1 and K2 on path L's rays (the primaries are LS's own; the shadow
    # rays start at path L's primary hits, which LS's tables give again but
    # on exact ties), held by source triangle.
    scene, flat, tables = prepared["path LS"]
    chunk = tables.chunks[0]
    source = kp.source_ids(flat.tri_pos.cpu().numpy())
    l_scene, l_flat, l_tables = scenes["sunlit"]
    primary = kp.tiled_primary(l_scene, device, WIDTH, HEIGHT)[:4]
    row = ("K1", "path LS", PRIMARIES)
    rows["K1"] = _nearest_row(row, chunk, flat, tables.shade_mode, primary,
                              kp.strided_subset(primary, kp.SHADOW_SUBSET),
                              source=source, plain_calls=PLAIN_CALLS_SBVH)
    _least_bound(row, rows["K1"], kernels["K1"]["path_l"],
                 "path L's row on the same rays, object-SAH tables")
    shadow = kp.sunlit_shadow_case(l_scene, l_flat, l_tables, WIDTH, HEIGHT)
    row = ("K2", "path LS", SHADOW)
    rows["K2"] = _anyhit_row(row, chunk, shadow,
                             plain_calls=PLAIN_CALLS_SBVH)
    _least_bound(row, rows["K2"], kernels["K2"],
                 "path L's row on the same rays, object-SAH tables")

    # K4 and K5 on path F's primaries, coarse and fine masks.
    scene, flat, tables = prepared["path FS"]
    chunk = tables.chunks[0]
    tri_pos = flat.tri_pos.cpu().numpy()
    source = kp.source_ids(tri_pos)
    kw = dict(alpha_mask=True, fine_rows=chunk.fine_mask_rows)
    args = (chunk.bvh8, chunk.tris_packed)
    rays = kp.tiled_primary(scene, device, WIDTH, HEIGHT)[:4]
    subset = kp.strided_subset(rays, kp.FOLIAGE_SUBSET)
    k_hits = kp.FOLIAGE_MULTIHIT_K

    def check_k4(plain_rec):
        rec = ct.trace_nearest_bvh8(*args, *subset, True, None, 0,
                                    records=chunk.tri_records, **kw)
        results = {}
        kp._compare("K4 path FS", rec, plain_rec, tri_pos, results,
                    source=source)
        return results["K4 path FS"]

    def check_k5(plain_slots):
        slots = ct.trace_multihit_bvh8(*args, *subset, k_hits, True,
                                       records=chunk.tri_records, **kw)
        results = {}
        kp._compare_slots_by_source("K5 path FS", slots, plain_slots, source,
                                    results)
        return results["K5 path FS"]

    row = ("K4", "path FS", PRIMARIES)
    rows["K4"] = _timed_kernel(
        row, lambda counters: ct.kernel_launcher(
            *args, *rays, True, None, 0, counters=counters,
            records=chunk.tri_records, **kw),
        lambda: ct.trace_nearest_bvh8_plain(*args, *subset, True, None, 0,
                                            **kw),
        rays, subset[0].shape[0], check_k4, plain_calls=PLAIN_CALLS_SBVH)
    _least_bound(row, rows["K4"], kernels["K4"],
                 "path F's row on the same rays, object-SAH tables")
    row = ("K5", "path FS", PRIMARIES)
    rows["K5"] = _timed_kernel(
        row, lambda counters: ct.multihit_launcher(
            *args, *rays, k_hits, True, counters=counters,
            records=chunk.tri_records, **kw),
        lambda: ct.trace_multihit_bvh8_plain(*args, *subset, k_hits, True,
                                             **kw),
        rays, subset[0].shape[0], check_k5, plain_calls=PLAIN_CALLS_SBVH)
    _least_bound(row, rows["K5"], kernels["K5"],
                 "path F's row on the same rays, object-SAH tables")

    # K6 and its any-hit query on path I's rays over IS's tables (path I's
    # trees when no BLAS split), and on the cards' own rays over their
    # split BLAS; K7 on path U's primaries over US's treelets.
    i_scene, i_flat, i_tables = scenes["sunlit_inst"]
    tables = prepared["path IS"][2]
    primary = kp.tiled_primary(i_scene, device, WIDTH, HEIGHT)[:4]
    shadow = kp.sunlit_shadow_case(i_scene, i_flat, i_tables, WIDTH, HEIGHT)
    source = _pool_sources(tables)
    for k, row, rays, any_hit in (
            ("K6", ("K6", "path IS", PRIMARIES), primary, False),
            ("K6_anyhit", ("K6_anyhit", "path IS", SHADOW), shadow, True)):
        rows[k] = _inst_row(row, tables, rays, any_hit, source)
        _least_bound(row, rows[k], kernels[k],
                     "path I's row on the same rays, object-SAH BLAS")
        rows[k]["shapes"] = (f"path I's {row[2]} over path IS's two-level "
                             "tables, 1280x720")
    cards_rows = {}
    c_scene, c_flat, c_tables = cards
    primary = kp.tiled_primary(c_scene, device, WIDTH, HEIGHT)[:4]
    shadow = kp.sunlit_shadow_case(c_scene, c_flat, c_tables, WIDTH, HEIGHT)
    for k, row, rays, any_hit in (
            ("K6", ("K6", "cards IS", PRIMARIES), primary, False),
            ("K6_anyhit", ("K6_anyhit", "cards IS", SHADOW), shadow, True)):
        cards_rows[k] = _inst_row(row, c_tables, rays, any_hit, cards_source)
        cards_rows[k]["shapes"] = (
            f"{row[2]} of make_foliage_scene(cards={CARDS_IS}) made opaque "
            "and untextured, its cards one split BLAS (STEELJAX_SBVH=1), "
            "1280x720")
    u_scene, u_flat, u_tables = scenes["stress_tex_treelets"]
    _, flat, tables = prepared["path US"]
    rays = kp.tiled_primary(u_scene, device, WIDTH, HEIGHT)[:4]
    subset = kp.strided_subset(rays, kp.TEX_SUBSET)
    source = kp.source_ids(flat.tri_pos.cpu().numpy())
    label = f"K7 path US {PRIMARIES}"

    def check_k7(plain_rec):
        rec = treelets_lib.trace_treelets(tables.treelets, *subset, True)
        torch.cuda.synchronize()
        results = {}
        kp._compare(label, rec, plain_rec, flat.tri_pos.cpu().numpy(),
                    results, attrs={k: v.cpu().numpy() for k, v in (
                        ("nrm", flat.tri_nrm), ("tan", flat.tri_tan),
                        ("uv", flat.tri_uv), ("mat", flat.tri_mat))},
                    d=subset[1].cpu().numpy(), source=source)
        return results[label]

    rows["K7"] = _timed_treelet_trace("K7", tables.treelets, rays, subset,
                                      True, False, check_k7, label)
    _least_bound(("K7", "path US", PRIMARIES), rows["K7"], kernels["K7"],
                 "path U's row on the same rays, object-SAH treelets")
    rows["K7"]["shapes"] = ("path U's primaries over path US's treelets, "
                            "1280x720, every round of one trace")
    for k, ray_set, rays_of in (("K1", PRIMARIES, "path L"),
                                ("K2", SHADOW, "path L"),
                                ("K4", PRIMARIES, "path F"),
                                ("K5", PRIMARIES, "path F")):
        rows[k]["shapes"] = (f"{rays_of}'s {ray_set} over {rays_of}S's "
                             "spatial-split tables, 1280x720")
    rows["K5"]["tolerance"] = ("by source triangle, repeats of one "
                               "triangle dropped: |dt| < 2e-3, |du|, |dv| < "
                               "5e-3 on equal ids, ray mismatches <= max(2, "
                               "N K/5000)")

    # The frames, beside the object-SAH frames of this call.
    alpha_passes = 2 * (1 + 4)
    scene, flat, tables = prepared["path FS"]
    drives = (("path LS", prepared["path LS"], {"K1": 1, "K2": 1},
               "path L"),
              ("path FS", prepared["path FS"],
               {"K4": alpha_passes, "alpha": alpha_passes}, "path F"),
              ("path FS multihit", (scene, flat, tables.replace(
                  multihit_k=k_hits)),
               {"K5": alpha_passes, "alpha": k_hits * alpha_passes},
               "path F multihit"),
              ("path IS", prepared["path IS"], {"K6": 1, "K6_anyhit": 1},
               "path I"),
              ("path US", prepared["path US"], {"K7": None, "K7_pick": None},
               "path U"))
    frames = {}
    for label, (scene, flat, tables), expected, sah in drives:
        out = drive_path(label, scene, flat, tables, expected)
        ref = sah_paths[sah]
        delta = np.abs(out["image"] - ref["image"]).max(axis=-1)
        out["pixels_beyond"] = int((delta > PIXEL_ATOL).sum())
        print(f"{label} against {sah} (object SAH, this call): "
              f"{out['ms_frame']:.3f} against {ref['ms_frame']:.3f} "
              f"ms/frame, device busy {out['busy_ms']:.3f} against "
              f"{ref['busy_ms']:.3f} ms, {out['device_kernels']:.0f} against "
              f"{ref['device_kernels']:.0f} device kernels a frame; "
              f"{out['pixels_beyond']} of {delta.size} pixels differ by "
              f"more than {PIXEL_ATOL} (max {float(delta.max()):.3e})")
        _same_frame(label, out, sah, ref)
        frames[label] = out
    return {"tables": info, "rows": rows, "cards_rows": cards_rows,
            "frames": frames, "prepared": prepared}


# Phase 19, STEELJAX_SHADE_MODE: the reference's cap on the flat nearest
# trace's fused shading mode (steeljax/accel/dispatch.py:27-32, :476-478),
# read by dispatch.trace_nearest at every trace.  Each path renders with
# the switch unset and at 0 in SHADE_TURNS, two warm and SHADE_TIMED_FRAMES
# timed frames and 2 profiled ones a turn (path H: one warm).
SHADE_SWITCH = "STEELJAX_SHADE_MODE"
SHADE_TURNS = (None, "0", "0", None)
SHADE_TIMED_FRAMES = 2
# The integrator's two material branches (record_function ranges): the
# fused kernel's outputs, or the tri_shade row gather and unpack_material.
SHADE_SPANS = ("integrator.shade_fused", "integrator.shade_gather")
# A capped frame against the uncapped one (tests/test_torch_shade_mode.py,
# the path tracer's budget of tests/test_torch_integrator.py): at most
# max(2, N / SHADE_PIXEL_DIVISOR) pixels beyond PIXEL_ATOL, and rays_traced
# within SHADE_RAYS_PER_PIXEL segments a diverging pixel or RAYS_RTOL of
# the frame's, the larger: the fused normal and the gathered one part in
# their last bits, and a path that parts there and adds no radiance (a
# roulette flip whose segment hits an unlit wall) changes rays_traced and
# no pixel.  The tiles of the CPU tests part in none.
SHADE_PIXEL_DIVISOR = 200
SHADE_RAYS_PER_PIXEL = 4


def _with_switch(name: str, value, fn):
    """fn() with the environment variable `name` set to `value` (None:
    unset), restored afterwards."""
    import os

    before = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        return fn()
    finally:
        if before is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = before


def _capped_held(label, capped: dict, fused: dict) -> dict:
    """Hold a capped turn's last frame to an uncapped turn's (the budget
    above; rays_traced where the turns count it)."""
    delta = np.abs(capped["image"] - fused["image"]).max(axis=-1)
    beyond = int((delta > PIXEL_ATOL).sum())
    budget = max(2, delta.size // SHADE_PIXEL_DIVISOR)
    out = {"pixels_beyond": beyond, "max_delta": float(delta.max())}
    text = ""
    ok = beyond <= budget
    if "rays_frame" in capped:
        out["rays_delta"] = abs(capped["rays_frame"] - fused["rays_frame"])
        rays_budget = max(SHADE_RAYS_PER_PIXEL * beyond,
                          RAYS_RTOL * fused["rays_frame"])
        ok &= out["rays_delta"] <= rays_budget
        text = (f"; rays_traced a frame {capped['rays_frame']:.0f} against "
                f"{fused['rays_frame']:.0f} (|delta| {out['rays_delta']:.0f},"
                f" budget {rays_budget:.1f})")
    print(f"{label}: {beyond} of {delta.size} pixels beyond {PIXEL_ATOL} "
          f"(budget {budget}), max |delta| {out['max_delta']:.3e}" + text)
    if not ok:
        raise RuntimeError(f"{label}: the capped frame is beyond the "
                           "uncapped one's budget")
    return out


def _shade_way(label, turns: list, kernel_ms: float) -> dict:
    """One way's numbers from its two turns: ms/frame of each turn and
    their mean, the first turn's launches a frame, and of its profile
    device busy, kernels a frame, trace kernels, the ranges' device ms and
    rays_traced."""
    first = turns[0]
    way = {"launches_per_frame": {
               k: v / first["host_frames"]
               for k, v in first["launches"].items() if v},
           "ms_frame": [t["ms_frame"] for t in turns],
           "ms_frame_mean": float(np.mean([t["ms_frame"] for t in turns])),
           "busy_ms": first["busy_ms"],
           "device_kernels": first["device_kernels"],
           "trace_ms": first["trace_ms"], "span_ms": first["span_ms"],
           "primaries_kernel_ms": kernel_ms}
    if "rays_frame" in first:
        way["rays_frame"] = first["rays_frame"]
    print(f"{label}: " + ", ".join(f"{ms:.3f}" for ms in way["ms_frame"])
          + f" ms/frame (mean {way['ms_frame_mean']:.3f}), device busy "
          f"{way['busy_ms']:.3f} ms, {way['device_kernels']:.0f} kernels a "
          "frame, trace kernels "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
              way["trace_ms"].items()))
          + " ms, ranges " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in sorted(way["span_ms"].items()))
          + f"; the primaries' kernel alone {kernel_ms:.4f} ms; launches a "
          "frame " + ", ".join(f"{k} {v:.0f}" for k, v in
                               way["launches_per_frame"].items())
          + (f"; rays_traced {way['rays_frame']:.0f} a frame"
             if "rays_frame" in way else ""))
    return way


def _shade_turns(label, run, kernel_ms: dict, branch: dict) -> dict:
    """Run `run(value)` for each value of SHADE_TURNS under that switch;
    check that each turn took its material branch (`branch`: {way: the
    record_function range that must have device time, the other none}),
    hold each capped turn to the uncapped turn beside it, print each way
    (_shade_way) and return both ways with the held deltas."""
    turns = [_with_switch(SHADE_SWITCH, value, lambda: run(value))
             for value in SHADE_TURNS]
    ways = {"unset": [turns[0], turns[3]], "0": [turns[1], turns[2]]}
    for way, outs in ways.items():
        for out in outs:
            spans = out["span_ms"]
            if out["busy_ms"] > 0.0 and branch and not (
                    spans.get(branch[way], 0.0) > 0.0 and all(
                        spans.get(k, 0.0) == 0.0 for k in branch.values()
                        if k != branch[way])):
                raise RuntimeError(f"{label} with the switch {way}: device "
                                   f"time in the ranges {spans}, expected "
                                   f"{branch[way]} alone")
    result = {way: _shade_way(f"{label} {SHADE_SWITCH} {way}", outs,
                              kernel_ms[way]) for way, outs in ways.items()}
    result["held"] = [
        _capped_held(f"{label} capped turn {i} against the uncapped turn "
                     "beside it", turns[i], turns[j])
        for i, j in ((1, 0), (2, 3))]
    for i, j, way in ((0, 3, "unset"), (1, 2, "0")):
        same = bool(np.array_equal(turns[i]["image"], turns[j]["image"]))
        result[way]["turns_bit_equal"] = same
        print(f"{label} {SHADE_SWITCH} {way}: its two turns' frames "
              f"bit-equal: {same}")
    return result


def _hybrid_turn(renderer, frames: int) -> dict:
    """One warm and `frames` timed path H frames with the launch counts
    set to 0 just before and read just after (one K1 and one K2 a frame,
    no other kernel), then 2 profiled frames with the G-buffer stage's
    device span."""
    from steeljax_torch.accel import cuda_traverse

    _reset_launches()
    ms_frame, image = _hybrid_frames(renderer, frames)
    launches = dict(cuda_traverse.LAUNCHES)
    total = 1 + frames
    want = {name: total if name in ("K1", "K2") else 0 for name in launches}
    if launches != want:
        raise RuntimeError(f"path H launched {launches} over {total} "
                           f"frames, expected {want}")
    image = image.cpu().numpy()
    if not np.isfinite(image).all() or float(image.std()) <= 0.0:
        raise RuntimeError("path H: a non-finite or constant frame")
    prof = _profile_frames(renderer.render_frame_device,
                           spans=("gbuffer_stage",))
    return {"ms_frame": ms_frame, "image": image, "launches": launches,
            "host_frames": total,
            "busy_ms": prof["busy_ms"], "device_kernels": prof["kernels"],
            "trace_ms": prof["trace_ms"], "span_ms": prof["span_ms"]}


def phase_shade_mode(device, scenes, cornell, path_h, kernels) -> dict:
    """STEELJAX_SHADE_MODE on the card.  Checks that prepare_scene put
    every path's tri_shade rows on the card (the gather's table).  Times K1
    in shade mode 0 alone (rows K1_shade0) on the primaries of Cornell,
    path L and path T and on path H's G-buffer rays, each against its plain
    version, beside phase 3b's K1 and K3 rows on the same rays.  Renders
    Cornell, path L and path T (drive_path) and path H (the hybrid frame
    at 1920x1080) with the switch unset and at 0 in turns (_shade_turns):
    the launches each way (capped, path T launches K1 in K3's place), the
    material branch each took, the frames held to each other, and per way
    ms/frame, device busy, kernels a frame, the trace kernels and the
    ranges' device ms, and rays_traced.  Path T at 1 must raise the clear
    error, and any other outcome fails the phase.  The switch is restored
    afterwards.  Returns {"rows", "paths", "launches"}."""
    import os

    from steeljax_torch.accel import dispatch
    from steeljax_torch.apps import kernel_parity as kp
    from steeljax_torch.core.config import RenderConfig
    from steeljax_torch.render.hybrid.renderer import HybridRenderer

    before = os.environ.get(SHADE_SWITCH)
    l_scene, l_flat, l_tables = scenes["sunlit"]
    t_scene, t_flat, t_tables = scenes["stress_tex"]
    paths = {"Cornell": (cornell["prepared"], {"K1": 1}, {"K1": 1}),
             "path L": (scenes["sunlit"], {"K1": 1, "K2": 1},
                        {"K1": 1, "K2": 1}),
             "path T": (scenes["stress_tex"], {"K3": 1}, {"K1": 1})}
    for label, ((_, flat, tables), _, _) in paths.items():
        if flat.tri_shade.device != device:
            raise RuntimeError(f"{label}: tri_shade on "
                               f"{flat.tri_shade.device}, not {device}")
        print(f"{label}: tri_shade {tuple(flat.tri_shade.shape)} on "
              f"{flat.tri_shade.device}, tables in shade mode "
              f"{tables.shade_mode}")

    rows = {}
    cflat, ctables, cases = kp.cornell_cases(device, WIDTH, HEIGHT)
    hw, hh = kp.HYBRID_WIDTH, kp.HYBRID_HEIGHT
    l_rays = kp.tiled_primary(l_scene, device, WIDTH, HEIGHT)[:4]
    t_rays = kp.tiled_primary(t_scene, device, WIDTH, HEIGHT)[:4]
    h_rays = kp.hybrid_rays(l_scene, device, hw, hh)[:4]
    for label, ray_set, chunk, flat, rays, subset in (
            ("Cornell", PRIMARIES, ctables.chunks[0], cflat,
             cases["primary"], cases["primary"]),
            ("path L", PRIMARIES, l_tables.chunks[0], l_flat, l_rays,
             kp.strided_subset(l_rays, kp.SHADOW_SUBSET)),
            ("path T", PRIMARIES, t_tables.chunks[0], t_flat, t_rays,
             kp.strided_subset(t_rays, kp.TEX_SUBSET)),
            ("path H", GBUFFER, l_tables.chunks[0], l_flat, h_rays,
             kp.strided_subset(h_rays, kp.SHADOW_SUBSET))):
        rows[label] = _nearest_row(("K1_shade0", label, ray_set), chunk,
                                   flat, 0, rays, subset, plain_calls=1)
        rows[label]["shapes"] = (f"{label} {ray_set}, "
                                 + (f"{hw}x{hh}" if label == "path H"
                                    else f"{WIDTH}x{HEIGHT}")
                                 + ", shade mode 0 (STEELJAX_SHADE_MODE=0)")
    fused_ms = {"Cornell": kernels["K1"]["ms"],
                "path L": kernels["K1"]["path_l"]["ms"],
                "path T": kernels["K3"]["ms"],
                "path H": kernels["K1"]["path_h"]["ms"]}

    out, launches = {}, {}
    branch = {"unset": SHADE_SPANS[0], "0": SHADE_SPANS[1]}
    for label, (prepared, unset, capped) in paths.items():
        def run(value, label=label, prepared=prepared, unset=unset,
                capped=capped):
            way = "unset" if value is None else f"at {value}"
            return drive_path(f"{label} ({SHADE_SWITCH} {way})", *prepared,
                              unset if value is None else capped,
                              frames=SHADE_TIMED_FRAMES, spans=SHADE_SPANS)

        out[label] = _shade_turns(
            label, run, {"unset": fused_ms[label],
                         "0": rows[label]["ms"]}, branch)
    # The hybrid G-buffer has no range of its own: the switch's effect on
    # its trace is read off the record.
    h_subset = kp.strided_subset(h_rays, kp.SHADOW_SUBSET)
    for value, fused in ((None, True), ("0", False)):
        rec = _with_switch(SHADE_SWITCH, value,
                           lambda: dispatch.trace_nearest(l_tables, *h_subset))
        if ("n" in rec) != fused:
            raise RuntimeError(f"path H's trace with {SHADE_SWITCH} "
                               f"{value}: record fields {sorted(rec)}")
    renderer = HybridRenderer(l_scene, hw, hh, RenderConfig(width=hw,
                                                            height=hh),
                              environment=path_h["env"],
                              prepared=(l_flat, l_tables), device=device)
    out["path H"] = _shade_turns(
        "path H", lambda value: _hybrid_turn(renderer, SHADE_TIMED_FRAMES),
        {"unset": fused_ms["path H"], "0": rows["path H"]["ms"]}, {})
    for label in out:
        launches[label] = out[label]["0"]["launches_per_frame"]["K1"]

    try:
        _with_switch(SHADE_SWITCH, "1", lambda: drive_path(
            f"path T ({SHADE_SWITCH}=1)", *scenes["stress_tex"], {"K3": 1},
            frames=1))
    except ValueError as err:
        if f"{SHADE_SWITCH}=1" not in str(err):
            raise
        print(f"path T with {SHADE_SWITCH}=1 raises, as it must: {err}")
    else:
        raise RuntimeError(f"path T rendered with {SHADE_SWITCH}=1; the "
                           "textured tables' cap of 1 must raise")
    if os.environ.get(SHADE_SWITCH) != before:
        raise RuntimeError(f"{SHADE_SWITCH} was not restored")
    return {"rows": rows, "paths": out, "launches": launches}


# Phase 20, every ray of the big paths against the walk: each kernel launch
# of phases 3a/3b's rays held against dispatch.trace_nearest_walk /
# trace_any_walk (instances.trace_nearest_instanced_walk for K6), the
# reference's CPU oracle run on the card.  The phase's budget in seconds:
# every comparison runs on all of its rays within it (PERF.md §6).
WALK_BUDGET_S = 90.0


def _walk_timed(fn, device) -> tuple:
    """(fn(stats), the walk's seconds, its stats, its peak memory in MiB
    above what was allocated before it)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    stats = {}
    t0 = time.perf_counter()
    out = fn(stats)
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return (out, seconds, stats,
            (torch.cuda.max_memory_allocated(device) - base) / 2**20)


def _every(x, step: int):
    """Every step-th ray of a record (a dict of (N, ...) tensors) or of an
    (N,) tensor: kernel_parity.strided_subset's choice."""
    if isinstance(x, dict):
        return {k: v[::step] for k, v in x.items()}
    return x[::step]


# A ray on which the kernel and the walk hit different surfaces (both hit,
# |dt| past kernel_parity's limit) is a grazing flip when, in float64, the
# nearer of the two triangles is hit within this barycentric margin of its
# edge: float32 rounding, FMA contraction in the kernel and the reference's
# in the walk, may put such a hit on either side of the edge.
GRAZING_MARGIN = 1e-5


def _margins64(p, o, d) -> tuple:
    """float64 Moller-Trumbore of rays o, d (n, 3) on triangles p (n, 3,
    3): (t, the smallest barycentric coordinate)."""
    v0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    pvec = np.cross(d, e2)
    inv = 1.0 / (e1 * pvec).sum(-1)
    tvec = o - v0
    u = (tvec * pvec).sum(-1) * inv
    qvec = np.cross(tvec, e1)
    v = (d * qvec).sum(-1) * inv
    t = (e2 * qvec).sum(-1) * inv
    return t, np.minimum(np.minimum(u, v), 1.0 - u - v)


def flat_geometry(tri_pos):
    """The `geometry` of _surface_flips over flat tables: the triangles'
    permuted (T, 3, 3) positions, the world rays."""
    pos = np.asarray(tri_pos, np.float64)

    def geometry(tri, inst, o, d):
        return pos[tri], o, d

    return geometry


def instanced_geometry(tables):
    """The `geometry` of _surface_flips over two-level tables: the pooled
    object-space triangles (the BLAS' permuted positions in BLAS order, as
    blas_tri_offset counts them), each ray in its instance's object space
    (t is the same there: the transform is affine)."""
    pool = np.concatenate([b.tri_pos.cpu().numpy() for b in
                           tables.cpu_blas]).astype(np.float64)
    inv = tables.inst_trace[:, :12].cpu().double().numpy().reshape(-1, 3, 4)

    def geometry(tri, inst, o, d):
        a = inv[inst]
        return (pool[tri], np.einsum("nij,nj->ni", a[:, :, :3], o)
                + a[:, :, 3], np.einsum("nij,nj->ni", a[:, :, :3], d))

    return geometry


def _surface_flips(label, entry, rec_k, rec_w, rays, judge,
                   geometry) -> dict:
    """Re-judge a nearest-hit comparison whose rays include some that both
    records hit at |dt| >= atol, on different triangles: each such ray is
    listed with both t, both triangles and, from float64 on the triangles
    and rays `geometry(tri, inst, o, d)` gives (flat_geometry,
    instanced_geometry), the barycentric margin of the nearer triangle's
    hit; the rest are judged by _compare with those rays taken out; and the
    comparison passes only if every such ray is a grazing flip
    (GRAZING_MARGIN) and they and the hit mismatches together stay within
    max(2, N/5000), the budget of rays that may disagree."""
    from steeljax_torch.apps import kernel_parity as kp

    k, w = kp._numpy(rec_k), kp._numpy(rec_w)
    idx = np.nonzero(k["hit"] & w["hit"] & (np.abs(k["t"] - w["t"])
                                            >= judge.get("atol", 2e-3)))[0]
    if not len(idx):
        return entry
    o, d = (x[torch.as_tensor(idx, device=x.device)].double().cpu().numpy()
            for x in rays[:2])
    inst_k, inst_w = (r.get("inst", r["tri"])[idx] for r in (k, w))
    t_k, m_k = _margins64(*geometry(k["tri"][idx], inst_k, o, d))
    t_w, m_w = _margins64(*geometry(w["tri"][idx], inst_w, o, d))
    nearer = np.where(t_k < t_w, m_k, m_w)
    for rec in (k, w):
        rec["hit"] = rec["hit"].copy()
        rec["hit"][idx] = False
    results = {}
    with contextlib.redirect_stdout(io.StringIO()):
        kp._compare(label, k, w, results=results, **judge)
    out = results[label]
    out["max_t_delta_all"] = entry.get("max_t_delta", 0.0)
    out["surface_flips"] = [
        {"ray": int(i), "t_kernel": float(k["t"][i]),
         "t_walk": float(w["t"][i]), "tri_kernel": int(k["tri"][i]),
         "tri_walk": int(w["tri"][i]), "nearer_margin": float(m)}
        for i, m in zip(idx, nearer)]
    out["ok"] = bool(out["ok"] and (np.abs(nearer) < GRAZING_MARGIN).all()
                     and out["hit_mismatches"] + len(idx)
                     <= max(2, k["hit"].shape[0] // 5000))
    return out


def _held_to_walk(label, kernel, walk, rays, device, plain=None,
                  plain_limit=None, judge=None, walked=None,
                  geometry=None) -> dict:
    """One comparison of phase 20: `kernel(rays)` (a record, or (N,) flags
    for an any-hit query) against `walk(rays, stats)` on every ray of
    `rays`, by kernel_parity's _compare (`judge`: its keywords) or
    _compare_hits, with its budgets.
    `plain`, the plain version's record of phase 3b on the strided subset
    of at most `plain_limit` rays, holds the walk itself there.  `walked`
    caches walks by label across comparisons on the same rays.  With
    `geometry` (flat_geometry, instanced_geometry), rays the two hit on
    other surfaces are judged by _surface_flips.  Prints one line and
    raises on a disagreement."""
    from steeljax_torch.apps import kernel_parity as kp

    n = rays[0].shape[0]
    hits = judge is None
    rec_k = kernel(rays)
    torch.cuda.synchronize(device)
    key = (walk, id(rays[0]))
    if walked is not None and key in walked:
        rec_w, seconds, stats, peak = walked[key]
        reused = True
    else:
        rec_w, seconds, stats, peak = _walk_timed(
            lambda stats: walk(rays, stats), device)
        reused = False
        if walked is not None:
            walked[key] = (rec_w, seconds, stats, peak)
    results = {}
    # kernel_parity's judges print a line each; this phase prints its own.
    with contextlib.redirect_stdout(io.StringIO()):
        if hits:
            kp._compare_hits(label, rec_k, rec_w, results)
        else:
            kp._compare(label, rec_k, rec_w, results=results, **judge)
    entry = results[label]
    if geometry is not None:
        entry = _surface_flips(label, entry, rec_k, rec_w, rays, judge,
                               geometry)
    entry.update(budget=max(2, n // 5000),
                 walk_s=seconds, walk_steps=stats.get("steps", 0),
                 walk_host_reads=stats.get("host_reads", 0),
                 walk_batches=stats.get("batches", 0),
                 walk_peak_mib=peak, walk_reused=reused)
    text = (f"{label}: {n} rays compared, {entry['hit_mismatches']} hit "
            f"mismatches (budget "
            f"max(2, N/5000) = {entry['budget']}), {entry['hits']} hits")
    flips = entry.get("surface_flips", [])
    if flips:
        text += (f", {len(flips)} rays on another surface (max |dt| "
                 f"{entry['max_t_delta_all']:.3e}; float64 barycentric margin "
                 "of the nearer triangle "
                 + ", ".join(f"{f['nearer_margin']:.2e}" for f in flips[:8])
                 + f"; grazing below {GRAZING_MARGIN:g}; counted with the hit "
                 "mismatches)")
    if not hits:
        text += (f", max |dt| {entry.get('max_t_delta', 0.0):.3e}"
                 + (" on the other common hits" if flips else "")
                 + f", tri ids equal on {entry.get('tri_matches_pct', 100.0):.4f}"
                 "% of the common hits"
                 + (f", source triangles on {entry['source_matches_pct']:.4f}%"
                    if "source_matches_pct" in entry else ""))
    text += ("; the walk " + ("(the one above, reused)" if reused else
             f"{seconds:.3f} s, {entry['walk_steps']} steps in "
             f"{entry['walk_batches']} batches, {entry['walk_host_reads']} "
             f"host reads, peak {peak:.0f} MiB"))
    if plain is not None:
        step = -(-n // plain_limit)
        sub = {}
        with contextlib.redirect_stdout(io.StringIO()):
            if hits:
                kp._compare_hits("walk", _every(rec_w, step), plain, sub)
            else:
                # The plain version's record is the kernel's kind; the
                # walk's has no fused outputs to compare.
                kp._compare("walk", plain, _every(rec_w, step),
                            judge["tri_pos"], sub)
        entry["walk_against_plain"] = sub["walk"]
        text += (f"; the walk against the plain version on its "
                 f"{sub['walk']['rays']} rays: "
                 f"{sub['walk']['hit_mismatches']} hit mismatches"
                 + ("" if hits else
                    f", max |dt| {sub['walk'].get('max_t_delta', 0.0):.3e}")
                 + f" ({'PASS' if sub['walk']['ok'] else 'FAIL'})")
    print(text)
    if not entry["ok"]:
        raise RuntimeError(f"{label}: the kernel disagrees with the walk: "
                           f"{entry}")
    if plain is not None and not entry["walk_against_plain"]["ok"]:
        raise RuntimeError(f"{label}: the walk disagrees with the plain "
                           f"version: {entry['walk_against_plain']}")
    return entry


def phase_walk(device, scenes, kernels, sbvh) -> dict:
    """Phase 20, every ray against the walk.  The reference holds its
    kernels against its BVH walk (steeljax/apps/kernel_parity.py:229-400),
    which costs about rays x log(triangles); phase 3b holds the kernels
    against their brute-force plain versions, which cost rays x records, on
    strided subsets of the big paths' rays.  Here the walk
    (dispatch.trace_nearest_walk, trace_any_walk,
    instances.trace_nearest_instanced_walk) runs on the card over the same
    tables, and each kernel launch is held against it on every ray of
    phases 3a/3b's ray sets, by kernel_parity's _compare or _compare_hits
    and their budgets (at most max(2, N/5000) hit mismatches; |dt| < 2e-3,
    fused normals within 5e-3 of the interpolated attributes, no material
    mismatch):
      * K1 in mode 1 on Cornell's 921,600 primaries, its fused outputs
        checked against the interpolated attributes, as flat_shade1;
      * K1 on path L's primaries and first-bounce rays;
      * K2 and K2-dense on path L's first-bounce shadow rays;
      * K3 (mode 2) on path T's primaries, with the attributes;
      * K4 with the coarse masks only (the tables' fine rows are left out:
        the reference's walk has no fine plane), nearest on path F's
        primaries and any-hit on its first-bounce sun rays;
      * K1 and K2 on path H's 2,073,600 G-buffer and sun rays;
      * path C's two-chunk sweep (dispatch.trace_nearest: K1 a chunk) on
        its primaries against the walk's sweep over the same chunks;
      * K6 on path I's primaries, instance ids recorded;
      * K7 through the scheduler on path U's primaries, against the walk
        of the one tree its treelets were cut from;
      * over phase 18's spatial-split tables (`sbvh`), by source triangle
        as well (kernel_parity.source_ids): K1 on path L's primaries over
        path LS's and K4 with coarse masks on path F's primaries over path
        FS's.
    A ray both hit on different surfaces (|dt| past the limit) counts with
    the hit mismatches, and only where float64 puts the nearer triangle's
    hit within GRAZING_MARGIN of its edge (_surface_flips); its line lists
    those margins.
    The walk itself is held against phase 3b's plain version on that row's
    strided subset (the plain record phase 3b or 18 kept), except for K4
    with coarse masks, whose plain version runs here on
    kernel_parity.FOLIAGE_SUBSET rays, and K7, whose plain trace runs the
    scheduler.  K5 keeps phase 3b's strided check: the reference has no
    K-nearest walk.  Returns {label: entry}."""
    from steeljax_torch.accel import cuda_traverse as ct
    from steeljax_torch.accel import dispatch
    from steeljax_torch.accel.instances import trace_nearest_instanced_walk
    from steeljax_torch.accel.treelets import trace_treelets
    from steeljax_torch.apps import kernel_parity as kp

    def flat_walk(prepared, any_hit=False):
        _, flat, tables = prepared
        pos, ds = flat.tri_pos, flat.tri_double_sided
        if any_hit:
            return lambda rays, stats: dispatch.trace_any_walk(
                tables, pos, ds, *rays, stats=stats)
        return lambda rays, stats: dispatch.trace_nearest_walk(
            tables, pos, ds, *rays, True, stats=stats)

    def nearest(chunk, mode, alpha=False):
        shade = chunk.shade_packed if mode else None
        return lambda rays: ct.trace_nearest_bvh8(
            chunk.bvh8, chunk.tris_packed, *rays, True, shade, mode,
            alpha_mask=alpha, records=chunk.tri_records)

    def anyhit(chunk, alpha=False):
        bvh8, tris, records, dense = dispatch.anyhit_tables(chunk)
        return lambda rays: ct.trace_any_bvh8(
            bvh8, tris, *rays, dense, alpha_mask=alpha, records=records)

    def judged(flat, rays, attrs=("nrm", "mat")):
        return {"tri_pos": flat.tri_pos.cpu().numpy(),
                "attrs": {k: getattr(flat, f"tri_{k}").cpu().numpy()
                          for k in attrs} if attrs else None,
                "d": rays[1].cpu().numpy()}

    def held(row):
        return row["held"]["rays"], row["held"]["plain"]

    out, walked = {}, {}

    def check(kernel_key, label, kernel, walk, rays, plain=None,
              plain_limit=None, judge=None, geometry=None):
        if geometry is None and judge is not None and \
                judge["tri_pos"] is not None:
            geometry = flat_geometry(judge["tri_pos"])
        out[label] = _held_to_walk(label, kernel, walk, rays, device, plain,
                                   plain_limit, judge, walked, geometry)
        out[label]["kernel"] = kernel_key

    start = time.perf_counter()
    cflat, ctables, _ = kp.cornell_cases(device, WIDTH, HEIGHT)
    rays, plain = held(kernels["K1"])
    check("K1", "K1 Cornell primaries", nearest(ctables.chunks[0], 1),
          flat_walk((None, cflat, ctables)), rays, plain, rays[0].shape[0],
          judged(cflat, rays))

    path_l = scenes["sunlit"]
    _, lflat, ltables = path_l
    lchunk = ltables.chunks[0]
    l_walk, l_walk_any = flat_walk(path_l), flat_walk(path_l, any_hit=True)
    for label, row in (("K1 path L primaries", kernels["K1"]["path_l"]),
                       ("K1 path L first-bounce rays",
                        kernels["K1"]["path_l_bounce1"])):
        rays, plain = held(row)
        check("K1", label, nearest(lchunk, ltables.shade_mode), l_walk, rays,
              plain, kp.SHADOW_SUBSET, judged(lflat, rays))
    # K2 and K2-dense trace the same rays: one walk holds both.
    for name, label, chunk in (
            ("K2", "K2 path L first-bounce shadow rays", lchunk),
            ("K2_dense", "K2-dense path L first-bounce shadow rays",
             scenes["sunlit_dense"][2].chunks[0])):
        rays, plain = held(kernels[name])
        check(name, label, anyhit(chunk), l_walk_any, rays, plain,
              kp.SHADOW_SUBSET)

    path_t = scenes["stress_tex"]
    _, tflat, ttables = path_t
    rays, plain = held(kernels["K3"])
    check("K3", "K3 path T primaries", nearest(ttables.chunks[0], 2),
          flat_walk(path_t), rays, plain, kp.TEX_SUBSET,
          judged(tflat, rays, ("nrm", "tan", "uv", "mat")))

    path_f = scenes["foliage"]
    _, fflat, ftables = path_f
    fchunk = ftables.chunks[0]
    for name, label in (
            ("K4", "K4 (coarse masks) path F primaries"),
            ("K4_anyhit",
             "K4 any-hit (coarse masks) path F first-bounce sun rays")):
        any_hit = name == "K4_anyhit"
        rays = kernels[name]["held"]["rays"]
        subset = kp.strided_subset(rays, kp.FOLIAGE_SUBSET)
        if any_hit:
            plain = ct.trace_any_bvh8_plain(fchunk.bvh8, fchunk.tris_packed,
                                            *subset, alpha_mask=True)
        else:
            plain = ct.trace_nearest_bvh8_plain(
                fchunk.bvh8, fchunk.tris_packed, *subset, True,
                alpha_mask=True)
        check(name, label, anyhit(fchunk, True) if any_hit
              else nearest(fchunk, 0, True), flat_walk(path_f, any_hit),
              rays, plain, kp.FOLIAGE_SUBSET,
              None if any_hit else judged(fflat, rays, None))

    for name, label, row in (
            ("K1", "K1 path H G-buffer rays", kernels["K1"]["path_h"]),
            ("K2", "K2 path H sun rays", kernels["K2"]["path_h"])):
        rays, plain = held(row)
        if name == "K2":
            check(name, label, anyhit(lchunk), l_walk_any, rays, plain,
                  kp.SHADOW_SUBSET)
        else:
            check(name, label, nearest(lchunk, ltables.shade_mode), l_walk,
                  rays, plain, kp.SHADOW_SUBSET, judged(lflat, rays))

    path_c = scenes["sunlit_chunked"]
    _, c_flat, c_tables = path_c
    rays, plain = held(kernels["K1"]["path_c"])
    check("K1", "K1 path C primaries (both chunks, the sweep)",
          lambda rays: dispatch.trace_nearest(c_tables, *rays, True),
          flat_walk(path_c), rays, plain, kp.TEX_SUBSET,
          judged(c_flat, rays))

    _, _, itables = scenes["sunlit_inst"]
    rays, plain = held(kernels["K6"])
    check("K6", "K6 path I primaries",
          lambda rays: ct.trace_nearest_bvh8_inst(itables, *rays, True),
          lambda rays, stats: trace_nearest_instanced_walk(
              itables, *rays, True, stats=stats),
          rays, plain, kp.SHADOW_SUBSET, {"tri_pos": None, "direct": True},
          instanced_geometry(itables))

    _, uflat, utables = scenes["stress_tex_treelets"]
    rays = kernels["K7"]["held"]["rays"]
    check("K7", "K7 path U primaries",
          lambda rays: trace_treelets(utables.treelets, *rays, True),
          flat_walk(scenes["stress_tex_treelets"]), rays,
          judge=judged(uflat, rays, ("nrm", "tan", "uv", "mat")))

    # Phase 18's spatial-split tables: a triangle may fill several slots.
    path_ls = sbvh["prepared"]["path LS"]
    _, ls_flat, ls_tables = path_ls
    rays, plain = held(sbvh["rows"]["K1"])
    judge = judged(ls_flat, rays)
    judge["source"] = kp.source_ids(judge["tri_pos"])
    check("K1", "K1 path LS primaries (path L's, by source triangle)",
          nearest(ls_tables.chunks[0], ls_tables.shade_mode),
          flat_walk(path_ls), rays, plain, kp.SHADOW_SUBSET, judge)
    path_fs = sbvh["prepared"]["path FS"]
    _, fs_flat, fs_tables = path_fs
    fs_chunk = fs_tables.chunks[0]
    rays = sbvh["rows"]["K4"]["held"]["rays"]
    plain = ct.trace_nearest_bvh8_plain(
        fs_chunk.bvh8, fs_chunk.tris_packed,
        *kp.strided_subset(rays, kp.FOLIAGE_SUBSET), True, alpha_mask=True)
    judge = judged(fs_flat, rays, None)
    judge["source"] = kp.source_ids(judge["tri_pos"])
    check("K4", "K4 (coarse masks) path FS primaries (by source triangle)",
          nearest(fs_chunk, 0, True), flat_walk(path_fs), rays, plain,
          kp.FOLIAGE_SUBSET, judge)
    seconds = time.perf_counter() - start
    walks = sum(e["walk_s"] for e in out.values() if not e["walk_reused"])
    print(f"phase 20: {len(out)} comparisons of "
          f"{sum(e['rays'] for e in out.values())} rays in all, the walks "
          f"{walks:.1f} s of the phase's {seconds:.1f} s (budget "
          f"{WALK_BUDGET_S:.0f} s)")
    return out


def _row_fields(row: dict) -> dict:
    """The fields of a kernel's sub-row in the kernels line."""
    return {f: row[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "shapes", "rays", "plain_rays",
                                "own_bound_ms", "bound_from", "one_chunk_ms",
                                "trace_ms", "tolerance",
                                "parity_max_abs_err")
            if f in row}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: chip_smoke.py runs only on the GPU")
    import steeljax_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    seconds = {}
    start = time.perf_counter()

    def phase(title, fn, *args):
        print(f"== {title}")
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[title] = time.perf_counter() - t0
        print(f"-- {title}: {seconds[title]:.1f} s")
        return out

    smi = phase("1. device and toolchain", phase_device)
    ptxas = phase("2. build", phase_build)
    scenes, renderers, prepare_s, prepare_steps = phase(
        "3a. prepare paths L, T, F, S, F multihit, U, UL, C, C one chunk, "
        "L16, I and J",
        phase_prepare, device)
    kernels = phase("3b. parity and kernel times", phase_parity, device,
                    scenes)
    cornell = phase("4. Cornell main path", phase_cornell, device)
    path_l = phase("5a. path L (sunlit stress)", drive_path, "path L",
                   *scenes["sunlit"], {"K1": 1, "K2": 1})
    path_l_dense = phase("5b. path L, dense any-hit tables", drive_path,
                         "path L dense", *scenes["sunlit_dense"],
                         {"K1": 1, "K2_dense": 1})
    kernels.update(phase("5c. path stage kernels against their plain "
                         "versions (path L)", phase_stages, scenes))
    kernels.update(phase("5d. the alpha test kernel against its plain "
                         "version (path F)", phase_alpha, scenes))
    path_t = phase("6. path T (textured stress)", drive_path, "path T",
                   *scenes["stress_tex"], {"K3": 1})
    # Each bounce traces its material rays and its sun rays, each in one
    # pass and max_alpha_retrace = 4 re-trace passes, and runs the exact
    # alpha test once a pass (K5: once for each of its K slots).
    alpha_passes = 2 * (1 + 4)
    k_hits = scenes["foliage_multihit"][2].multihit_k
    path_f = phase("7a. path F (foliage, serrated leaves)", drive_path,
                   "path F", *scenes["foliage"],
                   {"K4": alpha_passes, "alpha": alpha_passes})
    path_s = phase("7b. path S (foliage, solid leaves)", drive_path,
                   "path S", *scenes["foliage_solid"],
                   {"K4": alpha_passes, "alpha": alpha_passes})
    path_fm = phase("7c. path F, multihit_k = 4", drive_path,
                    "path F multihit", *scenes["foliage_multihit"],
                    {"K5": alpha_passes, "alpha": k_hits * alpha_passes})
    phase("8. cross-device tiles", phase_cross_device, device)

    def against(title, label, name, expected, ref_label, ref):
        def run():
            out = drive_path(label, *scenes[name], expected)
            _same_frame(label, out, ref_label, ref)
            return out
        return phase(title, run)

    path_i = against("9a. path I (sunlit stress, instanced)", "path I",
                     "sunlit_inst", {"K6": 1, "K6_anyhit": 1}, "path L",
                     path_l)
    phase("9a. path I, edit and refresh_scene()", phase_instanced_edit,
          device, scenes, renderers, prepare_s["sunlit"])
    path_j = against("9b. path J (textured stress, instanced)", "path J",
                     "stress_tex_inst", {"K6": 1}, "path T", path_t)
    path_u = against("10a. path U (textured stress, treelets)", "path U",
                     "stress_tex_treelets", {"K7": None, "K7_pick": None},
                     "path T", path_t)
    path_ul = against("10b. path UL (sunlit stress, treelets)", "path UL",
                      "sunlit_treelets", {"K7": None, "K7_anyhit": None,
                                          "K7_pick": None}, "path L", path_l)
    path_h = phase("11. path H (hybrid, sunlit stress, 1920x1080)",
                   phase_hybrid, device, scenes)
    path_c = phase("12. path C (sunlit stress, 2,633,508 triangles, two "
                   "chunks)", phase_chunked, scenes, path_l)
    path_l16 = phase("13. path L16 (path L at supernode width 16)",
                     phase_wide, scenes, path_l)
    phase("14. a GLTF file through render_cli", phase_gltf)
    engine = phase("15. the engine", phase_engine, device)
    path_g = phase("16. path G (light-volume GI on path L's scene)",
                   phase_gi, device, scenes, path_h)
    path_r = phase("17. path R (raster G-buffer on path H)", phase_raster,
                   device, scenes, path_h, ptxas)
    kernels["R"] = path_r["kernel"]
    sbvh = phase("18. paths LS, FS, IS and US (SBVH)", phase_sbvh, device,
                 scenes, kernels, prepare_steps,
                 {"path L": path_l, "path F": path_f,
                  "path F multihit": path_fm, "path I": path_i,
                  "path U": path_u})
    shade = phase("19. STEELJAX_SHADE_MODE unset and 0 (Cornell, paths L, "
                  "T and H)", phase_shade_mode, device, scenes, cornell,
                  path_h, kernels)
    walk = phase("20. every ray against the walk", phase_walk, device,
                 scenes, kernels, sbvh)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in seconds.items())
          + f"; the run {time.perf_counter() - start:.1f} s")
    # Phase 16's rows of K1 and K2 at the capture's shapes.
    for k, row in path_g["rows"].items():
        kernels[k]["path_g"] = row
    kernels["K1"]["max_abs_err"] = max(
        kernels["K1"]["max_abs_err"],
        path_g["rows"]["K1"]["parity_max_abs_err"])
    kernels["K2"]["mismatches"][f"path G {PROBE_SHADOW}"] = (
        path_g["rows"]["K2"]["parity"]["hit_mismatches"])
    kernels["K2"]["max_abs_err"] = float(
        max(kernels["K2"]["mismatches"].values()) > 0)
    # Phase 18's rows over spatial-split tables (K1, K2, K4 and K5 on paths
    # LS and FS, K6 and its any-hit query on path IS and the cards, K7 on
    # path US) and phase 19's K1 in shade mode 0: each adds its parity to
    # its kernel's error.
    subrows = [(k, "sbvh", row) for k, row in sbvh["rows"].items()]
    subrows += [(k, "sbvh_cards", row)
                for k, row in sbvh["cards_rows"].items()]
    for k, key, row in subrows:
        kernels[k][key] = row
    kernels["K1"]["shade_mode0"] = shade["rows"]
    subrows += [("K1", "shade_mode0", row) for row in shade["rows"].values()]
    for k, key, row in subrows:
        if "mismatches" in kernels[k]:
            kernels[k]["mismatches"][f"{key} {row['shapes']}"] = (
                row["parity"]["hit_mismatches"])
            kernels[k]["max_abs_err"] = float(
                max(kernels[k]["mismatches"].values()) > 0)
        else:
            kernels[k]["max_abs_err"] = max(kernels[k]["max_abs_err"],
                                            row["parity_max_abs_err"])
    # Phase 20's comparisons with the walk, under the kernel each holds.
    for label, entry in walk.items():
        kernels[entry["kernel"]].setdefault("walk", {})[label] = {
            f: entry.get(f) for f in ("rays", "hit_mismatches", "budget",
                                      "max_t_delta", "walk_s")}
    # The frames whose launches each sbvh sub-row reports, and its tables.
    sbvh_frames = {"K1": ("path LS", "path LS"), "K2": ("path LS", "path LS"),
                   "K4": ("path FS", "path FS"),
                   "K5": ("path FS multihit", "path FS"),
                   "K6": ("path IS", "path IS"),
                   "K6_anyhit": ("path IS", "path IS"),
                   "K7": ("path US", "path US")}

    launches = {"K1": cornell["launches"]["K1"],
                "K2": path_l["launches"]["K2"],
                "K2_dense": path_l_dense["launches"]["K2_dense"],
                "K3": path_t["launches"]["K3"],
                "K4": path_f["launches"]["K4"],
                "K4_anyhit": max(p["launches"]["K4_anyhit"] for p in (
                    path_f, path_s, path_fm)),
                "K5": path_fm["launches"]["K5"],
                "K6": path_i["launches"]["K6"],
                "K6_shade2": path_j["launches"]["K6"],
                "K6_anyhit": path_i["launches"]["K6_anyhit"],
                "K7": path_u["launches"]["K7"],
                "K7_shade1": path_ul["launches"]["K7"],
                "K7_anyhit": path_ul["launches"]["K7_anyhit"],
                "K7_pick": path_u["launches"]["K7_pick"],
                "R": path_r["launches"]["R"],
                "nee": path_l["launches"]["nee"],
                "sample": path_l["launches"]["sample"],
                "alpha": path_f["launches"]["alpha"]}
    sub_paths = {"path_h": (path_h, 1 + HYBRID_TIMED_FRAMES),
                 "path_c": (path_c, path_c["host_frames"]),
                 "path_l16": (path_l16, path_l16["host_frames"])}

    def sub_row(k, key):
        """A sub-row of a kernel at another path's shapes (phase 3b; path
        G's phase 16; over spatial-split tables, phase 18), with the
        kernel's launches a frame on that path (phases 11-13; path G: a GI
        frame's, and the capture's; the sbvh row: path LS's, FS's or FS
        multihit's, IS's or US's, with the tables' counts and the frame's
        ms; the cards' rows, which no frame drives; K1 in shade mode 0 on
        Cornell, paths L, T and H, phase 19, with its launches a frame
        under STEELJAX_SHADE_MODE=0)."""
        row = kernels[k][key]
        if key == "shade_mode0":
            return {label: {**{"launches_per_frame":
                                   shade["launches"][label]},
                            **_row_fields(entry)}
                    for label, entry in row.items()}
        if key == "sbvh_cards":
            launches = {"launches_per_frame": None,
                        "tables": sbvh["tables"]["cards"]}
        elif key == "sbvh":
            label, tables_of = sbvh_frames[k]
            out = sbvh["frames"][label]
            launches = {"launches_per_frame":
                        out["launches"][k] / out["host_frames"],
                        "frames_of": label, "ms_frame": out["ms_frame"],
                        "busy_ms": out["busy_ms"],
                        "pixels_beyond_sah": out["pixels_beyond"],
                        "tables": sbvh["tables"][tables_of]}
        elif key == "path_g":
            launches = {
                "launches_per_frame": path_g["frame_launches"][k]
                / path_g["frames"],
                "capture_launches": path_g["capture_launches"][k]}
        else:
            out, n = sub_paths[key]
            launches = {"launches_per_frame": out["launches"][k] / n}
        return {**launches, **_row_fields(row)}

    sources = {k: "steeljax_torch/csrc/alpha8.cu" for k in launches}
    for k in ("K7", "K7_shade1", "K7_anyhit", "K7_pick"):
        sources[k] = "steeljax_torch/csrc/treelet8.cu"
    for k in ("K6", "K6_shade2", "K6_anyhit"):
        sources[k] = "steeljax_torch/csrc/instanced8.cu"
    sources["R"] = "steeljax_torch/csrc/raster.cu"
    sources["nee"] = sources["sample"] = "steeljax_torch/csrc/pathstage.cu"
    sources["alpha"] = "steeljax_torch/csrc/alphatest.cu"
    titles = {
        "K1": "K1 trace_alpha8 NEAREST without masks (BVH8 nearest hit, "
              "cull, shade mode 1)",
        "K2": "K2 trace_alpha8 ANY without masks (BVH8 any-hit occlusion, "
              "the 12-record rows' 48-byte records)",
        "K2_dense": "K2-dense trace_alpha8 ANY without masks (any-hit "
                    "occlusion, the dense 14-record rows' 48-byte records)",
        "K3": "K3 trace_alpha8 NEAREST without masks (nearest hit, "
              "textured shade mode 2)",
        "K4": "K4 trace_alpha8 NEAREST (nearest hit with alpha masks, coarse "
              "and fine)",
        "K4_anyhit": "K4 trace_alpha8 ANY (any-hit occlusion with alpha "
                     "masks)",
        "K5": "K5 trace_alpha8 K_NEAREST (K nearest hits with alpha masks "
              "and the opaque bound)",
        "K6": "K6 trace_inst8 (two-level TLAS/BLAS nearest hit, shade mode "
              "1; launches on path I)",
        "K6_shade2": "K6 trace_inst8 (two-level nearest hit, textured shade "
                     "mode 2; launches on path J)",
        "K6_anyhit": "K6 trace_inst8 (two-level any-hit occlusion)",
        "K7": "K7 treelet_round8 (treelet rounds in place, nearest hit, "
              "shade mode 2; launches on path U; ms the device time of the "
              "K rounds of one trace, whose first pick is K7_pick's entry; "
              "trace_ms the whole trace; bound of the trace)",
        "K7_shade1": "K7 treelet_round8 (treelet rounds in place, nearest "
                     "hit, shade mode 1; launches on path UL)",
        "K7_anyhit": "K7 treelet_round8 (treelet rounds in place, any-hit "
                     "occlusion; launches on path UL)",
        "K7_pick": "K7 treelet_pick8 (the treelet scheduler's first packet "
                   "pick of a trace; launches on path U)",
        "R": "R raster_tiles (the raster G-buffer's tile stage, one block a "
             "32x24 subtile, candidates culled by bbox before staging, "
             "slice tags, a 32x3 strip a warp; launches on path R; ms and "
             "plain_ms on the whole frame; bound_ms at strip granularity "
             "from the bytes the work reads; subtile_bound_ms the bound at "
             "subtile granularity, whole records and every pixel of a "
             "covering candidate)",
        "nee": "nee (a bounce's next-event estimation up to the shadow ray, "
               "one thread a ray; launches on path L; ms, plain_ms and "
               "bound_ms summed over one frame's 4 bounces, phase 5c)",
        "sample": "sample (a bounce's BRDF sampling, path update and "
                  "Russian roulette, one thread a ray; launches on path L; "
                  "ms, plain_ms and bound_ms summed over one frame's 4 "
                  "bounces, phase 5c)",
        "alpha": "alpha (the exact alpha test at a hit, one thread a ray; "
                 "launches: the tests of one eager path F frame; ms, "
                 "plain_ms and bound_ms summed over them, phase 5d)"}
    replaces = {
        "K1": "steeljax/accel/pallas_traverse.py:249",
        "K2": "steeljax/accel/pallas_traverse.py:506",
        "K2_dense": "steeljax/accel/pallas_traverse.py:781",
        "K3": "steeljax/accel/pallas_traverse.py:548",
        "K4": "steeljax/accel/pallas_traverse.py:457",
        "K4_anyhit": "steeljax/accel/pallas_traverse.py:506",
        "K5": "steeljax/accel/pallas_traverse.py:812",
        "K6": "steeljax/accel/pallas_traverse.py:1283",
        "K6_shade2": "steeljax/accel/pallas_traverse.py:1568",
        "K6_anyhit": "steeljax/accel/pallas_traverse.py:1524",
        "K7": "steeljax/accel/pallas_traverse.py:1252",
        "K7_shade1": "steeljax/accel/pallas_traverse.py:1252",
        "K7_anyhit": "steeljax/accel/pallas_traverse.py:1252",
        "K7_pick": "steeljax/accel/treelets.py:184",
        "R": "steeljax/render/hybrid/raster.py:306",
        "nee": "no Pallas kernel: plain jnp in "
               "steeljax/render/pt/integrator.py",
        "sample": "no Pallas kernel: plain jnp in "
                  "steeljax/render/pt/integrator.py",
        "alpha": "no Pallas kernel: plain jnp in "
                 "steeljax/render/pt/integrator.py:132-148"}
    print(json.dumps({"kernels": [{
        "name": titles[k], "route": "cuda", "source": sources[k],
        "replaces": replaces[k], "launches": launches[k],
        "max_abs_err": kernels[k]["max_abs_err"],
        "ms": kernels[k]["ms"], "plain_ms": kernels[k]["plain_ms"],
        "bound_ms": kernels[k]["bound_ms"],
        "bound_by": kernels[k]["bound_by"], "library_ms": None,
        "trace_bound_ms": kernels[k].get("trace_bound_ms"),
        "trace_ms": kernels[k].get("trace_ms"),
        "tolerance": kernels[k]["tolerance"],
        "shapes": kernels[k]["shapes"], "rays": kernels[k]["rays"],
        "plain_rays": kernels[k]["plain_rays"],
        **{key: kernels[k][key] for key in (
            "bit_equal", "subtile_bound_ms", "subtile_bound_by", "winners",
            "work", "ties", "cornell", "registers", "walk")
            if key in kernels[k]},
        **{key: sub_row(k, key) for key in (*sub_paths, "path_g", "sbvh",
                                            "sbvh_cards", "shade_mode0")
           if key in kernels[k]},
        "engine_launches": {name: counts[k] for name, counts in
                            engine.items() if counts.get(k)}}
        for k in launches]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
