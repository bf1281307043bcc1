"""Native builds: the binned-SAH BVH builder (g++) and the CUDA kernels.

The BVH builder is this package's `native/bvh_builder.cpp`, a byte-for-byte
copy of the reference's source compiled with the reference's g++ line into
this package's build directory, so both packages build the same tree, with
or without spatial splits.  Unlike the reference (whose "auto" method falls
back to a numpy Morton builder, a different tree, when its library cannot
be built or a build fails), a failed compile, load or build raises.

`cuda_library()` builds `csrc/*.cu` with nvcc for sm_90a into a shared
library with a plain C interface, loaded with ctypes: one nvcc process per
source, all started together, then one link.  Both libraries are built at
first use and rebuilt when a source is newer than the library;
`cuda_ptxas()` always has a build's register report, building anew when
the process has loaded a library built earlier.  `reload_cuda_library()`
rebuilds and rebinds the CUDA library of a running process whose sources
changed since it was loaded (the engine's `R` key).
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"
BVH_SOURCE = _PKG / "native" / "bvh_builder.cpp"
CUDA_SOURCES = (_PKG / "csrc" / "alpha8.cu",
                _PKG / "csrc" / "instanced8.cu",
                _PKG / "csrc" / "treelet8.cu",
                _PKG / "csrc" / "raster.cu",
                _PKG / "csrc" / "pathstage.cu",
                _PKG / "csrc" / "alphatest.cu")
# Headers the sources include: a change rebuilds the library too.
CUDA_HEADERS = (_PKG / "csrc" / "trace8_common.cuh",)
NVCC_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

CUDA_LIBRARY = "libsteeljax_torch_cuda.so"

_libs: dict[str, ctypes.CDLL] = {}
# Modification time of the build each loaded library was opened from.
_loaded_mtime: dict[str, float] = {}
# Compiler output of the last build in this process, by library name
# (nvcc's -Xptxas -v register/spill report for the CUDA library).
BUILD_LOGS: dict[str, str] = {}


def _stale(target: Path, sources) -> bool:
    if not target.exists():
        return True
    built = target.stat().st_mtime
    return any(Path(s).stat().st_mtime > built for s in sources)


def _build(target: Path, command_head: list[str], sources) -> None:
    """Run `command_head + sources + [-o tmp]` and move the result into
    place atomically, so concurrent processes never load a partial file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            command_head + [str(s) for s in sources] + ["-o", tmp],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"build of {target.name} failed ({' '.join(command_head)}):"
                f"\n{proc.stdout}\n{proc.stderr}")
        BUILD_LOGS[target.name] = proc.stdout + proc.stderr
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_cuda(target: Path, sources=CUDA_SOURCES) -> None:
    """Compile each of `sources` to an object with its own nvcc, all at
    once, then link them into `target` (atomically, as _build); the ptxas
    report goes to BUILD_LOGS[target.name]."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [Path(s) for s in sources]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)]
        logs = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate(timeout=600)
            logs.append(out)
            if proc.returncode != 0:
                for other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        _build(target, [nvcc, *NVCC_ARCH, "-shared"], objects)
        BUILD_LOGS[target.name] = "".join(logs)


def _load(name: str, sources, build, declare) -> ctypes.CDLL:
    """The library `name`, built from `sources` by `build(target)` when
    stale, loaded once per process; `declare` sets its ctypes signatures."""
    if name not in _libs:
        target = BUILD_DIR / name
        if _stale(target, sources):
            build(target)
        lib = ctypes.CDLL(str(target))
        declare(lib)
        _libs[name] = lib
        _loaded_mtime[name] = target.stat().st_mtime
    return _libs[name]


def _declare_bvh(lib: ctypes.CDLL) -> None:
    lib.steeljax_build_sbvh.restype = ctypes.c_int
    lib.steeljax_build_sbvh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]


def _declare_cuda(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    lib.steeljax_trace_alpha8.restype = ctypes.c_int
    lib.steeljax_trace_alpha8.argtypes = (
        [ptr] * 22 + [ctypes.c_int] * 10 + [ptr])
    lib.steeljax_trace_inst8.restype = ctypes.c_int
    lib.steeljax_trace_inst8.argtypes = (
        [ptr] * 23 + [ctypes.c_int] * 8 + [ptr])
    lib.steeljax_treelet_round8.restype = ctypes.c_int
    lib.steeljax_treelet_round8.argtypes = (
        [ptr] * 26 + [ctypes.c_int] * 12 + [ptr])
    lib.steeljax_treelet_pick8.restype = ctypes.c_int
    lib.steeljax_treelet_pick8.argtypes = (
        [ptr] * 4 + [ctypes.c_int] * 4 + [ptr])
    lib.steeljax_raster_tiles.restype = ctypes.c_int
    lib.steeljax_raster_tiles.argtypes = (
        [ptr] * 14 + [ctypes.c_int] * 4 + [ptr])
    # The path stages take arrays of pointers and of int64 values.
    lib.steeljax_nee_stage.restype = ctypes.c_int
    lib.steeljax_nee_stage.argtypes = [ptr, ptr, ptr]
    lib.steeljax_sample_stage.restype = ctypes.c_int
    lib.steeljax_sample_stage.argtypes = [ptr, ptr, ctypes.c_float, ptr]
    lib.steeljax_alpha_test.restype = ctypes.c_int
    lib.steeljax_alpha_test.argtypes = [ptr, ptr, ptr]


def bvh_library() -> ctypes.CDLL:
    if not BVH_SOURCE.exists():
        raise FileNotFoundError(
            f"BVH builder source not found at {BVH_SOURCE}")
    return _load("libsteeljax_torch_bvh.so", [BVH_SOURCE],
                 lambda target: _build(
                     target, ["g++", "-O3", "-march=native", "-shared",
                              "-fPIC", "-std=c++17"], [BVH_SOURCE]),
                 _declare_bvh)


def find_nvcc() -> str:
    """nvcc from PATH, then $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or at "
        "/usr/local/cuda/bin/nvcc: the CUDA kernels cannot be built")


def ptxas_table(log: str) -> dict:
    """{kernel instance: (registers, stack frame bytes, spill stores, spill
    loads, static shared memory bytes)} from nvcc's -Xptxas -v report, the
    names demangled by c++filt where the machine has it, without namespaces
    and parameter lists."""
    table, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            table[entry] = [0, 0, 0, 0, 0]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            table[entry][1:4] = [int(g) for g in m.groups()]
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and entry:
            table[entry][0] = int(m.group(1))
            table[entry][4] = int(m.group(2) or 0)
    names = list(table)
    if names and shutil.which("c++filt"):
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True).stdout
        plain = plain.splitlines()
        if len(plain) == len(names):
            table = {re.sub(r"^void ", "", re.sub(
                r"\(anonymous namespace\)::", "", p).split("(")[0]): table[n]
                for n, p in zip(names, plain)}
    return {k: tuple(v) for k, v in table.items()}


def cuda_library() -> ctypes.CDLL:
    return _load(CUDA_LIBRARY, CUDA_SOURCES + CUDA_HEADERS, build_cuda,
                 _declare_cuda)


def reload_cuda_library() -> bool:
    """Rebuild the CUDA library when a source is newer than the build this
    process loaded, and rebind: later launches call the new build.  A
    second dlopen of one path returns the handle already open, so the new
    build is opened under a name of its own (unlinked once open).  Returns
    whether it rebound; with no library loaded yet, or nothing newer, it
    changes nothing (the first launch builds from the sources as they
    are)."""
    if CUDA_LIBRARY not in _libs:
        return False
    sources = CUDA_SOURCES + CUDA_HEADERS
    if not any(Path(s).stat().st_mtime > _loaded_mtime[CUDA_LIBRARY]
               for s in sources):
        return False
    target = BUILD_DIR / CUDA_LIBRARY
    if _stale(target, sources):
        build_cuda(target)
    fd, fresh = tempfile.mkstemp(prefix=target.stem + ".", suffix=".so",
                                 dir=BUILD_DIR)
    os.close(fd)
    try:
        shutil.copyfile(target, fresh)
        lib = ctypes.CDLL(fresh)
    finally:
        os.unlink(fresh)
    _declare_cuda(lib)
    _libs[CUDA_LIBRARY] = lib
    _loaded_mtime[CUDA_LIBRARY] = target.stat().st_mtime
    return True


def cuda_ptxas() -> dict:
    """ptxas_table of the CUDA library's build from this tree's sources:
    the report of this process's build, or, when it has built none (a
    current library from an earlier run is only loaded), of a build run
    now, after which cuda_library() loads that build without another."""
    if CUDA_LIBRARY not in BUILD_LOGS:
        build_cuda(BUILD_DIR / CUDA_LIBRARY)
    return ptxas_table(BUILD_LOGS[CUDA_LIBRARY])


def build_bvh_sah(tri_pos: np.ndarray, max_leaf: int,
                  spatial_alpha: float = 0.0, dup_ratio: float = 1.5
                  ) -> tuple[np.ndarray, np.ndarray, int]:
    """Binned-SAH build, with spatial splits when `spatial_alpha` > 0 (the
    reference's steeljax/native/__init__.py:73-113).  Returns (nodes (N, 8)
    f32, refs (R,) int64, depth).

    Without splits `refs` is a permutation of the T triangles.  With them it
    is a reference list: a triangle id may sit under several leaves, with
    R <= int(T * dup_ratio) + 16, the capacity the builder is given (its
    nodes' capacity is twice that, plus 2).  A nonzero status of the builder
    raises."""
    lib = bvh_library()
    tris = np.ascontiguousarray(
        np.asarray(tri_pos, np.float32).reshape(-1, 9))
    count = len(tris)
    if count == 0:
        raise ValueError("build_bvh_sah needs at least one triangle")
    ref_capacity = (count if spatial_alpha <= 0
                    else int(count * dup_ratio) + 16)
    capacity = 2 * ref_capacity + 2
    nodes = np.zeros((capacity, 8), np.float32)
    refs = np.zeros(ref_capacity, np.int64)
    node_count = ctypes.c_int64(0)
    ref_count = ctypes.c_int64(0)
    depth = ctypes.c_int(0)
    status = lib.steeljax_build_sbvh(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(count), ctypes.c_int(max_leaf),
        ctypes.c_float(spatial_alpha),
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(capacity),
        refs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(ref_capacity),
        ctypes.byref(node_count), ctypes.byref(ref_count),
        ctypes.byref(depth))
    if status != 0:
        raise RuntimeError(f"steeljax_build_sbvh failed with status {status} "
                           f"(spatial_alpha {spatial_alpha}, {count} "
                           "triangles)")
    return (nodes[:node_count.value].copy(),
            refs[:ref_count.value].copy(), int(depth.value))
