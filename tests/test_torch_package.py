"""The PyTorch port stands alone: it imports with jax and steeljax blocked,
no file of it imports either or builds a path into the steeljax package
(its BVH builder source is its own copy of the reference's), TF32 is off,
and its stdlib PNG writer gives the reference writer's pixels."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import steeljax_torch

PKG_DIR = Path(steeljax_torch.__file__).parent
REPO = PKG_DIR.parent
FORBIDDEN = ("jax", "flax", "steeljax")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG_DIR)], prefix="steeljax_torch."))


def test_slice_modules_are_present():
    names = set(_submodules())
    for mod in ("core.rng", "scene.flatten", "accel.bvh",
                "accel.cuda_traverse", "accel.dispatch", "accel.instances",
                "accel.treelets", "accel.alphamask", "native",
                "render.pt.integrator", "render.pt.renderer", "convert",
                "apps.kernel_parity", "apps.render_cli", "io.image",
                "core.colors", "env.cubemap", "env.panorama", "env.ibl",
                "env.environment", "render.texture", "render.hybrid.gbuffer",
                "render.hybrid.lighting", "render.hybrid.forward",
                "render.hybrid.renderer", "core.logger", "core.validate",
                "scene.gltf", "scene.loader", "core.aabb",
                "scene.transform", "scene.textures", "core.profiling",
                "io.checkpoint", "render.scene_renderer", "engine",
                "engine.input", "engine.events", "engine.overlay",
                "engine.systems", "engine.engine", "apps.compare",
                "apps.testsystem_demo", "apps.viewer", "gi", "gi.probes",
                "gi.sh", "gi.tets", "gi.light_volume", "gi.sample",
                "gi.debug", "parallel", "parallel.mesh", "entry",
                "render.hybrid.raster", "apps.fit_env_surrogate",
                "accel.traverse", "accel.intersect"):
        assert f"steeljax_torch.{mod}" in names, mod


def test_imports_with_jax_and_steeljax_blocked():
    """A fresh interpreter with jax, flax and steeljax made unimportable
    (the test process has already imported jax through the conftest)."""
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'steeljax'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {_submodules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'steeljax') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_file_imports_jax_flax_or_steeljax():
    offenders = []
    for path in sorted(PKG_DIR.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


def _path_into_steeljax(node) -> bool:
    """A string constant naming the steeljax package directory as a path
    component: "steeljax" alone, or a path whose first component it is."""
    if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
        return False
    parts = node.value.replace("\\", "/").split("/")
    return parts[0] == "steeljax" and (len(parts) > 1
                                        or node.value == "steeljax")


def _path_calls(tree):
    """The string constants that a path is built from: operands of `/`,
    arguments of Path(), PurePath(), open() and os.path.join()."""
    for node in ast.walk(tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            yield from (node.left, node.right)
        elif isinstance(node, ast.Call):
            func = node.func
            name = (func.id if isinstance(func, ast.Name) else
                    func.attr if isinstance(func, ast.Attribute) else "")
            if name in ("Path", "PurePath", "open", "join"):
                yield from node.args


def test_no_file_builds_a_path_into_steeljax():
    """No .py file of the port, nor chip_smoke.py, reads a file of the
    reference package: no path built from a "steeljax" component (strings
    that only name a reference file:line, as the kernels' "replaces", are
    not paths)."""
    offenders = []
    for path in [*sorted(PKG_DIR.rglob("*.py")), REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and node.value == "steeljax"):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno}")
        for node in _path_calls(tree):
            if _path_into_steeljax(node):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not offenders, offenders


def test_bvh_source_is_the_ports_copy():
    """The BVH builder compiles from the port's own source, a byte-for-byte
    copy of the reference's, so both packages build the same trees."""
    import steeljax
    from steeljax_torch import native

    source = native.BVH_SOURCE.resolve()
    assert source.is_relative_to(PKG_DIR.resolve())
    reference = Path(steeljax.__file__).parent / "native" / "bvh_builder.cpp"
    assert source.read_bytes() == reference.read_bytes()
    for cuda_source in native.CUDA_SOURCES + native.CUDA_HEADERS:
        assert cuda_source.resolve().is_relative_to(PKG_DIR.resolve())
        assert cuda_source.exists()


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_write_png_matches_reference_writer(tmp_path):
    """The stdlib PNG decodes (with Pillow) to the reference writer's
    pixels, bit for bit, for float and uint8 input, RGB and RGBA."""
    from PIL import Image

    from steeljax.io.image import write_png as write_png_ref
    from steeljax_torch.io.image import write_png

    r = np.random.default_rng(0)
    images = [r.uniform(-0.2, 1.2, (9, 13, 3)).astype(np.float32),
              r.integers(0, 256, (5, 7, 4)).astype(np.uint8)]
    for i, image in enumerate(images):
        ours, ref = tmp_path / f"ours{i}.png", tmp_path / f"ref{i}.png"
        write_png(ours, image)
        write_png_ref(ref, image)
        np.testing.assert_array_equal(np.asarray(Image.open(ours)),
                                      np.asarray(Image.open(ref)))


# The reference's switches the port leaves out on purpose: the TPU kernels'
# packet size (sublanes), which sizes a TPU packet and has no CUDA meaning.
NOT_PORTED_SWITCHES = ("STEELJAX_SUBLANES",)


def _switches(root: Path) -> set:
    import re

    return {name for path in root.rglob("*.py")
            for name in re.findall(r"STEELJAX_[A-Z0-9_]+", path.read_text())}


def test_every_reference_switch_is_in_the_port():
    """Every STEELJAX_* name in the reference's .py files also appears in
    the port's (read, or named where the port takes an argument instead),
    except the not-ported TPU sizing switch, which the reference does
    have."""
    import steeljax

    reference = _switches(Path(steeljax.__file__).parent)
    assert set(NOT_PORTED_SWITCHES) <= reference
    missing = sorted(reference - _switches(PKG_DIR)
                     - set(NOT_PORTED_SWITCHES))
    assert not missing, missing


def _public_callables():
    """(qualified name, function) of every public function of the port's
    modules and every public method and __init__ of their classes."""
    import importlib
    import inspect

    for name in _submodules():
        mod = importlib.import_module(name)
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__",
                                                None) != name:
                continue
            if inspect.isfunction(obj):
                yield f"{name}.{attr}", obj
            elif inspect.isclass(obj):
                for meth, fn in vars(obj).items():
                    if inspect.isfunction(fn) and (
                            meth == "__init__" or not meth.startswith("_")):
                        yield f"{name}.{attr}.{meth}", fn


def test_no_public_function_defaults_device_to_cpu():
    """The port's entry points and helpers run on the card unless the
    caller asks for the CPU: no public function's parameter named like
    `device` defaults to the CPU."""
    import inspect

    checked, cpu = 0, []
    for qualname, fn in _public_callables():
        for param in inspect.signature(fn).parameters.values():
            if "device" not in param.name:
                continue
            checked += 1
            default = param.default
            if (isinstance(default, str) and default.split(":")[0] == "cpu"
                    or isinstance(default, torch.device)
                    and default.type == "cpu"):
                cpu.append(f"{qualname}({param.name}={default!r})")
    assert checked > 20, checked
    assert not cpu, cpu
