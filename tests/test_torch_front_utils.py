"""The port's host utilities of the front ends against the reference's:
AABBox, Transform and the quaternions, the default textures and
TextureCache, the input enums and event normalisation, the overlay font,
compare.rmse and core.profiling.  Inputs come from numpy seeds; the
results must be equal (1e-6 for the float math)."""

import json

import numpy as np
import pytest
import torch

from steeljax.apps.compare import rmse as rmse_ref
from steeljax.core.aabb import AABBox as AABBoxRef
from steeljax.core.profiling import FrameTimer as FrameTimerRef
from steeljax.engine import input as input_ref
from steeljax.engine.events import KeyInput as KeyInputRef
from steeljax.engine.events import MouseInput as MouseInputRef
from steeljax.engine.overlay import burn_overlay as burn_overlay_ref
from steeljax.engine.overlay import render_text_mask as text_mask_ref
from steeljax.scene import textures as textures_ref
from steeljax.scene import transform as transform_ref
from steeljax_torch.apps import compare
from steeljax_torch.core import profiling
from steeljax_torch.core.aabb import AABBox
from steeljax_torch.engine import input as input_mod
from steeljax_torch.engine.events import KeyInput, MouseInput
from steeljax_torch.engine.overlay import burn_overlay, render_text_mask
from steeljax_torch.io.image import write_png
from steeljax_torch.scene import textures, transform

SEEDS = [0, 1, 2, 3]


def _boxes(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(2, 7, 3)).astype(np.float32) * 3.0
    probes = rng.normal(size=(5, 3)).astype(np.float32) * 3.0
    matrix = np.eye(4, dtype=np.float32)
    q = rng.normal(size=4)
    matrix[:3, :3] = transform_ref.quat_to_matrix(q / np.linalg.norm(q)) \
        * rng.uniform(0.5, 2.0, 3).astype(np.float32)
    matrix[:3, 3] = rng.normal(size=3)
    return pts, probes, matrix, float(rng.uniform(0.1, 1.0))


def _box_results(cls, pts, probes, matrix, amount):
    a, b = cls.from_points(pts[0]), cls.from_points(pts[1])
    out = {"empty_valid": cls().valid, "valid": a.valid,
           "center": a.center, "extent": a.extent, "corners": a.corners()}
    for name, box in (("add", a.add(b)), ("extend", a.extend(amount)),
                      ("transform", a.transform(matrix)),
                      ("add_point", a.add_point(probes[0])),
                      ("empty_add_point", cls().add_point(probes[1]))):
        out[name] = np.stack([box.lo, box.hi])
    out["intersects"] = (a.intersects(b), a.intersects(a.extend(-10.0)))
    out["contains"] = tuple(a.contains(p) for p in probes) + (
        a.contains(a.center),)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_aabb_matches_reference(seed):
    args = _boxes(seed)
    ours, ref = (_box_results(c, *args) for c in (AABBox, AABBoxRef))
    assert ours.keys() == ref.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
        if isinstance(ours[key], np.ndarray):
            assert ours[key].dtype == np.asarray(ref[key]).dtype, key


def _transform_results(m, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    t = m.Transform.compose(rng.normal(size=3), q,
                            rng.uniform(0.5, 2.0, 3))
    other = m.Transform.compose(rng.normal(size=3), (0, 0, 0, 1),
                                (2, 2, 2))
    point = rng.normal(size=3)
    # Each of Shepperd's four branches: the trace positive, then each
    # diagonal entry the largest.
    branches = [m.matrix_to_quat(m.quat_to_matrix(v)) for v in
                ([0.1, 0.2, 0.3, 0.9], [0.9, 0.2, 0.1, 0.05],
                 [0.1, 0.9, 0.2, 0.05], [0.1, 0.2, 0.9, 0.05])]
    return {"quat_to_matrix": m.quat_to_matrix(q),
            "matrix_to_quat": m.matrix_to_quat(m.quat_to_matrix(q)),
            "branches": np.stack(branches), "matrix": t.matrix,
            "translation": t.translation, "scale": t.scale,
            "rotation": t.rotation,
            "axes": np.stack([t.axis(i) for i in range(3)]),
            "inverse": t.inverse().matrix, "matmul": (t @ other).matrix,
            "apply": t.apply(point), "identity": m.Transform().matrix}


@pytest.mark.parametrize("seed", SEEDS)
def test_transform_matches_reference(seed):
    ours = _transform_results(transform, seed)
    ref = _transform_results(transform_ref, seed)
    for key in ours:
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=1e-6,
                                   err_msg=key)
        assert ours[key].dtype == ref[key].dtype, key


@pytest.mark.parametrize("name,args", [
    ("black_texture", ()), ("black_texture", (2,)), ("white_texture", ()),
    ("flat_normal_texture", (3,)), ("checkered_texture", ()),
    ("checkered_texture", (8, 2)), ("checkered_texture", (12, 5))])
def test_default_textures_match_reference(name, args):
    ours = getattr(textures, name)(*args)
    ref = getattr(textures_ref, name)(*args)
    assert ours.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)


def test_texture_cache_matches_reference(tmp_path):
    """One decode per path; the images equal the reference cache's."""
    rng = np.random.default_rng(5)
    paths = []
    for i, shape in enumerate([(3, 5, 3), (4, 4, 4)]):
        paths.append(tmp_path / f"t{i}.png")
        write_png(paths[-1], rng.integers(0, 256, shape).astype(np.uint8))
    cache, cache_ref = textures.TextureCache(), textures_ref.TextureCache()
    for path in paths + paths:
        np.testing.assert_array_equal(cache.get(path), cache_ref.get(path))
    assert cache.get(paths[0]) is cache.get(str(paths[0]))
    assert len(cache) == len(cache_ref) == 2


# ---- input and events ---------------------------------------------------

@pytest.mark.parametrize("enum_name", ["Key", "KeyAction", "MouseButton",
                                       "MouseButtonAction", "ModifierFlags"])
def test_input_enums_equal_reference(enum_name):
    ours = {e.name: e.value for e in getattr(input_mod, enum_name)}
    ref = {e.name: e.value for e in getattr(input_ref, enum_name)}
    assert ours == ref
    assert len(ours) > 1


def test_key_char_and_from_char_match_reference():
    for key, key_ref in zip(input_mod.Key, input_ref.Key):
        assert key.char == key_ref.char
    for ch in "wasd t1509~ \x1b[":
        assert input_mod.Key.from_char(ch).name == \
            input_ref.Key.from_char(ch).name


def _events(m, refs):
    K, A, B, BA, F = (getattr(m, n) for n in (
        "Key", "KeyAction", "MouseButton", "MouseButtonAction",
        "ModifierFlags"))
    key_input, mouse_input = refs
    return [key_input(K.W, A.PRESS, F.SHIFT), key_input("w"),
            key_input(K.ESCAPE, A.RELEASE), key_input(K.F5, A.REPEAT),
            key_input(K.SPACE), key_input(K.K3, "press",
                                          F.SHIFT | F.CONTROL),
            mouse_input(B.LEFT, BA.RELEASE), mouse_input(B.RIGHT),
            mouse_input("middle", "press", F.ALT), mouse_input(B.B8)]


def _plain(event) -> tuple:
    """An event's fields, the modifier flags as an int."""
    mods = event.mods if isinstance(event.mods, frozenset) else int(
        event.mods)
    return (type(event).__name__, getattr(event, "key", None),
            getattr(event, "button", None), event.action, mods)


def test_event_normalisation_matches_reference():
    ours = _events(input_mod, (KeyInput, MouseInput))
    ref = _events(input_ref, (KeyInputRef, MouseInputRef))
    assert [_plain(e) for e in ours] == [_plain(e) for e in ref]
    assert ours[0] == KeyInput("w", "press", input_mod.ModifierFlags.SHIFT)


# ---- overlay ------------------------------------------------------------

LINES = [["Frame time: 12.34 ms (81.1 FPS)"],
         ["Frame time: 0.99 ms (1010.1 FPS)", "mode=HYBRID t=19s"],
         ["abc xyz ~ %+-=/ (1,2):'q'"], []]


@pytest.mark.parametrize("lines", LINES, ids=["one", "two", "glyphs",
                                              "none"])
@pytest.mark.parametrize("scale", [1, 2])
def test_text_mask_matches_reference(lines, scale):
    np.testing.assert_array_equal(render_text_mask(lines, scale=scale),
                                  text_mask_ref(lines, scale=scale))


@pytest.mark.parametrize("case", [
    dict(shape=(60, 200), lines=LINES[0]),
    dict(shape=(9, 16), lines=LINES[1]),
    dict(shape=(36, 64), lines=LINES[1], origin=(2, 30), scale=2),
    dict(shape=(40, 120), lines=LINES[2], color=(1.0, 0.2, 0.0),
         backing=0.3),
    dict(shape=(20, 20), lines=LINES[0], origin=(25, 0)),
    dict(shape=(20, 30), lines=[])], ids=lambda c: "x".join(
        map(str, c["shape"])) + f"-{len(c['lines'])}")
def test_burn_overlay_byte_equal(case):
    """burn_overlay on the same seeded frame gives the reference's bytes,
    and leaves its input as it was."""
    case = dict(case)
    shape = case.pop("shape") + (3,)
    frame = np.random.default_rng(7).uniform(0, 1, shape).astype(np.float32)
    kept = frame.copy()
    ours = burn_overlay(frame, **case)
    ref = burn_overlay_ref(frame, **case)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(frame, kept)


# ---- compare and profiling ----------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_rmse_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a8 = rng.integers(0, 256, (9, 16, 3)).astype(np.uint8)
    b8 = rng.integers(0, 256, (9, 16, 3)).astype(np.uint8)
    af = rng.uniform(0, 1, (9, 16, 3)).astype(np.float32)
    for x, y in ((a8, b8), (a8, a8), (af, b8), (af, af * 0.5)):
        assert compare.rmse(x, y) == rmse_ref(x, y)
    with pytest.raises(ValueError, match="shape mismatch"):
        compare.rmse(a8, a8[:4])


def test_compare_main(tmp_path, capsys):
    image = np.random.default_rng(3).integers(0, 256, (9, 16, 3))
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    write_png(a, image.astype(np.uint8))
    write_png(b, (255 - image).astype(np.uint8))
    assert compare.main([str(a), str(a)]) == 0
    assert json.loads(capsys.readouterr().out)["rmse"] == 0.0
    assert compare.main([str(a), str(b), "--threshold", "0.2"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["pass"] is False and out["rmse"] > 0.2


def test_frame_timer_matches_reference(monkeypatch):
    """The same clock readings give the same moving average and text."""
    import time

    readings = [1.0, 1.05, 1.08, 1.2, 1.21]
    timers = []
    for cls in (profiling.FrameTimer, FrameTimerRef):
        it = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda it=it: next(it))
        timer = cls(smoothing=0.8)
        texts = [(timer.tick(), timer.fps, timer.overlay_text())
                 for _ in readings]
        timers.append(texts)
    assert timers[0] == timers[1]
    assert timers[0][-1][2].startswith("Frame time: ")


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    """trace(log_dir) writes a Chrome trace that holds the named scopes of
    its body, and beside it the record of the spans (record.<pid>.json)."""
    profiling.reset()
    with profiling.trace(tmp_path / "trace"):
        with profiling.frame("hybrid.render_frame_device"):
            with profiling.named_scope("gbuffer_stage"):
                torch.ones(64).sum()
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"hybrid.render_frame_device", "gbuffer_stage"} <= names
    records = list((tmp_path / "trace").glob("record.*.json"))
    assert len(records) == 1
    rows = json.loads(records[0].read_text())["rows"]
    assert len(rows) == 1 and rows[0]["profiled"] is True
    assert "gbuffer_stage" in rows[0]["spans"]


def test_start_profiler_server_is_not_ported():
    with pytest.raises(NotImplementedError, match="no live profiling"):
        profiling.start_profiler_server()
