"""The check that decides `correct`, on the CPU at a tiny size: the program
agrees with the plain reference; the control (the reference in bfloat16 in
the program's place) fails the cell's limits; and a run with the timed
path broken underneath comes out not correct, once for each fault a
cell can have (a path-traced frame step that leaves the accumulation as it
was; half of the frame's pixels left out; radiance or colour altered
where it is produced; a hybrid frame has no state to leave unchanged).
One card has no exchange between chips to leave out."""

from __future__ import annotations

import pytest
import torch

from portbench import checks
from portbench.tests.helpers import run_tiny, tiny_environment

CELLS = ("foliage_alpha.pt_720p", "sunlit_stress.pt_720p",
         "sunlit_stress.hybrid_1080p")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def small_bakes(monkeypatch):
    tiny_environment(monkeypatch)


@pytest.mark.parametrize("workload", CELLS)
def test_program_agrees_with_reference(workload):
    result, numbers, limits, _ = run_tiny(workload)
    assert result["correct"], (numbers, limits)
    assert result["attempted"] == 2
    assert result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    _, _, limits, session = run_tiny(workload)
    control = session.control(torch.bfloat16)
    assert not checks.verdict(control, limits), (control, limits)


def _accumulate_unchanged(monkeypatch):
    from steeljax_torch.render.pt import renderer

    def unchanged(state, result):
        return renderer.AccumulationState(accumulated=state.accumulated,
                                          index=state.index + 1)

    monkeypatch.setattr(renderer, "accumulate", unchanged)


def _half_left_out(monkeypatch):
    from steeljax_torch.render.pt import integrator

    render = integrator.render_pixels

    def half(scene, tables, iv, ip, near, far, w, h, px, py, *args,
             **kwargs):
        n = len(px) // 2
        out, stats = render(scene, tables, iv, ip, near, far, w, h, px[:n],
                            py[:n], *args, **kwargs)
        return torch.cat([out, torch.zeros_like(out)])[:len(px)], stats

    monkeypatch.setattr(integrator, "render_pixels", half)


def _radiance_altered(monkeypatch):
    from steeljax_torch.render.pt import integrator

    render = integrator.render_pixels

    def altered(*args, **kwargs):
        out, stats = render(*args, **kwargs)
        return out * 1.01, stats

    monkeypatch.setattr(integrator, "render_pixels", altered)


def _hybrid_half_left_out(monkeypatch):
    from steeljax_torch.render.hybrid import renderer

    render = renderer.render_hybrid_pixels

    def half(*args, **kwargs):
        out = render(*args, **kwargs)
        return torch.cat([out[:len(out) // 2],
                          torch.zeros_like(out[len(out) // 2:])])

    monkeypatch.setattr(renderer, "render_hybrid_pixels", half)


def _hybrid_altered(monkeypatch):
    from steeljax_torch.render.hybrid import renderer

    render = renderer.render_hybrid_pixels
    monkeypatch.setattr(renderer, "render_hybrid_pixels",
                        lambda *a, **k: render(*a, **k) * 1.01)


@pytest.mark.parametrize("workload, fault", [
    ("sunlit_stress.pt_720p", _accumulate_unchanged),
    ("sunlit_stress.pt_720p", _half_left_out),
    ("sunlit_stress.pt_720p", _radiance_altered),
    ("sunlit_stress.hybrid_1080p", _hybrid_half_left_out),
    ("sunlit_stress.hybrid_1080p", _hybrid_altered)])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    result, numbers, limits, _ = run_tiny(workload)
    assert not result["correct"], (numbers, limits)


def test_numbers_of_identical_frames_are_zero():
    x = torch.rand(64, 3)
    before = torch.rand(64, 3)
    after = (x + 3.0 * before) / 4.0
    assert checks.frame_numbers(torch, x, x.clone()) == {
        "diverged_share": 0.0, "median_gap": 0.0}
    assert checks.accum_gap(torch, x, before, after, 3) == 0.0


def test_nan_counts_as_diverged():
    x = torch.ones(4, 3)
    y = x.clone()
    y[0, 1] = float("nan")
    assert checks.frame_numbers(torch, y, x)["diverged_share"] == 0.25
    assert checks.accum_gap(torch, x, x, y, 0) == float("inf")
    assert not checks.verdict({"accum_gap": float("nan")},
                              {"accum_gap": 1.0})
