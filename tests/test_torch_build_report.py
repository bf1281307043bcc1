"""The register report that chip_smoke.py's build phase checks: the CUDA
library's ptxas table comes from a build in this process even when a
library built earlier is current, and the check of the any-hit kernel K2's
registers refuses an empty report instead of calling it a change."""

from __future__ import annotations

import pytest

import chip_smoke
from steeljax_torch import native

# A ptxas -v report of one K2 instance, in nvcc's words.
REPORT = """\
ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    {frame} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, 536 bytes cmem[0]
"""


def _table(regs_by_name):
    """A ptxas table (registers, stack frame, spills, smem) of instances."""
    return {name: (regs, frame, 0, 0, 0)
            for name, (regs, frame) in regs_by_name.items()}


@pytest.mark.parametrize("log", ["", "nvcc: nothing compiled\n"])
def test_k2_check_refuses_an_empty_report(log):
    with pytest.raises(RuntimeError, match="no ptxas report"):
        chip_smoke.check_k2_ptxas(native.ptxas_table(log))


def test_k2_check_passes_the_earlier_registers():
    table = _table({**chip_smoke.K2_PTXAS, "alpha8_kernel": (96, 0)})
    assert chip_smoke.check_k2_ptxas(table) == chip_smoke.K2_PTXAS


def test_k2_check_refuses_changed_registers():
    changed = dict(chip_smoke.K2_PTXAS)
    name = next(iter(changed))
    changed[name] = (changed[name][0] + 8, changed[name][1])
    with pytest.raises(RuntimeError, match="changed their registers"):
        chip_smoke.check_k2_ptxas(_table(changed))
    del changed[name]
    with pytest.raises(RuntimeError, match="changed their registers"):
        chip_smoke.check_k2_ptxas(_table(changed))


def test_cuda_ptxas_builds_when_the_process_has_built_nothing(
        monkeypatch, tmp_path):
    """A current library from an earlier run is only loaded by
    cuda_library(), which leaves BUILD_LOGS empty: cuda_ptxas() then builds
    anew, and a second call reuses that build's report."""
    builds = []

    def build(target):
        builds.append(target)
        native.BUILD_LOGS[target.name] = REPORT.format(
            name="trace8_kernel", regs=40, frame=1024)

    monkeypatch.setattr(native, "BUILD_LOGS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "build_cuda", build)
    (tmp_path / native.CUDA_LIBRARY).write_bytes(b"")
    assert native.cuda_ptxas() == {"trace8_kernel": (40, 1024, 0, 0, 0)}
    assert builds == [tmp_path / native.CUDA_LIBRARY]
    native.cuda_ptxas()
    assert len(builds) == 1
