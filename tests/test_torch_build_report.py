"""The register report that chip_smoke.py's build phase checks: the CUDA
library's ptxas table comes from a build in this process even when a
library built earlier is current, and the check that no instance of
csrc/alpha8.cu's walk (K1-K5, the any-hit kernel K2's instances among them)
spills refuses a spill, a report without K2 and an empty report instead of
passing them; likewise the check of the raster kernel R (csrc/raster.cu)."""

from __future__ import annotations

import pytest

import chip_smoke
from steeljax_torch import native

# A ptxas -v report of one kernel instance, in nvcc's words.
REPORT = """\
ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    {frame} bytes stack frame, {spill} bytes spill stores, {spill} bytes \
spill loads
ptxas info    : Used {regs} registers, 536 bytes cmem[0]
"""
K2 = "alpha8_kernel<1, 1, false, false, false, 0>"
K2_COUNT = "alpha8_kernel<1, 1, false, false, true, 0>"
K4 = "alpha8_kernel<0, 1, true, true, false, 0>"
K5 = "alpha8_kernel<2, 8, false, false, true, 0>"


def _table(**spills):
    """A ptxas table (registers, stack frame, spill stores, spill loads,
    smem) of K2's two instances, K4's and K5's, with the spill bytes given
    by instance name."""
    return {name: (48, 1024, spills.get(name, 0), spills.get(name, 0), 0)
            for name in (K2, K2_COUNT, K4, K5)}


@pytest.mark.parametrize("log", ["", "nvcc: nothing compiled\n"])
def test_spill_check_refuses_an_empty_report(log):
    with pytest.raises(RuntimeError, match="no ptxas report"):
        chip_smoke.check_spills(native.ptxas_table(log))


def test_spill_check_passes_zero_spills():
    table = {**_table(), "inst8_kernel<false, 0, false>": (56, 2048, 0, 0, 0)}
    assert chip_smoke.check_spills(table) == {K2: (48, 1024),
                                              K2_COUNT: (48, 1024)}


@pytest.mark.parametrize("name", [K2, K2_COUNT, K4, K5])
def test_spill_check_refuses_a_spill(name):
    with pytest.raises(RuntimeError, match="spill"):
        chip_smoke.check_spills(_table(**{name: 8}))


def test_spill_check_refuses_a_report_without_k2():
    table = {name: entry for name, entry in _table().items()
             if name not in (K2, K2_COUNT)}
    with pytest.raises(RuntimeError, match="no instance of K2"):
        chip_smoke.check_spills(table)


def _mangled(mode, k, alpha, fine, count, shade):
    """An alpha8_kernel instance's name as nvcc reports it; ptxas_table
    demangles it with c++filt (binutils, beside the g++ that compiles the
    BVH code) to alpha8_kernel<mode, k, alpha, fine, count, shade>."""
    flags = "".join(f"ELb{int(x)}" for x in (alpha, fine, count))
    return (f"_ZN12_GLOBAL__N_113alpha8_kernelILi{mode}ELi{k}{flags}"
            f"ELi{shade}EEEvNS_9AlphaArgsE")


def test_spill_check_reads_the_spills_of_a_report():
    """A report in nvcc's words: a spill of one instance of the walk is
    refused, and the spills of the other kernels' instances are not the
    check's."""
    log = "".join(REPORT.format(name=name, frame=1024, spill=spill, regs=48)
                  for name, spill in (
                      (_mangled(1, 1, False, False, False, 0), 0),
                      (_mangled(2, 8, False, False, True, 0), 0),
                      ("inst8_kernel", 8)))
    assert chip_smoke.check_spills(native.ptxas_table(log)) == {
        K2: (48, 1024)}
    with pytest.raises(RuntimeError, match="spill"):
        chip_smoke.check_spills(native.ptxas_table(
            log + REPORT.format(name=_mangled(0, 1, True, True, False, 0),
                                frame=2064, spill=8, regs=72)))


def test_cuda_ptxas_builds_when_the_process_has_built_nothing(
        monkeypatch, tmp_path):
    """A current library from an earlier run is only loaded by
    cuda_library(), which leaves BUILD_LOGS empty: cuda_ptxas() then builds
    anew, and a second call reuses that build's report."""
    builds = []

    def build(target):
        builds.append(target)
        native.BUILD_LOGS[target.name] = REPORT.format(
            name=_mangled(1, 1, False, False, False, 0), regs=40,
            frame=1024, spill=0)

    monkeypatch.setattr(native, "BUILD_LOGS", {})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "build_cuda", build)
    (tmp_path / native.CUDA_LIBRARY).write_bytes(b"")
    assert native.cuda_ptxas() == {K2: (40, 1024, 0, 0, 0)}
    assert builds == [tmp_path / native.CUDA_LIBRARY]
    native.cuda_ptxas()
    assert len(builds) == 1


# The raster kernel R as nvcc reports it (csrc/raster.cu's
# raster_tiles_kernel in the anonymous namespace: 14 pointers, 3 ints).
RASTER_MANGLED = ("_ZN12_GLOBAL__N_119raster_tiles_kernelEPKfPKiS3_S3_S3_S3_"
                  "S3_S3_S3_PfS4_S4_S4_S4_iii")


def test_raster_check_reads_a_report():
    """R's entry of a report in nvcc's words, demangled: its registers and
    shared memory; a spill of another kernel is not this check's."""
    log = (REPORT.format(name=RASTER_MANGLED, frame=0, spill=0, regs=40)
           + REPORT.format(name="inst8_kernel", frame=0, spill=8, regs=64))
    table = native.ptxas_table(log)
    assert chip_smoke.RASTER_INSTANCE in table
    assert chip_smoke.check_raster_ptxas(table) == (40, 0, 0, 0, 0)


def test_raster_check_refuses_a_spill():
    with pytest.raises(RuntimeError, match="spills"):
        chip_smoke.check_raster_ptxas(
            {chip_smoke.RASTER_INSTANCE: (40, 16, 8, 8, 28736)})


def test_raster_check_refuses_a_report_without_r():
    with pytest.raises(RuntimeError, match="no raster_tiles_kernel"):
        chip_smoke.check_raster_ptxas(_table())
