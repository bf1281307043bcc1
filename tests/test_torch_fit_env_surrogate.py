"""The port's surrogate-environment fit against the reference on the CPU.

The gallery image and the reference's CornellBox.gltf are not in the
repository, so both modules' GALLERY and SCENE point at files the test
writes: a synthetic PNG (seeded noise over a vertical gradient) and the
Cornell box written by chip_smoke.write_cornell_gltf (its chrome sphere
gives mirror samples).  gather_samples at 96x54 must give the reference's
counts of background and mirror samples, with directions and radiance
within 1e-5; fit_sh2 and bake_cube within 1e-5; main writes the
reference's npz keys (the reference's main run on the 96x54 samples)."""

import sys
from pathlib import Path

import numpy as np
import pytest

from steeljax.apps import fit_env_surrogate as ref
from steeljax_torch.apps import fit_env_surrogate as port
from test_torch_support import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("surrogate")
    rng = np.random.default_rng(11)
    ramp = np.linspace(40.0, 220.0, 90)[:, None, None]
    image = np.clip(ramp + rng.normal(0.0, 25.0, (90, 160, 3)), 0, 255)
    Image.fromarray(image.astype(np.uint8)).save(tmp / "gallery.png")
    chip_smoke.write_cornell_gltf(tmp / "cornell.gltf")
    mp = pytest.MonkeyPatch()
    for module in (ref, port):
        mp.setattr(module, "GALLERY", str(tmp / "gallery.png"))
        mp.setattr(module, "SCENE", str(tmp / "cornell.gltf"))
    yield tmp
    mp.undo()


@pytest.fixture(scope="module")
def samples(inputs):
    return (port.gather_samples(96, 54, device="cpu"),
            ref.gather_samples(96, 54))


def test_gather_samples_match_reference(samples):
    (dirs, rads, kinds), (dirs_r, rads_r, kinds_r) = samples
    for kind in (0, 1):
        assert (kinds == kind).sum() == (kinds_r == kind).sum()
    assert (kinds == 1).sum() > 0 and (kinds == 0).sum() > 0
    np.testing.assert_array_equal(kinds, kinds_r)
    np.testing.assert_allclose(dirs, dirs_r, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rads, rads_r, rtol=0, atol=1e-5)


def test_fit_and_bake_match_reference(samples):
    dirs, rads, kinds = samples[1]
    coeffs, stats = port.fit_sh2(dirs, rads, kinds)
    coeffs_r, stats_r = ref.fit_sh2(dirs, rads, kinds)
    np.testing.assert_allclose(coeffs, coeffs_r, rtol=0, atol=1e-5)
    for key in ("fit_rms", "const_rms"):
        assert abs(stats[key] - stats_r[key]) <= 1e-5
    np.testing.assert_allclose(stats["mean"], stats_r["mean"], atol=1e-5)
    np.testing.assert_allclose(port.bake_cube(coeffs, 8),
                               ref.bake_cube(coeffs_r, 8), rtol=0, atol=1e-5)
    y = np.linspace(0.0, 1.0, 257)
    np.testing.assert_allclose(port.inverse_tone_map(y),
                               ref.inverse_tone_map(y), rtol=0, atol=0)
    np.testing.assert_array_equal(port.sh2_basis(dirs), ref.sh2_basis(dirs))


def test_samples_from_image_is_gather_samples(inputs, samples):
    """The decode split off: the inner function on the decoded image gives
    gather_samples' samples."""
    from PIL import Image

    from steeljax_torch.scene import load_scene

    img = np.asarray(Image.open(port.GALLERY).convert("RGB").resize(
        (96, 54), Image.LANCZOS), np.float64) / 255.0
    out = port.samples_from_image(img, load_scene(port.SCENE), "cpu")
    for a, b in zip(out, samples[0]):
        np.testing.assert_array_equal(a, b)


def test_main_writes_reference_keys(inputs, samples, tmp_path,
                                    monkeypatch):
    path, path_r = tmp_path / "ours.npz", tmp_path / "ref.npz"
    assert port.main(["-o", str(path), "--resolution", "8",
                      "--device", "cpu"]) == 0
    monkeypatch.setattr(ref, "gather_samples", lambda: samples[1])
    assert ref.main(["-o", str(path_r), "--resolution", "8"]) == 0
    with np.load(path) as out, np.load(path_r) as out_r:
        assert set(out.files) == set(out_r.files)
        for key in out_r.files:
            assert out[key].shape == out_r[key].shape, key
            assert out[key].dtype == out_r[key].dtype, key
        assert np.isfinite(out["cube"]).all() and (out["cube"] >= 0).all()
