"""What the benchmark loads: run.py and everything a run imports leave no
module whose top-level name is jax, jaxlib, flax or steeljax (compared
whole: steeljax_torch is not steeljax); the reference loads nothing of the
program; and without a card run.py exits with no result."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _loaded(code: str) -> set:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = _loaded(
        "import portbench.run, portbench.calibrate, portbench.traced\n"
        "import portbench.modes.pt, portbench.modes.hybrid\n"
        "import portbench.port_scene\n"
        "import steeljax_torch.render.pt.renderer\n"
        "import steeljax_torch.render.hybrid.renderer\n"
        "import steeljax_torch.render.pt.integrator\n"
        "import steeljax_torch.scene.scene\n"
        "from portbench import run\n"
        "for p in (run.HERE / 'metrics').glob('*.py'):\n"
        "    run.read_metric(p.stem, {'mode': None, 'setup_s': 1.0,"
        " 'e2e': {}, 'window': {'frames': 1, 'wall_s': 1.0,"
        " 'frame_ms': [1.0]}})\n")
    assert "steeljax_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "steeljax"}


def test_reference_loads_nothing_of_the_program():
    names = _loaded(
        "import portbench.reference.path, portbench.reference.trace\n"
        "import portbench.reference.scene, portbench.reference.brdf\n"
        "import portbench.reference.hybrid\n"
        "import portbench.reference.environment\n"
        "import portbench.scenes.foliage, portbench.scenes.sunlit_stress\n"
        "import portbench.checks, portbench.roofline\n")
    assert not names & {"steeljax_torch", "steeljax", "jax", "jaxlib",
                        "flax"}


def test_forbidden_modules_compares_whole_names():
    from portbench import run

    assert run.forbidden_modules(["steeljax_torch.render", "jaxtyping",
                                  "flaxen"]) == []
    assert run.forbidden_modules(["steeljax.accel", "jaxlib.xla_client",
                                  "flax", "numpy"]) == \
        ["flax", "jaxlib", "steeljax"]


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "sunlit_stress.pt_720p", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
