"""Scene generators, one module each, found by the name a configuration's
file gives under "generator"; each module's `make(params, placement_seed)`
returns a `common.SceneArrays`."""

from __future__ import annotations

import importlib


def load_generator(name: str):
    return importlib.import_module(f"portbench.scenes.{name}")
