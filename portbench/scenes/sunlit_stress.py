"""The sunlit stress scene: the Cornell box filled with a grid of spheres
and boxes, under a directional sun.

Frozen copy of `make_sunlit_stress_scene`, `make_stress_scene` and
`make_cornell_scene` of the port's `steeljax_torch/scene/builtin.py`
(which follow `steeljax/scene/builtin.py` and the JAX bench's hybrid scene,
`bench.py:228-233`), as they stood when the benchmark was written.  The
only difference: the generator that draws the instances' scales takes its
seed as a parameter (the port's fixes it at 7), so
`make(params, placement_seed=7)` gives the port's scene.
"""

from __future__ import annotations

import numpy as np

from portbench.scenes.common import (DOUBLE_SIDED, CameraSpec, EntitySpec,
                                     MaterialSpec, SceneArrays, box, quad,
                                     trs, uv_sphere)


def make(params: dict, placement_seed: int) -> SceneArrays:
    instances = int(params["instances"])
    detail = int(params["sphere_detail"])
    rng = np.random.default_rng(placement_seed)

    def material(base, emission=0.0, metallic=0.0, roughness=1.0):
        return MaterialSpec(base_color=(*base, 1.0),
                            emission=(emission,) * 3, metallic=metallic,
                            roughness=roughness, flags=DOUBLE_SIDED)

    materials = [material((1, 1, 1)), material((0, 1, 0)),
                 material((1, 0, 0)), material((1, 1, 1), emission=1.0),
                 material((0.7, 0.7, 0.7), roughness=0.6),
                 material((0.9, 0.9, 0.9), metallic=1.0, roughness=0.1)]
    gray, green, red, lamp, matte, metal = range(6)
    meshes = [quad(10.0), box(1.0), uv_sphere(1.0, detail, detail * 2)]
    wall, cube, sphere = range(3)
    half_pi = float(np.pi / 2)
    entities = [
        EntitySpec(trs((0, 0, -5)), [(wall, gray)]),
        EntitySpec(trs((0, -5, 0), (1, 0, 0), half_pi), [(wall, gray)]),
        EntitySpec(trs((0, 5, 0), (1, 0, 0), half_pi), [(wall, gray)]),
        EntitySpec(trs((-5, 0, 0), (0, 1, 0), -half_pi), [(wall, green)]),
        EntitySpec(trs((5, 0, 0), (0, 1, 0), -half_pi), [(wall, red)]),
        EntitySpec(trs((0, 4.75, 0), (1, 0, 0), half_pi, (0.25, 0.25, 1.0)),
                   [(wall, lamp)]),
        EntitySpec(trs((3.0, -3.5, 1.7), (0, 1, 0), 0.96, (2.5, 2.5, 2.5)),
                   [(cube, matte)]),
        EntitySpec(trs((-2.5, -2.0, -2.0), None, 0.0, (2.5, 6.0, 2.5)),
                   [(cube, matte)]),
        EntitySpec(trs((-3.0, -4.0, 3.0)), [(sphere, metal)]),
        EntitySpec(trs((3.3, -1.0, 0.0)), [(sphere, matte)]),
    ]
    side = int(np.ceil(instances ** (1 / 3)))
    count = 0
    for ix in range(side):
        for iy in range(side):
            for iz in range(side):
                if count >= instances:
                    break
                pos = (np.array([ix, iy, iz], np.float32) / max(side - 1, 1)
                       * 8.0 - 4.0)
                scale = 0.25 + 0.35 * rng.random()
                mesh = sphere if (count % 3) else cube
                entities.append(EntitySpec(
                    trs(pos, None, 0.0, (scale, scale, scale)),
                    [(mesh, matte if count % 2 == 0 else metal)]))
                count += 1
    entities.append(EntitySpec(trs((0, 0, 0), (0, 0, 1), -2.0), [],
                               light_color=(3.0, 2.9, 2.7)))
    camera = CameraSpec(position=(0.0, 0.0, 16.0), direction=(0.0, 0.0, -1.0),
                        y_fov=0.872664626, aspect_w=1.77777, aspect_h=1.0,
                        near=0.01, far=100.0)
    return SceneArrays(meshes=meshes, materials=materials, textures=[],
                       entities=entities, camera=camera)
