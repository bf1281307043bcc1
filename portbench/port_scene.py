"""A `SceneArrays` handed to the program under test: the port's `Scene`,
built through its public scene API (`steeljax_torch.scene`), one entity per
`EntitySpec`, as the port's own generators build theirs."""

from __future__ import annotations

import numpy as np

from portbench.scenes.common import SceneArrays


def build(arrays: SceneArrays):
    from steeljax_torch.core import camera as camera_lib
    from steeljax_torch.scene.material import Material, MaterialFlags
    from steeljax_torch.scene.primitive import Primitive
    from steeljax_torch.scene.scene import (Entity, Light, LightType,
                                            RenderObject, Scene)

    scene = Scene()
    scene.textures.extend(arrays.textures)
    for m in arrays.materials:
        emission = np.zeros(4, np.float32)
        emission[:3] = m.emission
        scene.materials.append(Material(
            base_color_factor=np.asarray(m.base_color, np.float32),
            emission_factor=emission,
            base_color_texture=m.base_color_texture,
            roughness_factor=m.roughness, metallic_factor=m.metallic,
            normal_scale=m.normal_scale, occlusion_strength=m.occlusion,
            alpha_cutoff=m.alpha_cutoff, flags=MaterialFlags(m.flags)))
    for mesh in arrays.meshes:
        scene.primitives.append(Primitive.create(
            mesh.indices, mesh.positions, mesh.normals, None, mesh.uvs))
    for e in arrays.entities:
        entity = Entity(local_transform=np.asarray(e.transform, np.float32),
                        render_objects=[RenderObject(p, m)
                                        for p, m in e.objects])
        if e.light_color is not None:
            entity.light = Light(type=LightType.DIRECTIONAL,
                                 color=np.asarray(e.light_color, np.float32))
        scene.add_entity(entity)
    cam = arrays.camera
    scene.camera_location = camera_lib.CameraLocation(
        position=np.asarray(cam.position, np.float32),
        direction=np.asarray(cam.direction, np.float32),
        up=np.asarray(cam.up, np.float32))
    scene.camera_projection = camera_lib.CameraProjection(
        y_fov=cam.y_fov, width=cam.aspect_w, height=cam.aspect_h,
        z_near=cam.near, z_far=cam.far)
    return scene
