"""Built-in procedural scenes (no asset files required).

`make_cornell_scene` reproduces the layout of the reference's default scene
(Assets/Scenes/CornellBox/CornellBox.gltf, Config.hpp:19): a 10-unit box
with green/red side walls, an emissive ceiling lamp, two boxes, and two
spheres.  Used by tests and the smoke scripts so the framework is
exercisable without the reference checkout.  `make_parity_scene` carries a
directional light; `make_stress_scene` fills the box with a grid of spheres
and boxes, optionally textured; `make_sunlit_stress_scene` is the JAX
bench's hybrid scene, a stress scene under a directional sun;
`make_foliage_scene` is a canopy of alpha-tested leaf cards over a ground
quad (steeljax/scene/builtin.py:199-307).
"""

from __future__ import annotations

import numpy as np

from steeljax_torch.core import camera as camera_lib
from steeljax_torch.scene.material import Material, MaterialFlags
from steeljax_torch.scene.primitive import Primitive, make_uv_sphere
from steeljax_torch.scene.scene import (Entity, Light, LightType, RenderObject,
                                  Scene)


def make_quad(size: float = 10.0) -> Primitive:
    """size x size quad in the XY plane facing +Z."""
    h = size * 0.5
    positions = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]],
                         np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    normals = np.tile(np.array([0, 0, 1], np.float32), (4, 1))
    return Primitive.create(indices, positions, normals, None, uvs)


def make_box(size: float = 1.0) -> Primitive:
    """Axis-aligned cube with per-face normals, centered at origin."""
    h = size * 0.5
    faces = []
    idx = []
    normals = []
    uvs = []
    axes = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
    base = 0
    for axis, u_ax, v_ax in axes:
        for sign in (1.0, -1.0):
            corners = []
            for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3, np.float32)
                p[axis] = sign * h
                p[u_ax] = du * h
                p[v_ax] = dv * h
                corners.append(p)
            n = np.zeros(3, np.float32)
            n[axis] = sign
            faces.extend(corners)
            normals.extend([n] * 4)
            uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            if sign > 0:
                idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
            else:
                idx.extend([base, base + 2, base + 1, base, base + 3, base + 2])
            base += 4
    return Primitive.create(
        np.array(idx, np.uint32), np.array(faces, np.float32),
        np.array(normals, np.float32), None, np.array(uvs, np.float32))


def _trs(translation, rotation_axis=None, angle=0.0, scale=(1, 1, 1)):
    m = np.eye(4, dtype=np.float32)
    r = np.eye(3, dtype=np.float32)
    if rotation_axis is not None:
        axis = np.asarray(rotation_axis, np.float32)
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(angle), np.sin(angle)
        x, y, z = axis
        r = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s,
             x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c),
             y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
             c + z * z * (1 - c)],
        ], np.float32)
    m[:3, :3] = r * np.asarray(scale, np.float32)[None, :]
    m[:3, 3] = translation
    return m


def make_cornell_scene(sphere_detail: int = 12) -> Scene:
    scene = Scene()

    def add_material(base_color, emission=0.0, metallic=0.0, roughness=1.0,
                     double_sided=True) -> int:
        flags = MaterialFlags.DOUBLE_SIDED if double_sided else (
            MaterialFlags.NONE)
        em = np.zeros(4, np.float32)
        em[:3] = emission
        scene.materials.append(Material(
            base_color_factor=np.array([*base_color, 1.0], np.float32),
            emission_factor=em,
            metallic_factor=metallic, roughness_factor=roughness,
            flags=flags))
        return len(scene.materials) - 1

    gray = add_material((1, 1, 1))
    green = add_material((0, 1, 0))
    red = add_material((1, 0, 0))
    lamp = add_material((1, 1, 1), emission=1.0)
    matte = add_material((0.7, 0.7, 0.7), roughness=0.6)
    metal = add_material((0.9, 0.9, 0.9), metallic=1.0, roughness=0.1)

    quad = 0
    scene.primitives.append(make_quad(10.0))
    box = 1
    scene.primitives.append(make_box(1.0))
    sphere = 2
    scene.primitives.append(
        make_uv_sphere(1.0, sphere_detail, sphere_detail * 2))

    half_pi = float(np.pi / 2)

    def add(name, prim, mat, transform):
        scene.add_entity(Entity(
            name=name, local_transform=transform,
            render_objects=[RenderObject(prim, mat)]))

    add("back_wall", quad, gray, _trs((0, 0, -5)))
    add("bottom_wall", quad, gray, _trs((0, -5, 0), (1, 0, 0), half_pi))
    add("top_wall", quad, gray, _trs((0, 5, 0), (1, 0, 0), half_pi))
    add("green_wall", quad, green, _trs((-5, 0, 0), (0, 1, 0), -half_pi))
    add("red_wall", quad, red, _trs((5, 0, 0), (0, 1, 0), -half_pi))
    add("lamp", quad, lamp,
        _trs((0, 4.75, 0), (1, 0, 0), half_pi, (0.25, 0.25, 1.0)))
    add("cube", box, matte,
        _trs((3.0, -3.5, 1.7), (0, 1, 0), 0.96, (2.5, 2.5, 2.5)))
    add("tall_cube", box, matte, _trs((-2.5, -2.0, -2.0), None, 0.0,
                                      (2.5, 6.0, 2.5)))
    add("metal_sphere", sphere, metal, _trs((-3.0, -4.0, 3.0)))
    add("matte_sphere", sphere, matte, _trs((3.3, -1.0, 0.0)))

    scene.camera_location = camera_lib.CameraLocation(
        position=np.array([0, 0, 16], np.float32),
        direction=np.array([0, 0, -1], np.float32),
        up=camera_lib.UP)
    scene.camera_projection = camera_lib.CameraProjection(
        y_fov=0.872664626, width=1.77777, height=1.0,
        z_near=0.01, z_far=100.0)
    return scene


def make_parity_scene(sphere_detail: int = 8) -> Scene:
    """Single-bounce-dominated scene for the PT-vs-hybrid numeric gate:
    an open ground plane + matte spheres under one directional light and
    the sky env.  With no enclosing geometry, multi-bounce transport (the
    part deferred split-sum lighting cannot represent) is a small fraction
    of the image, so the two pipelines must agree within a tight RMSE —
    unlike the emissive-lamp Cornell where hybrid has no light source."""
    scene = Scene()
    scene.materials.append(Material(
        base_color_factor=np.array([0.75, 0.75, 0.75, 1.0], np.float32),
        emission_factor=np.zeros(4, np.float32),
        metallic_factor=0.0, roughness_factor=0.9,
        flags=MaterialFlags.DOUBLE_SIDED))
    scene.materials.append(Material(
        base_color_factor=np.array([0.6, 0.3, 0.2, 1.0], np.float32),
        emission_factor=np.zeros(4, np.float32),
        metallic_factor=0.0, roughness_factor=0.7,
        flags=MaterialFlags.NONE))
    scene.primitives.append(make_quad(20.0))
    scene.primitives.append(
        make_uv_sphere(1.0, sphere_detail, sphere_detail * 2))

    half_pi = float(np.pi / 2)
    scene.add_entity(Entity(
        name="ground", local_transform=_trs((0, -1, 0), (1, 0, 0), half_pi),
        render_objects=[RenderObject(0, 0)]))
    scene.add_entity(Entity(
        name="sphere", local_transform=_trs((0, 0, 0)),
        render_objects=[RenderObject(1, 1)]))
    scene.add_entity(Entity(
        name="sphere2", local_transform=_trs((2.5, -0.4, -1.0), None, 0.0,
                                             (0.6, 0.6, 0.6)),
        render_objects=[RenderObject(1, 0)]))

    # Directional "sun": gather_lights takes -X of the world transform, so
    # rotate +X onto the desired direction (down-forward-left).
    sun = Entity(name="sun", local_transform=_trs((0, 0, 0), (0, 0, 1),
                                                  -2.2))
    sun.light = Light(type=LightType.DIRECTIONAL,
                      color=np.array([3.0, 2.9, 2.7], np.float32))
    scene.add_entity(sun)

    scene.camera_location = camera_lib.CameraLocation(
        position=np.array([0, 1.2, 6.0], np.float32),
        direction=np.array([0, -0.15, -1], np.float32),
        up=camera_lib.UP)
    scene.camera_projection = camera_lib.CameraProjection(
        y_fov=0.9, width=1.77777, height=1.0, z_near=0.01, z_far=100.0)
    return scene


def _leaf_texture(size: int = 128, serrated: bool = True) -> np.ndarray:
    """Procedural RGBA leaf card: green lobes with an alpha mask
    (~45% coverage) — the San Miguel foliage pattern that makes the
    reference's AnyHit shader (AnyHit.rahit:25-52) the hot path.

    serrated=True adds texel-scale perforations everywhere (periodic
    sin x sin cuts, period ~8 texels): the ADVERSARIAL case where no
    coverage cell is provably opaque.  serrated=False models the common
    real-asset profile — solid leaflet interiors, smooth boundaries —
    where the fine OPAQUE plane (accel.alphamask) lets interior hits
    terminate traversal exactly like opaque geometry."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    alpha = np.zeros((size, size), bool)
    # Three elliptical leaflets fanning from the bottom-center stem.
    for cx, cy, rx, ry, rot in ((0.5, 0.42, 0.16, 0.34, 0.0),
                                (0.30, 0.55, 0.13, 0.27, 0.6),
                                (0.70, 0.55, 0.13, 0.27, -0.6)):
        dx, dy = x - cx, y - cy
        u = dx * np.cos(rot) - dy * np.sin(rot)
        v = dx * np.sin(rot) + dy * np.cos(rot)
        alpha |= (u / rx) ** 2 + (v / ry) ** 2 < 1.0
    # Serrated edge + midrib cut so the mask is high-frequency.
    alpha &= ~((np.abs(x - 0.5) < 0.012) & (y < 0.45))
    if serrated:
        alpha &= (np.sin(x * 97.0) * np.sin(y * 83.0)) > -0.92
    tex = np.zeros((size, size, 4), np.uint8)
    shade = (90 + 100 * y).astype(np.uint8)
    tex[..., 0] = 30
    tex[..., 1] = shade
    tex[..., 2] = 25
    tex[..., 3] = np.where(alpha, 255, 0)
    return tex


def make_foliage_scene(cards: int = 500_000, region: float = 9.0,
                       card_size: float = 0.55, seed: int = 11,
                       serrated: bool = True) -> Scene:
    """San Miguel-class alpha-test workload: a dense canopy of randomly
    oriented textured leaf cards (2 tris each) over a ground plane.
    Every leaf intersection runs the alpha-test re-trace loop
    (render/pt/integrator trace_material_ray; reference AnyHit.rahit:
    25-52) — the actual hard part of San Miguel-style scenes, which the
    sphere/box stress scene does not exercise.  serrated=False swaps in
    the solid-interior leaf texture (see _leaf_texture) — the realistic
    asset profile where opaque-plane termination applies."""
    rng = np.random.default_rng(seed)
    scene = Scene()
    scene.textures.append(_leaf_texture(serrated=serrated))
    scene.materials.append(Material(
        base_color_factor=np.ones(4, np.float32),
        base_color_texture=0, roughness_factor=0.8, metallic_factor=0.0,
        alpha_cutoff=0.5,
        flags=MaterialFlags.ALPHA_TEST | MaterialFlags.DOUBLE_SIDED))
    scene.materials.append(Material(
        base_color_factor=np.array([0.45, 0.4, 0.32, 1.0], np.float32),
        roughness_factor=0.95, metallic_factor=0.0,
        flags=MaterialFlags.DOUBLE_SIDED))

    # One merged primitive: `cards` quads with random position/orientation
    # inside a canopy slab (vectorized — no per-card Python entities).
    h = card_size * 0.5
    base = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]],
                    np.float32)                                   # (4, 3)
    axis = rng.normal(size=(cards, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, np.pi, cards).astype(np.float32)
    c, s = np.cos(ang)[:, None, None], np.sin(ang)[:, None, None]
    k = np.zeros((cards, 3, 3), np.float32)  # cross-product matrices
    k[:, 0, 1], k[:, 0, 2] = -axis[:, 2], axis[:, 1]
    k[:, 1, 0], k[:, 1, 2] = axis[:, 2], -axis[:, 0]
    k[:, 2, 0], k[:, 2, 1] = axis[:, 1], -axis[:, 0]
    rot = np.eye(3, dtype=np.float32)[None] + s * k + (1 - c) * (k @ k)
    centers = np.empty((cards, 3), np.float32)
    centers[:, 0] = rng.uniform(-region, region, cards)
    centers[:, 2] = rng.uniform(-region, region, cards)
    centers[:, 1] = rng.uniform(0.3, max(region * 0.65, 0.3 + 1e-6), cards)
    pos = (base[None] @ rot.transpose(0, 2, 1) + centers[:, None])
    nrm = np.broadcast_to(rot[:, None, :, 2], (cards, 4, 3))
    uv = np.tile(np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
                 (cards, 1))
    quad_idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    idx = (quad_idx[None] + 4 * np.arange(cards, dtype=np.uint32)[:, None])
    scene.primitives.append(Primitive.create(
        idx.reshape(-1), pos.reshape(-1, 3).astype(np.float32),
        np.ascontiguousarray(nrm.reshape(-1, 3), np.float32),
        None, uv))
    scene.primitives.append(make_quad(region * 4.0))

    scene.add_entity(Entity(name="canopy", local_transform=_trs((0, 0, 0)),
                            render_objects=[RenderObject(0, 0)]))
    scene.add_entity(Entity(
        name="ground",
        local_transform=_trs((0, 0, 0), (1, 0, 0), float(np.pi / 2)),
        render_objects=[RenderObject(1, 1)]))

    sun = Entity(name="sun", local_transform=_trs((0, 0, 0), (0, 0, 1),
                                                  -2.1))
    sun.light = Light(type=LightType.DIRECTIONAL,
                      color=np.array([3.0, 2.9, 2.7], np.float32))
    scene.add_entity(sun)

    scene.camera_location = camera_lib.CameraLocation(
        position=np.array([0, region * 0.45, region * 1.6], np.float32),
        direction=np.array([0, -0.12, -1], np.float32),
        up=camera_lib.UP)
    scene.camera_projection = camera_lib.CameraProjection(
        y_fov=0.872664626, width=1.77777, height=1.0,
        z_near=0.01, z_far=200.0)
    return scene


def _brick_texture(size: int = 256) -> np.ndarray:
    """Procedural opaque RGBA brick/noise texture (base color): a real
    high-frequency bilinear workload for the textured stress scene."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    row = np.floor(y * 8.0)
    bx = x * 4.0 + np.where(row % 2 == 0, 0.0, 0.5)
    mortar = ((np.abs(bx - np.round(bx)) < 0.04)
              | (np.abs(y * 8.0 - np.round(y * 8.0)) < 0.06))
    rng = np.random.default_rng(3)
    noise = rng.uniform(0.85, 1.15, (size, size)).astype(np.float32)
    tex = np.zeros((size, size, 4), np.uint8)
    base = np.where(mortar[..., None],
                    np.array([168, 160, 150], np.float32),
                    np.array([152, 74, 56], np.float32))
    tex[..., :3] = np.clip(base * noise[..., None], 0, 255).astype(np.uint8)
    tex[..., 3] = 255
    return tex


def make_stress_scene(instances: int = 400, sphere_detail: int = 24,
                      textured: bool = False) -> Scene:
    """Cornell box populated with a grid of instanced spheres and boxes, a
    many-triangle synthetic workload (steeljax/scene/builtin.py:329-373).

    `textured=True` gives the instanced materials (4 and 5) the 256x256
    brick base-color texture, so the textured shading path (uv
    interpolation and bilinear atlas sampling) runs at full scene scale."""
    rng = np.random.default_rng(7)
    scene = make_cornell_scene(sphere_detail=sphere_detail)
    sphere = 2  # from make_cornell_scene
    box = 1
    if textured:
        scene.textures.append(_brick_texture())
        scene.materials[4] = Material(
            base_color_factor=np.ones(4, np.float32),
            emission_factor=np.zeros(4, np.float32),
            base_color_texture=0, roughness_factor=0.6,
            metallic_factor=0.0, flags=MaterialFlags.DOUBLE_SIDED)
        scene.materials[5] = Material(
            base_color_factor=np.array([0.9, 0.9, 0.9, 1.0], np.float32),
            emission_factor=np.zeros(4, np.float32),
            base_color_texture=0, roughness_factor=0.15,
            metallic_factor=1.0, flags=MaterialFlags.DOUBLE_SIDED)
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
                prim = sphere if (count % 3) else box
                mat = 4 + (count % 2)  # matte / metal
                scene.add_entity(Entity(
                    name=f"stress_{count}",
                    local_transform=_trs(pos, None, 0.0,
                                         (scale, scale, scale)),
                    render_objects=[RenderObject(prim, mat)]))
                count += 1
    return scene


def make_sunlit_stress_scene(instances: int = 300,
                             sphere_detail: int = 16) -> Scene:
    """The JAX bench's hybrid scene (bench.py:228-233): a stress scene plus
    a directional sun of colour (3.0, 2.9, 2.7)."""
    scene = make_stress_scene(instances=instances,
                              sphere_detail=sphere_detail)
    sun = Entity(name="sun", local_transform=_trs((0, 0, 0), (0, 0, 1),
                                                  -2.0))
    sun.light = Light(type=LightType.DIRECTIONAL,
                      color=np.array([3.0, 2.9, 2.7], np.float32))
    scene.add_entity(sun)
    return scene
