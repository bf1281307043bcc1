"""Light-volume global illumination.

Port of steeljax/gi: the reference's (shipped but disabled, Config.hpp:44)
GI bake, made functional: probe placement by octree subdivision filtered by
a geometry test, path-traced probe cubemaps (through the port's trace
kernels), 3rd-order spherical-harmonics projection, Delaunay tetrahedral
mesh, and runtime barycentric interpolation via a tetrahedral walk
(GlobalIllumination.cpp:174-243, LightVolume.comp, Lighting.glsl:92-182).
"""

from steeljax_torch.gi.light_volume import (  # noqa: F401
    LightVolume, generate_light_volume)
from steeljax_torch.gi.sample import sample_light_volume  # noqa: F401
