"""Primary-hit assembly: intersection + interaction + textured material.

Single entry point used by the G-buffer and by secondary bounces.
"""

from __future__ import annotations

from typing import Tuple

from ..scene.scene_data import SceneData
from . import intersect as ix
from . import surface as surf
from .bsdf import SurfaceMaterial
from .texture import fetch_textured_material


def trace_primary(
    scene: SceneData,
    trv: ix.TraversalArrays,
    o, d,
    with_textures: bool,
    active=None,
) -> Tuple[surf.Interaction, SurfaceMaterial, ix.Hit]:
    """Closest hit + interaction + textured material for a ray batch."""
    hit = ix.intersect_closest(trv, o, d, active=active)
    it = surf.make_interaction(scene, hit)
    mat, mapped_norm = fetch_textured_material(
        scene, it.mat_id, it.uv, it.norm, with_textures
    )
    it = it._replace(norm=mapped_norm)
    return it, mat, hit
