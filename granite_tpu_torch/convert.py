"""State carried across from the JAX package to the port.

Every function takes the JAX side's arrays through `np.asarray` (which
any array type supports, so this module needs no jax import) and returns
the port's tensors on a given device.  The tests use these to feed both
implementations identical inputs; a user can hand a scene packed by the
JAX package straight to the port.

uint32 bit masks (the reference's light masks) become int32 of the same
bits; JAX's 0-dim light count becomes a Python int.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.clusterer import LightBuffer
from .ops.raster import TriangleSetup
from .renderer.scene_renderer import PackedScene


def tensor(x, device="cpu") -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:     # jax hands out read-only views
        a = a.copy()
    return torch.as_tensor(a, device=device)


def scene_arrays(arrays: dict, device="cpu") -> dict:
    """PackedScene.device_arrays() (granite_tpu) -> {field: tensor}."""
    return {k: tensor(v, device) for k, v in arrays.items()}


def packed_scene(jax_packed, device="cpu") -> PackedScene:
    """A granite_tpu PackedScene -> the port's PackedScene."""
    arrays = scene_arrays(jax_packed.device_arrays(), device)
    host = {f: getattr(jax_packed, f) for f in (
        "obj_node", "obj_aabb_min", "obj_aabb_max", "obj_flags",
        "num_objects", "num_nodes", "num_static_verts", "morph_v0",
        "morph_default_weights", "has_normal_maps", "has_mr_textures",
        "has_emissive")}
    host["morph_nodes"] = list(jax_packed.morph_nodes or [])
    fields = set(PackedScene.DEVICE_FIELDS)
    return PackedScene(**{k: v for k, v in arrays.items() if k in fields},
                       **host)


def environment(jax_env, device="cpu") -> dict:
    """A granite_tpu Environment -> the port's env dict (strips, sh,
    levels, sky_params), as shade_surface_fused takes it."""
    return {"strips": tensor(jax_env.strips, device),
            "sh": tensor(jax_env.sh, device),
            "levels": int(jax_env.num_levels),
            "sky_params": jax_env.sky_params}


def light_buffer(lights, device="cpu") -> LightBuffer:
    """granite_tpu ops.clusterer.LightBuffer -> the port's LightBuffer."""
    return LightBuffer(*(tensor(getattr(lights, f), device) for f in (
        "pos", "color", "inv_radius", "dir", "spot_scale_bias",
        "is_spot")), count=int(np.asarray(lights.count)))


def triangle_setup(setup, device="cpu") -> TriangleSetup:
    """granite_tpu ops.raster.TriangleSetup -> the port's TriangleSetup."""
    return TriangleSetup(*(tensor(getattr(setup, f), device)
                           for f in TriangleSetup._fields))


def frame_params(params, device="cpu"):
    """A frame's params pytree (dicts, lists, LightBuffers, arrays,
    scalars) -> the same structure of tensors."""
    if isinstance(params, dict):
        return {k: frame_params(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)) and not hasattr(params, "_fields"):
        return type(params)(frame_params(v, device) for v in params)
    if hasattr(params, "_fields") and hasattr(params, "inv_radius"):
        return light_buffer(params, device)
    if params is None or isinstance(params, (bool, int, float, str)):
        return params
    return tensor(params, device)
