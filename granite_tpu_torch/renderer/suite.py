"""RendererSuite (port of granite_tpu/renderer/suite.py; reference
renderer/renderer.hpp:182-211).

The reference keeps one specialized Renderer per render role (forward
opaque/transparent, shadow depth PCF/VSM directional/positional, depth
prepass, motion vectors, deferred G-buffer) and a `Config` that rebuilds
the set when global options flip.  Here each "renderer" is a pass
executor (the callable a RenderGraph pass runs); the suite is the
registry the viewer's graph bake consults instead of branching on the
config inline.

`set_default_renderers(app, config)` mirrors RendererSuite::
set_default_renderers: it derives every role from the Config and binds
the viewer's pass methods.  `set_renderer` overrides a role (the
reference's escape hatch for custom passes).  Unlike the JAX viewer,
which builds a new suite at every bake and so drops an override set
before it, the port's viewer keeps one suite: the defaults are derived
again at each bake and an override stays until it is set again.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Optional


class Type(enum.Enum):
    """renderer.hpp:186-197 Type: the same roles."""
    ForwardOpaque = 0
    ForwardTransparent = 1
    ShadowDepthDirectionalPCF = 2
    ShadowDepthDirectionalFallbackPCF = 3
    ShadowDepthPositionalPCF = 4
    ShadowDepthDirectionalVSM = 5
    ShadowDepthPositionalVSM = 6
    PrepassDepth = 7
    MotionVector = 8
    Deferred = 9
    DeferredLighting = 10     # G-buffer and lighting resolve are separate
    #                           graph passes


@dataclass
class Config:
    """renderer.hpp:205-211 RendererSuite::Config."""
    pcf_kernel_wide: bool = False
    directional_light_vsm: bool = False
    forward_z_prepass: bool = False
    cascaded_directional_shadows: bool = False


class RendererSuite:
    def __init__(self):
        self._defaults: dict[Type, Callable] = {}
        self._overrides: dict[Type, Callable] = {}
        self.config = Config()

    def set_renderer(self, t: Type, fn: Callable) -> None:
        self._overrides[t] = fn

    def get(self, t: Type) -> Optional[Callable]:
        return self._overrides.get(t, self._defaults.get(t))

    def set_default_renderers(self, app, config: Config) -> None:
        """Bind the default pass executors for every role the Config
        selects.  `app` is the SceneViewerApplication owning the pass
        methods."""
        self.config = config
        d = self._defaults = {
            Type.ForwardOpaque: app._forward_pass,
            Type.ForwardTransparent: app._apply_transparent,
            Type.Deferred: app._gbuffer_pass,
            Type.DeferredLighting: app._lighting_pass,
            # The motion-vector target rides the G-buffer pass: the same
            # executor, the MV output declared by the pass setup.
            Type.MotionVector: app._gbuffer_pass,
            # The visibility raster is the depth prepass by design; the
            # shadow executor stands for an explicit one.
            Type.PrepassDepth: app._shadow_pass}
        if config.directional_light_vsm:
            d[Type.ShadowDepthDirectionalVSM] = app._shadow_pass
            d[Type.ShadowDepthPositionalVSM] = app._shadow_pass
        else:
            d[Type.ShadowDepthDirectionalPCF] = app._shadow_pass
            # fallback: the non-cascaded single-map path
            d[Type.ShadowDepthDirectionalFallbackPCF] = app._shadow_pass
            d[Type.ShadowDepthPositionalPCF] = app._shadow_pass

    def shadow_renderer(self) -> Optional[Callable]:
        """The directional-shadow role the Config selects."""
        if self.config.directional_light_vsm:
            return self.get(Type.ShadowDepthDirectionalVSM)
        return self.get(Type.ShadowDepthDirectionalPCF)

    def main_geometry_renderer(self, deferred: bool,
                               motion_vectors: bool) -> Callable:
        if deferred:
            return self.get(Type.MotionVector if motion_vectors
                            else Type.Deferred)
        return self.get(Type.ForwardOpaque)
