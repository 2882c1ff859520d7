"""SceneViewerApplication — the scene viewer on PyTorch/CUDA (port of the
deferred/forward + HDR + post-processing subset of
granite_tpu/app/scene_viewer.py).

Graph (swapchain_updated): shadow-main [-> ocean-fft] [-> fog-volume]
-> gbuffer [-> ssao] -> lighting [-> ssr] (deferred) or forward (forward)
[-> taa-resolve | fsr2-upscale] -> bloom-threshold / luminance /
bloom-down0-3 / bloom-up0-1 -> tonemap -> sRGB backbuffer, or with an
LDR AA tonemap -> ldr -> fxaa|smaa -> sRGB backbuffer.  The frame
renders at resolutionScale x the display size; FSR2 upscales to display
size before the HDR chain, otherwise the tonemap resizes and sharpens.
Temporal AA jitters the camera per frame (TemporalJitter) and the
surface pass emits motion vectors.  A scene file (.gltf, .glb or a
.scene composition, scene/scene_loader.py) brings its cameras, skins,
morph targets and animations: the animation system poses the nodes each
frame, the frame params carry the skin palette and morph weights (and
last frame's, for the motion vectors), and the skinned meshes are
dynamic shadow casters, rasterized by B1 into a sun map every frame and
composited onto the cached static map.  The FFT ocean (ocean-fft pass, its
grid displaced at vertex transform by the elapsed time) and the terrain
join the scene before it is packed; meshEncoding "meshlet" re-encodes the
static meshes through the MLT2 codec; volumetric decals blend into the
resolved base color before lighting.  occlusionCulling takes the
surface through two-phase HiZ culling (B1 in each phase, a launch per
65,536 valid triangles, then the classic resolve), its per-object
visibility set carried as vis-history; volumetricFogRegions bounds the
froxel fog to unit-box regions (a default one at scale 40);
volumetricDiffuse bakes ambient-cube probe
volumes at set-up (B1, the classic resolve, B3, B4 on small cube faces)
whose irradiance replaces the SH sky's.  directionalLightShadowsCascaded
renders four camera-fitted sun maps through B1 every frame;
PCFKernelWide takes the 6x6 windowed PCF; clusteredLightsShadowsVSM packs
the light atlas as blurred moments; msaa N supersamples at sqrt(N) x the
render scale, which the tonemap's resize reduces; renderTargetFp16 makes
the HDR colour targets float16; showUi composites the host-rendered stats
window after the tonemap.  textureStreaming packs the scene with fallback
textures and post_frame latches the decoded images (worker threads, the
native texture codec for `.gtpx` sidecars) into the bundle rows B3 reads,
under textureBudgetMB.  The bake takes the shadow-main, gbuffer, lighting
and forward executors from a RendererSuite (renderer/suite.py), whose
Config carries PCFKernelWide, directionalLightShadowsVSM,
forwardDepthPrepass and directionalLightShadowsCascaded.  Kernels: B1 for
the sun shadow map (or the cascades), the clustered light shadow atlas
and the culled main view, B2 + B3 for the surface, B3 + B4 for lighting
(B4 takes the SSAO plane), B3T for the VSM sun term.  Config knobs keep
the reference's config.json names; a knob value the port does not
implement raises NotImplementedError.

Run:
  python -m granite_tpu_torch.app.scene_viewer --bench-scene \
      --config cfg.json --width 1920 --height 1080 --frames 12 \
      --device cuda --png-path out.png
  python -m granite_tpu_torch.app.scene_viewer --scene scene.gltf \
      --camera-index 0 --config cfg.json --frames 8 --png-path out.png
"""

from __future__ import annotations

import contextlib
import glob
import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..filesystem import Filesystem
from ..graph.debug import execute_debug
from ..graph.render_graph import (
    AttachmentInfo, BufferInfo, Queue, RenderGraph, SizeClass,
)
from ..kernels import build as K
from ..math.frustum import Frustum
from ..math.muglm import (
    look_at_matrix, perspective, quat_from_axis_angle, quat_normalize,
    quat_rotate,
)
from ..math.transforms import decompose_trs
from ..ops import hdr as HDR
from ..ops import raster as R
from ..ops import taa as TAA
from ..ops.clusterer import bin_lights_tiles, bin_lights_z, pack_lights
from ..ops.decals import (
    apply_decals, build_decal_strips, builtin_decal_image, pack_decals,
)
from ..ops.fsr2 import fsr2_jitter_phases, fsr2_upscale
from ..ops.fxaa import fxaa
from ..ops.hiz import build_hiz, occlusion_test, project_aabbs
from ..ops.light_shadows import FACE_DIRS, FACE_UPS, assign_slices, \
    pack_atlas, pack_atlas_vsm
from ..ops.shadow import (
    cascade_matrices, directional_shadow_matrix, shadow_uv_transform,
    vsm_moments,
)
from ..ops.smaa import smaa
from ..ops.srgb import encode_rgba8
from ..ops.ssao import ssao, upsample_ao
from ..ops.ssr import ssr
from ..ops.volumetric_fog import (
    DEFAULT_D, DEFAULT_H, DEFAULT_W, Z_RANGE, apply_fog,
    fog_accumulate, fog_light_density,
)
from ..renderer.environment import (
    Environment, analytic_sky, procedural_sky_equirect, sample_environment,
)
from ..renderer.ground import (
    GroundLOD, fbm_heightmap, flat_grid_mesh, ground_mesh,
)
from ..renderer.ocean import Ocean, OceanConfig
from ..renderer.render_context import RenderContext
from ..renderer.scene_renderer import (
    BLOCK_MORPH_SKIN, BLOCK_SKIN, PackedScene, fused_raster_surface,
    mesh_instances, motion_vectors, pack_scene, project, rasterize_objects,
    rasterize_scene, render_shadow_map, shade_surface_fused,
    surface_attributes, transform_vertices, transparent_composite,
    world_positions,
)
from ..renderer.suite import (
    Config as SuiteConfig, RendererSuite, Type as SuiteType,
)
from ..renderer.volumetric_diffuse import (
    FACE_DIRS as PROBE_FACE_DIRS, FACE_DV as PROBE_FACE_DV, bake_volume,
    fallback_cube_from_sky, volume_transforms,
)
from ..scene.animation import AnimationSystem
from ..scene.camera import FPSCamera
from ..scene.scene import (
    RENDERABLE_CASTS_SHADOW, RENDERABLE_DYNAMIC, RENDERABLE_OPAQUE,
    RENDERABLE_TRANSPARENT, Scene,
)
from ..scene.scene_formats import (
    ALPHA_MODE_BLEND, LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPOT,
    MaterialData, NodeData, SceneInfo,
)
from ..scene.scene_loader import SceneLoader
from ..ui.flat_renderer import composite_overlay
from ..ui.widgets import Label, UIManager, Window
from ..utils.image_io import save_png
from ..utils.logging import LOGI, LOGW
from ..utils.timeline_trace import ROOT, span, upload
from .application import Application
from .headless import headless_main

_MAPPING = {
    "renderer": "renderer", "msaa": "msaa",
    "directionalLightShadows": "directional_light_shadows",
    "directionalLightShadowsCascaded": "directional_light_cascaded_shadows",
    "directionalLightShadowsVSM": "directional_light_shadows_vsm",
    "clusteredLightsShadows": "clustered_lights_shadows",
    "clusteredLightsShadowsVSM": "clustered_lights_shadows_vsm",
    "clusteredLightsShadowsResolution": "clustered_lights_shadow_resolution",
    "clusteredLightsShadowsHalfRes": "clustered_lights_shadows_half_res",
    "ssao": "ssao", "ssr": "ssr", "volumetricFog": "volumetric_fog",
    "volumetricFogRegions": "volumetric_fog_regions",
    "volumetricDecals": "volumetric_decals",
    "volumetricDiffuse": "volumetric_diffuse",
    "volumetricDiffuseResolution": "volumetric_diffuse_resolution",
    "volumetricDiffuseFaceResolution": "volumetric_diffuse_face_resolution",
    "textureStreaming": "texture_streaming",
    "materialTileSampler": "material_tile_sampler",
    "materialTextures": "material_textures",
    "envTileSampler": "env_tile_sampler",
    "envSpecularHalfRes": "env_specular_half_res",
    "fusedShade": "fused_shade", "rasterMaxVisible": "raster_max_visible",
    "binPlanCache": "bin_plan_cache", "meshEncoding": "mesh_encoding",
    "shadowTermHalfRes": "shadow_term_half_res",
    "textureBudgetMB": "texture_budget_mb",
    "renderTargetFp16": "render_target_fp16",
    "rescaleScene": "rescale_scene",
    "resolutionScaleSharpen": "resolution_scale_sharpen",
    "forwardDepthPrepass": "forward_depth_prepass",
    "PCFKernelWide": "pcf_kernel_wide", "hdrBloom": "hdr_bloom",
    "hdrBloomDynamicExposure": "hdr_bloom_dynamic_exposure",
    "hdrBloomDepth": "hdr_bloom_depth",
    "shadowMapResolution": "shadow_map_resolution",
    "resolutionScale": "resolution_scale", "postAA": "post_aa",
    "lodBias": "lod_bias", "ocean": "ocean", "terrain": "terrain",
    "showUi": "show_ui", "occlusionCulling": "occlusion_culling",
}

# Vulkan-pipeline knobs the reference's design satisfies by construction;
# accepted and logged, as the JAX viewer does.
_BY_DESIGN = ("mergeSubpasses", "useTransientColor",
              "useTransientDepthStencil", "renderGraphForceSingleQueue",
              "queueWaitOnSubmission", "useAsyncComputePost",
              "forceNoSubgroups", "forceNoSubgroupShuffle",
              "forceNoSubgroupSizeControl", "instanceDeferredLights",
              "timestamp")

# postAA values that jitter the camera, and their phase tables (taaFSR2's
# Halton sequence depends on the render and display widths).
_JITTER_TABLES = {"taa": TAA.JITTER_TAA_8PHASE,
                  "taa-extreme": TAA.JITTER_TAA_16PHASE,
                  "smaaT2X": TAA.JITTER_SMAA_T2X,
                  "fxaa2phase": TAA.JITTER_FXAA_2PHASE}
_POST_AA = ("none", "fxaa", "smaa", "taaFSR2") + tuple(_JITTER_TABLES)


def _flag(v) -> str:
    return str(v).lower()


@dataclass
class ViewerConfig:
    """config.json knobs, the JAX viewer's names and defaults."""
    renderer: str = "forward"
    msaa: int = 1
    directional_light_shadows: bool = True
    directional_light_cascaded_shadows: bool = False
    directional_light_shadows_vsm: bool = False
    clustered_lights_shadows: bool = True
    clustered_lights_shadows_vsm: bool = False
    clustered_lights_shadow_resolution: int = 512
    clustered_lights_shadows_half_res: bool = True
    ssao: bool = False
    ssr: bool = False
    volumetric_fog: bool = False
    volumetric_fog_regions: bool = False
    volumetric_decals: bool = False
    volumetric_diffuse: bool = False
    volumetric_diffuse_resolution: int = 8
    volumetric_diffuse_face_resolution: int = 8
    texture_streaming: bool = False
    shadow_term_half_res: str = "false"
    material_tile_sampler: str = "auto"
    material_textures: bool = True
    env_tile_sampler: bool = True
    env_specular_half_res: bool = False
    fused_shade: str = "auto"
    raster_max_visible: int | str = 0
    bin_plan_cache: str = "false"
    mesh_encoding: str = "classic"
    texture_budget_mb: float = 0.0
    render_target_fp16: bool = False
    rescale_scene: bool = False
    resolution_scale_sharpen: bool = True
    forward_depth_prepass: bool = False
    pcf_kernel_wide: bool = False
    hdr_bloom: bool = True
    hdr_bloom_dynamic_exposure: bool = True
    hdr_bloom_depth: int = 6
    shadow_map_resolution: float = 2048.0
    resolution_scale: float = 1.0
    post_aa: str = "none"
    lod_bias: float = 0.0
    ocean: bool = False
    terrain: bool = False
    show_ui: bool = False
    occlusion_culling: bool = False
    unsupported: dict = field(default_factory=dict)

    @classmethod
    def from_json(cls, path: str) -> "ViewerConfig":
        cfg = cls()
        with open(path) as f:
            doc = json.load(f)
        for k, v in doc.items():
            if k in _MAPPING:
                setattr(cfg, _MAPPING[k], v)
            elif k in _BY_DESIGN:
                LOGI("config key '%s'=%s satisfied by design", k, v)
            else:
                cfg.unsupported[k] = v
                LOGW("config key '%s' not yet supported; ignored", k)
        return cfg

    def check_slice(self) -> None:
        """Raise NotImplementedError for knob values outside the port (the
        untiled environment, the bin-plan cache and the non-kernel
        routes); every other knob of the JAX viewer renders."""
        need = {
            "renderer": ("deferred", "forward"), "msaa": (1, 2, 4, 8),
            "env_tile_sampler": (True,),
            "mesh_encoding": ("classic", "meshlet"),
            "post_aa": _POST_AA,
        }
        for name, allowed in need.items():
            if getattr(self, name) not in allowed:
                raise NotImplementedError(
                    f"config {name}={getattr(self, name)!r} is not part of "
                    f"the port yet (supported: {allowed})")
        if not float(self.resolution_scale) > 0.0:
            raise ValueError(f"config resolution_scale="
                             f"{self.resolution_scale!r} must be > 0")
        # The port always takes the kernel route (B3 samplers, B4 shade).
        for name in ("material_tile_sampler", "fused_shade"):
            if _flag(getattr(self, name)) not in ("auto", "true"):
                raise NotImplementedError(
                    f"config {name}={getattr(self, name)!r}: the port has "
                    "only the kernel route")
        if _flag(self.bin_plan_cache) != "false":
            raise NotImplementedError("binPlanCache is not ported")
        if not isinstance(self.raster_max_visible, int) and \
                self.raster_max_visible != "auto":
            raise NotImplementedError("rasterMaxVisible takes an int (0 = no "
                                      'compaction) or "auto"')


def _add_child_node(info: SceneInfo, node: NodeData) -> int:
    """Append `node` as a child of the first root (or as the root)."""
    idx = len(info.nodes)
    info.nodes.append(node)
    if info.roots:
        info.nodes[info.roots[0]].children.append(idx)
    else:
        info.roots.append(idx)
    return idx


class SceneViewerApplication(Application):
    CLUSTER_Z_SLICES = 32
    CLUSTER_TILE = 64
    LIGHT_CAPACITY = 32
    DECAL_CAPACITY = 16
    DECAL_LAYERS = 2

    @staticmethod
    def add_cli(parser) -> None:
        parser.add_argument("--scene", type=str, default=None,
                            help="glTF/GLB scene or .scene composition")
        parser.add_argument("--config", type=str, default=None,
                            help="config.json path (reference schema)")
        parser.add_argument("--quirks", type=str, default=None,
                            help="quirks.json (accepted; knobs logged)")
        parser.add_argument("--camera-index", type=int, default=-1,
                            dest="camera_index",
                            help="the scene camera to render through "
                                 "(-1 frames the scene bounds)")
        parser.add_argument("--bench-scene", action="store_true",
                            dest="bench_scene",
                            help="use the Sponza-class synthetic scene "
                                 "(default: the golden images' test scene)")

    def __init__(self, args=None, device="cuda"):
        """args: namespace with `config` (path or None), `bench_scene`,
        `scene` (a .gltf, .glb or .scene path, or None), `camera_index`
        (-1 frames the scene bounds) and optionally `quirks` (a
        quirks.json path); device: 'cuda' (raises without a card) or
        'cpu'.  A camera index past the scene's cameras raises
        ValueError.  GRANITE_DEBUG_GRAPH set routes every frame through
        graph/debug.execute_debug (its per-pass host ms go to the hub's
        interval stats, `hub.stats`); GRANITE_WATCH_KERNELS set watches
        the kernel sources (post_frame).  The graph bake takes the
        shadow, surface and lighting executors from `renderer_suite`."""
        super().__init__(device)
        self.config = (ViewerConfig.from_json(args.config)
                       if args is not None and getattr(args, "config", None)
                       else ViewerConfig())
        self.config.check_slice()
        quirks = getattr(args, "quirks", None) if args is not None else None
        if quirks:
            # quirks.json (scene_viewer_application.cpp:130): workaround
            # toggles for Vulkan driver bugs; none applies to the port.
            with open(quirks) as f:
                for k, v in json.load(f).items():
                    LOGW("quirk '%s'=%s has no counterpart in the port; "
                         "ignored", k, v)
        scene_path = getattr(args, "scene", None) if args is not None \
            else None
        # A scene file's terrain settings (none: the defaults).
        self._terrain_cfg: dict = {}
        if args is not None and getattr(args, "bench_scene", False):
            from .bench_scene import build_bench_scene
            info = build_bench_scene()
            LOGI("Using Sponza-class bench scene")
        elif scene_path:
            loader = SceneLoader(scene_path)
            info = loader.get_scene()
            if loader.ocean_config is not None:
                self.config.ocean = True
            if loader.terrain_config is not None:
                self.config.terrain = True
                self._terrain_cfg = loader.terrain_config
            LOGI("Loaded scene %s", scene_path)
        else:
            from .bench_scene import build_default_test_scene
            info = build_default_test_scene()
            LOGI("Using procedural test scene")
        self.info = info
        self.ocean = None
        self.ground = None
        self._ocean_obj = -1
        self._ground_obj = -1
        if self.config.ocean:
            self._add_ocean(info)
        if self.config.terrain:
            self._add_terrain(info)
        self.scene = self._build_runtime_scene(info)
        if self.config.rescale_scene:
            self._rescale_scene()
        self.meshlet_meshes = 0
        if self.config.mesh_encoding == "meshlet":
            # Static meshes route through the MLT2 meshlet streams
            # (skinned / morphed meshes keep classic: their joints and
            # deltas have no stream), after the ocean and ground joined.
            for i, md in enumerate(info.meshes):
                if md.joints is None and md.morph_position_deltas is None \
                        and md.encoding == "classic":
                    info.meshes[i] = md.to_meshlets()
                    self.meshlet_meshes += 1
            LOGI("meshEncoding=meshlet: %d/%d meshes re-encoded",
                 self.meshlet_meshes, len(info.meshes))
        # textureBudgetMB bounds the decoded bytes of the streamed images
        # (AssetManager::set_asset_budget); 0 is no bound.
        budget = int(self.config.texture_budget_mb * 2**20) \
            if self.config.texture_budget_mb > 0 else None
        self.packed: PackedScene = pack_scene(
            info, device=self.device,
            texture_streaming=self.config.texture_streaming,
            texture_budget=budget)
        # The skinned meshes cast their sun shadows per frame: B1 sets up
        # and bins their triangles only.
        dynamic = (self.scene.r_flags & RENDERABLE_DYNAMIC) != 0
        self._has_dynamic_casters = bool(dynamic.any())
        self._dynamic_tris = torch.nonzero(
            self._t(dynamic, torch.bool)[self.packed.tri_object.long()]
        )[:, 0] if self._has_dynamic_casters else None
        self.animation_system = AnimationSystem(self.scene)
        for anim in info.animations:
            self.animation_system.start_animation(anim)
        if info.animations:
            LOGI("Playing %d animations", len(info.animations))
        v_node = self.packed.v_node
        if self.ocean is not None:
            # per-vertex mask of the ocean grid; water casts no shadow
            self._ocean_vmask = v_node == self._ocean_node
            self._ocean_obj = int(np.nonzero(
                self.packed.obj_node == self._ocean_node)[0][0])
        if self.ground is not None:
            # The LOD terrain displaces at transform time; the shadow path
            # has no camera, so the LOD ground only receives shadows (the
            # baked terrain keeps casting).
            self._ground_vmask = v_node == self._ground_node
            self._ground_obj = int(np.nonzero(
                self.packed.obj_node == self._ground_node)[0][0])
        # Decal images (RGBA float linear, one per tex id); None takes
        # the built-in decal image.  Read at swapchain_updated.
        self.decal_images = None
        self._decal_strips = None
        self.camera = self._setup_camera(
            getattr(args, "camera_index", -1) if args is not None else -1)
        self.context = RenderContext()
        self.graph = RenderGraph()
        self._history = None
        self._jitter = None
        self._mv_prev = None     # last frame's node world matrices
        self._sun_dir = np.array([0.35, 0.9, 0.25], np.float32)
        self._sun_dir /= np.linalg.norm(self._sun_dir)
        self._sun_color = np.array([3.0, 2.8, 2.5], np.float32)
        for nd in info.nodes:
            # a directional light of the scene gives the sun its colour
            if nd.light is not None and \
                    info.lights[nd.light].type == LIGHT_DIRECTIONAL:
                light = info.lights[nd.light]
                self._sun_color = light.color * light.intensity
        sky = dict(sun_dir=tuple(float(v) for v in self._sun_dir),
                   sun_color=tuple(float(v) for v in self._sun_color))
        self.environment = Environment(procedural_sky_equirect(128, **sky),
                                       sky_params=sky, device=self.device)
        self._param_cache = None
        self._static_shadow_cache = None
        self._orbit_cache = None
        # rasterMaxVisible "auto": the compaction capacity (None until the
        # first frame's census, 0 = uncapped) and the triangles an object
        self._auto_max_visible = None
        self._tris_per_object = None
        # render_frames_chained's checksum of its frames but the last
        self._last_chain_checksum = None
        self.raster_stats: dict = {}
        # occlusionCulling: the last frame's objects in the frustum,
        # rendered in each phase and culled (0-dim device tensors, read
        # without a sync)
        self.cull_counts: dict = {}
        # volumetricDiffuse: the baked volumes and the sky fallback,
        # baked once at the first swapchain_updated
        self._vol_diffuse = None
        self.bake_seconds = 0.0
        self.bake_stats: dict = {}
        # showUi: the stats window, built at the first frame
        self.ui_manager = None
        self._ui_stats_label = None
        # Hot reload (shader_manager's inotify watch): a changed
        # config.json is read again and the graph re-baked at post_frame.
        # The path is made absolute: the file protocol's root is "/".
        self._fs = Filesystem()
        self._reload_config = False
        self._config_path = getattr(args, "config", None) \
            if args is not None else None
        if self._config_path:
            self._config_path = os.path.abspath(self._config_path)
            self._fs.install_notification(self._config_path,
                                          self._config_changed)
        # GRANITE_DEBUG_GRAPH: breadcrumbs and the NaN/Inf scan, pass by
        # pass; the per-pass ms accumulate in the hub's interval stats.
        self._debug_graph = bool(os.environ.get("GRANITE_DEBUG_GRAPH"))
        self.last_breadcrumbs = None
        # The role -> pass executor registry the graph bake consults; a
        # role set with set_renderer stays across bakes.
        self.renderer_suite = RendererSuite()
        # GRANITE_WATCH_KERNELS: [path, mtime] of the op and renderer
        # modules and the CUDA sources (opt-in: runs stay deterministic).
        self._kernel_watch = []
        if os.environ.get("GRANITE_WATCH_KERNELS"):
            pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            for pat in ("ops/*.py", "renderer/*.py", "csrc/*.cu*"):
                for f in sorted(glob.glob(os.path.join(pkg, pat))):
                    self._kernel_watch.append([f, os.path.getmtime(f)])

    # -- scene ----------------------------------------------------------------
    def _add_ocean(self, info: SceneInfo) -> None:
        """Compose an FFT ocean into the scene (renderer/ocean.cpp;
        BASELINE config 5)."""
        self.ocean = Ocean(OceanConfig(), device=self.device)
        mat = len(info.materials)
        info.materials.append(MaterialData(
            name="ocean",
            base_color_factor=np.array([0.02, 0.07, 0.12, 1], np.float32),
            roughness_factor=0.15, metallic_factor=0.0))
        mesh = len(info.meshes)
        info.meshes.append(self.ocean.grid_mesh(mat))
        self._ocean_node = _add_child_node(info, NodeData(
            name="ocean", translation=np.array([0, -0.8, 0], np.float32),
            meshes=[mesh]))

    def _add_terrain(self, info: SceneInfo) -> None:
        """Compose a heightmap terrain (renderer/ground.cpp).  terrain
        {"lod": true} takes GroundLOD (a flat grid displaced per frame
        with per-vertex distance LOD); otherwise the displacement is
        baked into the vertex buffer at load."""
        tc = self._terrain_cfg
        world_size = float(tc.get("worldSize", 80.0))
        amplitude = float(tc.get("amplitude", 2.5))
        grid = int(tc.get("grid", 128))
        mat = len(info.materials)
        info.materials.append(MaterialData(
            name="ground",
            base_color_factor=np.array([0.25, 0.3, 0.12, 1], np.float32),
            roughness_factor=0.95, metallic_factor=0.0))
        mesh = len(info.meshes)
        hm = fbm_heightmap(amplitude=amplitude, seed=int(tc.get("seed", 0)))
        if tc.get("lod"):
            self.ground = GroundLOD(hm, world_size=world_size, grid=grid,
                                    max_lod=float(tc.get("maxLod", 5.0)),
                                    base_patch_size=int(
                                        tc.get("basePatchSize", 64)),
                                    device=self.device)
            md = flat_grid_mesh(world_size, grid, material=mat)
            md.aabb_max[1] = amplitude      # conservative displaced AABB
            info.meshes.append(md)
        else:
            info.meshes.append(ground_mesh(hm, world_size=world_size,
                                           grid=grid, material=mat))
        node = _add_child_node(info, NodeData(
            name="ground", translation=np.array([0, -1.5, 0], np.float32),
            meshes=[mesh]))
        if self.ground is not None:
            self._ground_node = node

    def _build_runtime_scene(self, info: SceneInfo) -> Scene:
        """Nodes and renderables for culling.  The renderables go in
        pack_scene's object order (its block key, plain | morph |
        morph+skin | skin), so a renderable's row is its packed object;
        the skinned ones are the dynamic shadow casters.  (The JAX viewer
        sorts on "skinned" alone, which parts from pack_scene's order
        when a morph-only mesh comes before a plain one.)"""
        s = Scene()
        parent = {c: i for i, nd in enumerate(info.nodes)
                  for c in nd.children}
        for i, nd in enumerate(info.nodes):
            s.create_node(parent=parent.get(i, -1),
                          translation=nd.translation, rotation=nd.rotation,
                          scale=nd.scale)
        for block, i, mesh_idx in mesh_instances(info):
            md = info.meshes[mesh_idx]
            mat = info.materials[md.material] if (
                0 <= md.material < len(info.materials)) else None
            transparent = mat is not None and \
                mat.alpha_mode == ALPHA_MODE_BLEND
            flags = RENDERABLE_CASTS_SHADOW | (
                RENDERABLE_TRANSPARENT if transparent else RENDERABLE_OPAQUE)
            if block in (BLOCK_MORPH_SKIN, BLOCK_SKIN):
                flags |= RENDERABLE_DYNAMIC
            s.add_renderable(i, mesh_idx, flags, md.aabb_min, md.aabb_max)
        s.update_transform_tree()
        return s

    def _rescale_scene(self) -> None:
        """rescaleScene (rescale_scene(10.0f), scene_viewer_application.cpp
        :491): scale the roots so the scene's AABB radius becomes 10."""
        self.scene.update_transform_tree()
        mn = self.scene.r_world_min.min(axis=0)
        mx = self.scene.r_world_max.max(axis=0)
        radius = max(0.5 * float(np.linalg.norm(mx - mn)), 1e-6)
        factor = 10.0 / radius
        for r in self.info.roots:
            self.scene.scale[r] = self.scene.scale[r] * factor
        self.scene.update_transform_tree()
        LOGI("rescaleScene: radius %.3f -> 10 (x%.3f)", radius, factor)

    def _setup_camera(self, camera_index: int) -> FPSCamera:
        """The scene camera `camera_index` (its fovy, depth range,
        orthographic extent and node's world transform), or with -1 a
        camera looking at the scene bounds from above, infinite far."""
        cam = FPSCamera()
        if camera_index >= len(self.info.cameras):
            raise ValueError(
                f"camera_index={camera_index}: the scene has "
                f"{len(self.info.cameras)} cameras")
        if camera_index >= 0:
            cd = self.info.cameras[camera_index]
            cam.set_fovy(cd.fovy)
            cam.set_depth_range(cd.znear, cd.zfar)
            if cd.ortho:
                cam.set_ortho(True, cd.xmag, cd.ymag)
            if cd.node is not None:
                w = self.scene.world[cd.node]
                cam.position = w[:3, 3].copy()
                _t, r, _s = decompose_trs(w)
                cam.rotation = quat_normalize(
                    np.array([r[0], -r[1], -r[2], -r[3]], np.float32))
            return cam
        self.scene.update_cached_transforms()
        mn = self.scene.r_world_min.min(axis=0)
        mx = self.scene.r_world_max.max(axis=0)
        center = 0.5 * (mn + mx)
        radius = max(0.5 * float(np.linalg.norm(mx - mn)), 1e-3)
        eye = center + np.array([0.6, 0.45, 0.9]) * radius * 1.2
        cam.look_at(eye, center)
        cam.set_depth_range(radius * 1e-3, 0.0)   # infinite far
        return cam

    def _t(self, a, dtype=torch.float32):
        return upload(np.asarray(a), dtype=dtype,
                      device=self.device)

    # -- graph ------------------------------------------------------------------
    def swapchain_updated(self, width: int, height: int) -> None:
        self.width, self.height = width, height
        self.camera.set_aspect(width / height)
        self._has_lights = any(
            nd.light is not None and self.info.lights[nd.light].type != 0
            for nd in self.info.nodes)
        self._has_transparent = bool(
            (self.packed.obj_flags & RENDERABLE_TRANSPARENT).any())
        zn = max(self.camera.znear, 1e-3)
        zf = self.camera.zfar if self.camera.zfar > 0 else 1000.0
        self._cluster_range = (zn, zf)
        self._has_decals = self.config.volumetric_decals and \
            bool(self.scene.decal_node)
        if self._has_decals and self._decal_strips is None:
            imgs = self.decal_images or [builtin_decal_image()]
            self._decal_strips = torch.as_tensor(build_decal_strips(imgs),
                                                 device=self.device)
        if self.config.volumetric_diffuse and self._vol_diffuse is None:
            self._bake_diffuse_volumes()
        if self.config.volumetric_fog_regions and \
                self.config.volumetric_fog and not self.scene.fog_region_node:
            # The reference viewer's default region
            # (scene_viewer_application.cpp:311-320): scale 40 at y = 20.
            node = self.scene.create_node(translation=(0.0, 20.0, 0.0),
                                          scale=(40.0, 40.0, 40.0))
            self.scene.create_volumetric_fog_region(node)
            self.scene.update_transform_tree()
        self._build_light_shadow_atlas()
        # The frame renders at resolutionScale x the display size; msaa
        # N > 1 is ordered-grid supersampling on top of it, as in the JAX
        # viewer: sqrt(N) x the scale, reduced by the tonemap's resize.
        rs = float(self.config.resolution_scale)
        if self.config.msaa > 1:
            rs = rs * float(np.sqrt(self.config.msaa))
        self._rw = max(int(width * rs), 1)
        self._rh = max(int(height * rs), 1)
        if self.config.renderer == "deferred" and self.config.ssr and (
                self._rw % 2 or self._rh % 2):
            # The JAX viewer's SSR stacks its half-res march grid with the
            # full-res depth and fails on an odd render size
            # (granite_tpu/ops/ssr.py:30, "All input arrays must have the
            # same shape").
            raise NotImplementedError(
                f"ssr at an odd render size {self._rw}x{self._rh} "
                "(resolutionScale, msaa): the JAX viewer fails there too")
        g = self.graph
        g.reset()
        g.set_backbuffer_dimensions(width, height)
        # renderTargetFp16: the HDR colour targets (lit frame, SSR, TAA /
        # FSR2 resolve and history, the bloom chain) are float16; the
        # graph casts each pass's output to its target's type.
        rt_dtype = torch.float16 if self.config.render_target_fp16 \
            else torch.float32

        def display(scale, channels, dtype=torch.float32):
            return AttachmentInfo(SizeClass.SWAPCHAIN_RELATIVE, scale, scale,
                                  channels=channels, dtype=dtype)

        def display_rt(scale, channels):
            return display(scale, channels, rt_dtype)

        def rel(scale, channels, dtype=torch.float32):
            return display(rs * scale, channels, dtype)

        def rel_rt(scale, channels):
            return rel(scale, channels, rt_dtype)

        # Temporal jitter for the TAA family (post/temporal.cpp); taaFSR2
        # upscales, smaaT2X and fxaa2phase add their LDR pass after TAA.
        aa = self.config.post_aa
        self._use_fsr2 = aa == "taaFSR2"
        self._use_taa = aa in _JITTER_TABLES or self._use_fsr2
        self._use_fxaa = aa in ("fxaa", "fxaa2phase")
        self._use_smaa = aa in ("smaa", "smaaT2X")
        self._jitter = None
        if self._use_taa:
            phases = fsr2_jitter_phases(self._rw, width) if self._use_fsr2 \
                else _JITTER_TABLES[aa]
            self._jitter = TAA.TemporalJitter(phases, self._rw, self._rh)

        # The RendererSuite (renderer.hpp:182-211): each surface, shadow
        # and lighting pass below takes its executor from the suite.
        c = self.config
        self.renderer_suite.set_default_renderers(self, SuiteConfig(
            pcf_kernel_wide=c.pcf_kernel_wide,
            directional_light_vsm=c.directional_light_shadows_vsm,
            forward_z_prepass=c.forward_depth_prepass,
            cascaded_directional_shadows=(
                c.directional_light_cascaded_shadows)))
        use_shadow = self.config.directional_light_shadows
        cascaded = self.config.directional_light_cascaded_shadows
        if use_shadow:
            # Cascades render 4 depth maps (the sun term is cascaded PCF,
            # VSM or not); otherwise one depth map, or its VSM moments.
            s = int(self.config.shadow_map_resolution)
            vsm = self.config.directional_light_shadows_vsm and not cascaded
            g.add_pass("shadow-main", Queue.GRAPHICS) \
                .add_external_input("world") \
                .add_depth_stencil_output(
                    "shadow-depth", AttachmentInfo(
                        SizeClass.ABSOLUTE, s, s, channels=2 if vsm else 1,
                        layers=4 if cascaded else 1)) \
                .set_execute(self.renderer_suite.shadow_renderer())
        if self.ocean is not None:
            n = self.ocean.config.fft_resolution
            g.add_pass("ocean-fft", Queue.ASYNC_COMPUTE) \
                .add_color_output("ocean-maps", AttachmentInfo(
                    SizeClass.ABSOLUTE, n, n, channels=5)) \
                .set_execute(self.ocean.fft_pass)
        if self.config.volumetric_fog:
            # Froxel fog volume: light density + accumulation in one pass;
            # the lit frame composites it.  The sun term is shadowed only
            # by a single plain depth map (not VSM, not cascades), as in
            # the reference.
            fog = g.add_pass("fog-volume", Queue.ASYNC_COMPUTE) \
                .add_storage_output("fog-volume", BufferInfo(
                    (DEFAULT_D, DEFAULT_H, DEFAULT_W, 4), torch.float32))
            if self._fog_reads_shadow():
                fog.add_texture_input("shadow-depth")
            fog.set_execute(self._fog_volume_pass)
        if self.config.renderer == "deferred":
            self._add_deferred_passes(g, rel, rel_rt, use_shadow)
        else:
            fwd = g.add_pass("forward", Queue.GRAPHICS) \
                .add_external_input("world") \
                .add_external_input("normal_mats") \
                .add_color_output("hdr", rel_rt(1, 3)) \
                .add_depth_stencil_output("depth-main", rel(1, 1))
            self._add_surface_outputs(fwd, rel)
            if self.config.volumetric_fog:
                fwd.add_texture_input("fog-volume")
            if use_shadow:
                fwd.add_texture_input("shadow-depth")
            if self.ocean is not None:
                fwd.add_texture_input("ocean-maps")
            fwd.set_execute(self.renderer_suite.main_geometry_renderer(
                deferred=False, motion_vectors=self._use_taa))

        hdr_name = "hdr-ssr" if self.config.renderer == "deferred" \
            and self.config.ssr else "hdr"
        self._lit_name = hdr_name
        post_rel_rt = rel_rt
        if self._use_fsr2:
            # Temporal upscale to display size; the HDR chain and the
            # tonemap then run at display size.
            post_rel_rt = display_rt
            g.add_pass("fsr2-upscale", Queue.GRAPHICS) \
                .add_texture_input(hdr_name) \
                .add_texture_input("depth-main") \
                .add_texture_input("mv") \
                .add_history_input("fsr2-history") \
                .add_color_output("hdr-resolved", display_rt(1, 3)) \
                .add_color_output("fsr2-history", display_rt(1, 4)) \
                .set_execute(self._fsr2_pass)
            hdr_name = "hdr-resolved"
        elif self._use_taa:
            # TAA resolve before the HDR chain, history in TAA space.
            g.add_pass("taa-resolve", Queue.GRAPHICS) \
                .add_texture_input(hdr_name) \
                .add_texture_input("depth-main") \
                .add_texture_input("mv") \
                .add_history_input("taa-history") \
                .add_color_output("hdr-resolved", rel_rt(1, 3)) \
                .add_color_output("taa-history", rel_rt(1, 3)) \
                .set_execute(self._taa_pass)
            hdr_name = "hdr-resolved"
        self._hdr_name = hdr_name

        if self.config.hdr_bloom:
            self._add_hdr_chain(g, post_rel_rt)
        self._ldr_aa = self._use_fxaa or self._use_smaa
        tm = g.add_pass("tonemap", Queue.GRAPHICS) \
            .add_texture_input(hdr_name)
        if self._ldr_aa:
            tm.add_color_output("ldr", AttachmentInfo(channels=3))
        else:
            tm.add_color_output("backbuffer",
                                AttachmentInfo(channels=4, dtype=torch.uint8))
        if self.config.hdr_bloom:
            tm.add_texture_input("bloom-final")
            tm.add_texture_input("luminance")
        tm.set_execute(self._tonemap_pass)
        self._display_size_hdr = self._use_fsr2 or (
            self._rw, self._rh) == (width, height)
        if self._display_size_hdr:
            # no resize to display size (nor its sharpen): the tonemap,
            # the UI composite and the encode are per pixel
            tm.set_row_banded()
        if self._ldr_aa:
            # FXAA / SMAA 1x on the tonemapped LDR target (post/aa.cpp).
            name = "fxaa" if self._use_fxaa else "smaa"
            g.add_pass(name, Queue.GRAPHICS) \
                .add_texture_input("ldr") \
                .add_color_output("backbuffer",
                                  AttachmentInfo(channels=4,
                                                 dtype=torch.uint8)) \
                .set_execute(self._fxaa_pass if self._use_fxaa
                             else self._smaa_pass)
        g.set_backbuffer_source("backbuffer")
        g.bake()
        g.log()
        self._history = g.initial_history(self.device)
        self._param_cache = None
        self._orbit_cache = None

    def reset_history(self) -> None:
        """Re-clear the carried history resources (TAA feedback, exposure
        adaptation, occlusion visibility) to their frame-0 state: the
        like-for-like start of a sequential and a chained run
        (tools/hw_verify.py)."""
        self._history = self.graph.initial_history(self.device)

    def _add_surface_outputs(self, p, rel) -> None:
        """Under TAA the surface pass (gbuffer or forward) reads last
        frame's node transforms and writes motion vectors; under
        occlusion culling it reads and writes the per-object visibility
        set (vis-history)."""
        if self._use_taa:
            p.add_external_input("prev_world")
            p.add_color_output("mv", rel(1, 2))
        if self.config.occlusion_culling:
            p.add_history_input("vis-history")
            p.add_storage_output("vis-history", BufferInfo(
                (self.packed.num_objects,), torch.bool))

    def _fog_reads_shadow(self) -> bool:
        """The fog volume's sun term reads the shadow map only when it is
        a single plain depth map."""
        c = self.config
        return c.directional_light_shadows and not (
            c.directional_light_cascaded_shadows
            or c.directional_light_shadows_vsm)

    def _add_deferred_passes(self, g, rel, rel_rt, use_shadow: bool) -> None:
        """G-buffer pass, [SSAO at half res,] the lighting resolve, [SSR]."""
        gb = g.add_pass("gbuffer", Queue.GRAPHICS) \
            .add_external_input("world") \
            .add_external_input("normal_mats") \
            .add_color_output("g-base", rel(1, 3)) \
            .add_color_output("g-normal", rel(1, 3)) \
            .add_color_output("g-pbr", rel(1, 2)) \
            .add_color_output("g-emissive", rel(1, 3)) \
            .add_color_output("g-pos", rel(1, 3)) \
            .add_depth_stencil_output("depth-main", rel(1, 1)) \
            .add_color_output("g-covered", rel(1, 1, torch.bool))
        self._add_surface_outputs(gb, rel)
        if self.ocean is not None:
            gb.add_texture_input("ocean-maps")
        gb.set_execute(self.renderer_suite.main_geometry_renderer(
            deferred=True, motion_vectors=self._use_taa))
        if self.config.ssao:
            g.add_pass("ssao", Queue.COMPUTE) \
                .add_texture_input("depth-main") \
                .add_color_output("ssao-output", rel(0.5, 1)) \
                .set_execute(self._ssao_pass)
        light = g.add_pass("lighting", Queue.GRAPHICS)
        for name in ("g-base", "g-normal", "g-pbr", "g-emissive", "g-pos",
                     "g-covered", "depth-main"):
            light.add_attachment_input(name)
        light.add_external_input("world").add_external_input("normal_mats") \
            .add_color_output("hdr", rel_rt(1, 3))
        if self.config.ssao:
            light.add_texture_input("ssao-output")
        if self.config.volumetric_fog:
            light.add_texture_input("fog-volume")
        if use_shadow:
            light.add_texture_input("shadow-depth")
        if self.ocean is not None:
            # the transparent queue re-runs the (displaced) transform
            light.add_texture_input("ocean-maps")
        light.set_execute(
            self.renderer_suite.get(SuiteType.DeferredLighting))
        if self.config.ssr:
            # Screen-space reflections over the lit frame (deferred only).
            g.add_pass("ssr", Queue.GRAPHICS) \
                .add_texture_input("hdr") \
                .add_texture_input("depth-main") \
                .add_texture_input("g-normal") \
                .add_texture_input("g-base") \
                .add_texture_input("g-pbr") \
                .add_color_output("hdr-ssr", rel_rt(1, 3)) \
                .set_execute(self._ssr_pass)

    def _add_hdr_chain(self, g, rel) -> None:
        """setup_hdr_postprocess: threshold at 1/2 res -> 4 downsamples
        (the first with temporal feedback) -> 2 upsamples; luminance with
        temporal smoothing."""
        depth = max(0, min(int(self.config.hdr_bloom_depth), 6))
        thresh = "bloom-final" if depth == 0 else "bloom-thresh"
        g.add_pass("bloom-threshold", Queue.GRAPHICS) \
            .add_texture_input(self._hdr_name) \
            .add_history_input("luminance") \
            .add_color_output(thresh, rel(0.5, 4)) \
            .set_execute(self._make_bloom_threshold(thresh)) \
            .set_row_banded()
        # banded: the threshold band's sum and count, one all_reduce
        g.add_pass("luminance", Queue.ASYNC_COMPUTE) \
            .add_texture_input(thresh) \
            .add_history_input("luminance") \
            .add_storage_output("luminance", BufferInfo((), torch.float32)) \
            .set_execute(self._make_luminance(thresh)) \
            .set_row_banded()
        prev = thresh
        for i, s in enumerate([0.25, 0.125, 0.0625, 0.03125][:depth]):
            name = "bloom-final" if depth == i + 1 else f"bloom-d{i}"
            p = g.add_pass(f"bloom-down{i}", Queue.COMPUTE) \
                .add_texture_input(prev) \
                .add_color_output(name, rel(s, 4))
            if i == 0:
                p.add_history_input(name)
            p.set_execute(self._make_bloom_down(i, prev, name))
            prev = name
        for j, s in enumerate([0.0625, 0.125][:max(depth - 4, 0)]):
            name = "bloom-final" if depth == 5 + j else f"bloom-u{j}"
            g.add_pass(f"bloom-up{j}", Queue.COMPUTE) \
                .add_texture_input(prev) \
                .add_color_output(name, rel(s, 4)) \
                .set_execute(self._make_bloom_up(prev, name))
            prev = name

    # -- passes -----------------------------------------------------------------
    def _shadow_pass(self, ctx):
        """Under cascades, B1 rasterizes the four camera-fitted maps every
        frame over the static and dynamic casters together (posed by the
        skin palette and morph weights; no static cache).  Otherwise the
        cached static sun map, or under VSM its baked moments.  With
        dynamic casters, B1 rasterizes the visible ones (posed by this
        frame's skin palette and morph weights) into a map of their own
        each frame, composited onto the static map with max (reverse Z:
        the greater depth is the closer); VSM then blurs the moments of
        the composite each frame."""
        p = ctx.params
        if self.config.directional_light_cascaded_shadows:
            maps = []
            for c in range(p["cascade_vps"].shape[0]):
                depth, stats = render_shadow_map(
                    self.packed, ctx.input("world"), p["cascade_vps"][c],
                    int(self.config.shadow_map_resolution),
                    p["shadow_mask"], skin_palette=p.get("skin_palette"),
                    morph_weights=p.get("morph_weights"), with_stats=True)
                self.raster_stats[f"shadow-cascade{c}"] = stats
                maps.append(depth)
            return {"shadow-depth": torch.stack(maps)}
        vsm = self.config.directional_light_shadows_vsm
        if not self._has_dynamic_casters:
            return {"shadow-depth": p["static_vsm_moments"] if vsm
                    else p["static_shadow_depth"]}
        dyn, stats = render_shadow_map(
            self.packed, ctx.input("world"), p["shadow_vp"],
            int(self.config.shadow_map_resolution),
            p["dynamic_shadow_mask"], skin_palette=p.get("skin_palette"),
            morph_weights=p.get("morph_weights"), with_stats=True,
            tris=self._dynamic_tris)
        self.raster_stats["shadow-dynamic"] = stats
        depth = torch.maximum(p["static_shadow_depth"], dyn)
        return {"shadow-depth": vsm_moments(depth) if vsm else depth}

    def _transform(self, ctx):
        """Vertex transform with the ocean's and the LOD terrain's
        displacers, when the scene has them."""
        p = ctx.params
        fns = []
        if self.ocean is not None:
            maps = ctx.input("ocean-maps")
            fns.append(lambda pos, nrm: self.ocean.displace(
                pos, nrm, self._ocean_vmask, maps,
                camera_pos=p["camera_pos"]))
        if self.ground is not None:
            fns.append(lambda pos, nrm: self.ground.displace(
                pos, nrm, self._ground_vmask, p["camera_pos"]))
        displace_fn = None
        if fns:
            def displace_fn(pos, nrm):
                for f in fns:
                    pos, nrm = f(pos, nrm)
                return pos, nrm
        with span("raster.transform"):
            return transform_vertices(self.packed, ctx.input("world"),
                                      ctx.input("normal_mats"),
                                      p["view_proj"],
                                      skin_palette=p.get("skin_palette"),
                                      morph_weights=p.get("morph_weights"),
                                      displace_fn=displace_fn)

    def _resolved_max_visible(self):
        mv = self.config.raster_max_visible
        if mv == "auto":
            mv = self._auto_max_visible or 0
        return mv if mv > 0 else None

    def _update_auto_max_visible(self, masks) -> None:
        """rasterMaxVisible "auto" (the JAX viewer's rule): the capacity
        of the visibility compaction is 1.5x the worst visible-object
        triangle count over `masks`, rounded up to 8192, and 0 (no
        compaction) at or above the scene total.  It only grows: it never
        shrinks and never leaves 0, so a frame never drops geometry that
        an earlier frame kept.  JAX re-traces its compiled frame on a
        growth; here nothing needs to follow one: the G-buffer pass reads
        the capacity when it runs, bin_triangles sizes its buffers on each
        call, and no cached params, orbit bank or raster buffer carries
        it."""
        if self._tris_per_object is None:
            self._tris_per_object = np.bincount(
                self.packed.tri_object.cpu().numpy(),
                minlength=self.packed.num_objects)
        worst = max(int(self._tris_per_object[m].sum()) for m in masks)
        total = int(self.packed.indices.shape[0])
        cap = max(8192, -(-int(worst * 1.5) // 8192) * 8192)
        cap = 0 if cap >= total else cap
        prev = self._auto_max_visible
        if prev is not None and (prev == 0 or (cap != 0 and cap <= prev)):
            return
        self._auto_max_visible = cap

    def _raster_surface(self, ctx, xf, stats_key: str):
        """Raster + resolve (B2) + material fetch (B3) of the opaque
        queue -> (surf, depth, extra pass outputs).  Under occlusion
        culling: the two-phase cull's visibility buffer (B1 in each
        phase), the classic resolve and B3, and the next frame's
        vis-history."""
        clip, wpos, wnrm, wtan = xf
        # Under TAA the resolve also carries each surface's last-frame
        # world position (B2's PLANE_PREV: last frame's node transforms,
        # skin palette and morph weights) for the motion vectors.
        p = ctx.params
        prev_wpos = world_positions(
            self.packed, ctx.input("prev_world"), p.get("prev_skin_palette"),
            p.get("prev_morph_weights")) if self._use_taa else None
        if self.config.occlusion_culling:
            setup, depth, tri, vis = self._two_phase_visibility(ctx, clip)
            surf = surface_attributes(
                self.packed, setup, tri, wpos, wnrm, wtan, self._rw,
                self._rh, lod_bias=self.config.lod_bias,
                prev_world_pos=prev_wpos,
                material_textures=self.config.material_textures)
            return surf, depth, {"vis-history": vis}
        surf, depth, stats = fused_raster_surface(
            self.packed, clip, ctx.params["object_mask"], wpos, wnrm, wtan,
            self._rw, self._rh, lod_bias=self.config.lod_bias,
            prev_world_pos=prev_wpos,
            max_visible=self._resolved_max_visible(),
            material_textures=self.config.material_textures)
        self.raster_stats[stats_key] = stats
        return surf, depth, {}

    def _two_phase_visibility(self, ctx, clip):
        """Two-phase HiZ occlusion culling (scene_renderer.hpp:132
        CullingPhase First/Second, meshlet_cull.comp): phase 1 rasterizes
        last frame's visible set, a HiZ pyramid is built from its depth,
        phase 2 rasterizes the other frustum-visible objects that pass
        the test against it (or reach behind the near plane); the phases
        merge on depth, and the next frame's visible set is tested
        against the final depth.  Both phases run B1 through
        rasterize_objects (CULL_BACK, no compaction: rasterMaxVisible is
        not read here, as in the reference's classic route).
        -> (setup, depth, tri, vis)."""
        p = ctx.params
        w, h = self._rw, self._rh
        prev_vis = ctx.history("vis-history")
        setup = R.setup_triangles(clip, self.packed.indices, w, h)
        rmin, rmax, maxz, behind = project_aabbs(
            p["obj_world_min"], p["obj_world_max"], p["view_proj"], w, h)

        def raster_with(mask, phase: int):
            _setup, depth, tri, stats = rasterize_objects(
                self.packed, setup, mask, w, h)
            self.raster_stats[f"occlusion-phase{phase}"] = stats
            return depth, tri

        object_mask = p["object_mask"]
        m1 = object_mask & prev_vis
        depth1, tri1 = raster_with(m1, 1)
        occ2 = occlusion_test(build_hiz(depth1), rmin, rmax, maxz, w, h) \
            | behind
        m2 = object_mask & ~prev_vis & occ2
        depth2, tri2 = raster_with(m2, 2)
        closer2 = depth2 > depth1
        depth = torch.where(closer2, depth2, depth1)
        tri = torch.where(closer2, tri2, tri1)
        vis = occlusion_test(build_hiz(depth), rmin, rmax, maxz, w, h) \
            | behind
        self.cull_counts = {"in_frustum": object_mask.sum(),
                            "phase1": m1.sum(), "phase2": m2.sum(),
                            "culled": (object_mask & ~m1 & ~m2).sum()}
        return setup, depth, tri, vis

    def _lit_color(self, ctx, surf, depth, xf=None, ao=None):
        """Lighting (B4, with the AO plane when given) of a surf dict, the
        transparent queue forward-shaded over it, then fog -> hdr.
        xf: the vertex transform, when the caller already has it."""
        kw = self.light_kwargs(
            ctx.params, ctx.input("shadow-depth")
            if self.config.directional_light_shadows else None)
        color = shade_surface_fused(surf, ctx.params, ao=ao, **kw)
        color = self._apply_transparent(ctx, color, depth, xf, kw)
        if self.config.volumetric_fog:
            # Reverse-Z, infinite far: view depth = znear / ndc z; the
            # background takes the whole fog range.
            zn = max(self.camera.znear, 1e-3)
            world_z = torch.where(depth > 1e-8, zn / depth.clamp_min(1e-8),
                                  torch.full_like(depth, Z_RANGE))
            color = apply_fog(color, world_z, ctx.input("fog-volume"))
        return color

    def _apply_transparent(self, ctx, hdr, depth, xf, kw):
        """The transparent queue forward-shaded over the lit frame
        (Queue::Transparent; the suite's ForwardTransparent role).  xf:
        the vertex transform or None; kw: the lit frame's light_kwargs."""
        if not self._has_transparent:
            return hdr
        clip, wpos, wnrm, wtan = xf if xf is not None \
            else self._transform(ctx)
        kw = {k: v for k, v in kw.items()
              if k not in ("background", "width", "height")}
        # The reference shades this queue with its classic shade_surface,
        # which fetches the specular environment at full resolution.
        kw["env"] = {k: v for k, v in kw["env"].items() if k != "half_res"}
        return transparent_composite(
            self.packed, clip, depth, hdr, ctx.params["transparent_mask"],
            ctx.params, self._rw, self._rh, world_pos=wpos,
            world_normal=wnrm, world_tangent=wtan, **kw)

    def _motion_vectors(self, ctx, surf, depth):
        p = ctx.params
        return motion_vectors(surf["prev_pos"], surf["covered"], depth,
                              p["prev_vp_uv"], p["taa_reproj"], self._rw,
                              self._rh)

    def _apply_decals(self, ctx, surf):
        """Mix volumetric decals into the resolved base color before
        lighting (apply_volumetric_decals, volumetric_decal.h:22), inside
        a `decals` span so torch.profiler times the blend on its own."""
        if not self._has_decals:
            return surf
        p = ctx.params
        with span("decals"):
            base, alpha = apply_decals(
                surf["base_color"], surf["alpha"], surf["pos"], p["decals"],
                p["decal_strips"], layers=self.DECAL_LAYERS)
            out = dict(surf)
            cov = surf["covered"]
            out["base_color"] = torch.where(cov[..., None], base,
                                            surf["base_color"])
            out["alpha"] = torch.where(cov, alpha, surf["alpha"])
        return out

    def _forward_pass(self, ctx):
        """The forward renderer: surface and lighting in one pass."""
        xf = self._transform(ctx)
        surf, depth, out = self._raster_surface(ctx, xf, "forward")
        surf = self._apply_decals(ctx, surf)
        out.update({"hdr": self._lit_color(ctx, surf, depth, xf),
                    "depth-main": depth})
        if self._use_taa:
            out["mv"] = self._motion_vectors(ctx, surf, depth)
        return out

    def _gbuffer_pass(self, ctx):
        surf, depth, out = self._raster_surface(ctx, self._transform(ctx),
                                                "gbuffer")
        surf = self._apply_decals(ctx, surf)
        out.update({
            "g-base": surf["base_color"], "g-normal": surf["normal"],
            "g-pbr": torch.stack([surf["metallic"], surf["roughness"]],
                                 dim=-1),
            "g-emissive": surf["emissive"], "g-pos": surf["pos"],
            "depth-main": depth, "g-covered": surf["covered"]})
        if self._use_taa:
            out["mv"] = self._motion_vectors(ctx, surf, depth)
        return out

    def _on_here(self, v) -> bool:
        """A true/false/"auto" knob as the reference reads it: "auto" is on
        on the accelerator (here the card), off on the CPU."""
        if isinstance(v, bool):
            return v
        return _flag(v) == "true" or (_flag(v) == "auto"
                                      and self.device.type == "cuda")

    def light_kwargs(self, params, shadow_map):
        """Keyword arguments of shade_surface_fused for this frame."""
        p = params
        # materialTileSampler picks the reference's routes: the tiled
        # half-res VSM term through B3T or the classic per-pixel term, and
        # the specular environment at full resolution (at every other
        # pixel, upsampled, under envSpecularHalfRes) or the untiled route's
        # every other pixel (B3 fetches materials and environment on every
        # device).
        tiled = self._on_here(self.config.material_tile_sampler)
        kw = dict(shadow_map=shadow_map,
                  shadow_uv_mat=p["shadow_uv_mat"],
                  width=self._rw, height=self._rh, background=None,
                  pcf_wide=self.config.pcf_kernel_wide,
                  shadow_tiled=(
                      self.config.directional_light_shadows_vsm and tiled),
                  shadow_half_res=self._on_here(
                      self.config.shadow_term_half_res),
                  env={"strips": self.environment.strips,
                       "sh": self.environment.sh,
                       "levels": self.environment.num_levels,
                       "sky_params": self.environment.sky_params,
                       "tiled": tiled,
                       "half_res": self.config.env_specular_half_res},
                  vol_diffuse=self._vol_diffuse)
        if self._has_lights:
            zn, zf = self._cluster_range
            kw.update(lights=p["lights"], z_masks=p["z_masks"],
                      tile_masks=p["tile_masks"], z_near=zn, z_far=zf,
                      cluster_shadows=self._cluster_shadow)
        return kw

    def _lighting_pass(self, ctx):
        surf = {"base_color": ctx.input("g-base"),
                "normal": ctx.input("g-normal"),
                "metallic": ctx.input("g-pbr")[..., 0],
                "roughness": ctx.input("g-pbr")[..., 1],
                "emissive": ctx.input("g-emissive"),
                "pos": ctx.input("g-pos"),
                "covered": ctx.input("g-covered")}
        ao = upsample_ao(ctx.input("ssao-output"), self._rh, self._rw) \
            if self.config.ssao else None
        return {"hdr": self._lit_color(ctx, surf, ctx.input("depth-main"),
                                       ao=ao)}

    def _fog_volume_pass(self, ctx):
        p = ctx.params
        shadow = ctx.input("shadow-depth") if self._fog_reads_shadow() \
            else None
        regions = None
        if self.config.volumetric_fog_regions and \
                self.scene.fog_region_node:
            regions = [(volume_transforms(self.scene.world[node])[0], vol)
                       for node, vol in zip(self.scene.fog_region_node,
                                            self.scene.fog_region_volume)]
        density = fog_light_density(
            p["inv_view_proj"], self.camera.get_projection(),
            p["camera_pos"], p["sun_dir"], p["sun_color"],
            shadow_map=shadow, shadow_uv_mat=p["shadow_uv_mat"],
            lights=p.get("lights"), regions=regions)
        return {"fog-volume": fog_accumulate(density)}

    def _ssao_pass(self, ctx):
        proj = self.camera.get_projection()
        # half-res pixels per world unit at view depth 1
        proj_scale = 0.25 * self._rh * abs(float(proj[1, 1]))
        return {"ssao-output": ssao(ctx.input("depth-main"),
                                    z_near=max(self.camera.znear, 1e-3),
                                    proj_scale=proj_scale)}

    def _ssr_pass(self, ctx):
        pbr = ctx.input("g-pbr")
        return {"hdr-ssr": ssr(
            ctx.input("hdr"), ctx.input("depth-main"), ctx.input("g-normal"),
            ctx.input("g-base"), pbr[..., 0], pbr[..., 1],
            ctx.params["view"], self.camera.get_projection(), self._rw,
            self._rh)}

    def _taa_pass(self, ctx):
        out, hist = TAA.taa_resolve(
            ctx.input(self._lit_name), ctx.history("taa-history"),
            ctx.input("depth-main"), ctx.params["taa_reproj"], self._rw,
            self._rh, mv=ctx.input("mv"))
        return {"hdr-resolved": out, "taa-history": hist}

    def _fsr2_pass(self, ctx):
        out, hist = fsr2_upscale(
            ctx.input(self._lit_name), ctx.input("depth-main"),
            ctx.input("mv"), ctx.history("fsr2-history"),
            ctx.params["fsr2_jitter"], self.height, self.width)
        return {"hdr-resolved": out, "fsr2-history": hist}

    def _make_bloom_threshold(self, dst: str):
        def ex(ctx):
            h, w = ctx.size(dst)
            avg_lin = torch.exp2(ctx.history("luminance"))
            return {dst: HDR.bloom_threshold(
                ctx.input(self._hdr_name), avg_lin, h, w,
                dynamic_exposure=self.config.hdr_bloom_dynamic_exposure,
                rows=ctx.rows(dst))}
        return ex

    def _make_luminance(self, src: str):
        def ex(ctx):
            return {"luminance": HDR.average_log_luminance(
                ctx.input(src), ctx.history("luminance"),
                ctx.params["frame_time"],
                mean=lambda values: ctx.mean(src, values))}
        return ex

    def _make_bloom_down(self, i: int, src: str, dst: str):
        def ex(ctx):
            h, w = ctx.size(dst)
            return {dst: HDR.bloom_downsample(
                ctx.input(src), h, w,
                history=ctx.history(dst) if i == 0 else None,
                frame_time=ctx.params["frame_time"] if i == 0 else None)}
        return ex

    def _make_bloom_up(self, src: str, dst: str):
        def ex(ctx):
            h, w = ctx.size(dst)
            return {dst: HDR.bloom_upsample(ctx.input(src), h, w)}
        return ex

    def _tonemap_pass(self, ctx):
        # rows: this rank's band of the output (row-banded frames only)
        rows = ctx.rows("ldr" if self._ldr_aa else "backbuffer")
        bloom = avg_log = None
        if self.config.hdr_bloom:
            bloom = ctx.input("bloom-final")
            if self.config.hdr_bloom_dynamic_exposure:
                avg_log = ctx.input("luminance")
        ldr = HDR.tonemap(ctx.input(self._hdr_name), bloom, avg_log,
                          rows=rows)
        if not self._display_size_hdr:
            # Render size to display size (msaa's reduction too), then the
            # post-upscale sharpen.
            ldr = HDR.resize_bilinear(ldr, self.height, self.width)
            if self.config.resolution_scale_sharpen:
                ldr = HDR.sharpen(ldr)
        if self.config.show_ui:
            # The UI overlay (the host-rendered widget tree), blended on
            # the display-size frame before the LDR AA or the encode.
            overlay = ctx.params["ui_overlay"]
            ldr = composite_overlay(
                ldr, overlay if rows is None else overlay[rows[0]:rows[1]])
        if self._ldr_aa:
            return {"ldr": ldr.clamp(0.0, 1.0)}
        return {"backbuffer": encode_rgba8(ldr)}

    def _fxaa_pass(self, ctx):
        return {"backbuffer": encode_rgba8(
            fxaa(ctx.input("ldr"), self.width, self.height))}

    def _smaa_pass(self, ctx):
        return {"backbuffer": encode_rgba8(smaa(ctx.input("ldr")))}

    # -- lights and shadows -----------------------------------------------------
    def _positional_lights(self):
        """(node world matrix, LightData) of every point/spot light."""
        return [(self.scene.world[i], self.info.lights[nd.light])
                for i, nd in enumerate(self.info.nodes)
                if nd.light is not None
                and self.info.lights[nd.light].type in (LIGHT_POINT,
                                                        LIGHT_SPOT)]

    def light_shadow_slices(self):
        """The clustered shadow atlas's views from the current pose:
        (light infos, assign_slices' (vps, slice, kind), and per atlas
        slice its (light view-proj, caster mask)); None without lights."""
        self.scene.update_transform_tree()
        self.scene.update_cached_transforms()
        infos = []
        for w, light in self._positional_lights():
            d = -w[:3, 2]
            infos.append({
                "pos": w[:3, 3].astype(np.float32),
                "dir": (d / max(np.linalg.norm(d), 1e-9)).astype(np.float32),
                "radius": float(light.range if light.range > 0 else 100.0),
                "outer": float(light.outer_cone),
                "is_spot": light.type == LIGHT_SPOT})
        if not infos:
            return None
        assigned = assign_slices(infos)
        vps = assigned[0]
        caster = (self.packed.obj_flags & RENDERABLE_CASTS_SHADOW) != 0
        mn, mx = self.scene.r_world_min, self.scene.r_world_max
        views = []
        si = 0
        for li in infos:
            dist = np.linalg.norm(np.clip(li["pos"], mn, mx) - li["pos"],
                                  axis=1)
            mask = self._t(caster & (dist <= li["radius"]), torch.bool)
            nslices = 1 if li["is_spot"] else 6
            views += [(vps[si + f], mask) for f in range(nslices)]
            si += nslices
        return infos, assigned, views

    def _build_light_shadow_atlas(self):
        """Clustered light shadow atlas, rendered once (kernel B1) from the
        current pose and cached, as in the reference viewer."""
        self._cluster_shadow = None
        if not (self._has_lights and self.config.clustered_lights_shadows):
            return
        found = self.light_shadow_slices()
        if found is None:
            return
        infos, (vps, slice_np, kind_np), views = found
        size = int(self.config.clustered_lights_shadow_resolution)
        world = self._t(self.scene.world[:self.scene.num_nodes])
        palette = self._skin_palette()
        slices = [render_shadow_map(self.packed, world, vp, size, mask,
                                    skin_palette=palette)
                  for vp, mask in views]
        pack = pack_atlas_vsm if self.config.clustered_lights_shadows_vsm \
            else pack_atlas
        self._cluster_shadow = {
            "atlas_flat": pack(torch.stack(slices)),
            "vps_np": vps, "size": size,
            "light_slice_np": slice_np, "light_kind_np": kind_np,
            "light_pos_np": np.stack([li["pos"] for li in infos]),
            "num_lights": len(infos), "k": 2,
            "half_res": bool(self.config.clustered_lights_shadows_half_res)}
        LOGI("Clustered shadow atlas: %d lights, %d slices at %d^2",
             len(infos), len(slices), size)

    def _bake_diffuse_volumes(self):
        """Bake the ambient-cube probe grid of every diffuse volume of the
        scene (VolumetricDiffuseLightManager::refresh, done once here
        instead of incrementally over frame layers); with none declared,
        declare_diffuse_volume's.  Each probe renders 6 faces
        (probe_face, then B4 with the sun and the sky)."""
        t0 = time.monotonic()
        scene = self.scene
        self.declare_diffuse_volume()
        bake = self.bake_inputs()
        fr = bake["face_res"]

        def render_face(pos, face):
            surf, params = self.probe_face(bake, pos, face)
            return shade_surface_fused(surf, params, width=fr, height=fr,
                                       env=bake["env"])

        volumes = [bake_volume(render_face, scene.world[node], res,
                               face_res=fr)
                   for node, res in zip(scene.diffuse_volume_node,
                                        scene.diffuse_volume_res)]

        def sky(dirs):
            if self.environment.sky_params:
                return analytic_sky(dirs, **self.environment.sky_params)
            return sample_environment(self.environment.strips, dirs,
                                      torch.zeros(dirs.shape[:-1],
                                                  device=dirs.device))

        self._vol_diffuse = {"volumes": volumes,
                             "fallback": fallback_cube_from_sky(
                                 sky, device=self.device)}
        # B1's overflow and clamp counters summed over the faces
        self.bake_stats = bake["stats"]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.bake_seconds = time.monotonic() - t0
        LOGI("Baked %d volumetric diffuse volume(s), probe res %s, faces "
             "%d^2, in %.2f s", len(volumes), scene.diffuse_volume_res, fr,
             self.bake_seconds)

    def declare_diffuse_volume(self) -> None:
        """With no diffuse volume declared, one over the scene bounds, as
        the reference viewer does (scene_viewer_application.cpp:300-309),
        at volumetricDiffuseResolution along its longest side."""
        scene = self.scene
        if scene.diffuse_volume_node:
            return
        mn = scene.r_world_min.min(axis=0)
        mx = scene.r_world_max.max(axis=0)
        ext = np.maximum(mx - mn, 1e-3) * 1.1
        node = scene.create_node(translation=0.5 * (mn + mx), scale=ext)
        rx = int(self.config.volumetric_diffuse_resolution)
        res = tuple(max(int(round(rx * r)), 2) for r in ext / ext.max())
        scene.create_volumetric_diffuse_light(res, node)
        scene.update_transform_tree()

    def bake_inputs(self) -> dict:
        """What every face of the diffuse bake shares: the scene's world
        vertices (transformed once, in the current pose), the opaque
        objects' mask, the face size, the projection (90 degrees, near
        0.05, infinite far) and the environment (the reference bake's
        untiled specular route: its env carries no tile sampler)."""
        n = self.scene.num_nodes
        world = self.scene.world[:n]
        _clip, *verts = transform_vertices(
            self.packed, self._t(world),
            self._t(np.linalg.inv(world[:, :3, :3]).transpose(0, 2, 1)
                    .astype(np.float32)), torch.eye(4, device=self.device))
        return {"verts": verts, "stats": {},
                "mask": self._t((self.packed.obj_flags & RENDERABLE_OPAQUE)
                                != 0, torch.bool),
                "face_res": int(self.config.volumetric_diffuse_face_resolution),
                "proj": perspective(np.pi / 2, 1.0, 0.05),
                "env": {"strips": self.environment.strips,
                        "sh": self.environment.sh,
                        "levels": self.environment.num_levels,
                        "sky_params": self.environment.sky_params,
                        "tiled": False}}

    def probe_face_view(self, bake: dict, pos, face: int):
        """Cube face `face` of a probe at `pos` -> (its view-projection,
        the scene's clip-space vertices through it)."""
        view = look_at_matrix(pos, pos + PROBE_FACE_DIRS[face],
                              -PROBE_FACE_DV[face])
        vp = (bake["proj"] @ view).astype(np.float32)
        return vp, project(bake["verts"][0], self._t(vp))

    def probe_face(self, bake: dict, pos, face: int):
        """One cube face of a probe at `pos`: B1 over the opaque objects
        (in triangle chunks: a face is one tile, whose list could pass
        the walk's clamp), the classic resolve and B3 -> (surf, shading
        params).  B1's overflow and clamp counters add up in
        bake["stats"]."""
        wpos, wnrm, wtan = bake["verts"]
        fr = bake["face_res"]
        vp, clip = self.probe_face_view(bake, pos, face)
        setup, _depth, tri, stats = rasterize_scene(
            self.packed, clip, bake["mask"], fr, fr)
        totals = bake["stats"]
        for k in ("visible_overflow", "huge_overflow", "clamped_entries"):
            totals[k] = totals.get(k, 0) + stats[k]
        surf = surface_attributes(self.packed, setup, tri, wpos, wnrm, wtan,
                                  fr, fr)
        return surf, {"camera_pos": self._t(pos),
                      "inv_view_proj": self._t(
                          np.linalg.inv(vp).astype(np.float32)),
                      "sun_dir": self._t(self._sun_dir),
                      "sun_color": self._t(self._sun_color)}

    def _collect_lights(self):
        pos, col, rad, dirs, inner, outer, spot = [], [], [], [], [], [], []
        for w, light in self._positional_lights():
            pos.append(w[:3, 3])
            col.append(light.color * light.intensity)
            rad.append(light.range if light.range > 0 else 100.0)
            dirs.append(-w[:3, 2] / max(np.linalg.norm(w[:3, 2]), 1e-9))
            inner.append(light.inner_cone)
            outer.append(light.outer_cone)
            spot.append(1.0 if light.type == LIGHT_SPOT else 0.0)
        if not pos:
            return None
        cap = min(self.LIGHT_CAPACITY, max(8, -(-len(pos) // 8) * 8))
        return pack_lights(np.asarray(pos), np.asarray(col),
                           np.asarray(rad), np.asarray(dirs),
                           np.asarray(inner), np.asarray(outer),
                           np.asarray(spot), capacity=cap,
                           device=self.device)

    def _skin_palette(self):
        """This pose's joint matrices, world[joint] @ inverse_bind of
        every skin, concatenated (SkinnedMesh::get_world_transforms), on
        the device; None without skins."""
        if not self.info.skins:
            return None
        mats = [np.matmul(self.scene.world[sk.joints], sk.inverse_bind)
                for sk in self.info.skins]
        return self._t(np.concatenate(mats).astype(np.float32))

    def _morph_weights(self):
        """This frame's (instances, targets) morph weights of the packed
        morph instances: the animation's weights channel where it has
        written one, else the node's or mesh's defaults; None without
        morph targets."""
        if self.packed.morph_deltas is None:
            return None
        defaults = self.packed.morph_default_weights
        mt = defaults.shape[1]
        rows = []
        for i, node in enumerate(self.packed.morph_nodes):
            w = self.scene.node_morph_weights.get(int(node))
            if w is None:
                rows.append(defaults[i])
            else:
                row = np.zeros(mt, np.float32)
                row[:min(len(w), mt)] = w[:mt]
                rows.append(row)
        return self._t(np.stack(rows))

    # -- frame ------------------------------------------------------------------
    def sun_shadow_view(self):
        """(light view-proj fitted to the scene bounds, the static and the
        dynamic casters inside it as (objects,) bool masks).  The ocean
        and the LOD ground cast no sun shadow."""
        scene = self.scene
        mn = scene.r_world_min.min(axis=0)
        mx = scene.r_world_max.max(axis=0)
        light_vp = directional_shadow_matrix(self._sun_dir, mn, mx)
        frustum = Frustum(light_vp)
        static = np.zeros(self.packed.num_objects, bool)
        static[scene.gather_visible_static_shadow_renderables(frustum)] = True
        dynamic = np.zeros(self.packed.num_objects, bool)
        dynamic[scene.gather_visible_dynamic_shadow_renderables(
            frustum)] = True
        for obj in (self._ocean_obj, self._ground_obj):
            if obj >= 0:
                static[obj] = dynamic[obj] = False
        return light_vp, static, dynamic

    def _view_params(self, ctx: RenderContext, lights) -> dict:
        out = {"view_proj": self._t(ctx.view_projection),
               "inv_view_proj": self._t(np.linalg.inv(
                   ctx.view_projection).astype(np.float32)),
               "view": self._t(ctx.view),
               "camera_pos": self._t(ctx.camera_pos)}
        if lights is not None:
            zn, zf = self._cluster_range
            with span("lights"):
                out["z_masks"] = bin_lights_z(lights, out["view"],
                                              self.CLUSTER_Z_SLICES, zn, zf)
                out["tile_masks"] = bin_lights_tiles(
                    lights, out["view_proj"], self._rw, self._rh,
                    self.CLUSTER_TILE)
        return out

    def _frame_sig(self, frame_time: float):
        return (self.camera.position.tobytes(),
                self.camera.rotation.tobytes(), float(frame_time))

    def _ocean_time(self, elapsed_time: float):
        """The ocean's phase time: elapsed time modulo two periods."""
        period = self.ocean.config.animation_period
        return self._t(np.float32(elapsed_time % (period * 2)))

    def ui_overlay(self, frame_time: float) -> np.ndarray:
        """showUi: the stats window's widget tree (ui/widgets.py;
        ui_manager.hpp:44), its label the frame time and the triangle
        count, rendered on the host into the display-size (H, W, 4) RGBA
        overlay."""
        if self.ui_manager is None or self.ui_manager.width != self.width:
            self.ui_manager = UIManager(self.width, self.height)
            win = self.ui_manager.add_child(Window("granite tpu"))
            self._ui_stats_label = win.add_child(Label(""))
        self._ui_stats_label.set_text(
            f"{frame_time * 1000:5.1f} ms "
            f"{int(self.packed.indices.shape[0])} tris")
        return self.ui_manager.render()

    def build_frame_params(self, frame_time: float,
                           elapsed_time: float = 0.0) -> dict:
        """Host-side frame prep: culling, shadow matrices (the cascades'
        from the camera), the cached static sun shadow map (kernel B1),
        the skin palette and morph weights of the current pose, light
        binning, the visible decals, the UI overlay, uploads.  Under TAA
        it steps the jitter first: the frame renders with the jittered
        view-proj (culling keeps the un-jittered frustum).  elapsed_time
        drives the ocean (the animation system poses the scene before this
        is called)."""
        with span("params"):
            return self._frame_params(frame_time, elapsed_time)

    def _frame_params(self, frame_time: float, elapsed_time: float) -> dict:
        scene = self.scene
        with span("cull"):
            scene.update_transform_tree()
            self.context.set_camera(self.camera)
            taa_reproj = None
            if self._jitter is not None:
                jittered = self._jitter.step(self.context.view_projection)
                taa_reproj = self._jitter.reproject_matrix()
                self.context.view_projection = jittered
            vis = scene.gather_visible_opaque_renderables(
                self.context.frustum)
            object_mask = np.zeros(self.packed.num_objects, bool)
            object_mask[vis] = True
            transparent_mask = np.zeros(self.packed.num_objects, bool)
            if self._has_transparent:
                transparent_mask[
                    scene.gather_visible_transparent_renderables(
                        self.context.frustum)] = True
                object_mask &= ~transparent_mask
            if self.config.raster_max_visible == "auto":
                self._update_auto_max_visible([object_mask])
        with span("sun_view"):
            light_vp, static_mask, dynamic_mask = self.sun_shadow_view()
        with span("node_mats"):
            n = scene.num_nodes
            world = scene.world[:n]
            nm = np.linalg.inv(world[:, :3, :3]).transpose(0, 2, 1).astype(
                np.float32)
            world_t = self._t(world)
            nm_t = self._t(nm)
            skin_palette = self._skin_palette()
            morph_weights = self._morph_weights()
        params = {
            "external": {"world": world_t, "normal_mats": nm_t},
            "skin_palette": skin_palette,
            "morph_weights": morph_weights,
            "sun_dir": self._t(self._sun_dir),
            "sun_color": self._t(self._sun_color),
            "object_mask": self._t(object_mask, torch.bool),
            "transparent_mask": self._t(transparent_mask, torch.bool),
            "shadow_uv_mat": self._t(shadow_uv_transform(light_vp)),
            "frame_time": float(frame_time),
        }
        if self.config.directional_light_shadows and \
                self.config.directional_light_cascaded_shadows:
            # Four maps fitted around the camera, every caster in the sun's
            # frustum rendered into each in the shadow pass.
            cascade_vps = cascade_matrices(
                self._sun_dir, self.camera.position,
                self.camera.get_front(), scene.r_world_min.min(axis=0),
                scene.r_world_max.max(axis=0))
            params["cascade_vps"] = cascade_vps
            params["shadow_uv_mat"] = self._t(np.stack(
                [shadow_uv_transform(m) for m in cascade_vps]))
            params["shadow_mask"] = self._t(static_mask | dynamic_mask,
                                            torch.bool)
        elif self.config.directional_light_shadows:
            # The static casters' map re-renders when the light frustum,
            # the caster set or their transforms change, as in the
            # reference viewer; the dynamic casters join it per frame in
            # the shadow pass.
            with span("sun_view"):
                static_nodes = np.unique(self.packed.obj_node[static_mask])
                size = int(self.config.shadow_map_resolution)
                key = (light_vp.tobytes(), static_mask.tobytes(),
                       world[static_nodes].tobytes(), size)
                if self._static_shadow_cache is None or \
                        self._static_shadow_cache[0] != key:
                    depth, stats = render_shadow_map(
                        self.packed, world_t, light_vp, size,
                        self._t(static_mask, torch.bool), with_stats=True)
                    self.raster_stats["shadow"] = stats
                    # VSM without dynamic casters: blur the moments once
                    # with the depth, under the same key.
                    moments = vsm_moments(depth) \
                        if self.config.directional_light_shadows_vsm \
                        and not self._has_dynamic_casters else None
                    self._static_shadow_cache = (key, depth, moments)
            params["static_shadow_depth"] = self._static_shadow_cache[1]
            if self._static_shadow_cache[2] is not None:
                params["static_vsm_moments"] = self._static_shadow_cache[2]
            if self._has_dynamic_casters:
                params["shadow_vp"] = light_vp
                params["dynamic_shadow_mask"] = self._t(dynamic_mask,
                                                        torch.bool)
        if self.config.show_ui:
            params["ui_overlay"] = self._t(self.ui_overlay(frame_time))
        if self.config.occlusion_culling:
            params["obj_world_min"] = self._t(scene.r_world_min.copy())
            params["obj_world_max"] = self._t(scene.r_world_max.copy())
        if self.ocean is not None:
            params["ocean_time"] = self._ocean_time(elapsed_time)
        if self._has_decals:
            # Only frustum-visible decals ride the table (the reference's
            # visible_decals gather, clusterer.hpp:123).
            dv = scene.gather_visible_volumetric_decals(self.context.frustum)
            nodes = np.asarray(scene.decal_node, np.int32)[dv]
            texs = np.asarray(scene.decal_tex, np.int32)[dv]
            params["decals"] = pack_decals(world[nodes], texs,
                                           capacity=self.DECAL_CAPACITY,
                                           device=self.device)
            params["decal_strips"] = self._decal_strips
        with span("lights"):
            lights = self._collect_lights() if self._has_lights else None
        if lights is not None:
            params["lights"] = lights
        params.update(self._view_params(self.context, lights))
        if self._jitter is not None:
            # Last frame's node transforms, skin palette and morph
            # weights for the motion vectors (the first frame reprojects
            # onto itself), the previous un-jittered view-proj, and this
            # frame's jitter for FSR2.
            prev_world, prev_palette, prev_morph = \
                (world_t, skin_palette, morph_weights) \
                if self._mv_prev is None else self._mv_prev
            params["external"]["prev_world"] = prev_world
            params["prev_skin_palette"] = prev_palette
            params["prev_morph_weights"] = prev_morph
            params["prev_vp_uv"] = self._t(
                TAA.UV_REMAP @ self._jitter._saved_nojitter[0])
            params["taa_reproj"] = self._t(taa_reproj)
            # (a copy: on the CPU world_t shares the scene's node array,
            # which the next frame's transform update overwrites)
            self._mv_prev = (self._t(world.copy()), skin_palette,
                             morph_weights)
            if self._use_fsr2:
                params["fsr2_jitter"] = self._t(
                    self._jitter.last_jitter_uv())
        self._param_cache = (self._frame_sig(frame_time), params)
        return params

    def render_frame(self, frame_time: float, elapsed_time: float):
        """One frame -> (H, W, 4) uint8 backbuffer on the app's device.
        The animation system poses the scene at elapsed_time first.  A
        still camera reuses the last frame's params, except under TAA,
        where every frame steps the jitter, while animations play or an
        ocean exists, whose pose and phase follow elapsed_time, and with
        the UI, whose label follows the frame time."""
        with span(ROOT):
            with span("animate"):
                self.animation_system.animate(elapsed_time)
            cached = self._param_cache
            if cached is not None and self._jitter is None \
                    and self.ocean is None and not self.config.show_ui \
                    and not self.animation_system.states \
                    and cached[0] == self._frame_sig(frame_time):
                params = cached[1]
            else:
                params = self.build_frame_params(frame_time, elapsed_time)
            with span("graph"):
                if self._debug_graph:
                    out, self._history, self.last_breadcrumbs = \
                        execute_debug(self.graph, params, self._history,
                                      device=self.hub)
                else:
                    out, self._history = self.graph.execute(params,
                                                            self._history)
        return out

    def render_frames_chained(self, frame_time: float, t0: float, n: int,
                              camera_orbit: float = 0.0):
        """n frames through graph.execute_chain with no host readback;
        returns the last backbuffer on the device and keeps the chain's
        checksum (the float32 sum of frames 0 .. n-2's backbuffers, on the
        device) in _last_chain_checksum.  camera_orbit > 0 yaws the camera
        by that many radians per frame.  A static scene keeps frame 0's
        params but the view params and light bins (culling masks stay at
        frame 0's, as in the reference's chained bench); under TAA the
        camera stays still and camera_orbit is ignored, as in the
        reference: each frame takes its own jittered view-proj (and FSR2
        jitter) from the host-side jitter sequence.  A time-varying frame
        (animations, an ocean or the UI) poses and rebuilds every frame's
        params at t0 + i * frame_time, the orbit included, as the
        reference's time-varying chain does.  Under GRANITE_DEBUG_GRAPH
        every frame goes through render_frame at t0 + i * frame_time and
        no checksum is kept, as in the reference (the debug route is per
        frame by nature)."""
        if self._debug_graph:
            out = None
            for i in range(n):
                out = self.render_frame(frame_time, t0 + i * frame_time)
            return out
        if self.animation_system.states or self.ocean is not None \
                or self.config.show_ui:
            return self._chain_time_varying(frame_time, t0, n, camera_orbit)
        cached = self._param_cache
        if cached is None or cached[0] != self._frame_sig(frame_time):
            self.build_frame_params(frame_time, t0)
            cached = self._param_cache
            if self._jitter is not None:
                # the jitter bank below regenerates frame 0's step
                self._jitter.unstep()
        params = cached[1]
        if self._jitter is not None:
            banks = self._jitter_banks(n)
        else:
            okey = (n, camera_orbit, cached[0])
            if self._orbit_cache is None or self._orbit_cache[0] != okey:
                self._orbit_cache = (okey, self._orbit_banks(
                    params, n, camera_orbit))
            banks = self._orbit_cache[1]
        out, self._history, self._last_chain_checksum = \
            self.graph.execute_chain(params, banks, self._history)
        return out

    def _chain_time_varying(self, frame_time: float, t0: float, n: int,
                            camera_orbit: float):
        """The eager counterpart of the reference's time-varying chain:
        frame i animates to t0 + i * frame_time and builds its params
        (skin palette, morph weights, world matrices, culling, light
        bins, jitter) exactly as render_frame would, just before it runs:
        on the CPU the params share the scene's node arrays, which the
        next pose overwrites.  Under rasterMaxVisible "auto" frame i so
        runs with the capacity of frames 0 .. i's census where the
        reference's one program takes all n frames'; either capacity
        holds every frame's visible triangles, and the compaction keeps
        their order, so the frames are the same."""
        def banks():
            for i in self._orbit(n, camera_orbit):
                et = t0 + i * frame_time
                self.animation_system.animate(et)
                yield self.build_frame_params(frame_time, et)

        # (closed at once if a frame raises: _orbit puts the pose back)
        with contextlib.closing(banks()) as frames:
            out, self._history, self._last_chain_checksum = \
                self.graph.execute_chain({}, frames, self._history)
        return out

    def _orbit(self, n: int, camera_orbit: float):
        """Yields 0 .. n-1 with the camera yawed i * camera_orbit radians
        about +y from its pose (left alone when camera_orbit is 0), and
        puts the pose back at the end."""
        saved_pos = self.camera.position.copy()
        saved_rot = self.camera.rotation.copy()
        conj = np.array([saved_rot[0], -saved_rot[1], -saved_rot[2],
                         -saved_rot[3]])
        try:
            for i in range(n):
                if camera_orbit != 0.0:
                    yaw = quat_from_axis_angle([0.0, 1.0, 0.0],
                                               i * camera_orbit)
                    front = quat_rotate(yaw, quat_rotate(conj,
                                                         [0.0, 0.0, -1.0]))
                    self.camera.position = saved_pos
                    self.camera.look_at(saved_pos, saved_pos + front)
                yield i
        finally:
            self.camera.position = saved_pos
            self.camera.rotation = saved_rot

    def _jitter_banks(self, n: int) -> list:
        """Per-frame jittered view-proj (and FSR2 jitter) of a still
        camera: the un-jittered view-proj is constant, so the
        reprojection params stay valid."""
        vp = self._jitter._saved_nojitter[-1]
        banks = []
        for _ in range(n):
            jit_vp = self._jitter.step(vp)
            bank = {"view_proj": self._t(jit_vp),
                    "inv_view_proj": self._t(
                        np.linalg.inv(jit_vp).astype(np.float32))}
            if self._use_fsr2:
                bank["fsr2_jitter"] = self._t(self._jitter.last_jitter_uv())
            banks.append(bank)
        return banks

    def _orbit_banks(self, params: dict, n: int, camera_orbit: float):
        """Per-frame view params + light bins for the orbiting camera."""
        banks = []
        for _ in self._orbit(n, camera_orbit):
            if camera_orbit == 0.0:
                banks.append({})
                continue
            ctx = RenderContext()
            ctx.set_camera(self.camera)
            banks.append(self._view_params(ctx, params.get("lights")))
        return banks

    def _config_changed(self, info) -> None:
        # A deleted config keeps the knobs in force (nothing to re-read).
        if info.type != "deleted":
            self._reload_config = True

    def post_frame(self) -> None:
        """Application::poll analogue, after each frame: the streaming
        latch (AssetManager::iterate + ResourceManager::latch_handles: the
        rows of scene.bundles rewritten in place), file notifications,
        the config.json hot reload, and under GRANITE_WATCH_KERNELS the
        reload of changed op / renderer modules (importlib) and CUDA
        sources (the loaded kernel library is dropped, so the next launch
        rebuilds it under its new hash); either re-bakes the graph."""
        if self.packed.streamer is not None:
            self.packed.streamer.latch()
        self._fs.poll_notifications()
        changed = []
        for ent in self._kernel_watch:
            try:
                m = os.path.getmtime(ent[0])
            except OSError:
                continue
            if m != ent[1]:
                ent[1] = m
                changed.append(ent[0])
        if changed:
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            for f in changed:
                if f.endswith(".py"):
                    name = os.path.relpath(f, root)[:-3].replace(os.sep, ".")
                    mod = sys.modules.get(name)
                    if mod is not None:
                        importlib.reload(mod)
                        LOGI("kernel module reloaded: %s", name)
                else:
                    K.drop_library()
                    LOGI("kernel source changed: %s", f)
            LOGI("kernel sources changed; re-baking render graph")
            self.swapchain_updated(self.width, self.height)
        if self._reload_config and self._config_path:
            self._reload_config = False
            LOGI("config.json changed; re-baking render graph")
            self.config = ViewerConfig.from_json(self._config_path)
            self.config.check_slice()
            self.swapchain_updated(self.width, self.height)

    def frame_stats(self) -> dict:
        """Raster counters of the last G-buffer pass, static shadow map
        and dynamic casters' shadow map as ints (syncs the device)."""
        return {pass_name: {k: int(v) for k, v in stats.items()}
                for pass_name, stats in self.raster_stats.items()}

    def capture_environment_probe(self, path: str, face_size: int = 512,
                                  equirect_height: int = 256) -> None:
        """Environment probe capture (SceneViewerApplication::
        capture_environment_probe, scene_viewer_application.cpp:641):
        renders the scene into 6 cube faces from the camera position at
        face_size^2, assembles an equirect radiance map of
        (equirect_height, 2 equirect_height) and writes `path` (PNG
        preview) and `path`.npy (linear float32).  The viewer's size and
        camera are put back afterwards."""
        saved = (self.camera.position.copy(), self.camera.rotation.copy(),
                 self.camera.fovy, self.camera.aspect)
        old_size = (self.width, self.height)
        self.swapchain_updated(face_size, face_size)
        self.camera.set_fovy(np.pi / 2)
        self.camera.set_aspect(1.0)
        faces = []
        for f in range(6):
            self.camera.look_at(saved[0], saved[0] + FACE_DIRS[f],
                                FACE_UPS[f])
            out = self.render_frame(1 / 60, 0.0)
            faces.append(out.cpu().numpy()[..., :3].astype(np.float32)
                         / 255.0)
        # cube -> equirect (convert_cube_to_environment analogue)
        h = equirect_height
        w = 2 * h
        v = (np.arange(h) + 0.5) / h
        u = (np.arange(w) + 0.5) / w
        theta = v * np.pi
        phi = u * 2 * np.pi
        st = np.sin(theta)[:, None]
        y = np.broadcast_to(np.cos(theta)[:, None], (h, w))
        x = st * np.cos(phi)[None, :]
        z = st * np.sin(phi)[None, :]
        d = np.stack([x, y, z], -1)
        ax = np.abs(d)
        face_id = np.where((ax[..., 0] >= ax[..., 1])
                           & (ax[..., 0] >= ax[..., 2]),
                           np.where(d[..., 0] >= 0, 0, 1),
                           np.where(ax[..., 1] >= ax[..., 2],
                                    np.where(d[..., 1] >= 0, 2, 3),
                                    np.where(d[..., 2] >= 0, 4, 5)))
        out_img = np.zeros((h, w, 3), np.float32)
        for f in range(6):
            m = face_id == f
            fwd = FACE_DIRS[f]
            up = FACE_UPS[f]
            right = np.cross(fwd, up)
            dd = d[m]
            zf = dd @ fwd
            uf = (dd @ right) / np.maximum(np.abs(zf), 1e-6)
            vf = (dd @ up) / np.maximum(np.abs(zf), 1e-6)
            px = np.clip(((uf * 0.5 + 0.5) * face_size).astype(int), 0,
                         face_size - 1)
            py = np.clip(((-vf * 0.5 + 0.5) * face_size).astype(int), 0,
                         face_size - 1)
            out_img[m] = faces[f][py, px]
        np.save(path + ".npy", out_img)
        save_png(path, np.clip(out_img, 0, 1))
        LOGI("Captured environment probe -> %s (+.npy HDR)", path)
        self.camera.position, self.camera.rotation = saved[0], saved[1]
        self.camera.set_fovy(saved[2])
        self.camera.set_aspect(saved[3])
        self.swapchain_updated(*old_size)


def main(argv=None) -> int:
    return headless_main(SceneViewerApplication, argv)


if __name__ == "__main__":
    raise SystemExit(main())
