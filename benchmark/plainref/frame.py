"""The reference frame of the benchmark's configurations: from the scene
description, the viewer's knobs, the frame size, the lens and a pose,
everything the viewer shows, worked out again here.

Set-up: the sun's depth map (every triangle, both faces), each point
light's six cube faces of depth (the triangles of the objects whose box
lies within the light's range), the material textures and the sky.  A
pose: the main view's z-buffer over every triangle (back faces dropped,
each triangle clipped at the near plane), the G-buffer (position,
normal, base colour with the material fetch, metallic and roughness),
and the lit HDR.  The bloom chain and the tonemap that turn a lit frame
into the backbuffer, with the exposure and bloom history kept here,
are the frozen copies in gref.ops.hdr.

control=True rounds the output of every stage (clip-space vertices,
depth maps, G-buffer, HDR, the bloom chain) to bfloat16: the step below
float32 that a later change could be tempted by.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import shade as S
from . import scene as G
from .zbuffer import rasterize

CLUSTER_Z_SLICES = 32
CLUSTER_TILE = 64
SHADOWED_LIGHTS_PER_PIXEL = 2
SUN_BIAS = 1e-3
ATLAS_BIAS = 2e-3
MATERIAL_TEXTURE_SIZE = 512
BLOOM_SCALES = (0.25, 0.125, 0.0625, 0.03125)
BLOOM_UP_SCALES = (0.0625, 0.125)
PIXEL_CHUNK = 1 << 20


class ReferenceFrameError(RuntimeError):
    """The reference cannot render this configuration."""


def _on(v, device) -> bool:
    """A true/false/"auto" knob: "auto" is on on the card, off elsewhere
    (the viewer's reading)."""
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    return s == "true" or (s == "auto" and device.type == "cuda")


# A true/false/"auto" knob's values, as _on reads them.
SWITCH = (True, False, "true", "false", "auto")


class ReferenceFrame:
    """The reference of the benchmark's configurations; its interface is
    the harness's contract for a reference (gbench/__init__.py)."""

    # The viewer knobs this reference models, each with the only values it
    # models (None: any value).  The harness refuses a configuration that
    # sets any other knob, or another value, before set-up.
    KNOBS = {
        "renderer": ("deferred", "forward"),
        "hdrBloom": (True, False),
        "hdrBloomDynamicExposure": (True, False),
        "directionalLightShadows": (True, False),
        "shadowMapResolution": None,
        "clusteredLightsShadows": (True, False),
        "clusteredLightsShadowsResolution": None,
        "clusteredLightsShadowsHalfRes": SWITCH,
        "shadowTermHalfRes": SWITCH,
        "materialTileSampler": SWITCH,
        # A cap on the visible set changes the frame only where it drops
        # geometry, which the geometry number reads as pixels off.
        "rasterMaxVisible": None,
        # At the one value that leaves the frame as drawn here.
        "msaa": (1,),
        "resolutionScale": (1, 1.0),
        "PCFKernelWide": (False,),
        "clusteredLightsShadowsVSM": (False,),
        "envSpecularHalfRes": (False,),
        "hdrBloomDepth": (6,),
        "postAA": ("none",),
    }

    def __init__(self, info, viewer_cfg: dict, width: int, height: int,
                 lens: dict, device, control: bool = False):
        self.device = torch.device(device)
        cfg = self.cfg = dict(viewer_cfg)
        self.width, self.height = int(width), int(height)
        self.lens = dict(lens)
        self.control = bool(control)
        self.deferred = cfg.get("renderer", "forward") == "deferred"
        self.bloom = bool(cfg.get("hdrBloom", True))
        self.sa = G.SceneArrays(info, self.device)
        sa = self.sa
        self.sky = S.Sky(sa.sun_dir, sa.sun_color, self.device)
        self._textures(info)
        self.sun_vp = None
        self.sun_depth = None
        if cfg.get("directionalLightShadows", True):
            self.sun_vp = G.sun_matrix(sa.sun_dir, sa.lo, sa.hi)
            size = int(cfg.get("shadowMapResolution", 2048))
            self.sun_depth = self._q(self._depth_map(self.sun_vp, size))
        self.atlas = None
        self.k_shadow = 0
        if cfg.get("clusteredLightsShadows", True) and sa.lights:
            self.atlas = self._light_atlas(
                int(cfg.get("clusteredLightsShadowsResolution", 512)))
            self.k_shadow = SHADOWED_LIGHTS_PER_PIXEL
        self.n_lights = len(sa.lights)
        self.history = self.initial_history()

    @property
    def atlas_depth(self):
        """The judged map `atlas_depth`: the atlas's (slices, S, S) depth."""
        return None if self.atlas is None else self.atlas["depth"]

    # -- set-up ---------------------------------------------------------------
    def _q(self, t):
        """bfloat16 round trip of a float tensor under control."""
        if self.control and t.is_floating_point():
            return t.to(torch.bfloat16).to(t.dtype)
        return t

    def _textures(self, info):
        """Base-colour textures: 0 white, then each image, linear, at the
        material size, texels stored as float16."""
        size = MATERIAL_TEXTURE_SIZE
        imgs = [np.ones((size, size, 4))]
        for img, srgb in zip(info.images, info.image_srgb):
            lin = S.srgb_u8_to_linear(img) if srgb else img / 255.0
            if lin.shape[:2] != (size, size):
                lin = S.resize_bilinear(lin, size, size)
            imgs.append(lin)
        self.textures = S.MipTexture(imgs, self.device, store=torch.float16)
        tex, base, mr = [], [], []
        for m in info.materials or [None]:
            img = None if m is None else m.base_color_image
            tex.append(0 if img is None else 1 + img)
            base.append(np.ones(4) if m is None else m.base_color_factor)
            mr.append([1.0, 1.0] if m is None else
                      [m.metallic_factor, m.roughness_factor])
            if m is not None and any(
                    getattr(m, k) is not None for k in (
                        "metallic_roughness_image", "normal_image",
                        "emissive_image")) or (m is not None and np.any(
                            m.emissive_factor)):
                raise ReferenceFrameError("the reference fetches base "
                                          "colour textures only")
        dev = self.device
        self.mat_tex = torch.as_tensor(tex, device=dev)
        self.mat_base = torch.as_tensor(np.asarray(base, np.float32),
                                        dtype=torch.float64, device=dev)
        self.mat_mr = torch.as_tensor(np.asarray(mr, np.float32),
                                      dtype=torch.float64, device=dev)

    def _triangles(self, view_proj, tris=None):
        """(clip-space triangles (T, 3, 4), their vertex ids, their ids)."""
        sa = self.sa
        clip = self._q(sa.clip(view_proj))
        idx = sa.indices if tris is None else sa.indices[tris]
        ids = torch.arange(len(sa.indices), device=self.device) \
            if tris is None else tris
        return clip[idx], idx, ids

    def _depth_map(self, view_proj, size: int, tris=None):
        tri_clip, vid, ids = self._triangles(view_proj, tris)
        depth, _ = rasterize(tri_clip, vid, size, size, cull_back=False,
                             tri_ids=ids)
        return depth

    def _light_atlas(self, size: int):
        """Six cube faces of depth a light, its casters the objects whose
        box lies within its range."""
        sa = self.sa
        faces, vps = [], []
        for light in sa.lights:
            p, r = light["pos"], light["radius"]
            near = np.linalg.norm(np.clip(p, sa.obj_lo, sa.obj_hi) - p,
                                  axis=1)
            objs = torch.as_tensor(np.nonzero(near <= r)[0],
                                   device=self.device)
            tris = torch.nonzero(torch.isin(sa.tri_object, objs))[:, 0]
            for vp in G.cube_face_matrices(p, r):
                faces.append(self._depth_map(vp, size, tris))
                vps.append(vp)
        return {"depth": self._q(torch.stack(faces)), "vps": np.stack(vps)}

    def initial_history(self) -> dict:
        """The viewer's frame-0 history: zeros (the log luminance, and
        the first bloom downsample's feedback at a quarter size)."""
        if not self.bloom:
            return {}
        h, w = self._size(BLOOM_SCALES[0])
        return {"luminance": torch.zeros((), device=self.device),
                "bloom": torch.zeros((h, w, 4), device=self.device)}

    def _size(self, scale: float):
        return (max(int(self.height * scale), 1),
                max(int(self.width * scale), 1))

    # -- a frame --------------------------------------------------------------
    def view(self, position, rotation):
        """-> (view, view-projection, camera position) in float64."""
        view = G.camera_view(position, rotation)
        proj = G.perspective(float(self.lens["fovy"]),
                             self.width / self.height,
                             float(self.lens["znear"]),
                             None if float(self.lens["zfar"]) <= 0
                             else float(self.lens["zfar"]))
        return view, proj @ view, np.asarray(position, np.float64)

    def visibility(self, view_proj):
        """-> (depth (H, W) f32, triangle (H, W), -1 where empty)."""
        tri_clip, vid, _ids = self._triangles(view_proj)
        return rasterize(tri_clip, vid, self.width, self.height,
                         cull_back=True)

    def gbuffer(self, view_proj, tri):
        """Per pixel (H, W, C) float64 planes, zero where uncovered:
        pos, normal, base (3), metal, rough."""
        sa = self.sa
        H, W = self.height, self.width
        dev = self.device
        out = {k: torch.zeros((H * W, c), dtype=torch.float64, device=dev)
               for k, c in (("pos", 3), ("normal", 3), ("base", 3),
                            ("metal", 1), ("rough", 1))}
        clip = self._q(sa.clip(view_proj))
        flat = tri.reshape(-1)
        pix_all = torch.nonzero(flat >= 0)[:, 0]
        for c0 in range(0, len(pix_all), PIXEL_CHUNK):
            pix = pix_all[c0:c0 + PIXEL_CHUNK]
            t = flat[pix]
            vi = sa.indices[t]                               # (P, 3)
            m = clip[vi][..., [0, 1, 3]].transpose(1, 2)     # (P, 3, 3)
            minv = torch.linalg.inv(m)
            px = (pix % W).to(torch.float64) + 0.5
            py = (pix // W).to(torch.float64) + 0.5
            ndc = torch.stack([2 * px / W - 1, 2 * py / H - 1,
                               torch.ones_like(px)], -1)
            c = (minv @ ndc[..., None])[..., 0]              # (P, 3)
            cx = minv[..., 0] * (2.0 / W)
            cy = minv[..., 1] * (2.0 / H)
            s = c.sum(-1, keepdim=True)
            b = c / s

            def interp(attr):
                return (b[..., None] * attr[vi]).sum(1)

            def deriv(attr, val, dc):
                a = attr[vi]
                return ((dc[..., None] * a).sum(1)
                        - val * dc.sum(-1, keepdim=True)) / s

            uv = interp(sa.uvs)
            dx = deriv(sa.uvs, uv, cx)
            dy = deriv(sa.uvs, uv, cy)
            mat = sa.tri_material[t]
            lod = S.lod_from_derivs(dx[:, 0], dx[:, 1], dy[:, 0], dy[:, 1],
                                    self.textures.size)
            texel = self.textures.sample(self.mat_tex[mat], uv[:, 0],
                                         uv[:, 1], lod)
            out["pos"][pix] = interp(sa.positions)
            out["normal"][pix] = S.normalize(interp(sa.normals))
            out["base"][pix] = self.mat_base[mat, :3] * texel[:, :3]
            out["metal"][pix] = self.mat_mr[mat, 0:1]
            out["rough"][pix] = self.mat_mr[mat, 1:2]
        return {k: self._q(v.reshape(H, W, -1)) for k, v in out.items()}

    def _sun_term(self, pos):
        """(h, w, 3) positions -> (h, w) the sun's 2x2 PCF term."""
        m = torch.as_tensor(self.sun_vp, device=self.device)
        c = pos @ m[:3, :3].T + m[:3, 3]
        u, v, z = 0.5 * c[..., 0] + 0.5, 0.5 * c[..., 1] + 0.5, c[..., 2]
        term = S.pcf2x2(self.sun_depth, u, v, z, SUN_BIAS)
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) & (z <= 1)
        return torch.where(inside, term, torch.ones_like(term))

    def _cluster_active(self, pos, rows, cols, view, view_proj):
        """(L, h, w) bool: light l may reach the pixel's cluster: its view
        depth's logarithmic slice (of CLUSTER_Z_SLICES between the near
        plane and 1000) and its 64-pixel tile overlap the light's sphere
        (the slice range of its depth extent, the tile box of its
        bounding cube's projected corners).  rows, cols: the full-size
        pixel coordinates of the samples."""
        sa = self.sa
        dev = self.device
        zn = max(float(self.lens["znear"]), 1e-3)
        zf = float(self.lens["zfar"]) if float(self.lens["zfar"]) > 0 \
            else 1000.0
        lr = math.log(zf / zn)
        n = CLUSTER_Z_SLICES
        vrow = torch.as_tensor(view[2], device=dev)
        pz = -(pos @ vrow[:3] + vrow[3])
        s = torch.floor((torch.log(pz.clamp_min(zn) / zn) / lr * n)
                        .clamp(0, n - 1))
        W, H, T = self.width, self.height, CLUSTER_TILE
        tx, ty = -(-W // T), -(-H // T)
        out = []
        for light in sa.lights:
            p, r = light["pos"], light["radius"]
            lz = -(view[2, :3] @ p + view[2, 3])
            z0, z1 = max(lz - r, zn), max(lz + r, zn)
            s0 = min(max(math.floor(math.log(z0 / zn) / lr * n), 0), n - 1)
            s1 = min(max(math.ceil(math.log(z1 / zn) / lr * n), 0), n)
            zact = (s >= s0) & (s < s1) & bool(lz + r > zn)
            corners = np.array([[(i >> k) & 1 for k in range(3)]
                                for i in range(8)]) * 2 - 1.0
            pts = p + corners * r
            h = pts @ view_proj[:3, :3].T + view_proj[:3, 3]
            w = pts @ view_proj[3, :3] + view_proj[3, 3]
            if (w <= 1e-6).any():
                bx0, bx1, by0, by1 = 0, tx, 0, ty
            else:
                sx = (0.5 * h[:, 0] / w + 0.5) * W
                sy = (0.5 * h[:, 1] / w + 0.5) * H
                bx0 = min(max(math.floor(sx.min() / T), 0), tx - 1)
                bx1 = min(max(math.ceil(sx.max() / T), 1), tx)
                by0 = min(max(math.floor(sy.min() / T), 0), ty - 1)
                by1 = min(max(math.ceil(sy.max() / T), 1), ty)
            trow = (rows // T)[:, None]
            tcol = (cols // T)[None, :]
            tact = (trow >= by0) & (trow < by1) & (tcol >= bx0) \
                & (tcol < bx1)
            out.append(zact & tact)
        return torch.stack(out)

    def _atlas_terms(self, pos, active):
        """(L, h, w) shadow terms of the point lights: the 2x2 PCF test
        in the cube face the position lies in, for the first
        SHADOWED_LIGHTS_PER_PIXEL active lights of the pixel; 1 for the
        others."""
        sa = self.sa
        first = torch.cumsum(active.to(torch.int64), 0) \
            <= SHADOWED_LIGHTS_PER_PIXEL
        terms = []
        for li, light in enumerate(sa.lights):
            d = pos - torch.as_tensor(light["pos"], device=self.device)
            a = d.abs()
            face = torch.where(
                (a[..., 0] >= a[..., 1]) & (a[..., 0] >= a[..., 2]),
                torch.where(d[..., 0] >= 0, 0, 1),
                torch.where(a[..., 1] >= a[..., 2],
                            torch.where(d[..., 1] >= 0, 2, 3),
                            torch.where(d[..., 2] >= 0, 4, 5)))
            term = torch.ones_like(a[..., 0])
            for f in range(6):
                sel = face == f
                if not bool(sel.any()):
                    continue
                m = torch.as_tensor(self.atlas["vps"][6 * li + f],
                                    device=self.device)
                c = pos[sel] @ m[:, :3].T + m[:, 3]
                w = c[:, 3].clamp_min(1e-9)
                u, v, z = (0.5 * c[:, 0] / w + 0.5, 0.5 * c[:, 1] / w + 0.5,
                           c[:, 2] / w)
                t = S.pcf2x2(self.atlas["depth"][6 * li + f], u, v, z,
                             ATLAS_BIAS)
                inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1) \
                    & (z >= 0) & (z <= 1)
                term[sel] = torch.where(inside, t, torch.ones_like(t))
            terms.append(torch.where(active[li] & first[li], term,
                                     torch.ones_like(term)))
        return torch.stack(terms)

    def _half(self, pos):
        return pos[::2, ::2]

    def _expand(self, t):
        """Nearest 2x expansion of half-size planes (.., h, w), cropped."""
        return t.repeat_interleave(2, -2).repeat_interleave(2, -1)[
            ..., :self.height, :self.width]

    def lit(self, g, view, view_proj, cam):
        """The lit HDR (H, W, 3) float64 of a G-buffer."""
        dev = self.device
        H, W = self.height, self.width
        cfg = self.cfg
        pos, n, base = g["pos"], g["normal"], g["base"]
        metal, rough_raw = g["metal"][..., 0], g["rough"][..., 0]
        covered = g["covered"]
        cam_t = torch.as_tensor(cam, device=dev)
        v = S.normalize(cam_t - pos)
        rough = rough_raw * 0.75 + 0.25

        def flat(t):
            return t.reshape(H * W, *t.shape[2:])

        # the sun and its shadow term
        if self.sun_depth is None:
            sun_term = torch.ones((H, W), dtype=torch.float64, device=dev)
        elif _on(cfg.get("shadowTermHalfRes", "false"), dev) and \
                H % 2 == 0 and W % 2 == 0 and H >= 64:
            sun_term = S.upsample2(self._sun_term(self._half(pos))[..., None]
                                   )[..., 0]
        else:
            sun_term = self._sun_term(pos)
        sun_dir = torch.as_tensor(self.sa.sun_dir, device=dev)
        out = S.cook_torrance(
            flat(n), flat(v), sun_dir.expand(H * W, 3),
            torch.as_tensor(self.sa.sun_color, device=dev), flat(sun_term),
            flat(base), flat(metal), flat(rough))
        # the sky: diffuse irradiance and the prefiltered specular
        out = out + self.sky.irradiance(flat(n)) * flat(base) \
            * (1 - flat(metal))[:, None]
        nov = S.dot(n, v).clamp(0.0, 1.0)
        refl = 2.0 * nov[..., None] * n - v
        lod = rough_raw * (self.sky.tex.levels - 1.0)
        if _on(cfg.get("materialTileSampler", "auto"), dev):
            spec = torch.zeros((H * W, 3), dtype=torch.float64, device=dev)
            sel = flat(covered)
            spec[sel] = self.sky.specular(flat(refl)[sel], flat(lod)[sel])
        else:   # every other pixel, upsampled
            h2 = self._half(refl)
            half = self.sky.specular(h2.reshape(-1, 3),
                                     self._half(lod).reshape(-1))
            spec = flat(S.upsample2(half.reshape(*h2.shape[:2], 3)))
        f0 = 0.04 + (flat(base) - 0.04) * flat(metal)[:, None]
        fres = f0 + (torch.maximum((1.0 - flat(rough_raw))[:, None], f0)
                     - f0) * ((1.0 - flat(nov)) ** 5)[:, None]
        out = out + spec * fres
        # the point lights, the first of each pixel's cluster shadowed
        if self.sa.lights:
            shadow = torch.ones((len(self.sa.lights), H, W),
                                dtype=torch.float64, device=dev)
            if self.atlas is not None:
                half = _on(cfg.get("clusteredLightsShadowsHalfRes", True), dev)
                ppos = self._half(pos) if half else pos
                rows = torch.arange(0, H, 2 if half else 1, device=dev)
                cols = torch.arange(0, W, 2 if half else 1, device=dev)
                act = self._cluster_active(ppos, rows, cols, view, view_proj)
                terms = self._atlas_terms(ppos, act)
                shadow = self._expand(terms) if half else terms
            for li, light in enumerate(self.sa.lights):
                lp = torch.as_tensor(light["pos"], device=dev)
                f = flat(pos) - lp
                dist = torch.sqrt((f * f).sum(-1).clamp_min(1e-12)) \
                    .clamp_min(0.1)
                col = torch.as_tensor(light["color"], device=dev)[None] \
                    * S.point_falloff(dist, light["radius"])[:, None]
                out = out + S.cook_torrance(
                    flat(n), flat(v), -f / dist[:, None], col,
                    flat(shadow[li]), flat(base), flat(metal), flat(rough))
        # the sky behind what is not covered
        px = torch.arange(W, dtype=torch.float64, device=dev) + 0.5
        py = torch.arange(H, dtype=torch.float64, device=dev) + 0.5
        ndc = torch.stack(torch.broadcast_tensors(
            (2 * px / W - 1)[None, :], (2 * py / H - 1)[:, None],
            torch.full((1, 1), 0.5, dtype=torch.float64, device=dev),
            torch.ones((1, 1), dtype=torch.float64, device=dev)), -1)
        inv = torch.as_tensor(np.linalg.inv(view_proj), device=dev)
        wp = ndc @ inv.T
        dirs = wp[..., :3] / wp[..., 3:4] - cam_t
        bg = self.sky.background(flat(dirs))
        return torch.where(flat(covered)[:, None], out, bg).reshape(H, W, 3)

    def surface(self, position, rotation) -> dict:
        """The pose's planes up to the lit HDR -> {"depth", "covered",
        "hdr"[, "g-base", "g-normal", "g-pbr", "g-emissive", "g-pos"]},
        float32."""
        view, vp, cam = self.view(position, rotation)
        depth, tri = self.visibility(vp)
        g = self.gbuffer(vp, tri)
        g["covered"] = tri >= 0
        hdr = self._q(self.lit(g, view, vp, cam).to(torch.float32))
        out = {"depth": depth, "covered": g["covered"], "hdr": hdr}
        if self.deferred:
            f32 = {k: v.to(torch.float32) for k, v in g.items()
                   if k != "covered"}
            out.update({"g-base": f32["base"], "g-normal": f32["normal"],
                        "g-pbr": torch.cat([f32["metal"], f32["rough"]], -1),
                        "g-emissive": torch.zeros_like(f32["base"]),
                        "g-pos": f32["pos"]})
        return out

    def post(self, hdr, frame_time: float = 1.0 / 60.0):
        """The bloom chain and the tonemap of one lit frame, advancing the
        reference's own history -> (H, W, 4) uint8 backbuffer."""
        from gref.ops import hdr as HDR
        from gref.ops.srgb import encode_rgba8
        if not self.bloom:
            return encode_rgba8(HDR.tonemap(hdr, None, None))
        hist = self.history
        th, tw = self._size(0.5)
        dyn = bool(self.cfg.get("hdrBloomDynamicExposure", True))
        thresh = self._q(HDR.bloom_threshold(
            hdr, torch.exp2(hist["luminance"]), th, tw,
            dynamic_exposure=dyn))
        lum = HDR.average_log_luminance(thresh, hist["luminance"],
                                        frame_time)
        prev, new_bloom = thresh, None
        for i, s in enumerate(BLOOM_SCALES):
            h, w = self._size(s)
            prev = self._q(HDR.bloom_downsample(
                prev, h, w, history=hist["bloom"] if i == 0 else None,
                frame_time=frame_time if i == 0 else None))
            if i == 0:
                new_bloom = prev
        for s in BLOOM_UP_SCALES:
            h, w = self._size(s)
            prev = self._q(HDR.bloom_upsample(prev, h, w))
        ldr = HDR.tonemap(hdr, prev, lum if dyn else None)
        self.history = {"luminance": lum, "bloom": new_bloom}
        return encode_rgba8(ldr)
