"""Surface attributes, the material fetch and the lighting, per pixel, in
float64 from the engine's stated formulas.

Attributes: perspective-correct barycentrics of the winning triangle
solved in homogeneous clip space at the pixel centre, with their exact
screen derivatives.  Material fetch: a box-filtered mip chain of each
image (linear texels stored as float16, as the engine stores material
texels), sampled with the engine's lod rule and its approximate
trilinear (the bilinear quad at floor(lod) blended toward the next
level's bilinear value at the quad's first texel centre).  Lighting:
Granite's Cook-Torrance (GGX, Schlick, its PI = 3.1415628 and roughness
remap), the sun with a 2x2 percentage-closer shadow test, the sky's
spherical-harmonic irradiance and prefiltered specular, the point lights
with their smooth range falloff, and the clustered shadow atlas's rule:
the first K lights of a pixel's cluster are shadowed, the others not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI_GRANITE = 3.1415628
SRGB_CUT = 0.04045


def normalize(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True).clamp_min(1e-20))


def dot(a, b):
    return (a * b).sum(-1)


# ---------------------------------------------------------------------------
# Images and mip chains
# ---------------------------------------------------------------------------

def srgb_u8_to_linear(img_u8: np.ndarray) -> np.ndarray:
    u = img_u8[..., :3].astype(np.float64) / 255.0
    rgb = np.where(u <= SRGB_CUT, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)
    return np.concatenate([rgb, img_u8[..., 3:4] / 255.0], -1)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize, texel centres at (i + 0.5), clamped at the edges."""
    h, w = img.shape[:2]

    def axis(n_in, n_out):
        x = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
        x = np.clip(x, 0, n_in - 1)
        i0 = np.minimum(np.floor(x).astype(int), n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, x - i0

    y0, y1, fy = axis(h, out_h)
    x0, x1, fx = axis(w, out_w)
    rows = img[y0] * (1 - fy)[:, None, None] + img[y1] * fy[:, None, None]
    return rows[:, x0] * (1 - fx)[None, :, None] \
        + rows[:, x1] * fx[None, :, None]


def box_mips(img: torch.Tensor) -> list:
    """2x2 box-filtered chain of a square power-of-two image down to 1x1."""
    levels = [img]
    while levels[-1].shape[0] > 1:
        a = levels[-1]
        n = a.shape[0] // 2
        levels.append(a.reshape(n, 2, n, 2, -1).mean(dim=(1, 3)))
    return levels


def upsample2_wrapped(img: torch.Tensor) -> torch.Tensor:
    """A level bilinearly upsampled by 2 at the finer level's texel
    centres, wrapping (repeat addressing)."""
    n = img.shape[0]
    pos = (torch.arange(2 * n, dtype=torch.float64, device=img.device)
           + 0.5) / 2 - 0.5
    i0 = torch.floor(pos)
    f = (pos - i0).to(img.dtype)
    a0 = i0.long() % n
    a1 = (a0 + 1) % n
    rows = img[a0] * (1 - f)[:, None, None] + img[a1] * f[:, None, None]
    return rows[:, a0] * (1 - f)[None, :, None] + rows[:, a1] * f[None, :, None]


class MipTexture:
    """Textures of one base size S as mip chains, texels and the
    next-level taps stored flat: level l at offset[l], row-major."""

    def __init__(self, images, device, store=None):
        """images: list of (S, S, C) float arrays; store: a dtype the
        texels are rounded through (float16 for material texels)."""
        self.device = torch.device(device)
        S = images[0].shape[0]
        self.size = S
        fine, parent = [], []
        for img in images:
            lv = box_mips(torch.as_tensor(np.asarray(img, np.float32),
                                          device=self.device))
            par = [upsample2_wrapped(lv[l + 1]) for l in range(len(lv) - 1)] \
                + [lv[-1]]
            fine.append(torch.cat([x.reshape(-1, x.shape[-1]) for x in lv]))
            parent.append(torch.cat([x.reshape(-1, x.shape[-1])
                                     for x in par]))
        self.levels = len(lv)
        sizes = [max(S >> l, 1) for l in range(self.levels)]
        self.offset = torch.as_tensor(np.concatenate([[0], np.cumsum(
            np.square(sizes))[:-1]]), device=self.device)

        def keep(parts):
            t = torch.stack(parts)
            if store is not None:
                t = t.to(store)
            return t.to(torch.float64)

        self.fine = keep(fine)        # (N, texels, C)
        self.parent = keep(parent)

    def sample(self, tex, u, v, lod):
        """tex (P,) texture index, u, v, lod (P,) -> (P, C); a coordinate
        that is not a number reads as 0."""
        L = self.levels
        u, v, lod = (torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)
                     for t in (u, v, lod))
        lod = lod.clamp(0.0, L - 1.0)
        l0 = torch.floor(lod).long()
        frac = (lod - l0)[:, None]
        ls = torch.clamp_min(torch.bitwise_right_shift(
            torch.full_like(l0, self.size), l0), 1)
        x = u.to(torch.float32) * ls - 0.5
        y = v.to(torch.float32) * ls - 0.5
        xf, yf = torch.floor(x), torch.floor(y)
        fx = (x - xf).to(torch.float64)[:, None]
        fy = (y - yf).to(torch.float64)[:, None]
        x0 = torch.remainder(xf.long(), ls)
        y0 = torch.remainder(yf.long(), ls)
        x1 = (x0 + 1) % ls
        y1 = (y0 + 1) % ls
        base = self.offset[l0]

        def at(yy, xx, arr=self.fine):
            return arr[tex, base + yy * ls + xx]

        top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
        bot = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
        fine = top * (1 - fy) + bot * fy
        return fine * (1 - frac) + at(y0, x0, self.parent) * frac


def lod_from_derivs(dudx, dvdx, dudy, dvdy, size: int):
    """The mip lod: log2 of the longer screen-axis footprint in texels."""
    sx = torch.sqrt((dudx * size) ** 2 + (dvdx * size) ** 2)
    sy = torch.sqrt((dudy * size) ** 2 + (dvdy * size) ** 2)
    return torch.log2(torch.maximum(sx, sy).clamp_min(1e-12))


# ---------------------------------------------------------------------------
# The sky
# ---------------------------------------------------------------------------

SKY_ZENITH = (0.20, 0.35, 0.65)
SKY_HORIZON = (0.55, 0.62, 0.72)
SKY_GROUND = (0.22, 0.2, 0.18)


def pow07(x):
    """The sky's x^0.7 on [0, 1]: s * p(s), s = sqrt(x), p the engine's
    degree-4 fit."""
    s = np.sqrt(np.clip(x, 0.0, 1.0)) if isinstance(x, np.ndarray) \
        else torch.sqrt(x.clamp(0.0, 1.0))
    return s * (0.22317565 + s * (1.94874432 + s * (
        -2.76040261 + s * (2.4335581 + s * -0.84682995))))


def sky_radiance(x, y, z, sun_dir, sun_color):
    """The procedural sky along unit directions (numpy or torch arrays):
    horizon-to-zenith gradient, ground below, a sun disk and halo."""
    is_np = isinstance(x, np.ndarray)
    lib = np if is_np else torch

    def c3(v):
        v = np.asarray(v, np.float64)
        return v if is_np else torch.as_tensor(v, device=x.device)

    cos_sun = x * sun_dir[0] + y * sun_dir[1] + z * sun_dir[2]
    t = pow07(y)[..., None]
    sky = c3(SKY_HORIZON) * (1 - t) + c3(SKY_ZENITH) * t
    g = lib.clip(-y, 0.0, 1.0)[..., None] if is_np else \
        (-y).clamp(0.0, 1.0)[..., None]
    img = sky * (1 - g) + c3(SKY_GROUND) * g
    if is_np:
        sun = np.clip((cos_sun - 0.9995) / 0.0005, 0.0, 1.0)
        halo = np.clip(cos_sun, 0.0, 1.0) ** 64
    else:
        sun = ((cos_sun - 0.9995) / 0.0005).clamp(0.0, 1.0)
        halo = cos_sun.clamp(0.0, 1.0) ** 64
    return img + c3(sun_color) * (40.0 * sun + 0.2 * halo)[..., None]


def equirect_dirs(h: int, w: int):
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    st = np.sin(theta)[:, None]
    return (st * np.cos(phi)[None, :], np.cos(theta)[:, None]
            * np.ones((1, w)), st * np.sin(phi)[None, :], st)


SH_BAND = (3.141593, 2.094395, 2.094395, 2.094395,
           0.785398, 0.785398, 0.785398, 0.785398, 0.785398)


def sh9_basis(x, y, z, lib=np):
    one = lib.ones_like(x)
    return [0.282095 * one, 0.488603 * y, 0.488603 * z, 0.488603 * x,
            1.092548 * x * y, 1.092548 * y * z, 0.315392 * (3 * y * y - 1),
            1.092548 * x * z, 0.546274 * (x * x - z * z)]


class Sky:
    """The environment of the viewer's procedural sky: its 128 x 256
    equirect image resampled to 256 x 256 and mip-chained (the specular
    fetch), and its irradiance as 9 spherical-harmonic coefficients."""

    def __init__(self, sun_dir, sun_color, device, height: int = 128):
        self.sun_dir = np.asarray(sun_dir, np.float64)
        self.sun_color = np.asarray(sun_color, np.float64)
        x, y, z, st = equirect_dirs(height, 2 * height)
        img = sky_radiance(x, y, z, self.sun_dir, self.sun_color)
        d_omega = (np.pi / height) * (2 * np.pi / (2 * height)) * st
        self.sh = torch.as_tensor(np.stack([
            (img * (b * d_omega)[..., None]).sum((0, 1)) * (a / np.pi)
            for b, a in zip(sh9_basis(x, y, z), SH_BAND)]), device=device)
        s = 1
        while s < 2 * height:
            s *= 2
        sq = resize_bilinear(np.concatenate(
            [img, np.ones_like(img[..., :1])], -1), s, s)
        self.tex = MipTexture([sq], device)

    def irradiance(self, n):
        basis = torch.stack(sh9_basis(n[..., 0], n[..., 1], n[..., 2],
                                      torch), -1)
        return (basis @ self.sh).clamp_min(0.0) / math.pi

    def specular(self, d, lod):
        """Prefiltered radiance along d (P, 3) at lod (P,) -> (P, 3)."""
        n = torch.sqrt((d * d).sum(-1).clamp_min(1e-20))
        theta = torch.arccos((d[:, 1] / n).clamp(-1.0, 1.0))
        phi = torch.atan2(d[:, 2], d[:, 0])
        u = torch.where(phi < 0, phi + 2 * math.pi, phi) / (2 * math.pi)
        s = self.tex.size
        v = (theta / math.pi).clamp(0.5 / s, 1.0 - 0.5 / s)
        tex = torch.zeros(len(u), dtype=torch.int64, device=u.device)
        return self.tex.sample(tex, u, v, lod)[:, :3]

    def background(self, dirs):
        return sky_radiance(*(normalize(dirs).unbind(-1)), self.sun_dir,
                            self.sun_color)


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def cook_torrance(n, v, l, color, shadow, base, metal, rough):
    """One light's reflected radiance (Granite's lighting.h): GGX
    distribution, Schlick-Smith visibility with k = (r + 1)^2 / 8,
    Schlick Fresnel from F0 = lerp(0.04, base, metal) and a Lambert
    diffuse; rough is the remapped roughness.  Per pixel: n, v, l (P, 3),
    color (P, 3) or (3,), shadow and metal and rough (P,), base (P, 3)."""
    h = normalize(l + v)
    nov = dot(n, v).clamp(1e-3, 1.0)
    nol = dot(n, l).clamp(1e-3, 1.0)
    hov = dot(h, v).clamp(1e-3, 1.0)
    noh = dot(n, h).clamp(1e-4, 1.0)
    a2 = rough ** 4
    dd = noh * noh * (a2 - 1.0) + 1.0
    D = a2 / (PI_GRANITE * dd * dd)
    k = (rough + 1.0) ** 2 / 8.0
    G = 0.25 / ((nov * (1 - k) + k) * (nol * (1 - k) + k)).clamp_min(1e-3)
    f0 = 0.04 + (base - 0.04) * metal[:, None]
    F = f0 + (1.0 - f0) * ((1.0 - hov) ** 5)[:, None]
    spec = F * (D * G)[:, None]
    diffuse = (1.0 - F) * base * (1.0 - metal)[:, None] / PI_GRANITE
    return color * (nol * shadow)[:, None] * (spec + diffuse)


def point_falloff(dist, radius):
    """Inverse square, times 1 - smoothstep over the last tenth of the
    light's range."""
    t = ((dist / radius - 0.9) * 10.0).clamp(0.0, 1.0)
    return (1.0 - t * t * (3.0 - 2.0 * t)) / (dist * dist)


def pcf2x2(depth_map, u, v, z, bias: float):
    """2x2 percentage-closer test against a reverse-Z depth map: the
    bilinear blend of (z >= texel - bias) over the footprint of (u, v),
    clamped at the map's edge; 1 outside [0, 1]^2 or past the near end."""
    S = depth_map.shape[-1]
    x = u * S - 0.5
    y = v * S - 0.5
    x0 = torch.nan_to_num(torch.floor(x)).clamp(0, S - 1)
    y0 = torch.nan_to_num(torch.floor(y)).clamp(0, S - 1)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    xi, yi = x0.long(), y0.long()
    xj, yj = (xi + 1).clamp_max(S - 1), (yi + 1).clamp_max(S - 1)

    def lit(yy, xx):
        return (z >= depth_map[..., yy, xx].to(torch.float64) - bias) \
            .to(torch.float64)

    top = lit(yi, xi) * (1 - fx) + lit(yi, xj) * fx
    bot = lit(yj, xi) * (1 - fx) + lit(yj, xj) * fx
    return top * (1 - fy) + bot * fy


def upsample2(img: torch.Tensor) -> torch.Tensor:
    """(h, w, ...) -> (2h, 2w, ...) bilinear, texel centres at (i + 0.5),
    clamped at the edges."""
    def axis(a, dim):
        n = a.shape[dim]
        a = a.movedim(dim, 0)
        prev = torch.cat([a[:1], a[:-1]])
        nxt = torch.cat([a[1:], a[-1:]])
        even = 0.25 * prev + 0.75 * a
        odd = 0.75 * a + 0.25 * nxt
        return torch.stack([even, odd], 1).reshape((2 * n,) + a.shape[1:]) \
            .movedim(0, dim)
    return axis(axis(img, 0), 1)
