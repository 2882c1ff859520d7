"""Port parity for the lighting pass: kernel B4's plain version
(granite_tpu_torch/ops/shade_fused.py) against the reference's
shade_planes_fused in Pallas interpret mode (3e-4, test_shade_fused.py's
tolerance), the port's shade_surface_fused against the reference's
classic shade_surface (3e-4 and > 55 dB), and the clustering tables it
consumes — all on one synthetic G-buffer made from a seed."""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from granite_tpu.math.muglm import look_at_matrix, perspective
from granite_tpu.ops import clusterer as JC
from granite_tpu.ops import light_shadows as JL
from granite_tpu.ops import shade_fused as JSF
from granite_tpu.ops import shadow as JSH
from granite_tpu.renderer import environment as JE
from granite_tpu.renderer import scene_renderer as JS
from granite_tpu_torch import convert
from granite_tpu_torch.ops import clusterer as TC
from granite_tpu_torch.ops import light_shadows as TL
from granite_tpu_torch.ops import shade_fused as TSF
from granite_tpu_torch.ops import shadow as TSH
from granite_tpu_torch.renderer import scene_renderer as TS

H, W = 96, 160
Z_NEAR, Z_FAR = 0.1, 100.0


def _camera():
    eye = np.array([0.0, 2.0, 6.0], np.float32)
    view = look_at_matrix(eye, np.array([0.0, 0.5, 0.0], np.float32),
                          np.array([0.0, 1.0, 0.0], np.float32))
    vp = perspective(np.pi / 3, W / H, Z_NEAR, Z_FAR) @ view
    return eye, view, vp, np.linalg.inv(vp).astype(np.float32)


def _gbuffer(seed):
    """Synthetic G-buffer whose positions lie in the view frustum."""
    rng = np.random.default_rng(seed)
    eye, view, vp, ivp = _camera()
    xs = (np.arange(W, dtype=np.float32)[None, :] + 0.5) / W * 2 - 1
    ys = (np.arange(H, dtype=np.float32)[:, None] + 0.5) / H * 2 - 1
    depth = rng.uniform(0.15, 0.95, (H, W)).astype(np.float32)
    ndc = np.stack([np.broadcast_to(xs, (H, W)),
                    np.broadcast_to(ys, (H, W)), depth,
                    np.ones((H, W), np.float32)], axis=-1)
    wp = ndc @ ivp.T
    n = rng.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    surf = {
        "base_color": rng.uniform(0.05, 1.0, (H, W, 3)).astype(np.float32),
        "normal": n,
        "metallic": rng.uniform(0.0, 1.0, (H, W)).astype(np.float32),
        "roughness": rng.uniform(0.05, 1.0, (H, W)).astype(np.float32),
        "pos": (wp[..., :3] / wp[..., 3:4]).astype(np.float32),
        "emissive": (rng.uniform(0.0, 0.2, (H, W, 3)) ** 2)
        .astype(np.float32),
        "covered": rng.uniform(size=(H, W)) < 0.8,
    }
    sun = np.array([0.3, 0.8, 0.5], np.float32)
    params = {"camera_pos": eye, "sun_dir": sun / np.linalg.norm(sun),
              "sun_color": np.array([2.0, 1.9, 1.7], np.float32),
              "view": view.astype(np.float32),
              "inv_view_proj": ivp}
    return surf, params, view, vp


def _lights(view, vp, n):
    rng = np.random.default_rng(7)
    pos = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    col = rng.uniform(0.5, 6.0, (n, 3)).astype(np.float32)
    radii = rng.uniform(1.0, 6.0, n).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    inner = rng.uniform(0.2, 0.5, n).astype(np.float32)
    is_spot = (rng.uniform(size=n) < 0.5).astype(np.float32)
    lights = JC.pack_lights(pos, col, radii, dirs, inner, inner + 0.3,
                            is_spot, capacity=32)
    return (lights, JC.bin_lights_z(lights, jnp.asarray(view), 32, Z_NEAR,
                                    Z_FAR),
            JC.bin_lights_tiles(lights, jnp.asarray(vp), W, H, tile=64))


def _kwargs(case, view, vp, rng):
    """Reference-side kwargs of shade_surface for each lighting case."""
    kw = dict(width=W, height=H, z_near=Z_NEAR, z_far=Z_FAR)
    if case == "sun":
        kw["background"] = jnp.asarray(np.array([0.1, 0.2, 0.3],
                                                 np.float32))
        return kw
    lights, zm, tm = _lights(view, vp, 11 if case == "lights" else 5)
    kw.update(lights=lights, z_masks=zm, tile_masks=tm)
    if case == "lights":
        kw["shadow_map"] = jnp.asarray(
            rng.uniform(0.0, 1.0, (128, 128)).astype(np.float32))
        kw["shadow_uv_mat"] = jnp.asarray(JSH.shadow_uv_transform(
            JSH.directional_shadow_matrix(
                np.array([0.3, 0.8, 0.5], np.float32),
                np.full(3, -8.0, np.float32), np.full(3, 8.0, np.float32))))
        kw["ao"] = jnp.asarray(rng.uniform(0.3, 1.0, (H, W))
                               .astype(np.float32))
        kw["background"] = jnp.zeros(3, jnp.float32)
    elif case == "env":
        je = JE.Environment(JE.procedural_sky_equirect(32))
        kw["env"] = {"strips": je.strips, "sh": je.sh,
                     "levels": je.num_levels, "sky_params": None}
    elif case == "cluster_shadows":
        infos = [{"pos": np.asarray(lights.pos[i]),
                  "dir": np.asarray(lights.dir[i]),
                  "radius": 1.0 / float(lights.inv_radius[i]),
                  "outer": 0.6, "is_spot": bool(lights.is_spot[i] > 0.5)}
                 for i in range(5)]
        vps, slice_np, kind_np = JL.assign_slices(infos)
        atlas = rng.uniform(0.0, 1.0, (vps.shape[0], 32, 32)) \
            .astype(np.float32)
        kw["cluster_shadows"] = {
            "atlas_flat": JL.pack_atlas(jnp.asarray(atlas)), "vps_np": vps,
            "size": 32, "num_lights": 5, "light_slice_np": slice_np,
            "light_kind_np": kind_np,
            "light_pos_np": np.asarray(lights.pos[:5]), "k": 2,
            "bias": 2e-3}
        kw["background"] = jnp.zeros(3, jnp.float32)
    return kw


def _port_kwargs(kw):
    out = convert.frame_params({k: v for k, v in kw.items()
                                if k not in ("env", "cluster_shadows")})
    if "env" in kw:
        out["env"] = dict(convert.frame_params(
            {k: kw["env"][k] for k in ("strips", "sh")}),
            levels=kw["env"]["levels"], sky_params=None)
    if "cluster_shadows" in kw:
        cs = dict(kw["cluster_shadows"])
        cs["atlas_flat"] = convert.tensor(cs["atlas_flat"])
        out["cluster_shadows"] = cs
    return out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(1.0, float(np.abs(a).max()))


def _psnr(a, b):
    a = np.clip(np.asarray(a), 0, 1) * 255
    b = np.clip(np.asarray(b), 0, 1) * 255
    return 10 * math.log10(255.0 ** 2 / max(float(((a - b) ** 2).mean()),
                                            1e-12))


CASES = ["sun", "lights", "env", "cluster_shadows"]


@pytest.mark.parametrize("case", CASES)
def test_shade_surface_fused_matches_reference(case):
    rng = np.random.default_rng(CASES.index(case) + 3)
    surf, params, view, vp = _gbuffer(CASES.index(case) + 3)
    kw = _kwargs(case, view, vp, rng)
    jsurf = {k: jnp.asarray(v) for k, v in surf.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    classic = JS.shade_surface(jsurf, jparams, **kw)
    pallas = JS.shade_surface_fused(jsurf, jparams, interpret=True, **kw)
    port = TS.shade_surface_fused(convert.frame_params(surf),
                                  convert.frame_params(params),
                                  **_port_kwargs(kw)).numpy()
    assert _rel(pallas, port) < 3e-4
    assert _rel(classic, port) < 3e-4
    assert _psnr(classic, port) > 55.0


def test_b4_plain_matches_pallas_kernel():
    """shade_planes_fused on the stacked planes the reference wrapper
    builds (random planes, lights and slot planes)."""
    rng = np.random.default_rng(21)
    _, params, view, vp = _gbuffer(21)
    lights, _, tm = _lights(view, vp, 9)
    ph, pw, k = 96, 256, 2
    planes = rng.uniform(0, 1, (JSF.P_FIXED + 2 * k, ph, pw)) \
        .astype(np.float32)
    planes[JSF.P_NRM:JSF.P_NRM + 3] /= np.linalg.norm(
        planes[JSF.P_NRM:JSF.P_NRM + 3], axis=0, keepdims=True)
    planes[JSF.P_POS:JSF.P_POS + 3] = rng.uniform(-4, 4, (3, ph, pw))
    planes[JSF.P_FIXED:JSF.P_FIXED + k] = rng.integers(-1, 9, (k, ph, pw))
    ltbl = JSF.fused_light_table(lights, jnp.asarray(view), Z_NEAR, Z_FAR,
                                 32)
    tmask = np.asarray(tm)[..., 0].view(np.int32)
    tmask = np.pad(tmask, ((0, 2 - tmask.shape[0]), (0, 4 - tmask.shape[1])))
    uni = np.zeros((8, 128), np.float32)
    uni[0, 0:3] = params["camera_pos"]
    uni[0, 3:6] = params["sun_dir"]
    uni[0, 6] = 9
    uni[0, 9:13] = view[2]
    uni[1, 0:3] = params["sun_color"]
    for has_env in (True, False):
        kw = dict(k_shadow=k, has_env=has_env, has_lights=True,
                  has_ao=True, ambient=not has_env)
        ref = JSF.shade_planes_fused(jnp.asarray(planes), ltbl,
                                     jnp.asarray(tmask), jnp.asarray(uni),
                                     90, 250, interpret=True, **kw)
        got = TSF.shade_planes_fused(
            torch.as_tensor(planes), convert.tensor(ltbl),
            torch.as_tensor(tmask), torch.as_tensor(uni), 90, 250, **kw)
        assert _rel(ref, got.numpy()) < 3e-4


def test_cluster_tables_match():
    _, _, view, vp = _gbuffer(4)
    jl, jzm, jtm = _lights(view, vp, 13)
    tl = convert.light_buffer(jl)
    tzm = TC.bin_lights_z(tl, torch.as_tensor(view.astype(np.float32)), 32,
                          Z_NEAR, Z_FAR)
    ttm = TC.bin_lights_tiles(tl, torch.as_tensor(vp.astype(np.float32)),
                              W, H, 64)
    assert np.array_equal(np.asarray(jzm).view(np.int32), tzm.numpy())
    assert np.array_equal(np.asarray(jtm).view(np.int32), ttm.numpy())
    jt = JSF.fused_light_table(jl, jnp.asarray(view), Z_NEAR, Z_FAR, 32)
    tt = TSF.fused_light_table(tl, torch.as_tensor(view.astype(np.float32)),
                               Z_NEAR, Z_FAR, 32)
    assert np.allclose(np.asarray(jt), tt.numpy(), rtol=1e-6)
    # pack_lights itself (host numpy) is a copy
    pl = TC.pack_lights(np.ones((3, 3)), np.ones((3, 3)), np.ones(3) * 2,
                        capacity=8)
    jp = JC.pack_lights(np.ones((3, 3)), np.ones((3, 3)), np.ones(3) * 2,
                        capacity=8)
    for a, b in zip(jp[:-1], pl[:-1]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert int(jp.count) == pl.count == 3


def test_shadow_terms_match():
    rng = np.random.default_rng(8)
    surf, _, view, vp = _gbuffer(8)
    pos = surf["pos"]
    m = JSH.shadow_uv_transform(JSH.directional_shadow_matrix(
        np.array([0.3, 0.8, 0.5], np.float32), np.full(3, -8.0, np.float32),
        np.full(3, 8.0, np.float32)))
    assert np.array_equal(m, TSH.shadow_uv_transform(
        TSH.directional_shadow_matrix(
            np.array([0.3, 0.8, 0.5], np.float32),
            np.full(3, -8.0, np.float32), np.full(3, 8.0, np.float32))))
    smap = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    ref = np.asarray(JSH.sample_directional_shadow(
        jnp.asarray(smap), jnp.asarray(m), jnp.asarray(pos)))
    got = TSH.sample_directional_shadow(torch.as_tensor(smap),
                                        torch.as_tensor(m),
                                        torch.as_tensor(pos)).numpy()
    assert np.allclose(ref, got, atol=1e-5)
    jl, _, _ = _lights(view, vp, 4)
    infos = [{"pos": np.asarray(jl.pos[i]), "dir": np.asarray(jl.dir[i]),
              "radius": 4.0, "outer": 0.6, "is_spot": i == 0}
             for i in range(4)]
    vps, sl, kd = JL.assign_slices(infos)
    vps_t, sl_t, kd_t = TL.assign_slices(infos)
    assert np.array_equal(vps, vps_t) and np.array_equal(sl, sl_t)
    assert np.array_equal(kd, kd_t)
    atlas = rng.uniform(0, 1, (vps.shape[0], 16, 16)).astype(np.float32)
    ja = JL.pack_atlas(jnp.asarray(atlas))
    ta = TL.pack_atlas(torch.as_tensor(atlas))
    assert np.array_equal(np.asarray(ja), ta.numpy())
    masks = np.full((H, W, 1), 0b1011, np.uint32)
    js, jt = JL.topk_shadow_terms(ja, vps, 16, 4, sl, kd,
                                  np.asarray(jl.pos[:4]), jnp.asarray(masks),
                                  jnp.asarray(pos), k=2)
    ts, tt = TL.topk_shadow_terms(ta, vps, 16, 4, sl, kd,
                                  np.asarray(jl.pos[:4]),
                                  convert.tensor(masks),
                                  torch.as_tensor(pos), k=2)
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.allclose(np.asarray(jt), tt.numpy(), atol=1e-5)
