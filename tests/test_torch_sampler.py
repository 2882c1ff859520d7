"""Port parity for the texture strips and kernel B3's plain version
(granite_tpu_torch/ops/tile_sampler.py) against the JAX reference's
ops/texture builders and sample_packed_lod, plus the environment bake
and fetch (renderer/environment.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from granite_tpu.assets import texture_array as JTA
from granite_tpu.ops import fastmath as JFM
from granite_tpu.ops import texture as JT
from granite_tpu.renderer import environment as JE
from granite_tpu_torch import convert
from granite_tpu_torch.assets import texture_array as TTA
from granite_tpu_torch.ops import fastmath as TFM
from granite_tpu_torch.ops import light_shadows as TL
from granite_tpu_torch.ops import texture as TT
from granite_tpu_torch.ops.tile_sampler import row_stride, sample_lod
from granite_tpu_torch.renderer import environment as TE

HW = (48, 80)


def _img(seed, s, c):
    return np.random.RandomState(seed).uniform(0, 1, (s, s, c)) \
        .astype(np.float32)


@pytest.mark.parametrize("wrap", [JT.WRAP_REPEAT, JT.WRAP_CLAMP])
@pytest.mark.parametrize("size,channels", [(16, 12), (32, 4), (1, 3)])
def test_strip_builders_match(wrap, size, channels):
    img = _img(size, size, channels)
    assert TT.num_mip_levels(size, size) == JT.num_mip_levels(size, size)
    assert TT.gutter_strip_height(size) == JT.gutter_strip_height(size)
    for dt in ("float16", "float32"):
        a = JT.build_packed_lod_strip_np(img, wrap, dtype=dt)
        b = TT.build_packed_lod_strip_np(img, wrap, dtype=dt)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_texture_helpers_match():
    rng = np.random.RandomState(2)
    u8 = rng.randint(0, 256, (20, 12, 4)).astype(np.uint8)
    for srgb in (True, False):
        ja, tb = JTA.TextureArrayBuilder(16), TTA.TextureArrayBuilder(16)
        assert ja.add_image(u8, srgb) == tb.add_image(u8, srgb)
        for x, y in zip(ja._images, tb._images):
            assert np.array_equal(x, y)
    img = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
    q_j = np.asarray(JT.quad_pack2d(jnp.asarray(img)))
    assert np.array_equal(q_j, TT.quad_pack2d(torch.as_tensor(img)).numpy())


def _coords(seed, n_bundles):
    rng = np.random.RandomState(seed)
    u = rng.uniform(-1.5, 2.5, HW).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, HW).astype(np.float32)
    lod = rng.uniform(-1.0, 9.0, HW).astype(np.float32)
    b = rng.randint(0, n_bundles, HW).astype(np.int32)
    return u, v, lod, b


@pytest.mark.parametrize("dtype,channels,size", [
    ("float16", 12, 32),     # material bundles
    ("float32", 4, 64),      # environment strip
])
def test_b3_plain_matches_sample_packed_lod(dtype, channels, size):
    strips = np.stack([TT.build_packed_lod_strip_np(
        _img(k, size, channels), dtype=dtype) for k in range(3)])
    u, v, lod, b = _coords(7, 3)
    ref = np.asarray(JT.sample_packed_lod(
        jnp.asarray(strips), jnp.asarray(b), jnp.asarray(u),
        jnp.asarray(v), jnp.asarray(lod), channels))
    got = sample_lod(torch.as_tensor(strips), torch.as_tensor(b),
                     torch.as_tensor(u), torch.as_tensor(v),
                     torch.as_tensor(lod), channels).numpy()
    assert got.shape == HW + (channels,)
    assert np.allclose(got, ref, rtol=0, atol=1e-6)


# Coordinates past the int32 range once scaled to texels, and non-finite
# ones: XLA saturates the float -> int32 cast (NaN -> 0) where a plain
# torch cast on the CPU gives INT32_MIN, so the texel picked differs.
EDGE_UV = np.array([3e9, -3e9, 5e9, 7e8, 1e8, np.inf, -np.inf, np.nan, 0.3],
                   np.float32)


@pytest.mark.parametrize("dtype,channels,size", [
    ("float16", 12, 32),     # material bundles
    ("float32", 4, 64),      # environment strip
])
def test_b3_plain_saturates_like_xla(dtype, channels, size):
    """B3's plain version against the reference's sample_packed_lod for
    every (u, v) pair of EDGE_UV at lods 0, 2 and the last level."""
    strips = np.stack([TT.build_packed_lod_strip_np(
        _img(k + 11, size, channels), dtype=dtype) for k in range(2)])
    u, v = (a.astype(np.float32) for a in np.meshgrid(EDGE_UV, EDGE_UV))
    b = (np.arange(u.size) % 2).reshape(u.shape).astype(np.int32)
    for lod_value in (0.0, 2.0, TT.num_mip_levels(size, size) - 1.0):
        lod = np.full(u.shape, lod_value, np.float32)
        ref = np.asarray(JT.sample_packed_lod(
            jnp.asarray(strips), jnp.asarray(b), jnp.asarray(u),
            jnp.asarray(v), jnp.asarray(lod), channels))
        args = (torch.as_tensor(strips), torch.as_tensor(b),
                torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(lod),
                channels)
        raw = TT.sample_packed_lod(*args).numpy()
        assert np.allclose(raw, ref, rtol=0, atol=1e-6, equal_nan=True)
        got = sample_lod(*args).numpy()
        want = np.nan_to_num(ref, nan=0.0, posinf=1.0, neginf=0.0)
        assert np.allclose(got, want, rtol=0, atol=1e-6)


def test_saturating_int32_matches_xla():
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.0 ** 31,
                  -2.0 ** 31, 2147483520.0, -7.0, 0.0], np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    got = TT.saturating_int32(torch.as_tensor(x)).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, ref)


def test_clip_coords_saturates_like_xla():
    """light_shadows._clip_coords against the reference's expression
    (granite_tpu/ops/light_shadows.py, the slice's x0/y0/fx/fy), exact."""
    S = 16
    x, y = (a.astype(np.float32) for a in np.meshgrid(
        EDGE_UV * S - 0.5, np.append(EDGE_UV, [-4.0, 15.7]) * S - 0.5))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jx0 = jnp.clip(jnp.floor(jx).astype(jnp.int32), 0, S - 1)
    jy0 = jnp.clip(jnp.floor(jy).astype(jnp.int32), 0, S - 1)
    jfx = jnp.clip(jx - jx0.astype(jx.dtype), 0.0, 1.0)
    jfy = jnp.clip(jy - jy0.astype(jy.dtype), 0.0, 1.0)
    x0, y0, fx, fy = TL._clip_coords(torch.as_tensor(x), torch.as_tensor(y),
                                     S)
    assert x0.dtype == y0.dtype == torch.int32
    assert np.array_equal(x0.numpy(), np.asarray(jx0))
    assert np.array_equal(y0.numpy(), np.asarray(jy0))
    assert np.array_equal(fx.numpy(), np.asarray(jfx), equal_nan=True)
    assert np.array_equal(fy.numpy(), np.asarray(jfy), equal_nan=True)


def test_b3_strided_views_match_contiguous():
    """The main path hands B3 u and v as views of the uv planes; the
    wrapper's result equals its result on contiguous copies."""
    strips = torch.as_tensor(TT.build_packed_lod_strip_np(_img(5, 16, 12)))[
        None]
    u, v, lod, b = _coords(6, 1)
    planes = torch.as_tensor(np.stack([u, v]))[:, :40, :72]
    uv = planes.movedim(0, -1)
    lod_t, b_t = torch.as_tensor(lod)[:40, :72], torch.as_tensor(b)[:40, :72]
    assert not uv[..., 0].is_contiguous()
    strided = sample_lod(strips, b_t, uv[..., 0], uv[..., 1], lod_t, 12)
    dense = sample_lod(strips, b_t.contiguous(), uv[..., 0].contiguous(),
                       uv[..., 1].contiguous(), lod_t.contiguous(), 12)
    assert torch.equal(strided, dense)


@pytest.mark.parametrize("make", [
    lambda t: t,                                   # contiguous
    lambda t: t[:, :40, :72].movedim(0, -1)[..., 1],   # uv[..., 1] of a crop
    lambda t: t.movedim(0, -1)[..., 0],            # uv[..., 0], whole plane
    lambda t: t[0, ::2, 3:9],                      # every other row
    lambda t: t[:, 5:6, :].movedim(0, -1)[..., 0],     # one row
    lambda t: t[0, 7, 11],                         # 0-d
])
def test_row_strides_read_the_view(make):
    """The kernel reads input i at (i // W) * row + i % W of the view's
    storage: row_stride gives that stride for the main path's views."""
    base = torch.arange(2 * 48 * 80, dtype=torch.float32).reshape(2, 48, 80)
    t = make(base)
    row = row_stride(t)
    W = t.shape[-1] if t.dim() else 1
    i = torch.arange(t.numel())
    flat = base.reshape(-1)[t.storage_offset() + (i // W) * row + i % W]
    assert torch.equal(flat, t.reshape(-1))


def test_row_strides_rejects_unmergeable_layouts():
    t = torch.zeros(4, 6, 8).permute(1, 0, 2)      # rows not in order
    with pytest.raises(ValueError):
        row_stride(t)


def test_row_stride_rejects_column_strides():
    """The kernel reads each row's elements contiguously: an (H, W, 2)
    tensor's [..., 0] is refused, a width-1 column is not."""
    t = torch.zeros(6, 8, 2)
    with pytest.raises(ValueError):
        row_stride(t[..., 0])
    assert row_stride(t[:, :1, 0]) == 16


def test_b3_wrapper_never_runs_plain_on_other_devices():
    """Only all-CPU inputs take the plain version; strips or coordinates
    on another device go to the kernel's checks, which raise here."""
    strips = torch.as_tensor(TT.build_packed_lod_strip_np(_img(1, 16, 4),
                                                          dtype="float32"))[None]
    u, v, lod, b = map(torch.as_tensor, _coords(2, 1))
    with pytest.raises(ValueError):
        sample_lod(strips.to("meta"), b, u, v, lod, 4)
    with pytest.raises(ValueError):
        sample_lod(strips, b, u.to("meta"), v, lod, 4)


def test_b3_skips_uncovered_and_contains_nans():
    strips = TT.build_packed_lod_strip_np(_img(1, 16, 12))[None]
    u, v, lod, b = _coords(3, 1)
    b[::3] = -1
    u[1, 1] = np.nan
    lod[2, 2] = np.nan
    got = sample_lod(torch.as_tensor(strips), torch.as_tensor(b),
                     torch.as_tensor(u), torch.as_tensor(v),
                     torch.as_tensor(lod), 12).numpy()
    assert np.isfinite(got).all()
    assert (got[::3] == 0).all()
    assert (got[1, 1] == 0).all() and (got[2, 2] == 0).all()
    assert (got[1::3] != 0).any()


def test_lod_from_derivs_matches():
    rng = np.random.RandomState(4)
    d = [rng.normal(0, 0.01, HW).astype(np.float32) for _ in range(4)]
    ref = np.asarray(JT.lod_from_derivs(*map(jnp.asarray, d), 512, 512,
                                        bias=0.5))
    got = TT.lod_from_derivs(*map(torch.as_tensor, d), 512, 512,
                             bias=0.5).numpy()
    assert np.allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_fastmath_matches():
    rng = np.random.RandomState(5)
    x, y, z = (rng.uniform(-1, 1, 4096).astype(np.float32)
               for _ in range(3))
    ju, jv = JFM.equirect_uv(*map(jnp.asarray, (x, y, z)))
    tu, tv = TFM.equirect_uv(*map(torch.as_tensor, (x, y, z)))
    assert np.allclose(np.asarray(ju), tu.numpy(), atol=1e-6)
    assert np.allclose(np.asarray(jv), tv.numpy(), atol=1e-6)
    t = rng.uniform(-0.2, 1.2, (64, 3))
    # float64 on both sides; vectorized libraries may round the last bit
    assert np.allclose(JFM.pow07(t, np), TFM.pow07_np(t), rtol=0,
                       atol=1e-14)


def test_environment_bake_matches():
    sky = dict(sun_dir=(0.3, 0.9, 0.2), sun_color=(3.0, 2.5, 2.0))
    eq_j = JE.procedural_sky_equirect(32, **sky)
    eq_t = TE.procedural_sky_equirect(32, **sky)
    assert np.array_equal(eq_j, eq_t)
    je = JE.Environment(eq_j, sky_params=sky)
    te = TE.Environment(eq_t, sky_params=sky)
    assert np.array_equal(np.asarray(je.strips), te.strips.numpy())
    assert np.array_equal(np.asarray(je.sh), te.sh.numpy())
    assert je.num_levels == te.num_levels


def test_environment_fetch_matches():
    """Specular env fetch through B3's plain version vs the reference's
    sample_environment; analytic sky and SH irradiance too."""
    je = JE.Environment(JE.procedural_sky_equirect(32))
    env = convert.environment(je)
    rng = np.random.RandomState(9)
    d = rng.normal(size=HW + (3,)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    lod = rng.uniform(0, je.num_levels, HW).astype(np.float32)
    ref = np.asarray(JE.sample_environment(je.strips, jnp.asarray(d),
                                           jnp.asarray(lod)))
    got = TE.sample_environment(env["strips"], torch.as_tensor(d),
                                torch.as_tensor(lod)).numpy()
    assert np.allclose(got, ref, rtol=1e-5, atol=1e-5)
    sky_j = np.asarray(JE.analytic_sky(jnp.asarray(d)))
    sky_t = TE.analytic_sky(torch.as_tensor(d)).numpy()
    assert np.allclose(sky_j, sky_t, rtol=1e-5, atol=1e-5)
    irr_j = np.asarray(JE.eval_sh9(je.sh, jnp.asarray(d)))
    irr_t = TE.eval_sh9(env["sh"], torch.as_tensor(d)).numpy()
    assert np.allclose(irr_j, irr_t, rtol=1e-5, atol=1e-6)
