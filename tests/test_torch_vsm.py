"""Port parity for the directional VSM path: granite_tpu_torch's
ops/shadow.vsm_moments, sample_vsm_shadow and sample_vsm_shadow_tiled,
and kernel B3T's plain version (ops/tile_sampler.sample_bilinear),
against the JAX package on seeded numpy inputs.  The tiled route is held
against the reference's level-0 target (tests/test_tile_sampler.py
`want_h`), not the interpret-mode Pallas sampler."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from granite_tpu.ops import hdr as JH
from granite_tpu.ops import shadow as JS
from granite_tpu_torch.ops import hdr as TH
from granite_tpu_torch.ops import shadow as TS
from granite_tpu_torch.ops.tile_sampler import sample_bilinear


def _smooth_depth(seed, s):
    rng = np.random.RandomState(seed)
    depth = rng.rand(s, s).astype(np.float32)
    for _ in range(4):     # smooth, like a real scene depth map
        depth = (depth + np.roll(depth, 1, 0) + np.roll(depth, 1, 1)
                 + np.roll(depth, -1, 0) + np.roll(depth, -1, 1)) / 5
    return depth


def _uv_mat():
    return JS.shadow_uv_transform(JS.directional_shadow_matrix(
        (0.3, 0.9, 0.2), (-5, -5, -5), (5, 5, 5)))


def test_vsm_moments_match():
    depth = np.random.RandomState(1).rand(64, 64).astype(np.float32)
    want = np.asarray(JS.vsm_moments(jnp.asarray(depth)))
    got = TS.vsm_moments(torch.as_tensor(depth)).numpy()
    assert got.shape == (64, 64, 2)
    assert np.allclose(got, want, rtol=0, atol=1e-6)
    # kernel B3T takes the map only as a contiguous tensor
    assert TS.vsm_moments(torch.as_tensor(depth)).is_contiguous()


def _coords(seed, shape):
    """u, v inside, on and outside [0, 1], a few NaN; live mask."""
    rng = np.random.RandomState(seed)
    u = rng.uniform(-0.3, 1.3, shape).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, shape).astype(np.float32)
    u[0, :4] = [0.0, 1.0, 0.5, 1.0]
    v[0, :4] = [0.0, 1.0, 1.0, 0.0]
    u[1, 1] = np.nan
    v[2, 3] = np.nan
    live = rng.rand(*shape) > 0.25
    live[1, 1] = live[2, 3] = True
    return u, v, live


@pytest.mark.parametrize("size", [(64, 64), (16, 48), (1, 1)])
def test_b3t_plain_matches_sample_bilinear_uv(size):
    img = np.random.RandomState(2).rand(*size, 2).astype(np.float32)
    u, v, live = _coords(3, (24, 40))
    ref = np.asarray(JH._sample_bilinear_uv(jnp.asarray(img), jnp.asarray(u),
                                            jnp.asarray(v)))
    want = np.nan_to_num(np.where(live[..., None], ref, 0.0), nan=0.0,
                         posinf=1.0, neginf=0.0)
    got = sample_bilinear(torch.as_tensor(img), torch.as_tensor(u),
                          torch.as_tensor(v), torch.as_tensor(live)).numpy()
    assert got.shape == (24, 40, 2) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert (got[~live] == 0).all() and (got[1, 1] == 0).all()
    assert np.allclose(got, want, rtol=0, atol=1e-6)


def test_bilinear_saturates_non_finite_like_xla():
    """u = +-inf or past the int32 range selects the edge texel, as XLA's
    saturating float->int conversion does (a plain torch cast sends them
    all to INT_MIN, i.e. texel 0: the port's fault before the fix)."""
    img = np.random.RandomState(4).rand(4, 6, 2).astype(np.float32)
    u = np.array([np.inf, -np.inf, 3e9, -3e9, 0.4], np.float32)
    v = np.array([0.3, 0.7, np.inf, 0.1, -np.inf], np.float32)
    want = np.asarray(JH._sample_bilinear_uv(
        jnp.asarray(img), jnp.asarray(u), jnp.asarray(v)))
    got = TH._sample_bilinear_uv(torch.as_tensor(img), torch.as_tensor(u),
                                 torch.as_tensor(v)).numpy()
    assert np.array_equal(got, want)
    sm = np.random.RandomState(5).rand(8, 8).astype(np.float32)
    z = np.full(5, 0.5, np.float32)
    want = np.asarray(JS.pcf_2x2(jnp.asarray(sm), jnp.asarray(u),
                                 jnp.asarray(v), jnp.asarray(z)))
    got = TS.pcf_2x2(torch.as_tensor(sm), torch.as_tensor(u),
                     torch.as_tensor(v), torch.as_tensor(z)).numpy()
    assert np.array_equal(got, want)


def _positions(span, h, w):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([xs / w * span - span / 2, np.zeros_like(xs),
                     ys / h * span - span / 2], axis=-1).astype(np.float32)


def test_sample_vsm_shadow_matches():
    moments = JS.vsm_moments(jnp.asarray(_smooth_depth(0, 64)))
    mat = _uv_mat()
    pos = _positions(12.0, 24, 40)        # part of it outside the frustum
    pos[..., 1] = np.random.RandomState(6).uniform(-3, 3, pos.shape[:2])
    want = np.asarray(JS.sample_vsm_shadow(moments, jnp.asarray(mat),
                                           jnp.asarray(pos)))
    got = TS.sample_vsm_shadow(torch.tensor(np.asarray(moments)),
                               torch.as_tensor(mat),
                               torch.as_tensor(pos)).numpy()
    assert (want == 1.0).any() and (want < 1.0).any()
    # The light-space projection differs by an ulp (matmul summation
    # order), and the Chebyshev term divides by a variance floored at
    # 1e-5, which amplifies it to ~5e-5: the tiled test's 1e-4 bound.
    assert np.allclose(got, want, rtol=0, atol=1e-4)


def test_tiled_route_matches_level0_target():
    """The port's tiled VSM route (half-res term through B3T's plain
    version) against the reference's exact level-0 composition on the
    smooth 128^2 depth map at 64x256 (tests/test_tile_sampler.py)."""
    moments = JS.vsm_moments(jnp.asarray(_smooth_depth(0, 128)))
    mat = _uv_mat()
    H, W = 64, 256
    pos = _positions(1.0, H, W)
    mj, pj = jnp.asarray(mat), jnp.asarray(pos)
    uvw = (pj @ mj[:3, :3].T) + mj[:3, 3]
    u, v, z = uvw[..., 0], uvw[..., 1], uvw[..., 2]
    mm = JH._sample_bilinear_uv(moments, u[::2, ::2], v[::2, ::2])
    th = JS._vsm_term(z[::2, ::2], mm[..., 0], mm[..., 1])
    want_h = np.asarray(JH.resize_bilinear(th[..., None], H, W)[..., 0])
    got = TS.sample_vsm_shadow_tiled(
        torch.tensor(np.asarray(moments)), torch.as_tensor(mat),
        torch.as_tensor(pos), torch.ones((H, W), dtype=torch.bool)).numpy()
    assert got.shape == (H, W)
    assert np.abs(got - want_h).max() <= 1e-4
    # uncovered pixels skip the fetch (moments 0), as the reference's
    # bundle -1 does; below 64 rows the term stays at full resolution
    small = TS.sample_vsm_shadow_tiled(
        torch.tensor(np.asarray(moments)), torch.as_tensor(mat),
        torch.as_tensor(pos[:32]), torch.zeros((32, W), dtype=torch.bool))
    m0 = torch.zeros(32, W)
    uvz = torch.tensor(np.asarray(uvw[:32]))
    assert torch.equal(small, TS._vsm_term(uvz[..., 2], m0, m0))


def test_b3t_rejects_unsupported_tensors():
    img = torch.zeros(4, 4, 2, device="meta")
    u = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):
        sample_bilinear(img, u, u, u.bool())
