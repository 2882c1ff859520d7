"""Port parity for the LDR anti-aliasing passes: granite_tpu_torch's
ops/fxaa.fxaa and ops/smaa.smaa against the JAX package's on the same
seeded 72x128 LDR image with hard edges (blocks, a slanted half-plane, a
disc)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from granite_tpu.ops import fxaa as JF
from granite_tpu.ops import smaa as JS
from granite_tpu_torch.ops import fxaa as TF
from granite_tpu_torch.ops import smaa as TS

H, W = 72, 128


def _ldr(seed=11):
    rng = np.random.RandomState(seed)
    img = np.kron(rng.uniform(0, 1, (H // 8, W // 16, 3)),
                  np.ones((8, 16, 1)))
    ys, xs = np.mgrid[0:H, 0:W]
    img[xs + 0.45 * ys > 70] = rng.uniform(0, 1, 3)
    img[(xs - 90) ** 2 + (ys - 40) ** 2 < 18 ** 2] = rng.uniform(0, 1, 3)
    return img.astype(np.float32)


def test_fxaa_matches():
    img = _ldr()
    want = np.asarray(JF.fxaa(jnp.asarray(img), W, H))
    got = TF.fxaa(torch.as_tensor(img), W, H).numpy()
    assert got.shape == (H, W, 3)
    assert np.abs(got - img).max() > 0.05        # it did anti-alias
    assert np.allclose(got, want, rtol=0, atol=1e-5)


def test_smaa_matches():
    img = _ldr()
    want = np.asarray(JS.smaa(jnp.asarray(img)))
    got = TS.smaa(torch.as_tensor(img)).numpy()
    assert got.shape == (H, W, 3)
    assert np.abs(got - img).max() > 0.05
    assert np.allclose(got, want, rtol=0, atol=1e-5)
    # the intermediate passes agree exactly too
    el_j, et_j = JS.edge_detection(jnp.asarray(img))
    el_t, et_t = TS.edge_detection(torch.as_tensor(img))
    assert np.array_equal(np.asarray(el_j), el_t.numpy())
    assert np.array_equal(np.asarray(et_j), et_t.numpy())
    for a, b in zip(JS.blending_weights(el_j, et_j),
                    TS.blending_weights(el_t, et_t)):
        assert np.allclose(np.asarray(a), b.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dy,dx", [(0, 0), (-1, 0), (2, 0), (0, -2),
                                   (1, 1), (-3, 5), (80, -200)])
def test_shift_matches(dy, dx):
    img = np.random.RandomState(3).rand(9, 7, 2).astype(np.float32)
    want = np.asarray(JF._shift(jnp.asarray(img), dy, dx))
    assert np.array_equal(TF.shift(torch.as_tensor(img), dy, dx).numpy(),
                          want)
