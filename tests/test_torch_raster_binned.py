"""Port parity for triangle setup, binning and kernel B1's plain version
(granite_tpu_torch/ops/raster_binned.py) against the JAX reference:
ops/raster.setup_triangles, raster_binned.bin_triangles,
rasterize_binned in Pallas interpret mode and the brute-force
ops/raster.rasterize — on identical setup arrays, made from a seed."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from granite_tpu.math import look_at_matrix, perspective
from granite_tpu.ops import raster as JR
from granite_tpu.ops import raster_binned as JB
from granite_tpu_torch import convert
from granite_tpu_torch.ops import raster as TR
from granite_tpu_torch.ops import raster_binned as TB

W, H = 256, 96   # 2x3 tiles of 128x32


def _random_clip(n, seed):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-1.1, 1.1, (n, 1, 2))
    offs = rng.uniform(-0.25, 0.25, (n, 3, 2))
    offs[: n // 10] *= 6          # a few multi-tile and huge triangles
    xy = (centers + offs).reshape(-1, 2)
    z = np.repeat(rng.uniform(0.1, 0.9, n), 3)
    return np.concatenate([xy, z[:, None], np.ones((n * 3, 1))],
                          axis=1).astype(np.float32)


def _perspective_clip(n, seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-3, 3, (n * 3, 3)).astype(np.float32)
    pts[:, 2] = -rng.uniform(0.05, 20.0, n * 3)   # some cross the near plane
    vp = perspective(np.pi / 2, W / H, 0.1, 100.0) @ look_at_matrix(
        [0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0])
    return (vp @ np.concatenate([pts, np.ones((n * 3, 1), np.float32)],
                                1).T).T.astype(np.float32)


def _mesh_clip():
    """A closed triangle fan grid: every interior edge is shared, so the
    top-left rule and watertightness are exercised."""
    g = 9
    ys, xs = np.mgrid[0:g, 0:g].astype(np.float32)
    xy = np.stack([xs / (g - 1) * 1.8 - 0.9, ys / (g - 1) * 1.6 - 0.8], -1)
    xy = xy + 0.013 * np.sin(xy * 7.0)
    z = 0.3 + 0.2 * xy[..., :1]
    clip = np.concatenate([xy, z, np.ones_like(z)], -1).reshape(-1, 4)
    idx = []
    for y in range(g - 1):
        for x in range(g - 1):
            a = y * g + x
            idx += [[a, a + 1, a + g], [a + 1, a + g + 1, a + g]]
    return clip.astype(np.float32), np.asarray(idx, np.int32)


def _case(name):
    if name == "random":
        clip = _random_clip(60, 1)
    elif name == "perspective":
        clip = _perspective_clip(50, 3)
    else:
        return _mesh_clip()
    return clip, np.arange(len(clip), dtype=np.int32).reshape(-1, 3)


CASES = ["random", "perspective", "mesh"]


def _setups(name, cull=JR.CULL_NONE):
    clip, idx = _case(name)
    js = JR.setup_triangles(jnp.asarray(clip), jnp.asarray(idx), W, H,
                            cull_mode=cull)
    return clip, idx, js, convert.triangle_setup(js)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("cull", [JR.CULL_NONE, JR.CULL_BACK])
def test_setup_triangles_matches(name, cull):
    clip, idx, js, _ = _setups(name, cull)
    ts = TR.setup_triangles(torch.as_tensor(clip), torch.as_tensor(idx), W,
                            H, cull_mode=cull)
    assert np.array_equal(np.asarray(js.valid), ts.valid.numpy())
    assert np.array_equal(np.asarray(js.bbox), ts.bbox.numpy())
    for f in ("adj", "zplane", "offset", "edge"):
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        # float32 round-off only (XLA may contract a*b+c into an FMA)
        assert np.allclose(a, b, rtol=1e-5, atol=1e-4), f


@pytest.mark.parametrize("name", CASES)
def test_bin_triangles_matches(name):
    _, _, js, ts = _setups(name)
    jpk, jst, jhr, jhs, jstats = JB.bin_triangles(js, W, H)
    tpk, tst, thr, ths, tstats = TB.bin_triangles(ts, W, H)
    assert np.array_equal(np.asarray(jst), tst.numpy())
    assert np.array_equal(np.asarray(jhs), ths.numpy())
    for k in ("visible_overflow", "exact_entries", "window_entries",
              "huge_overflow"):
        assert int(np.asarray(jstats[k])) == int(tstats[k]), k
    # each bin / huge row holds the same triangles (ties within a bin
    # may sort in another order: the reference's argsort is unstable)
    for jp, tp, starts in ((jpk, tpk, tst), (jhr, thr, ths)):
        jid = np.asarray(jp)[:, 20].view(np.int32)
        tid = tp[:, 20].numpy().view(np.int32)
        s = starts.numpy()
        for b in range(len(s) - 1):
            assert sorted(jid[s[b]:s[b + 1]]) == sorted(tid[s[b]:s[b + 1]])


@pytest.mark.parametrize("name", CASES)
def test_b1_plain_matches_pallas_and_classic(name):
    _, _, js, ts = _setups(name)
    d_pal, t_pal = JB.rasterize_binned(js, W, H, interpret=True)
    d_ref, t_ref = JR.rasterize(js, W, H)
    d_t, t_t = TB.rasterize_binned(ts, W, H)
    assert (t_t.numpy() >= 0).sum() > 500
    for d, t in ((d_pal, t_pal), (d_ref, t_ref)):
        assert np.array_equal(np.asarray(t), t_t.numpy())
        # XLA on the CPU contracts the z-plane multiply-add into an FMA
        # (one rounding); the port rounds each operation, like the CUDA
        # kernel built with --fmad=false.  Planes with a slope (the
        # perspective case) then differ by about an ulp.
        assert np.allclose(np.asarray(d), d_t.numpy(), rtol=2e-6, atol=0)


def test_b1_wide_window_and_huge_list():
    """The shadow-map window (2x8) on a wide target, plus a screen-
    filling triangle that must take the per-row huge lists."""
    bw, bh = 512, 256
    clip = np.concatenate([_random_clip(40, 5), np.array(
        [[-4, -4, 0.2, 1], [4, -4, 0.2, 1], [0, 4, 0.2, 1]], np.float32)])
    idx = np.arange(len(clip), dtype=np.int32).reshape(-1, 3)
    js = JR.setup_triangles(jnp.asarray(clip), jnp.asarray(idx), bw, bh,
                            cull_mode=JR.CULL_NONE)
    ts = convert.triangle_setup(js)
    d_ref, t_ref = JR.rasterize(js, bw, bh)
    d_t, t_t, stats = TB.rasterize_binned(ts, bw, bh, span_w=2, span_h=8,
                                          with_stats=True)
    assert np.array_equal(np.asarray(t_ref), t_t.numpy())
    assert np.array_equal(np.asarray(d_ref), d_t.numpy())
    assert int(stats["clamped_entries"]) == 0
    assert int(stats["huge_overflow"]) == 0


def test_classic_rasterize_port_matches():
    _, _, js, ts = _setups("random")
    d_ref, t_ref = JR.rasterize(js, W, H)
    d_t, t_t = TR.rasterize(ts, W, H)
    assert np.array_equal(np.asarray(t_ref), t_t.numpy())
    assert np.array_equal(np.asarray(d_ref), d_t.numpy())


@pytest.mark.parametrize("cap", [20, 64])
def test_visibility_compaction_counts_overflow(cap):
    _, _, js, ts = _setups("random")
    _, jst, _, _, jstats = JB.bin_triangles(js, W, H, max_visible=cap)
    _, tst, _, _, tstats = TB.bin_triangles(ts, W, H, max_visible=cap)
    assert np.array_equal(np.asarray(jst), tst.numpy())
    assert int(np.asarray(jstats["visible_overflow"])) == \
        int(tstats["visible_overflow"])
    assert (int(tstats["visible_overflow"]) > 0) == (cap == 20)


def test_entry_clamp_is_counted():
    """A range longer than MAX_ENTRIES_PER_TILE is clamped like the
    reference walk, and the skipped entries are counted."""
    n = TB.MAX_ENTRIES_PER_TILE + 7
    starts = torch.tensor([0, n, n], dtype=torch.int32)
    huge = torch.tensor([0, 0], dtype=torch.int32)
    assert int(TB.clamped_entries(starts, huge, 1, 1, 2, 4)) == 7


def _split_case():
    """One exact bin far longer than a slice (random small triangles plus
    40 copies of one triangle at one depth, all tying), window triangles
    over two tiles of a row and a screen-filling triangle, which a 2x1
    window sends to the huge lists."""
    rng = np.random.RandomState(7)
    n = 60
    centers = np.array([-0.7, -0.6]) + rng.uniform(-0.15, 0.15, (n, 1, 2))
    small = centers + rng.uniform(-0.05, 0.05, (n, 3, 2))
    small_z = np.repeat(rng.uniform(0.2, 0.9, n), 3)
    tie = np.tile(np.array([[-0.72, -0.62], [-0.6, -0.6], [-0.66, -0.5]]),
                  (40, 1))
    window = np.array([0.0, 0.0]) + rng.uniform(-0.3, 0.3, (10, 3, 2))
    huge = np.array([[-4, -4], [4, -4], [0, 4]], np.float64)
    xy = np.concatenate([small.reshape(-1, 2), tie,
                         window.reshape(-1, 2), huge])
    z = np.concatenate([small_z, np.full(120, 0.5),
                        np.repeat(rng.uniform(0.2, 0.9, 10), 3),
                        np.full(3, 0.1)])
    clip = np.concatenate([xy, z[:, None], np.ones((len(z), 1))],
                          1).astype(np.float32)
    idx = np.arange(len(clip), dtype=np.int32).reshape(-1, 3)
    return TR.setup_triangles(torch.as_tensor(clip), torch.as_tensor(idx), W,
                              H, cull_mode=JR.CULL_NONE)


SW, SH = 2, 1


@pytest.mark.parametrize("max_entries", [TB.MAX_ENTRIES_PER_TILE, 50])
def test_split_walk_merges_exactly(max_entries):
    """The kernels' plan: the walk cut into slices (walk_items), each
    slice evaluated on its own (plain_keys) and merged with amax, equals
    the unsliced walk exactly — depth and winning packet — including the
    first-in-walk-order tie-break and the per-range entry clamp."""
    setup = _split_case()
    tx, ty = W // TB.TILE_W, H // TB.TILE_H
    pk, st, hr, hs, _ = TB.bin_triangles(setup, W, H, span_w=SW, span_h=SH)
    ns, nh = pk.shape[0], hr.shape[0]
    args = (st, hs, tx, ty, SW, SH, ns, nh)
    whole, n_whole = TB.walk_items(*args, slice_len=1 << 20,
                                   max_entries=max_entries)
    sliced, n_sliced = TB.walk_items(*args, slice_len=16,
                                     max_entries=max_entries)
    n_w, n_s = int(n_whole[0]), int(n_sliced[0])
    assert n_s <= sliced.shape[0] and n_w <= whole.shape[0]
    assert (sliced[n_s:] == 0).all()
    _, seg_count = TB.scan_ranges(st, hs, tx, ty, SW, SH)
    # one exact bin longer than several slices; window and huge ranges
    assert int(seg_count[0].max()) > 3 * 16
    assert int(seg_count[1:-1].sum()) > 0 and int(seg_count[-1].sum()) > 0
    # the slices tile each clamped range in order, none longer than 16
    s = sliced[:n_s].long()
    assert int(s[:, 3].max()) <= 16 and int(s[:, 3].min()) > 0
    for t, g, start, count in whole[:n_w].long().tolist():
        part = s[(s[:, 0] == t) & (s[:, 1] == g)]
        assert part[:, 2].tolist() == list(range(start, start + count, 16))
        assert int(part[:, 3].sum()) == count
        assert count == min(int(seg_count[g, t]), max_entries)
    assert n_s > n_w
    span = (tx, ty, SW, SH)
    ref = TB.plain_keys(whole, n_whole, pk, hr, *span)
    merged = torch.zeros_like(ref)
    for i in range(n_s):
        merged = torch.maximum(merged, TB.plain_keys(
            sliced[i:i + 1], torch.ones(1, dtype=torch.int32), pk, hr, *span))
    assert torch.equal(merged, ref)
    depth, gid = TB.decode_keys(merged, ns, nh, SW, SH)
    d_ref, g_ref = TB.plain_winners(st, hs, pk, hr, *span)
    if max_entries == TB.MAX_ENTRIES_PER_TILE:
        assert torch.equal(depth.reshape(d_ref.shape), d_ref)
        assert torch.equal(gid.reshape(g_ref.shape), g_ref)
        # the 40 tied copies: the first in walk order wins their pixels
        tri = torch.cat([pk[:, TB.COL_TRI], hr[:, TB.COL_TRI]]) \
            .contiguous().view(torch.int32)[gid.clamp_min(0)]
        tied = (tri >= 60) & (tri < 100)
        assert int(tied.sum()) > 0 and int(tri[tied].unique().numel()) == 1
    else:
        # the clamp drops entries of the long bin, so some pixels keep
        # another winner than the unclamped walk's
        assert not torch.equal(gid.reshape(g_ref.shape), g_ref)
