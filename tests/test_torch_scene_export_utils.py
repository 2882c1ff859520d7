"""The port's scene_export/texture_utils.py and tmx_parser.py (numpy
copies) against the JAX package: tests/test_scene_export_utils.py's
texture_utils and TMX cases, each output exactly equal to the original's
on the same inputs.  The one exception is the reference fault fixed in
the copy: swizzle_image's ONE on a float16 image is 1.0 in the port,
where the original writes 15360.0."""

import json

import numpy as np
import pytest

from granite_tpu.scene_export import texture_utils as JT
from granite_tpu.scene_export import tmx_parser as JP
from granite_tpu_torch.scene_export import texture_utils as TT
from granite_tpu_torch.scene_export import tmx_parser as TP

SEED = 7


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _rng():
    return np.random.default_rng(SEED)


def test_srgb_curves_match():
    v = np.linspace(0.0, 1.25, 81, dtype=np.float32)
    _eq(TT.srgb_gamma_to_linear(v), JT.srgb_gamma_to_linear(v))
    _eq(TT.srgb_linear_to_gamma(v), JT.srgb_linear_to_gamma(v))
    rt = TT.srgb_linear_to_gamma(TT.srgb_gamma_to_linear(v[:65]))
    assert np.allclose(rt, v[:65], atol=1e-5)


@pytest.mark.parametrize("shape,srgb", [((64, 32), False), ((48, 20), False),
                                        ((37, 53), True), ((2, 2), True)])
def test_mip_chains_match(shape, srgb):
    img = _rng().integers(0, 256, shape + (4,), dtype=np.uint8)
    got, want = TT.generate_mipmaps(img, srgb), JT.generate_mipmaps(img, srgb)
    assert len(got) == len(want)
    assert got[-1].shape == (1, 1, 4)
    for a, b in zip(got, want):
        _eq(a, b)


def test_mip_chain_average_and_linear_filtering():
    """test_scene_export_utils.py's levels and average, and its
    linear-space sRGB filtering, on the port."""
    img = np.zeros((64, 32, 4), np.uint8)
    img[:, :16] = [200, 100, 50, 255]
    img[:, 16:] = [100, 200, 150, 255]
    chain = TT.generate_mipmaps(img)
    assert len(chain) == 7
    mean = img.astype(np.float64).mean(axis=(0, 1))
    assert np.allclose(chain[-1][0, 0], mean, atol=2.0)
    half = np.zeros((2, 2, 4), np.uint8)
    half[..., 3] = 255
    half[0, :, :3] = 255
    assert abs(int(TT.generate_mipmaps(half, srgb=True)[-1][0, 0, 0])
               - 188) <= 2


@pytest.mark.parametrize("srgb", [False, True])
def test_fixup_alpha_edges_matches(srgb):
    img = _rng().integers(0, 256, (19, 23, 4), dtype=np.uint8)
    img[..., 3] = np.where(img[..., 3] > 128, 255, img[..., 3] // 2)
    _eq(TT.fixup_alpha_edges(img, srgb), JT.fixup_alpha_edges(img, srgb))
    one = np.zeros((4, 4, 4), np.uint8)
    one[1, 1] = [200, 40, 80, 255]
    out = TT.fixup_alpha_edges(one)
    assert tuple(out[1, 1]) == (200, 40, 80, 255)
    assert np.allclose(out[1, 2, :3], [200, 40, 80], atol=1)
    assert tuple(out[3, 3, :3]) == (0, 0, 0)


SWIZZLES = [("b", "g", "r", "one"), ("identity",) * 4,
            ("zero", "a", "ONE", "r"), ("g", "g", "g", "identity")]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float16])
@pytest.mark.parametrize("swizzle", SWIZZLES)
def test_swizzle_matches(dtype, swizzle):
    rng = _rng()
    img = (rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
           if dtype == np.uint8
           else rng.uniform(0, 1, (5, 7, 4)).astype(dtype))
    got = TT.swizzle_image(img, swizzle)
    want = JT.swizzle_image(img, swizzle)
    ones = [i for i, s in enumerate(swizzle) if s.lower() == "one"]
    if dtype == np.float16:
        # the fixed fault: ONE is 1.0, where the original writes 15360.0
        for i in ones:
            assert (got[..., i] == 1.0).all()
            assert (want[..., i] == 15360.0).all()
        keep = [i for i in range(4) if i not in ones]
        _eq(got[..., keep], want[..., keep])
        assert got.dtype == np.float16
    else:
        _eq(got, want)
        for i in ones:
            assert (got[..., i] == (255 if dtype == np.uint8 else 1)).all()


def test_transparency_classification_matches():
    img = np.full((4, 4, 4), 255, np.uint8)
    seen = []
    for at, alpha in (((0, 0), 255), ((0, 0), 0), ((0, 1), 128)):
        img[at + (3,)] = alpha
        got = TT.image_slice_contains_transparency(img)
        assert got.name == JT.image_slice_contains_transparency(img).name
        seen.append(got)
    assert seen == [TT.TransparencyType.NONE, TT.TransparencyType.BINARY,
                    TT.TransparencyType.FLOATING]


def _write_map(tmp_path, margin=0, spacing=0):
    """test_scene_export_utils.py's 2x2 map with two 4x4 tiles (opaque
    red, green with one transparent texel), plus a seeded 3-tile
    tileset with a margin and spacing, an object layer and terrains."""
    tw = th = 4
    atlas = np.zeros((th, 2 * tw, 4), np.uint8)
    atlas[:, :tw] = [255, 0, 0, 255]
    atlas[:, tw:] = [0, 255, 0, 255]
    atlas[0, tw, 3] = 0
    np.save(tmp_path / "tiles.npy", atlas)
    rng = _rng()
    second = rng.integers(0, 256, (th + 2 * margin + 2 * spacing,
                                   3 * tw + 2 * margin + 2 * spacing, 4),
                          dtype=np.uint8)
    second[..., 3] = np.where(second[..., 3] > 100, 255, second[..., 3])
    np.save(tmp_path / "more.npy", second)
    doc = {
        "width": 2, "height": 2, "tilewidth": tw, "tileheight": th,
        "orientation": "orthogonal", "renderorder": "right-down",
        "layers": [{
            "type": "tilelayer", "width": 2, "height": 2,
            "visible": True, "opacity": 0.5, "id": 1,
            "data": [1, 2, 0, 1],
            "properties": [
                {"name": "speed", "type": "float", "value": 2.5},
                {"name": "tint", "type": "color", "value": "#80FF0000"},
                {"name": "rgb", "type": "color", "value": "#102030"},
                {"name": "solid", "type": "bool", "value": True},
                {"name": "count", "type": "int", "value": 3},
                {"name": "file", "type": "file", "value": "a.png"},
            ],
        }, {"type": "objectgroup"}, {
            "type": "tilelayer", "width": 2, "height": 1,
            "visible": False, "opacity": 1.0, "id": 3, "data": [5, 3]}],
        "tilesets": [{
            "tilecount": 2, "firstgid": 1, "margin": 0, "spacing": 0,
            "columns": 2, "image": "tiles.npy",
        }, {
            "tilecount": 3, "firstgid": 3, "margin": margin,
            "spacing": spacing, "columns": 3, "image": "more.npy",
            "tiles": [{"id": 1, "terrain": [0, 0, 1, -1],
                       "properties": [{"name": "hp", "type": "int",
                                       "value": 7}]}],
            "terrains": [{"name": "grass", "properties": [
                {"name": "soft", "type": "bool", "value": True}]},
                {"name": "rock"}],
        }],
    }
    p = tmp_path / "map.json"
    p.write_text(json.dumps(doc))
    return str(p)


def _load(path):
    return np.load(path)


@pytest.mark.parametrize("margin,spacing", [(0, 0), (1, 1)])
def test_tmx_parser_matches(tmp_path, margin, spacing):
    path = _write_map(tmp_path, margin, spacing)
    got, want = TP.TMXParser(path, _load), JP.TMXParser(path, _load)
    assert got.get_map_tiles() == want.get_map_tiles() == (2, 2)
    assert got.get_tile_size() == want.get_tile_size() == (4, 4)
    _eq(got.get_tilemap_image(), want.get_tilemap_image())
    assert got.get_tilemap_image().shape == (5, 4, 4, 4)
    for a, b in zip(got.get_layers(), want.get_layers(), strict=True):
        assert (a.size, a.id, a.opacity, a.visible) == \
            (b.size, b.id, b.opacity, b.visible)
        if b.tile_indices is None:
            assert a.tile_indices is None
        else:
            _eq(a.tile_indices, b.tile_indices)
        assert a.properties.keys() == b.properties.keys()
        for k, v in b.properties.items():
            _eq(a.properties[k], v)
    for a, b in zip(got.get_tiles(), want.get_tiles(), strict=True):
        assert (a.pipeline.name, a.terrain_corners, a.properties) == \
            (b.pipeline.name, b.terrain_corners, b.properties)
    assert [(t.name, t.properties) for t in got.get_terrains()] == \
        [(t.name, t.properties) for t in want.get_terrains()]
    layer = got.get_layers()[0]
    assert layer.tile_indices.tolist() == [[0, 1], [TP.NO_TILE, 0]]
    assert tuple(layer.properties["tint"]) == (255, 0, 0, 128)
    assert got.get_tiles()[0].pipeline == TP.DrawPipeline.OPAQUE
    assert got.get_tiles()[1].pipeline == TP.DrawPipeline.ALPHA_TEST


@pytest.mark.parametrize("change,error", [
    ({"orientation": "isometric"}, "orthogonal"),
    ({"renderorder": "left-up"}, "top-left"),
    ({"layers": [{"type": "tilelayer", "compression": "zlib"}]},
     "Compression")])
def test_tmx_parser_refusals_match(tmp_path, change, error):
    path = _write_map(tmp_path)
    doc = json.loads(open(path).read())
    doc.update(change)
    with open(path, "w") as f:
        json.dump(doc, f)
    for parser in (TP.TMXParser, JP.TMXParser):
        with pytest.raises(ValueError, match=error):
            parser(path, _load)


@pytest.mark.parametrize("value", ["FF0000", "#12345", 3])
def test_tmx_bad_colors_match(value):
    for mod in (TP, JP):
        with pytest.raises(ValueError):
            mod._parse_value("color", value)
