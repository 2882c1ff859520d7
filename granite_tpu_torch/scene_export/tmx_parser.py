"""Tiled TMX (JSON) map parser (copy of
granite_tpu/scene_export/tmx_parser.py; reference
scene-export/tmx_parser.cpp:1-346 + tmx_parser.hpp:30-135).

Parses orthogonal right-down Tiled maps: layers (tile index grids with
NoTile = -1), typed custom properties (bool/int/float/string/file/
color "#RRGGBB"/"#AARRGGBB"), tilesets packed into one (tile, H, W, 4)
RGBA8 tile atlas array (the reference's layered tilemap texture), tile
transparency classification into draw pipelines, terrain corner tags.
Image loading goes through PIL/stb-style readers in utils.image_io.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from ..utils.image_io import load_image
from .texture_utils import (
    TransparencyType, fixup_alpha_edges,
    image_slice_contains_transparency,
)

NO_TILE = -1


class DrawPipeline(Enum):
    OPAQUE = 0
    ALPHA_TEST = 1
    ALPHA_BLEND = 2


def _parse_value(type_: str, value):
    """tmx_parser.cpp parse_properties :44-91 (typed Value union)."""
    if type_ == "bool":
        return bool(value)
    if type_ == "int":
        return int(value)
    if type_ == "float":
        return float(value)
    if type_ in ("string", "file"):
        return str(value)
    if type_ == "color":
        hexs = str(value)
        if not hexs.startswith("#"):
            raise ValueError("Invalid color property format.")
        if len(hexs) == 7:
            rgb = int(hexs[1:], 16)
            return np.array([(rgb >> 16) & 255, (rgb >> 8) & 255,
                             rgb & 255, 255], np.uint8)
        if len(hexs) == 9:
            argb = int(hexs[1:], 16)
            return np.array([(argb >> 16) & 255, (argb >> 8) & 255,
                             argb & 255, (argb >> 24) & 255], np.uint8)
        raise ValueError("Invalid format.")
    raise ValueError(f"Unknown property type {type_}")


def _parse_properties(props) -> dict:
    return {p["name"]: _parse_value(p["type"], p["value"]) for p in props}


@dataclass
class Tile:
    pipeline: DrawPipeline = DrawPipeline.OPAQUE
    terrain_corners: tuple = (-1, -1, -1, -1)
    properties: dict = field(default_factory=dict)


@dataclass
class Terrain:
    name: str = ""
    properties: dict = field(default_factory=dict)


@dataclass
class Layer:
    tile_indices: np.ndarray = None     # (h, w) int32, NO_TILE = -1
    properties: dict = field(default_factory=dict)
    size: tuple = (0, 0)                # (w, h)
    id: int = 0
    opacity: float = 1.0
    visible: bool = False


class TMXParser:
    """tmx_parser.hpp:32 TMXParser — same accessors."""

    def __init__(self, path: str, image_loader=None):
        with open(path) as f:
            doc = json.load(f)
        self._parse(os.path.dirname(path), doc, image_loader)

    # -- accessors (tmx_parser.hpp:115-121) -----------------------------
    def get_tiles(self):
        return self.tiles

    def get_layers(self):
        return self.layers

    def get_terrains(self):
        return self.terrains

    def get_tilemap_image(self) -> np.ndarray:
        """(num_tiles, tile_h, tile_w, 4) uint8 — the layered tile
        atlas (reference: VK_FORMAT_R8G8B8A8_SRGB array texture)."""
        return self.tilemap

    def get_tile_size(self):
        return self.tile_size

    def get_map_tiles(self):
        return self.map_size

    # -------------------------------------------------------------------
    def _parse(self, base_path, doc, image_loader):
        self.map_size = (int(doc["width"]), int(doc["height"]))
        self.tile_size = (int(doc["tilewidth"]), int(doc["tileheight"]))
        if doc["orientation"] != "orthogonal":
            raise ValueError("Only orthogonal maps are supported.")
        if doc["renderorder"] != "right-down":
            raise ValueError("Only top-left rendering is supported.")

        self.layers = []
        for layer in doc["layers"]:
            out = Layer()
            if "compression" in layer:
                raise ValueError("TMX Compression not supported.")
            if layer["type"] != "tilelayer":
                out.visible = False
                self.layers.append(out)
                continue
            w, h = int(layer["width"]), int(layer["height"])
            out.size = (w, h)
            out.visible = bool(layer["visible"])
            out.opacity = float(layer["opacity"])
            out.id = int(layer["id"])
            out.tile_indices = (np.asarray(layer["data"], np.int64)
                                .astype(np.int32) - 1).reshape(h, w)
            if "properties" in layer:
                out.properties = _parse_properties(layer["properties"])
            self.layers.append(out)

        num_tiles = sum(int(t["tilecount"]) for t in doc["tilesets"])
        self.tiles = [Tile() for _ in range(num_tiles)]
        self.terrains = []

        tw, th = self.tile_size
        self.tilemap = np.zeros((num_tiles, th, tw, 4), np.uint8)

        base = 0
        for ts in doc["tilesets"]:
            count = int(ts["tilecount"])
            margin = int(ts["margin"])
            spacing = int(ts["spacing"])
            columns = int(ts["columns"])
            for tile in ts.get("tiles", []):
                off = int(tile["id"])
                if "terrain" in tile:
                    self.tiles[base + off].terrain_corners = tuple(
                        int(v) for v in tile["terrain"])
                if "properties" in tile:
                    self.tiles[base + off].properties = \
                        _parse_properties(tile["properties"])
            for terr in ts.get("terrains", []):
                self.terrains.append(Terrain(
                    name=terr["name"],
                    properties=_parse_properties(
                        terr.get("properties", []))))

            img = self._load_image(base_path, ts["image"], image_loader)
            rows = count // columns
            idx = base
            for y in range(rows):
                for x in range(columns):
                    # tmx_parser.cpp:242-251 margin/spacing walk
                    bx = margin + (x - 1) * spacing if x > 0 else margin
                    by = margin + (y - 1) * spacing if y > 0 else margin
                    bx += x * tw
                    by += y * tw      # sic — the reference uses tile_size.x
                    self.tilemap[idx] = img[by:by + th, bx:bx + tw]
                    t = image_slice_contains_transparency(self.tilemap[idx])
                    self.tiles[idx].pipeline = {
                        TransparencyType.NONE: DrawPipeline.OPAQUE,
                        TransparencyType.FLOATING: DrawPipeline.ALPHA_BLEND,
                        TransparencyType.BINARY: DrawPipeline.ALPHA_TEST,
                    }[t]
                    idx += 1
            base += count

        for i in range(num_tiles):
            self.tilemap[i] = fixup_alpha_edges(self.tilemap[i], srgb=True)

    @staticmethod
    def _load_image(base_path, rel, image_loader):
        if image_loader is not None:
            return image_loader(os.path.join(base_path, rel))
        img = load_image(os.path.join(base_path, rel))
        if img.shape[2] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)],
                axis=-1)
        return img
