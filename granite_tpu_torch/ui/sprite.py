"""Port (host copy, unchanged code) of granite_tpu/ui/sprite.py.

Sprite batching + atlas (reference: renderer/sprite.cpp + the
FlatRenderer queue semantics of flat_renderer.hpp:73 — sprites queue
with a texture, layer and transform, then flush() renders back-to-front
in batched draws).

Host/device split: the atlas packs on the host once (shelf packing);
queued sprites rasterize into the FlatRenderer overlay canvas at flush, sorted
by layer then atlas id — the batching axis the reference sorts draws
by.  The overlay composites device-side like all 2D content."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .flat_renderer import FlatRenderer


class SpriteAtlas:
    """Shelf-packed RGBA atlas (texture page of the 2D renderer)."""

    def __init__(self, size: int = 512):
        self.size = size
        self.sheet = np.zeros((size, size, 4), np.float32)
        self._shelf_y = 0
        self._shelf_h = 0
        self._cursor_x = 0
        self.rects: list[tuple[int, int, int, int]] = []

    def add(self, rgba: np.ndarray) -> int:
        """Pack an (h, w, 4) image; returns a sprite id."""
        img = np.asarray(rgba, np.float32)
        if img.max() > 1.0:
            img = img / 255.0
        h, w = img.shape[:2]
        if self._cursor_x + w > self.size:
            self._shelf_y += self._shelf_h
            self._cursor_x = 0
            self._shelf_h = 0
        if self._shelf_y + h > self.size or w > self.size:
            raise ValueError("atlas full")
        x, y = self._cursor_x, self._shelf_y
        self.sheet[y:y + h, x:x + w] = img
        self._cursor_x += w
        self._shelf_h = max(self._shelf_h, h)
        self.rects.append((x, y, w, h))
        return len(self.rects) - 1


@dataclass
class _QueuedSprite:
    sprite: int
    x: float
    y: float
    layer: float
    scale: float
    color: np.ndarray


class SpriteRenderer:
    """Queue sprites, flush once per frame into a FlatRenderer canvas
    (render_queue-style sort: layer major, atlas-local id minor)."""

    def __init__(self, atlas: SpriteAtlas):
        self.atlas = atlas
        self._queue: list[_QueuedSprite] = []

    def queue_sprite(self, sprite: int, x: float, y: float,
                     layer: float = 0.0, scale: float = 1.0,
                     color=(1.0, 1.0, 1.0, 1.0)) -> None:
        self._queue.append(_QueuedSprite(
            sprite, x, y, layer, scale,
            np.asarray(color, np.float32)))

    def flush(self, fr: FlatRenderer) -> int:
        """Blit queued sprites back-to-front; returns draw count."""
        order = sorted(range(len(self._queue)),
                       key=lambda i: (self._queue[i].layer,
                                      self._queue[i].sprite))
        for i in order:
            q = self._queue[i]
            ax, ay, w, h = self.atlas.rects[q.sprite]
            src = self.atlas.sheet[ay:ay + h, ax:ax + w]
            if q.scale != 1.0:
                sh = max(int(round(h * q.scale)), 1)
                sw = max(int(round(w * q.scale)), 1)
                yy = np.clip((np.arange(sh) / q.scale).astype(int),
                             0, h - 1)
                xx = np.clip((np.arange(sw) / q.scale).astype(int),
                             0, w - 1)
                src = src[yy][:, xx]
            sh, sw = src.shape[:2]
            x0 = int(round(q.x))
            y0 = int(round(q.y))
            x1 = min(x0 + sw, fr.width)
            y1 = min(y0 + sh, fr.height)
            cx0 = max(x0, 0)
            cy0 = max(y0, 0)
            if x1 <= cx0 or y1 <= cy0:
                continue
            tile = src[cy0 - y0:y1 - y0, cx0 - x0:x1 - x0] * q.color
            dst = fr.canvas[cy0:y1, cx0:x1]
            a = tile[..., 3:4]
            dst[...] = dst * (1 - a) + tile * a
        n = len(order)
        self._queue.clear()
        return n
