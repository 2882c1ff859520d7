"""Port (host copy, unchanged code) of granite_tpu/ui/font.py.

TrueType font rendering for the 2D overlay (reference:
renderer/font.{hpp,cpp} — stb_truetype glyph atlas at :32; here FreeType
via PIL rasterizes into the same kind of cached alpha atlas).

Falls back to the built-in 5x7 bitmap font when no TTF is available
(headless images in CI have no guaranteed font files)."""

from __future__ import annotations

import numpy as np

_DEFAULT_CANDIDATES = (
    "DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
)


class Font:
    """Glyph-atlas TTF font (Font::render_text analogue)."""

    def __init__(self, path: str | None = None, size: int = 16):
        self.size = size
        self._pil = None
        candidates = (path,) if path else _DEFAULT_CANDIDATES
        from PIL import ImageFont
        for cand in candidates:
            if cand is None:
                continue
            try:
                self._pil = ImageFont.truetype(cand, size)
                break
            except OSError:
                continue
        self._cache: dict[str, np.ndarray] = {}

    @property
    def available(self) -> bool:
        return self._pil is not None

    def glyph(self, ch: str) -> np.ndarray:
        """(h, w) float alpha bitmap of one glyph (cached atlas entry)."""
        g = self._cache.get(ch)
        if g is None:
            from PIL import Image, ImageDraw
            w = int(self._pil.getlength(ch)) or 1
            h = self.size + 4
            img = Image.new("L", (w, h), 0)
            ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=self._pil)
            g = np.asarray(img, np.float32) / 255.0
            self._cache[ch] = g
        return g

    def render_text(self, canvas: np.ndarray, text: str, x: int, y: int,
                    color=(1, 1, 1, 1)) -> None:
        """Alpha-blend `text` into an (H, W, 4) float canvas."""
        H, W = canvas.shape[:2]
        col = np.asarray(color, np.float32)
        cx = x
        for ch in text:
            if ch == " ":
                cx += self.size // 2
                continue
            g = self.glyph(ch)
            gh, gw = g.shape
            x1 = min(cx + gw, W)
            y1 = min(y + gh, H)
            if x1 <= cx or y1 <= y or cx < 0 or y < 0:
                cx += gw + 1
                continue
            a = g[: y1 - y, : x1 - cx, None] * col[3]
            dst = canvas[y:y1, cx:x1]
            dst[..., :3] = dst[..., :3] * (1 - a[..., 0:1]) \
                + col[:3] * a[..., 0:1]
            dst[..., 3:4] = np.maximum(dst[..., 3:4], a[..., 0:1])
            cx += gw + 1
