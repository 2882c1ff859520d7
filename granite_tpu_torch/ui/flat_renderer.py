"""2D batched renderer for UI/sprites/text (port of
granite_tpu/ui/flat_renderer.py; reference renderer/flat_renderer.hpp:73,
sprite.cpp, font.cpp with stb_truetype; the ui/ widget tree renders
through it).

Dynamic content (text, frame stats) rasterizes on the host into an RGBA
overlay; `composite_overlay` alpha-blends it onto the frame on the
device in the tonemap pass.  A 5x7 bitmap font stands in for
stb_truetype; the API (queue sprites and text, flush once) is
FlatRenderer's.  The host code is the JAX package's, unchanged.
"""

from __future__ import annotations

import numpy as np

# 5x7 bitmap font, ASCII 32..95 subset (uppercase/digits/punctuation).
_GLYPHS = {
    ' ': "00000|00000|00000|00000|00000|00000|00000",
    '.': "00000|00000|00000|00000|00000|01100|01100",
    ':': "00000|01100|01100|00000|01100|01100|00000",
    '/': "00001|00010|00100|00100|01000|10000|00000",
    '-': "00000|00000|00000|11111|00000|00000|00000",
    '|': "00100|00100|00100|00100|00100|00100|00100",
    '0': "01110|10001|10011|10101|11001|10001|01110",
    '1': "00100|01100|00100|00100|00100|00100|01110",
    '2': "01110|10001|00001|00110|01000|10000|11111",
    '3': "01110|10001|00001|00110|00001|10001|01110",
    '4': "00010|00110|01010|10010|11111|00010|00010",
    '5': "11111|10000|11110|00001|00001|10001|01110",
    '6': "01110|10000|11110|10001|10001|10001|01110",
    '7': "11111|00001|00010|00100|01000|01000|01000",
    '8': "01110|10001|10001|01110|10001|10001|01110",
    '9': "01110|10001|10001|01111|00001|00001|01110",
    'A': "01110|10001|10001|11111|10001|10001|10001",
    'B': "11110|10001|10001|11110|10001|10001|11110",
    'C': "01110|10001|10000|10000|10000|10001|01110",
    'D': "11110|10001|10001|10001|10001|10001|11110",
    'E': "11111|10000|10000|11110|10000|10000|11111",
    'F': "11111|10000|10000|11110|10000|10000|10000",
    'G': "01110|10001|10000|10111|10001|10001|01110",
    'H': "10001|10001|10001|11111|10001|10001|10001",
    'I': "01110|00100|00100|00100|00100|00100|01110",
    'J': "00111|00010|00010|00010|00010|10010|01100",
    'K': "10001|10010|10100|11000|10100|10010|10001",
    'L': "10000|10000|10000|10000|10000|10000|11111",
    'M': "10001|11011|10101|10101|10001|10001|10001",
    'N': "10001|11001|10101|10011|10001|10001|10001",
    'O': "01110|10001|10001|10001|10001|10001|01110",
    'P': "11110|10001|10001|11110|10000|10000|10000",
    'Q': "01110|10001|10001|10001|10101|10010|01101",
    'R': "11110|10001|10001|11110|10100|10010|10001",
    'S': "01111|10000|10000|01110|00001|00001|11110",
    'T': "11111|00100|00100|00100|00100|00100|00100",
    'U': "10001|10001|10001|10001|10001|10001|01110",
    'V': "10001|10001|10001|10001|10001|01010|00100",
    'W': "10001|10001|10001|10101|10101|11011|10001",
    'X': "10001|01010|00100|00100|00100|01010|10001",
    'Y': "10001|10001|01010|00100|00100|00100|00100",
    'Z': "11111|00001|00010|00100|01000|10000|11111",
    'm': "00000|00000|11010|10101|10101|10101|10101",
    's': "00000|00000|01111|10000|01110|00001|11110",
    'p': "00000|00000|11110|10001|11110|10000|10000",
    'x': "00000|00000|10001|01010|00100|01010|10001",
    'f': "00110|01000|11110|01000|01000|01000|01000",
    't': "01000|01000|11110|01000|01000|01001|00110",
    'r': "00000|00000|10110|11001|10000|10000|10000",
    'i': "00100|00000|01100|00100|00100|00100|01110",
    'u': "00000|00000|10001|10001|10001|10011|01101",
    'g': "00000|00000|01111|10001|01111|00001|01110",
    'e': "00000|00000|01110|10001|11111|10000|01110",
    'a': "00000|00000|01110|00001|01111|10001|01111",
    'n': "00000|00000|10110|11001|10001|10001|10001",
    'd': "00001|00001|01101|10011|10001|10011|01101",
    'o': "00000|00000|01110|10001|10001|10001|01110",
    'l': "01100|00100|00100|00100|00100|00100|01110",
    'c': "00000|00000|01110|10001|10000|10001|01110",
    'h': "10000|10000|10110|11001|10001|10001|10001",
    'v': "00000|00000|10001|10001|10001|01010|00100",
    'b': "10000|10000|11110|10001|10001|10001|11110",
}


def font_bitmap(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch, _GLYPHS[' ']).split("|")
    return np.array([[c == '1' for c in r] for r in rows], bool)


def draw_text(canvas: np.ndarray, text: str, x: int, y: int,
              color=(1.0, 1.0, 1.0, 1.0), scale: int = 1) -> None:
    """Rasterize text into an RGBA float canvas in place."""
    color = np.asarray(color, np.float32)
    cx = x
    for ch in text:
        g = font_bitmap(ch)
        g = np.kron(g, np.ones((scale, scale), bool))
        h, w = g.shape
        y1 = min(y + h, canvas.shape[0])
        x1 = min(cx + w, canvas.shape[1])
        if y1 > y and x1 > cx:
            region = g[:y1 - y, :x1 - cx]
            canvas[y:y1, cx:x1][region] = color
        cx += (5 + 1) * scale
    return canvas


class FlatRenderer:
    """Host-side sprite/text queue -> one RGBA overlay per frame."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.canvas = np.zeros((height, width, 4), np.float32)

    def begin(self) -> None:
        self.canvas[:] = 0.0

    def render_quad(self, x: int, y: int, w: int, h: int, color) -> None:
        x1 = min(x + w, self.width)
        y1 = min(y + h, self.height)
        c = np.asarray(color, np.float32)
        # alpha-over compositing into the canvas
        dst = self.canvas[y:y1, x:x1]
        a = c[3]
        dst[...] = dst * (1 - a) + c * a

    def render_text(self, text: str, x: int, y: int,
                    color=(1, 1, 1, 1), scale: int = 1,
                    font=None) -> None:
        """font: optional ui.font.Font (TTF path, renderer/font.hpp:32);
        defaults to the built-in 5x7 bitmap glyphs."""
        if font is not None and font.available:
            font.render_text(self.canvas, text, x, y, color)
        else:
            draw_text(self.canvas, text, x, y, color, scale)

    def flush(self) -> np.ndarray:
        """The overlay to composite (device-side alpha blend)."""
        return self.canvas


def composite_overlay(image, overlay):
    """Alpha-blend the (H, W, 4) overlay onto the (H, W, 3) image, on the
    image's device (torch tensors)."""
    a = overlay[..., 3:4]
    return image * (1.0 - a) + overlay[..., :3] * a
