"""Video input source (copy of granite_tpu/app/video_source.py; reference:
video/ffmpeg_decode.cpp VideoDecoder).

Decodes a video file to raw RGBA frames.  If an `ffmpeg` binary is on
the PATH, frames stream from `ffmpeg -i <path> -f rawvideo -pix_fmt rgba
-s WxH -`; otherwise a PNG-sequence directory (VideoSink's fallback
format: `<path minus extension>_frames/`, or `path` itself) plays back
through utils/image_io.  Neither found raises FileNotFoundError.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from ..utils.image_io import load_image
from ..utils.logging import LOGI, LOGW


class VideoSource:
    def __init__(self, path: str, width: int, height: int):
        self.width = width
        self.height = height
        self._proc: Optional[subprocess.Popen] = None
        self._png_files: list = []
        self._idx = 0
        frames_dir = os.path.splitext(path)[0] + "_frames"
        if os.path.isfile(path) and shutil.which("ffmpeg"):
            self._proc = subprocess.Popen(
                ["ffmpeg", "-i", path, "-f", "rawvideo",
                 "-pix_fmt", "rgba", "-s", f"{width}x{height}", "-"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
            LOGI("VideoSource: decoding %s via ffmpeg", path)
        elif os.path.isdir(frames_dir) or os.path.isdir(path):
            d = frames_dir if os.path.isdir(frames_dir) else path
            self._png_files = sorted(
                os.path.join(d, f) for f in os.listdir(d)
                if f.endswith(".png"))
            LOGW("VideoSource: no ffmpeg; playing PNG sequence %s "
                 "(%d frames)", d, len(self._png_files))
        else:
            raise FileNotFoundError(
                f"no decodable video at {path} (and no ffmpeg)")

    def read_frame(self) -> Optional[np.ndarray]:
        """Next (H, W, 4) uint8 frame, or None at end of stream."""
        if self._proc is not None:
            n = self.width * self.height * 4
            buf = self._proc.stdout.read(n)
            if len(buf) < n:
                return None
            return np.frombuffer(buf, np.uint8).reshape(
                self.height, self.width, 4)
        if self._idx >= len(self._png_files):
            return None
        rgba = load_image(self._png_files[self._idx])
        self._idx += 1
        return rgba

    def close(self) -> None:
        if self._proc is not None:
            self._proc.stdout.close()
            self._proc.wait()
            self._proc = None
