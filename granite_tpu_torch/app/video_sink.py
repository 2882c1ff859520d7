"""Video output sink (copy of granite_tpu/app/video_sink.py; reference:
video/ffmpeg_encode.cpp and the headless platform's --video-path encode,
application_headless.cpp:246).

A host-side sink fed by the frame loop.  If an `ffmpeg` binary is on the
PATH, raw RGBA frames pipe into it (rawvideo -> h264); otherwise the
frames are written as a numbered PNG sequence in `<path stem>_frames/`.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np

from ..utils.logging import LOGI, LOGW


class VideoSink:
    def __init__(self, path: str, width: int, height: int, fps: float = 60.0,
                 codec: str = "libx264"):
        self.path = path
        self.width = width
        self.height = height
        self.fps = fps
        self._proc: Optional[subprocess.Popen] = None
        self._frame = 0
        self._png_dir: Optional[str] = None
        if shutil.which("ffmpeg"):
            self._proc = subprocess.Popen(
                ["ffmpeg", "-y", "-f", "rawvideo", "-pixel_format", "rgba",
                 "-video_size", f"{width}x{height}", "-framerate", str(fps),
                 "-i", "-", "-c:v", codec, "-pix_fmt", "yuv420p", path],
                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            LOGI("VideoSink: encoding %s via ffmpeg (%s)", path, codec)
        else:
            self._png_dir = os.path.splitext(path)[0] + "_frames"
            os.makedirs(self._png_dir, exist_ok=True)
            LOGW("VideoSink: no ffmpeg; writing PNG sequence to %s",
                 self._png_dir)

    def push_frame(self, rgba: np.ndarray) -> None:
        rgba = np.asarray(rgba, np.uint8)
        if self._proc is not None:
            self._proc.stdin.write(rgba.tobytes())
        else:
            from ..utils.image_io import save_png
            save_png(os.path.join(self._png_dir,
                                  f"frame_{self._frame:05d}.png"), rgba)
        self._frame += 1

    def close(self) -> None:
        if self._proc is not None:
            self._proc.stdin.close()
            self._proc.wait(timeout=30)
            LOGI("VideoSink: wrote %d frames to %s", self._frame, self.path)
