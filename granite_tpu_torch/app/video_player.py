"""Video-textured quad (port of granite_tpu/app/video_player.py;
reference tests/video_player.cpp).

A VideoSource (app/video_source.py: ffmpeg over a pipe, or a PNG
sequence) streams RGBA frames that texture a 16:9 quad yawing 0.15 rad a
second of elapsed time.  Two graph passes: `screen` rasterizes the quad
(ops/raster: setup with CULL_NONE, the brute-force raster, analytic UV
derivatives) and samples the frame's mip stack trilinearly at the
derivatives' lod (ops/texture) over the clear colour; `blit` encodes the
sRGB backbuffer.  The frame's mips are the graph's external input
`video_mips`: each frame goes to the device in one host-to-device copy
of its uint8 texels, and the sRGB-to-linear conversion and the mip build
run on the device.  A frame of another size than the square
--video-size texture (a PNG of the sequence) is resized nearest on the
host first; at the end of the stream the last frame is held.

Run:  python -m granite_tpu_torch.app.video_player --video <file-or-dir> \\
          --width 640 --height 360 --frames 8 --device cuda \\
          --png-path out.png
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.render_graph import AttachmentInfo, Queue, RenderGraph
from ..math.muglm import look_at_matrix, perspective
from ..ops import raster as R
from ..ops import texture as T
from ..ops.srgb import encode_rgba8, srgb_to_linear
from ..utils.logging import LOGI
from .application import Application
from .headless import headless_main
from .video_source import VideoSource

CLEAR_COLOR = (0.02, 0.02, 0.04)
# The quad's half extents (16:9), its corners, UVs and two triangles.
HALF_W, HALF_H = 1.6, 0.9
CORNERS = ((-HALF_W, HALF_H, 0.0), (HALF_W, HALF_H, 0.0),
           (-HALF_W, -HALF_H, 0.0), (HALF_W, -HALF_H, 0.0))
UVS = ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0))
INDICES = ((0, 1, 2), (2, 1, 3))
EYE = (0.0, 0.0, 3.2)
FOVY, ZNEAR, ZFAR = 0.9, 0.1, 100.0
YAW_RATE = 0.15


class VideoPlayerApplication(Application):
    """Two passes: 'screen' rasterizes the video quad, 'blit' sRGB-encodes."""

    @staticmethod
    def add_cli(parser) -> None:
        parser.add_argument("--video", type=str, default=None,
                            help="video file (ffmpeg) or PNG-seq dir")
        parser.add_argument("--video-size", dest="video_size", type=int,
                            default=256)

    def __init__(self, args=None, device="cuda"):
        """args: namespace with `video` (a file ffmpeg decodes, or a
        directory of PNGs; required) and `video_size` (the square
        texture's side, default 256); device: 'cuda' (raises without a
        card) or 'cpu'."""
        super().__init__(device)
        path = getattr(args, "video", None)
        if path is None:
            raise SystemExit("--video <file or PNG dir> is required")
        self.tex_size = int(getattr(args, "video_size", 256) or 256)
        self.source = VideoSource(path, self.tex_size, self.tex_size)
        self._frame_np = np.zeros(
            (self.tex_size, self.tex_size, 4), np.uint8)
        self._frames_decoded = 0
        self.clear_color = torch.tensor(CLEAR_COLOR, dtype=torch.float32,
                                        device=self.device)
        self.graph = RenderGraph()
        self._history = None
        self._quad = None

    def swapchain_updated(self, width: int, height: int) -> None:
        super().swapchain_updated(width, height)
        view = look_at_matrix(np.array(EYE, np.float32),
                              np.zeros(3, np.float32),
                              np.array([0.0, 1.0, 0.0], np.float32))
        vp = perspective(FOVY, width / height, ZNEAR, ZFAR) @ view
        dev = self.device
        self._quad = {
            "corners": torch.tensor(CORNERS, dtype=torch.float32,
                                    device=dev),
            "uvs": torch.tensor(UVS, dtype=torch.float32, device=dev),
            "indices": torch.tensor(INDICES, dtype=torch.int32, device=dev),
            "vp_t": torch.as_tensor(np.ascontiguousarray(vp.T),
                                    dtype=torch.float32, device=dev)}
        g = self.graph
        g.reset()
        g.set_backbuffer_dimensions(width, height)
        g.add_pass("screen", Queue.GRAPHICS) \
            .add_external_input("video_mips") \
            .add_color_output("color", AttachmentInfo(channels=3)) \
            .set_execute(self._screen_pass)
        g.add_pass("blit", Queue.GRAPHICS) \
            .add_texture_input("color") \
            .add_color_output("backbuffer",
                              AttachmentInfo(channels=4, dtype=torch.uint8)) \
            .set_execute(lambda ctx: {
                "backbuffer": encode_rgba8(ctx.input("color"))})
        g.set_backbuffer_source("backbuffer")
        g.bake()
        g.log()
        self._history = g.initial_history(self.device)

    def _screen_pass(self, ctx):
        height, width = ctx.backbuffer_size()
        mips = ctx.input("video_mips")
        q = self._quad
        # The yaw's cosine and sine in float32 on the host: the quad's
        # rotation then needs no upload.
        yaw = np.float32(ctx.params["yaw"])
        c, s = float(np.cos(yaw)), float(np.sin(yaw))
        corners = q["corners"]
        rot = torch.stack([corners[:, 0] * c + corners[:, 2] * s,
                           corners[:, 1],
                           -corners[:, 0] * s + corners[:, 2] * c], dim=1)
        world_h = torch.cat([rot, torch.ones_like(rot[:, :1])], dim=1)
        clip = world_h @ q["vp_t"]
        idx = q["indices"]
        setup = R.setup_triangles(clip, idx, width, height,
                                  cull_mode=R.CULL_NONE)
        _depth, tri = R.rasterize(setup, width, height)
        px, py = R.pixel_centers(width, height, clip.device)
        uv, duv_dx, duv_dy = R.interpolate_with_derivs(
            q["uvs"], idx, tri, setup, px, py)
        lod = T.lod_from_derivs(duv_dx[..., 0], duv_dx[..., 1],
                                duv_dy[..., 0], duv_dy[..., 1],
                                mips.shape[2], mips.shape[1])
        texel = T.sample_trilinear(mips, uv[..., 0], uv[..., 1], lod)
        return {"color": torch.where((tri >= 0)[..., None], texel[..., :3],
                                     self.clear_color)}

    def render_frame(self, frame_time: float, elapsed_time: float):
        nxt = self.source.read_frame()
        if nxt is not None:
            if nxt.shape[:2] != (self.tex_size, self.tex_size):
                # PNG-sequence frames keep their own size; nearest-resize
                # into the constant texture shape.
                ys = (np.arange(self.tex_size) * nxt.shape[0]
                      // self.tex_size)
                xs = (np.arange(self.tex_size) * nxt.shape[1]
                      // self.tex_size)
                nxt = nxt[ys][:, xs]
            self._frame_np = nxt
            self._frames_decoded += 1
        # The one upload: the frame's uint8 texels.  sRGB -> linear and
        # the mip build (VideoDecoder's mipgen) run on the device.
        u8 = torch.tensor(self._frame_np, device=self.device).to(
            torch.float32) / 255.0
        frame = torch.cat([srgb_to_linear(u8[..., :3]), u8[..., 3:4]],
                          dim=-1)
        params = {"external": {"video_mips": T.build_mips(frame)},
                  "yaw": YAW_RATE * elapsed_time}
        out, self._history = self.graph.execute(params, self._history)
        return out

    def teardown(self) -> None:
        super().teardown()
        self.source.close()
        LOGI("VideoPlayer: %d frames decoded", self._frames_decoded)


def main(argv=None) -> int:
    return headless_main(VideoPlayerApplication, argv)


if __name__ == "__main__":
    raise SystemExit(main())
