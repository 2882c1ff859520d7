"""BASELINE config 1: headless clear + one textured triangle (port of
granite_tpu/app/triangle_demo.py; reference tests/triangle.cpp through
the headless platform).

Two graph passes: `triangle` sets up and rasterizes the rotating
triangle (ops/raster: setup, the brute-force raster, analytic UV
derivatives), samples the checkerboard's mip chain trilinearly at the
derivatives' lod (ops/texture) over the clear colour; `blit` encodes the
sRGB backbuffer.  The triangle turns 0.3 rad a second of elapsed time,
so --frames animates and --time-step is deterministic.

Run:  python -m granite_tpu_torch.app.triangle_demo --width 1280 \\
          --height 720 --frames 4 --device cuda --png-path out.png
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.render_graph import AttachmentInfo, Queue, RenderGraph
from ..ops import raster as R
from ..ops import texture as T
from ..ops.srgb import encode_rgba8
from .application import Application
from .bench_scene import checkerboard
from .headless import headless_main

CLEAR_COLOR = (0.01, 0.02, 0.05)
# The triangle in clip space (x, y, z; w = 1), its UVs and indices.
BASE = ((-0.6, 0.5, 0.5), (0.6, 0.5, 0.5), (0.0, -0.6, 0.5))
UVS = ((0.0, 0.0), (1.0, 0.0), (0.5, 1.0))


class TriangleApplication(Application):
    """The rotating textured triangle into a linear colour target, then
    the sRGB blit into the backbuffer."""

    def __init__(self, args=None, device="cuda"):
        super().__init__(device)
        self.mips = None
        self.graph = RenderGraph()
        self._history = None

    def swapchain_updated(self, width: int, height: int) -> None:
        super().swapchain_updated(width, height)
        self.mips = T.build_mips(torch.as_tensor(checkerboard(),
                                                 device=self.device))
        g = self.graph
        g.reset()
        g.set_backbuffer_dimensions(width, height)
        g.add_pass("triangle", Queue.GRAPHICS) \
            .add_external_input("texture") \
            .add_color_output("color", AttachmentInfo(channels=3)) \
            .set_execute(self._triangle_pass)
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

    @staticmethod
    def _triangle_pass(ctx):
        height, width = ctx.backbuffer_size()
        mips = ctx.input("texture")
        dev = mips.device
        angle = ctx.params["angle"]
        c, s = torch.cos(angle), torch.sin(angle)
        base = torch.tensor(BASE, dtype=torch.float32, device=dev)
        rot = torch.stack([base[:, 0] * c - base[:, 1] * s,
                           base[:, 0] * s + base[:, 1] * c,
                           base[:, 2]], dim=1)
        clip = torch.cat([rot, torch.ones((3, 1), device=dev)], dim=1)
        uvs = torch.tensor(UVS, dtype=torch.float32, device=dev)
        idx = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev)
        setup = R.setup_triangles(clip, idx, width, height,
                                  cull_mode=R.CULL_NONE)
        _depth, tri = R.rasterize(setup, width, height)
        px, py = R.pixel_centers(width, height, dev)
        uv, duv_dx, duv_dy = R.interpolate_with_derivs(uvs, idx, tri, setup,
                                                       px, py)
        lod = T.lod_from_derivs(duv_dx[..., 0], duv_dx[..., 1],
                                duv_dy[..., 0], duv_dy[..., 1],
                                mips.shape[2], mips.shape[1])
        texel = T.sample_trilinear(mips, uv[..., 0], uv[..., 1], lod)
        clear = torch.tensor(CLEAR_COLOR, dtype=torch.float32, device=dev)
        return {"color": torch.where((tri >= 0)[..., None], texel[..., :3],
                                     clear)}

    def render_frame(self, frame_time: float, elapsed_time: float):
        params = {"external": {"texture": self.mips},
                  "angle": torch.tensor(np.float32(0.3 * elapsed_time),
                                        device=self.device)}
        out, self._history = self.graph.execute(params, self._history)
        return out


def main(argv=None) -> int:
    return headless_main(TriangleApplication, argv)


if __name__ == "__main__":
    raise SystemExit(main())
