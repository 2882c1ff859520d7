"""bitmap-to-mesh: extrude a bitmap's opaque pixels into a watertight
3D mesh (port of tools/bitmap_to_mesh.py; reference:
tools/bitmap_to_mesh.cpp, greedy 2x2-quad rect claiming + neighbor
stitching for watertightness).

The greedy rectangle decomposition covers the front/back faces, and the
face-boundary vertices sit at PIXEL granularity (each rect face is a fan
over its pixel-step outline), so neighboring rects of different sizes
share identical boundary vertices: the T-junction cracks the reference
patches with degenerate triangles (bitmap_to_mesh.cpp:361) cannot occur
by construction.  Side walls are emitted per boundary pixel edge.

Usage:
  python -m granite_tpu_torch.tools.bitmap_to_mesh input.png \
      --output out.gltf [--depth 0.1] [--scale 1.0] \
      [--alpha-threshold 128] [--per-pixel]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..scene.scene_formats import MaterialData, MeshData, NodeData, SceneInfo
from ..scene_export import export_gltf
from ..utils.image_io import load_image


def greedy_rects(mask: np.ndarray) -> list:
    """Greedy rectangle decomposition of a boolean mask.
    Returns [(y, x, h, w)] covering every true pixel exactly once
    (the ClaimedRect pass of bitmap_to_mesh.cpp:165)."""
    h, w = mask.shape
    claimed = np.zeros_like(mask, dtype=bool)
    rects = []
    for y in range(h):
        for x in range(w):
            if not mask[y, x] or claimed[y, x]:
                continue
            # extend right
            rw = 1
            while x + rw < w and mask[y, x + rw] and \
                    not claimed[y, x + rw]:
                rw += 1
            # extend down while the full row is free
            rh = 1
            while y + rh < h and mask[y + rh, x:x + rw].all() and \
                    not claimed[y + rh, x:x + rw].any():
                rh += 1
            claimed[y:y + rh, x:x + rw] = True
            rects.append((y, x, rh, rw))
    return rects


def _outline_loop(y, x, rh, rw):
    """Counter-clockwise pixel-step outline of a rect (top-left origin,
    +y down): every integer lattice point on the border."""
    pts = []
    for i in range(rw):
        pts.append((x + i, y))
    for j in range(rh):
        pts.append((x + rw, y + j))
    for i in range(rw):
        pts.append((x + rw - i, y + rh))
    for j in range(rh):
        pts.append((x, y + rh - j))
    return pts


def bitmap_to_meshdata(img: np.ndarray, depth: float = 0.1,
                       scale: float = 1.0, alpha_threshold: int = 128,
                       per_pixel: bool = False) -> MeshData:
    """(H, W, 4) uint8 -> MeshData: front/back faces + side walls.
    UVs map the bitmap onto both faces (so the source image can be the
    base-color texture)."""
    h, w = img.shape[:2]
    mask = img[..., 3] >= alpha_threshold if img.shape[-1] == 4 else \
        img[..., :3].max(-1) >= alpha_threshold
    if not mask.any():
        raise ValueError("bitmap has no opaque pixels")
    rects = [(y, x, 1, 1) for y in range(h) for x in range(w)
             if mask[y, x]] if per_pixel else greedy_rects(mask)

    sx = scale / max(h, w)
    hd = 0.5 * depth * scale
    verts: dict = {}
    positions: list = []
    uvs: list = []
    tris: list = []

    def vid(px, py, z):
        key = (px, py, z)
        i = verts.get(key)
        if i is None:
            i = len(positions)
            verts[key] = i
            positions.append(((px - w * 0.5) * sx,
                              (h * 0.5 - py) * sx, z))
            uvs.append((px / w, py / h))
        return i

    for (y, x, rh, rw) in rects:
        loop = _outline_loop(y, x, rh, rw)
        front = [vid(px, py, hd) for px, py in loop]
        back = [vid(px, py, -hd) for px, py in loop]
        for k in range(1, len(loop) - 1):
            tris.append((front[0], front[k], front[k + 1]))      # +Z CCW
            tris.append((back[0], back[k + 1], back[k]))         # -Z

    # Side walls per boundary pixel edge (watertight with the faces'
    # pixel-granularity outlines).
    padded = np.zeros((h + 2, w + 2), bool)
    padded[1:-1, 1:-1] = mask
    for y in range(h):
        for x in range(w):
            if not mask[y, x]:
                continue
            if not padded[y, x + 1]:          # north edge (y side)
                a, b = vid(x, y, hd), vid(x + 1, y, hd)
                c, d = vid(x + 1, y, -hd), vid(x, y, -hd)
                tris += [(a, b, c), (a, c, d)]
            if not padded[y + 2, x + 1]:      # south edge
                a, b = vid(x + 1, y + 1, hd), vid(x, y + 1, hd)
                c, d = vid(x, y + 1, -hd), vid(x + 1, y + 1, -hd)
                tris += [(a, b, c), (a, c, d)]
            if not padded[y + 1, x]:          # west edge
                a, b = vid(x, y + 1, hd), vid(x, y, hd)
                c, d = vid(x, y, -hd), vid(x, y + 1, -hd)
                tris += [(a, b, c), (a, c, d)]
            if not padded[y + 1, x + 2]:      # east edge
                a, b = vid(x + 1, y, hd), vid(x + 1, y + 1, hd)
                c, d = vid(x + 1, y + 1, -hd), vid(x + 1, y, -hd)
                tris += [(a, b, c), (a, c, d)]

    pos = np.asarray(positions, np.float32)
    uv = np.asarray(uvs, np.float32)
    idx = np.asarray(tris, np.int32)
    return MeshData(positions=pos, uvs=uv, indices=idx,
                    material=0).finalize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("bitmap")
    ap.add_argument("--output", required=True)
    ap.add_argument("--depth", type=float, default=0.1)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--alpha-threshold", type=int, default=128)
    ap.add_argument("--per-pixel", action="store_true",
                    help="one quad per pixel (no greedy merge)")
    args = ap.parse_args(argv)

    img = load_image(args.bitmap)
    md = bitmap_to_meshdata(img, depth=args.depth, scale=args.scale,
                            alpha_threshold=args.alpha_threshold,
                            per_pixel=args.per_pixel)
    info = SceneInfo()
    info.images.append(img)
    info.image_srgb.append(True)
    info.materials.append(MaterialData(name="bitmap",
                                       base_color_image=0))
    info.meshes.append(md)
    info.nodes.append(NodeData(name="bitmap", meshes=[0]))
    info.roots.append(0)
    export_gltf(info, args.output)
    print(f"{args.output}: {len(md.positions)} verts, "
          f"{len(md.indices)} tris")
    return 0


if __name__ == "__main__":
    sys.exit(main())
