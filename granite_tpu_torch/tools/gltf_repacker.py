"""glTF repacker (port of tools/gltf_repacker.py; reference:
tools/gltf_repacker.cpp, mesh dedup/optimize and texture compression to
the engine container).

  python -m granite_tpu_torch.tools.gltf_repacker --input in.gltf \
      --output out.gltf [--compress-textures] [--meshlets]

- vertex deduplication + index rebuild per mesh,
- optional BC1/BC3/BC5 compression of the images into .gtpx sidecars
  (tex<i>.gtpx beside the output, through the native texture codec),
- optional MLT1 meshlet encoding stats (native/meshlet1.cpp).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..scene.gltf import GLTFParser
from ..scene_export import export_gltf


def dedup_mesh(md) -> tuple:
    """Weld identical vertices (position+normal+uv, rounded to 1e-6),
    keeping each one's first occurrence; rebuild the indices.  ->
    (vertices before, after)."""
    key = np.concatenate([md.positions, md.normals, md.uvs], axis=1)
    _uniq, first, inverse = np.unique(key.round(6), axis=0,
                                      return_index=True,
                                      return_inverse=True)
    inverse = inverse.reshape(-1)
    before = len(md.positions)
    md.positions = md.positions[first]
    md.normals = md.normals[first]
    md.uvs = md.uvs[first]
    md.tangents = md.tangents[first] if md.tangents is not None else None
    md.indices = inverse[md.indices].astype(np.int32)
    return before, len(md.positions)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--compress-textures", action="store_true")
    ap.add_argument("--meshlets", action="store_true")
    args = ap.parse_args(argv)

    info = GLTFParser(args.input).get_scene()
    total_before = total_after = 0
    for md in info.meshes:
        b, a = dedup_mesh(md)
        total_before += b
        total_after += a
    print(f"vertices: {total_before} -> {total_after} "
          f"({100 * (1 - total_after / max(total_before, 1)):.1f}% saved)")

    if args.compress_textures:
        # Format selection like texture_compression.cpp: alpha-carrying
        # images -> BC3, normal maps -> BC5 (RGTC XY), opaque color ->
        # BC1.
        from ..native.texture import (
            encode_bc1, encode_bc3, encode_bc5, gtpx_save,
        )
        normal_imgs = {m.normal_image for m in info.materials
                       if m.normal_image is not None}
        outdir = os.path.dirname(os.path.abspath(args.output))
        for i, img in enumerate(info.images):
            img = np.ascontiguousarray(img)
            if i in normal_imgs:
                fmt, blocks = "bc5", encode_bc5(img)
            elif img.shape[-1] == 4 and (img[..., 3] != 255).any():
                fmt, blocks = "bc3", encode_bc3(img)
            else:
                fmt, blocks = "bc1", encode_bc1(img)
            path = os.path.join(outdir, f"tex{i}.gtpx")
            gtpx_save(path, bytes(blocks), fmt, img.shape[1],
                      img.shape[0])
            raw = img.nbytes
            print(f"  tex{i}: {raw} -> {len(blocks)} bytes "
                  f"({fmt.upper()}) {path}")

    if args.meshlets:
        from ..native import meshlet_encode
        for i, md in enumerate(info.meshes):
            blob, n = meshlet_encode(md.positions, md.indices)
            raw = md.positions.nbytes + md.indices.nbytes
            print(f"  mesh{i}: {n} meshlets, {raw} -> {len(blob)} bytes")

    export_gltf(info, args.output)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
