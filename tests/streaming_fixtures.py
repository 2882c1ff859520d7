"""Textured scenes for the texture-streaming tests and chip_smoke.py's
streaming path: every material of a scene gets four RGBA8 images made
from a numpy seed (base colour, metallic-roughness, normal, emissive),
the scene is written as glTF by the port's exporter, and each PNG gets a
`.gtpx` sidecar from the port's encoders.  No jax.

Sidecar formats follow the glTF loader's colour spaces (base colour and
emissive sRGB, metallic-roughness and normal linear): base colour BC7,
BC3 or RGBA8 by material (BASE_FORMATS), metallic-roughness BC1, normal
BC5, emissive BC6H (HDR: the streamer skips its sRGB conversion, and its
payload is the sRGB-decoded PNG).
"""

from __future__ import annotations

import os
import time

import numpy as np

# Base-colour sidecar format of material i (the last repeats).
BASE_FORMATS = ("bc7", "bc7", "bc7", "bc3", "rgba8")
SLOT_FORMATS = {"metallic_roughness_image": "bc1", "normal_image": "bc5"}
SLOTS = ("base_color_image", "metallic_roughness_image", "normal_image",
         "emissive_image")
EMISSIVE_FACTOR = 0.2


def _pattern(rng, size: int) -> np.ndarray:
    """(size, size, 4) uint8: a seeded 16x16 grid of tiles plus a seeded
    sine wave a channel (along x for red and blue, along y for green),
    alpha 255.  Each channel repeats along one axis inside a tile, so PNG
    writes a 1024^2 image in tens of milliseconds."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    tiles = rng.uniform(-0.15, 0.15, (16, 16, 3)).astype(np.float32)
    cell = -(-size // 16)
    img = np.empty((size, size, 4), np.float32)
    img[..., :3] = tiles.repeat(cell, 0).repeat(cell, 1)[:size, :size]
    for c, axis in enumerate((xx, yy, xx)):
        freq, phase = rng.uniform(1.0, 9.0), rng.uniform(0.0, 6.3)
        img[..., c] += 0.5 + 0.3 * np.sin(2 * np.pi * freq * axis + phase)
    img[..., 3] = 1.0
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def add_material_images(info, size: int, seed: int) -> None:
    """Replace info's images: material i's four slots point at images
    4i .. 4i+3, sRGB for base colour and emissive; each material gets an
    emissive factor so its emissive image shows."""
    rng = np.random.default_rng(seed)
    info.images, info.image_srgb, info.image_paths = [], [], []
    for m in info.materials:
        for slot in SLOTS:
            setattr(m, slot, len(info.images))
            info.images.append(_pattern(rng, size))
            info.image_srgb.append(slot in ("base_color_image",
                                            "emissive_image"))
        m.emissive_factor = np.full(3, EMISSIVE_FACTOR, np.float32)


def image_files(gltf_path: str, count: int) -> list:
    """The PNG paths export_gltf wrote for `count` images."""
    base = os.path.splitext(gltf_path)[0]
    return [f"{base}_img{i}.png" for i in range(count)]


def sidecar_format(info, image: int,
                   base_formats=BASE_FORMATS) -> str:
    for mi, m in enumerate(info.materials):
        for slot in SLOTS:
            if getattr(m, slot) == image:
                if slot == "base_color_image":
                    return base_formats[min(mi, len(base_formats) - 1)]
                return SLOT_FORMATS.get(slot, "bc6h")
    raise ValueError(f"image {image} is in no material")


def write_sidecars(info, gltf_path: str, base_formats=BASE_FORMATS) -> dict:
    """A `.gtpx` beside each exported PNG, encoded by the port's codec
    from info's images, one encode a thread (the codec releases the
    interpreter lock).  -> {format: encode seconds summed}."""
    from concurrent.futures import ThreadPoolExecutor
    from granite_tpu_torch.native import texture as TX
    from granite_tpu_torch.ops.srgb import srgb_u8_to_linear_np
    TX.get_lib()                       # build once, before the threads

    def encode(i: int, png: str):
        img = info.images[i]
        fmt = sidecar_format(info, i, base_formats)
        t = time.perf_counter()
        if fmt == "rgba8":
            payload = np.ascontiguousarray(img).tobytes()
        elif fmt == "bc6h":
            payload = TX.encode_bc6h(srgb_u8_to_linear_np(img)).tobytes()
        else:
            payload = getattr(TX, f"encode_{fmt}")(img).tobytes()
        h, w = img.shape[:2]
        TX.gtpx_save(png + ".gtpx", payload, fmt, w, h)
        return fmt, time.perf_counter() - t

    pngs = image_files(gltf_path, len(info.images))
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        done = [pool.submit(encode, i, png) for i, png in enumerate(pngs)]
        results = [f.result() for f in done]
    seconds: dict = {}
    for fmt, s in results:
        seconds[fmt] = seconds.get(fmt, 0.0) + s
    return seconds


def write_textured_scene(info, directory: str, name: str, size: int,
                         seed: int, sidecars: bool = True,
                         base_formats=BASE_FORMATS) -> dict:
    """add_material_images, export_gltf to directory/name, then the
    sidecars.  -> {"path", "export_s", "sidecars_s" (wall),
    "encode_s": {format: encode seconds summed}}."""
    from granite_tpu_torch.scene_export import export_gltf
    add_material_images(info, size, seed)
    path = os.path.join(directory, name)
    t = time.perf_counter()
    export_gltf(info, path)
    t1 = time.perf_counter()
    out = {"path": path, "export_s": t1 - t, "encode_s": {}}
    if sidecars:
        out["encode_s"] = write_sidecars(info, path, base_formats)
    out["sidecars_s"] = time.perf_counter() - t1
    return out
