"""Texture streaming: AssetManager-driven bundle residency (port of
granite_tpu/assets/streaming.py).

Reference flow (SURVEY §3.4): AssetManager::register_asset ->
Application::post_frame -> AssetManager::iterate (budget/LRU, background
decode tasks) -> ResourceManager::latch_handles publishes new views;
draws use per-class fallback images until resident
(filesystem/asset_manager.hpp:51-66, 93-135;
vulkan/managers/resource_manager.hpp:78-152).

Here the draw-time "view" is a row of the material bundle array that
kernel B3 reads (PackedScene.bundles).  Each glTF image registers as an
asset; instantiation decodes it on a ThreadGroup worker into a numpy
array (a `.gtpx` sidecar through the native texture codec, else the
parser's RGBA8 through sRGB -> linear; then the resize) under a byte
budget.  latch() rebuilds on the host the strips of the bundles whose
images changed residency and writes each into its row of the device
array in place, so every holder of the array sees it.

One deliberate change from the original: it wraps the whole sidecar
decode in `except Exception` and renders the parser's PNG instead, which
hides a missing decoder.  Here only a malformed sidecar (gtpx_load's or
the decoder's ValueError) falls back to the PNG, with a warning; a build
or load failure of the codec raises (and AssetManager.iterate re-raises
it in the frame loop).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..filesystem.asset_manager import (
    AssetClass, AssetInstantiatorInterface, AssetManager,
)
from ..native.texture import decode_bc6h, decode_blocks, gtpx_load
from ..ops.srgb import srgb_u8_to_linear_np
from ..renderer.scene_renderer import build_bundle_strip
from ..utils.logging import LOGI, LOGW
from .texture_array import _resize_bilinear


class ImageInstantiator(AssetInstantiatorInterface):
    """Decodes one glTF image to a linear (S, S, 4) float32 array.

    Prefers a `<path>.gtpx` sidecar decoded with the native codec (BC6H
    takes the HDR route: no sRGB conversion, alpha 1); otherwise converts
    the parser-provided u8 RGBA.  Cost = decoded bytes (what the bundle
    row will hold)."""

    def __init__(self, images, image_srgb, image_paths, base_size: int):
        self.images = images
        self.image_srgb = image_srgb
        self.image_paths = image_paths or [None] * len(images)
        self.base_size = base_size
        s = base_size
        self._white = np.ones((s, s, 4), np.float32)
        normal = np.zeros((s, s, 4), np.float32)
        normal[..., 0:2] = 0.5
        normal[..., 2] = 1.0
        normal[..., 3] = 1.0
        self._normal = normal

    def _resized(self, linear: np.ndarray) -> np.ndarray:
        s = self.base_size
        if linear.shape[0] != s or linear.shape[1] != s:
            linear = _resize_bilinear(linear, s, s)
        return linear.astype(np.float32)

    def _sidecar(self, path: str):
        """-> ("u8", (H, W, 4) uint8) or ("hdr", (H, W, 4) float32) from
        the sidecar, or None when it is malformed (warned)."""
        try:
            fmt, w, h, _levels, _flags, payload = gtpx_load(path)
            data = np.frombuffer(payload, np.uint8)
            if fmt in ("bc6h", "bc6h_s"):
                hdr = decode_bc6h(data, w, h, signed=fmt == "bc6h_s")
                return "hdr", np.concatenate(
                    [hdr, np.ones_like(hdr[..., :1])], axis=-1)
            if fmt == "rgba8":
                if data.size != w * h * 4:
                    raise ValueError(f"rgba8 payload of {data.size} bytes "
                                     f"for {w}x{h}")
                return "u8", data.reshape(h, w, 4)
            return "u8", decode_blocks(fmt, data, w, h)
        except ValueError as err:
            LOGW("texture sidecar %s is malformed (%s); decoding the "
                 "image instead", path, err)
            return None

    def instantiate(self, path: str, asset_class: AssetClass):
        idx = int(path.split("://", 1)[1])
        src = self.image_paths[idx] if idx < len(self.image_paths) \
            else None
        img_u8 = None
        if src and os.path.exists(src + ".gtpx"):
            decoded = self._sidecar(src + ".gtpx")
            if decoded is not None and decoded[0] == "hdr":
                linear = self._resized(decoded[1])
                return linear, linear.nbytes
            if decoded is not None:
                img_u8 = decoded[1]
        if img_u8 is None:
            img_u8 = self.images[idx]
        if self.image_srgb[idx]:
            linear = srgb_u8_to_linear_np(img_u8)
        else:
            linear = img_u8.astype(np.float32) / 255.0
        linear = self._resized(linear)
        return linear, linear.nbytes

    def fallback(self, asset_class: AssetClass):
        if asset_class == AssetClass.NORMAL:
            return self._normal
        return self._white


class TextureStreamer:
    """Bundle-array residency manager for a packed scene.  `stats` counts
    the bundle rows latched and the host seconds spent building their
    strips and copying them to the device."""

    def __init__(self, info, bundle_keys, tex_to_image: dict,
                 base_size: int = 512, budget_bytes: Optional[int] = None,
                 device="cpu"):
        """tex_to_image: texture index -> glTF image index (the builtin
        white / flat-normal slots have no entry)."""
        self.bundle_keys = bundle_keys
        self.tex_to_image = tex_to_image
        self.base_size = base_size
        self.device = torch.device(device)
        self._inst = ImageInstantiator(
            info.images, info.image_srgb,
            getattr(info, "image_paths", None), base_size)
        self.manager = AssetManager(self._inst)
        if budget_bytes is not None:
            self.manager.set_asset_budget(budget_bytes)
        self._asset_of_tex: dict = {}
        for tex, img in tex_to_image.items():
            self._asset_of_tex[tex] = self.manager.register_asset(
                f"img://{img}", AssetClass.COLOR)
        self._resident_sig: dict = {}
        self._bundles: Optional[torch.Tensor] = None
        self.stats = {"latched": 0, "build_s": 0.0, "upload_s": 0.0}

    def _tex_image(self, tex: int, kind: int) -> np.ndarray:
        aid = self._asset_of_tex.get(tex)
        cls = AssetClass.NORMAL if kind == 2 else AssetClass.COLOR
        if aid is None:
            return self._inst.fallback(cls)
        self.manager.mark_used(aid)
        payload = self.manager.get_asset(aid)
        if payload is None:
            return self._inst.fallback(cls)
        return payload

    def fallback_strip(self) -> np.ndarray:
        """The strip of a bundle whose four images are all fallbacks."""
        color = self._inst.fallback(AssetClass.COLOR)
        return build_bundle_strip(
            [color, color, self._inst.fallback(AssetClass.NORMAL), color])

    def initial_bundles(self) -> torch.Tensor:
        """All-fallback bundle array for frame 0, on the scene's device."""
        strip = torch.from_numpy(self.fallback_strip())
        self._bundles = strip.to(self.device).unsqueeze(0).repeat(
            len(self.bundle_keys), 1, 1, 1)
        return self._bundles

    def latch(self) -> torch.Tensor:
        """Per-frame latch (ResourceManager::latch_handles): touch every
        referenced asset, iterate the manager, and rebuild and write in
        place the bundle rows whose images changed residency.  Returns
        the device bundle array (the same tensor every frame)."""
        # Request + touch every referenced asset (keeps the LRU fresh and
        # flags wanted-but-absent assets for the next iterate()).
        for aid in self._asset_of_tex.values():
            self.manager.get_asset(aid)
        self.manager.iterate()
        dirty = []
        for b, key in enumerate(self.bundle_keys):
            sig = tuple(
                self.manager.is_resident(self._asset_of_tex[t])
                if t in self._asset_of_tex else False for t in key)
            if self._resident_sig.get(b) != sig:
                self._resident_sig[b] = sig
                dirty.append(b)
        for b in dirty:
            key = self.bundle_keys[b]
            t0 = time.perf_counter()
            strip = build_bundle_strip(
                [self._tex_image(t, k) for k, t in enumerate(key)])
            t1 = time.perf_counter()
            # The strip lives in pageable host memory, so copy_ returns
            # only once its bytes are staged: the host strip may be freed
            # or rebuilt right after.  A pinned staging buffer reused
            # across latches would need an event before its next write.
            self._bundles[b].copy_(torch.from_numpy(strip))
            self.stats["build_s"] += t1 - t0
            self.stats["upload_s"] += time.perf_counter() - t1
        self.stats["latched"] += len(dirty)
        if dirty:
            LOGI("TextureStreamer: latched %d bundle(s), %d bytes "
                 "resident", len(dirty), self.manager.current_cost)
        return self._bundles
