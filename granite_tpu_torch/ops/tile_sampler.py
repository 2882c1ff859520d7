"""Per-pixel texture fetch from packed LOD strips — kernel B3 (replaces
granite_tpu/ops/tile_sampler.py _sample_kernel).

The reference's tile sampler planned texel rects per screen tile, DMA'd
them into VMEM and fetched texels with one-hot MXU matmuls: all TPU
workarounds for its slow per-pixel gather.  On Hopper the job is a
gather: each pixel reads ONE 5C-channel row of the (N, HS-1, S, 5C) LOD
strip (ops/texture.build_packed_lod_strip_np) at floor(lod) and
reconstructs approximate trilinear (bilinear quad lerped to the baked
parent tap), with ops/texture.sample_packed_lod semantics.  A warp
copies its 32 pixels' rows into shared memory as contiguous chunks
(cp.async, double-buffered in a persistent loop) and writes its outputs
as contiguous float4s (csrc/tile_sampler.cu says why).
Pixels with bundle < 0 (uncovered) return 0, and the output is
nan_to_num'd (nan -> 0, +inf -> 1, -inf -> 0) like the reference.

Used for the material fetch (f16 texels, C = 12) and the specular IBL
environment fetch (f32 texels, C = 4).

Kernel B3T is the reference kernel's other mode, `bilinear_taps`: an
exact f32 clamp-to-edge bilinear fetch of raw texels at level 0, which
the reference uses for the VSM moments (ops/shadow.sample_vsm_shadow_
tiled).  There the planner laid the moments out as a clamp-wrapped mip
strip and fetched 48-row rects with weighted one-hot matmuls; here one
thread per pixel reads the 2x2 footprint straight from the (H, W, C)
moment map.
"""

from __future__ import annotations

import torch

from ..kernels import build as K
from .hdr import _sample_bilinear_uv
from .texture import num_mip_levels, sample_packed_lod


def _finite_or_zero(out):
    return torch.nan_to_num(out, nan=0.0, posinf=1.0, neginf=0.0)


def sample_lod_plain(strips, bundle, u, v, lod, channels: int):
    """Plain PyTorch version of kernel B3 -> (..., channels) f32."""
    n = strips.shape[0]
    live = (bundle >= 0) & (bundle < n)
    out = sample_packed_lod(strips, torch.where(live, bundle,
                                                torch.zeros_like(bundle)),
                            u, v, lod, channels)
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    return _finite_or_zero(out)


def row_stride(t, name: str = "tensor"):
    """The row stride in elements that reads `t` as rows of its last
    dimension: element i lies at (i // W) * row + i % W, W = t.shape[-1].
    Contiguous tensors and views such as a plane of the (P, H, W) G-buffer
    or a crop of a padded plane have this form; raises for a last
    dimension that is not contiguous or leading dimensions that do not
    merge into one."""
    if t.dim() == 0:
        return 0
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: column stride {t.stride(-1)}, the kernel "
                         "reads rows of contiguous elements")
    row = span = None
    for size, stride in zip(reversed(t.shape[:-1]),
                            reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if row is None:
            row = stride
        elif stride != span:
            raise ValueError(f"{name}: strides {t.stride()} for shape "
                             f"{tuple(t.shape)} do not read as rows")
        span = stride * size
    return 0 if row is None else row


def sample_lod(strips, bundle, u, v, lod, channels: int):
    """Kernel B3: strips (N, HS-1, S, 5C), f16 with C = 12 or f32 with
    C = 4; bundle (...) int32 (-1 = skip); u, v, lod (...) f32 ->
    (..., channels) f32.  bundle, u, v and lod may be strided views (see
    row_stride): the kernel reads them in place."""
    dev = strips.device
    inputs = {"bundle": bundle, "u": u, "v": v, "lod": lod}
    if dev.type == "cpu" and all(t.device.type == "cpu"
                                 for t in inputs.values()):
        return sample_lod_plain(strips, bundle, u, v, lod, channels)
    if dev.type != "cuda":
        raise ValueError(f"sample_lod: strips on {dev} with inputs on "
                         f"{[str(t.device) for t in inputs.values()]}")
    variant = (strips.dtype, channels)
    if variant not in ((torch.float16, 12), (torch.float32, 4)):
        raise ValueError(f"sample_lod: {strips.dtype} strips with "
                         f"{channels} channels (the kernel instantiates f16 "
                         "C=12 for materials and f32 C=4 for the "
                         "environment)")
    K.check(strips, "strips", strips.dtype, dev, 4)
    N, rows, S, c5 = strips.shape
    if c5 != 5 * channels:
        raise ValueError(f"sample_lod: {c5} strip lanes for {channels} "
                         "channels")
    if N * rows * S >= 2 ** 31 or strips.data_ptr() % 16:
        raise ValueError("sample_lod: strips need < 2^31 rows and a "
                         "16-byte aligned start")
    if u.numel() >= 2 ** 31:
        raise ValueError(f"sample_lod: {u.numel()} pixels, at most 2^31 - 1")
    shape = u.shape
    strides = []
    for name, t in inputs.items():
        dtype = torch.int32 if name == "bundle" else torch.float32
        if t.shape != shape or t.device != dev or t.dtype != dtype:
            raise ValueError(f"sample_lod: {name} {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, expected "
                             f"{tuple(shape)} {dtype} on {dev}")
        strides.append(row_stride(t, name))
    out = torch.empty(shape + (channels,), dtype=torch.float32, device=dev)
    K.launch("B3", "granite_sample_lod", K.ptr(strips),
             int(strips.dtype == torch.float16), N, rows, S, channels,
             K.ptr(bundle), K.ptr(u), K.ptr(v), K.ptr(lod),
             max(shape[-1], 1) if shape else 1, *strides,
             K.ptr(out), u.numel(), num_mip_levels(S, S))
    return out


def sample_bilinear_plain(img, u, v, live):
    """Plain PyTorch version of kernel B3T -> (..., C) f32."""
    out = _sample_bilinear_uv(img, u, v)
    out = torch.where(live[..., None], out, torch.zeros_like(out))
    return _finite_or_zero(out)


def sample_bilinear(img, u, v, live):
    """Kernel B3T: img (H, W, C) f32 (kernel instantiates C = 2); u, v
    (...) f32; live (...) bool (False = skip, output 0) -> (..., C) f32,
    clamp-to-edge bilinear at level 0, nan_to_num'd."""
    dev = img.device
    if dev.type == "cpu":
        return sample_bilinear_plain(img, u, v, live)
    if dev.type != "cuda":
        raise ValueError(f"sample_bilinear: unsupported device {dev}")
    K.check(img, "img", torch.float32, dev, 3)
    H, W, C = img.shape
    if C != 2:
        raise ValueError(f"sample_bilinear: {C} channels (kernel "
                         "instantiates C = 2)")
    shape = u.shape
    u = u.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    live = live.to(torch.bool).contiguous()
    for name, t in (("u", u), ("v", v), ("live", live)):
        if t.shape != shape or t.device != dev:
            raise ValueError(f"sample_bilinear: {name} {tuple(t.shape)} on "
                             f"{t.device}, expected {tuple(shape)}")
    out = torch.empty(shape + (C,), dtype=torch.float32, device=dev)
    K.launch("B3T", "granite_sample_bilinear", K.ptr(img), H, W, C,
             K.ptr(u), K.ptr(v), K.ptr(live), K.ptr(out), u.numel())
    return out
