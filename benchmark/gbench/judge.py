"""The comparison that decides `correct`: the numbers the benchmark reads
off the viewer's planes against the reference's, each a share of the
pixels (or texels) that differ by more than a fixed tolerance.

  sun_depth   static 2048^2 sun map (B1): texels off by > DEPTH_TOL
  atlas_depth the clustered lights' shadow atlas (B1), likewise
  geometry    main view: pixels whose coverage differs or whose depth
              differs by > DEPTH_TOL (B2's binning, walk and resolve)
  gbuffer     surface attributes with the material fetch (B2's resolve,
              B3) where the geometry agrees: a channel off by > ATTR_TOL
              (positions relative to their magnitude)
  hdr         the lit HDR (B4, the PCF sun term, the atlas terms, the
              environment): off by > HDR_TOL x (1 + |reference|), a
              wrong answer somewhere in the frame
  hdr_fine    the same at HDR_FINE_TOL: the frame lit at a lower
              precision
  backbuffer  the sRGB backbuffer after bloom and tonemap: a channel off
              by more than BACKBUFFER_LEVELS

The reference works in float64 from the stated rules and the viewer in
float32, so the tolerances sit above float32's rounding of each stage
and below half precision's (2^-11 relative, the viewer's own float16
render targets) and bfloat16's (2^-9 relative a stage).
"""

from __future__ import annotations

import torch

DEPTH_TOL = 1e-6
ATTR_TOL = 1e-3
HDR_TOL = 1e-3
HDR_FINE_TOL = 1e-4
BACKBUFFER_LEVELS = 1
GBUFFER_PLANES = ("g-base", "g-normal", "g-pbr", "g-emissive", "g-pos")


def share(mask) -> float:
    return float(mask.to(torch.float64).mean())


def depth_off(a, b):
    return (a.to(torch.float64) - b.to(torch.float64)).abs() > DEPTH_TOL


def geometry_mask(port: dict, ref: dict):
    """Pixels where the two frames see different geometry."""
    return (port["covered"] != ref["covered"]) | depth_off(
        port["depth"], ref["depth"])


def compare_surface(port: dict, ref: dict) -> dict:
    """The per-pose numbers of one judged frame."""
    geo = geometry_mask(port, ref)
    out = {"geometry": share(geo)}
    same = ~geo
    if "g-base" in port:
        off = torch.zeros_like(geo)
        for name in GBUFFER_PLANES:
            a, b = port[name].to(torch.float64), ref[name].to(torch.float64)
            scale = b.abs().clamp_min(1.0) if name == "g-pos" else 1.0
            off |= (((a - b).abs() / scale) > ATTR_TOL).any(-1)
        out["gbuffer"] = share(off & same & ref["covered"])
    a, b = port["hdr"].to(torch.float64), ref["hdr"].to(torch.float64)
    rel = ((a - b).abs() / (1.0 + b.abs())).amax(-1)
    out["hdr"] = share(rel > HDR_TOL)
    out["hdr_fine"] = share(rel > HDR_FINE_TOL)
    return out


def errors(port: dict, ref: dict) -> dict:
    """The largest differences behind the numbers, for the run's output
    file (not compared): where the geometry agrees, the G-buffer's
    largest absolute error and the HDR's largest error relative to
    1 + |reference|."""
    same = ~geometry_mask(port, ref)
    out = {}
    a, b = port["hdr"].to(torch.float64), ref["hdr"].to(torch.float64)
    rel = ((a - b).abs() / (1.0 + b.abs())).amax(-1)
    out["hdr_max_rel"] = float(rel[same].max()) if same.any() else 0.0
    out["hdr_share_over"] = {f"{t:g}": share(rel > t)
                             for t in (2e-5, 5e-5, 1e-4, 5e-4, 1e-3)}
    if "g-base" in port:
        worst = 0.0
        for name in GBUFFER_PLANES:
            d = (port[name].to(torch.float64)
                 - ref[name].to(torch.float64)).abs().amax(-1)
            worst = max(worst, float(d[same & ref["covered"]].max())
                        if (same & ref["covered"]).any() else 0.0)
        out["gbuffer_max_abs"] = worst
    return out


def compare_backbuffer(a, b) -> float:
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    return share((d > BACKBUFFER_LEVELS).any(-1))


def compare_depth_map(a, b) -> float:
    return share(depth_off(a, b))
