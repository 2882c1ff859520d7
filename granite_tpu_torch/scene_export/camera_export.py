"""Recorded-camera JSON export and import (copy of
granite_tpu/scene_export/camera_export.py; reference:
scene-export/camera_export.cpp:33-73 and camera_export.hpp:31-41).

Cameras (position, direction, up and lens) serialize to a pretty-printed
JSON document with a top-level "cameras" array, field for field as the
reference writes it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np


@dataclass
class RecordedCamera:
    """camera_export.hpp:31 RecordedCamera."""
    fovy: float = 0.9
    aspect: float = 16 / 9
    znear: float = 0.1
    zfar: float = 1000.0
    position: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, -1], np.float32))
    up: np.ndarray = field(
        default_factory=lambda: np.array([0, 1, 0], np.float32))


def export_cameras_to_json(cameras) -> str:
    """camera_export.cpp:33 export_cameras_to_json."""
    doc = {"cameras": [
        {"fovy": float(c.fovy), "aspect": float(c.aspect),
         "znear": float(c.znear), "zfar": float(c.zfar),
         "direction": [float(v) for v in np.asarray(c.direction)],
         "position": [float(v) for v in np.asarray(c.position)],
         "up": [float(v) for v in np.asarray(c.up)]}
        for c in cameras]}
    return json.dumps(doc, indent=2)


def import_cameras_from_json(text: str) -> list:
    doc = json.loads(text)
    out = []
    for c in doc.get("cameras", []):
        out.append(RecordedCamera(
            fovy=float(c["fovy"]), aspect=float(c["aspect"]),
            znear=float(c["znear"]), zfar=float(c["zfar"]),
            position=np.asarray(c["position"], np.float32),
            direction=np.asarray(c["direction"], np.float32),
            up=np.asarray(c["up"], np.float32)))
    return out
