"""Animation system (copy of granite_tpu/scene/animation.py; reference:
renderer/animation_system.{hpp,cpp}).

Plays glTF animation channels onto scene nodes on the host: each
channel's keyframe lookup is a searchsorted and a lerp, slerp or cubic
Hermite, and all channels of all active animations write the Scene's SoA
TRS arrays (and its morph weights) in place before the transform-tree
update.  LINEAR, STEP and CUBICSPLINE interpolation (scene_formats.hpp:54
channel types).  tests/test_torch_animation.py holds it equal to the
original.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..math.muglm import quat_slerp
from .scene_formats import AnimationData


def _sample_channel(ch: dict, t: float):
    times = ch["times"]
    vals = ch["values"]
    interp = ch["interp"]
    if len(times) == 0:
        return None
    if len(times) == 1:
        v = vals[0]
        return v[1] if interp == "CUBICSPLINE" else v
    t = float(np.clip(t, times[0], times[-1]))
    i = int(np.searchsorted(times, t, side="right") - 1)
    i = min(max(i, 0), len(times) - 2)
    t0, t1 = float(times[i]), float(times[i + 1])
    dt = max(t1 - t0, 1e-9)
    u = (t - t0) / dt
    if interp == "STEP":
        return vals[i]
    if interp == "CUBICSPLINE":
        # vals: (K, 3, C) = (in-tangent, value, out-tangent)
        p0 = vals[i, 1]
        p1 = vals[i + 1, 1]
        m0 = vals[i, 2] * dt
        m1 = vals[i + 1, 0] * dt
        u2, u3 = u * u, u * u * u
        return ((2 * u3 - 3 * u2 + 1) * p0 + (u3 - 2 * u2 + u) * m0
                + (-2 * u3 + 3 * u2) * p1 + (u3 - u2) * m1)
    # LINEAR
    a, b = vals[i], vals[i + 1]
    if ch["path"] == "rotation":
        return quat_slerp(a, b, u)
    return a + (b - a) * u


@dataclass
class AnimationState:
    """AnimationSystem::AnimationState analogue."""
    animation: AnimationData
    start_time: float = 0.0
    looping: bool = True
    playing: bool = True


class AnimationSystem:
    def __init__(self, scene):
        self.scene = scene
        self.states: list[AnimationState] = []

    def start_animation(self, animation: AnimationData,
                        start_time: float = 0.0,
                        looping: bool = True) -> AnimationState:
        st = AnimationState(animation, start_time, looping)
        self.states.append(st)
        return st

    def stop_animation(self, state: AnimationState) -> None:
        if state in self.states:
            self.states.remove(state)

    def animate(self, elapsed_time: float) -> None:
        """Sample all active channels at `elapsed_time` and write node TRS
        (AnimationSystem::animate)."""
        scene = self.scene
        for st in self.states:
            if not st.playing:
                continue
            dur = st.animation.duration
            t = elapsed_time - st.start_time
            if st.looping and dur > 0:
                t = t % dur
            for ch in st.animation.channels:
                v = _sample_channel(ch, t)
                if v is None:
                    continue
                node = ch["node"]
                path = ch["path"]
                if path == "translation":
                    scene.translation[node] = v
                elif path == "rotation":
                    n = np.linalg.norm(v)
                    scene.rotation[node] = v / max(n, 1e-12)
                elif path == "scale":
                    scene.scale[node] = v
                elif path == "weights":
                    # Morph-target weights (scene_formats.hpp weights
                    # channel); consumed by the packer's morph ranges.
                    scene.node_morph_weights[node] = np.asarray(
                        v, np.float32)
