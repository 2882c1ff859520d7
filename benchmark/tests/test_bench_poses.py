"""The pose lists: a function of the traffic file and the seed alone;
every seed renders the same loop of poses from another place on it."""

import json
import os

import numpy as np
import pytest

from gbench.traffic import loop_angles, poses

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")
NAMES = ("orbit_1080p", "walk_1080p", "orbit_2160p")


def load(name):
    with open(os.path.join(TRAFFIC, f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", NAMES)
def test_same_seed_same_poses(name):
    a = poses(load(name), 2**31 + 77)
    b = poses(load(name), 2**31 + 77)
    assert a[0].dtype == np.float32 and a[1].dtype == np.float32
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


@pytest.mark.parametrize("name", NAMES)
def test_seeds_rotate_one_loop(name):
    p1, r1 = poses(load(name), 3)
    p2, r2 = poses(load(name), 2**33 + 5)
    assert len(p1) == len(p2) == len(loop_angles(load(name)))
    shift = int(np.nonzero((p2 == p1[0]).all(axis=1))[0][0])
    assert np.array_equal(np.roll(p2, -shift, axis=0), p1)
    assert np.array_equal(np.roll(r2, -shift, axis=0), r1)
    assert not np.array_equal(p1, p2)


def test_walk_speed_and_height():
    t = load("walk_1080p")
    p, _r = poses(t, 11)
    step = np.linalg.norm(np.diff(np.concatenate([p, p[:1]]), axis=0),
                          axis=1)
    assert np.allclose(step, 1.4 / 60, rtol=2e-2)
    assert np.all(p[:, 1] == np.float32(1.7))
    assert np.all(np.abs(p[:, [0, 2]]) < 14.0)   # inside the object field


def test_orbit_step_and_look():
    t = load("orbit_1080p")
    p, r = poses(t, 11)
    ang = np.unwrap(np.arctan2(p[:, 2], p[:, 0]).astype(np.float64))
    steps = np.diff(ang)
    # one loop: 0.01 rad a frame but at the list's seam, where the last
    # pose closes the circle short of a full step
    off = np.abs(steps - 0.01) > 1e-5
    assert off.sum() <= 1 and np.all((steps[off] > 0) & (steps[off] < 0.01))
    # every pose looks at the atrium's centre: -Z of the view is the
    # direction to it
    from plainref.scene import camera_view
    for i in (0, len(p) // 3):
        front = -camera_view(p[i], r[i])[2, :3]
        d = np.asarray(t["look"]) - p[i]
        assert np.allclose(front, d / np.linalg.norm(d), atol=1e-5)
