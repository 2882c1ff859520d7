"""The plain reference against the port's CPU path on a small view of the
bench scene (fewer objects, small maps): a sound run comes out correct;
the bfloat16 control and each planted fault come out not correct.  The
same comparison decides `correct` on the card at the cells' own sizes."""

import json
import os

import pytest
import torch

from gbench.cell import compare, run_cell

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 12345


def small(config: str, traffic: str):
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        tr = json.load(f)
    cfg["viewer"].update(shadowMapResolution=256,
                         clusteredLightsShadowsResolution=64)
    cfg["scene"]["target_tris"] = 20000
    tr.update(width=160, height=96)
    return cfg, tr


def verdict(cfg, numbers) -> bool:
    lim = cfg["limits"]
    return set(numbers) == set(lim) and all(numbers[k] <= lim[k]
                                             for k in lim)


CELLS = [("deferred_hdr", "orbit_1080p"), ("forward_pcf", "walk_1080p")]


@pytest.fixture(scope="module", params=CELLS, ids=[c for c, _ in CELLS])
def cell(request):
    torch.set_num_threads(2)
    cfg, tr = small(*request.param)
    res = run_cell(cfg, tr, SEED, 0.5, False, "cpu", log=lambda *a: None)
    return cfg, tr, res


def test_sound_run_is_correct(cell):
    cfg, tr, res = cell
    out = compare(res, cfg, "cpu", log=lambda *a: None)
    assert res["frames"] >= 4
    # the window's first and last frames are judged, and two drawn
    assert {0, res["frames"] - 1} <= set(out["detail"])
    assert verdict(cfg, out["numbers"]), out["numbers"]


def test_control_is_not_correct(cell):
    cfg, tr, res = cell
    out = compare(res, cfg, "cpu", control=True, log=lambda *a: None)
    assert not verdict(cfg, out["numbers"]), out["numbers"]


def _wrap_pass(app, name, change):
    rp = app.graph._passes[name]
    ex = rp._execute

    def broken(ctx):
        return change(ex(ctx))
    rp._execute = broken


def lit_block_altered(app):
    """A lit answer altered where it is produced."""
    name = "lighting" if "lighting" in app.graph._passes else "forward"

    def change(outs):
        hdr = outs["hdr"].clone()
        hdr[8:16, 8:16] += 0.5
        return {**outs, "hdr": hdr}
    _wrap_pass(app, name, change)


def stale_pose(app):
    """Each frame rendered at the pose the harness set the frame before."""
    render = app.render_frame
    prev = {}

    def broken(ft, et):
        cur = (app.camera.position.copy(), app.camera.rotation.copy())
        if prev:
            app.camera.position, app.camera.rotation = prev["p"]
        prev["p"] = cur
        return render(ft, et)
    app.render_frame = broken


def object_dropped(app):
    """The nearest visible object left out of the frame's object mask."""
    build = app.build_frame_params

    def broken(ft, et=0.0):
        p = build(ft, et)
        vis = torch.nonzero(p["object_mask"])[:, 0]
        if len(vis):
            mn = torch.as_tensor(app.scene.r_world_min, dtype=torch.float32)
            cam = torch.as_tensor(app.camera.position, dtype=torch.float32)
            d = (mn[vis.cpu()] - cam).norm(dim=1)
            mask = p["object_mask"].clone()
            mask[vis[int(d.argmin())]] = False
            p["object_mask"] = mask
        return p
    app.build_frame_params = broken


def backbuffer_altered(app):
    def change(outs):
        key = "backbuffer" if "backbuffer" in outs else "ldr"
        bb = outs[key].clone()
        bb[8:16, 8:16, 0] ^= 0x10
        return {**outs, key: bb}
    _wrap_pass(app, "tonemap", change)


@pytest.mark.parametrize("fault", [lit_block_altered, stale_pose,
                                   object_dropped, backbuffer_altered],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(fault):
    torch.set_num_threads(2)
    cfg, tr = small("deferred_hdr", "orbit_1080p")
    res = run_cell(cfg, tr, SEED, 0.5, False, "cpu", fault=fault,
                   log=lambda *a: None)
    out = compare(res, cfg, "cpu", log=lambda *a: None)
    assert not verdict(cfg, out["numbers"]), out["numbers"]
