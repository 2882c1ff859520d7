"""The legs of `python -m granite_tpu_torch.parallel` (the port's
counterpart of `__graft_entry__.py` `dryrun_multichip`), each a rank
function for `launch.spawn_ranks`: fn(mesh, ...) -> a picklable dict.

- `frame_leg`: frames of the viewer's deferred graph through
  shard_frame_step, the backbuffer gathered on rank 0 and (optionally)
  the same frames unsharded on rank 0 beside it;
- `raster_leg`: rasterize_binned_sharded on a TriangleSetup given as
  numpy arrays (`setup_arrays`), e.g. the 24-sphere field;
- `toy_leg`: the two-pass graph of the JAX package's sharding test;
- `dryrun_rank`: several legs in one launch.

They import nothing of JAX: the tests that hold them against the JAX
package import it, the ranks never do.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import types

import numpy as np
import torch

from ..graph.render_graph import AttachmentInfo, RenderGraph, SizeClass
from ..kernels import build as K
from ..ops.raster import TriangleSetup, setup_triangles
from .framebuffer_sharding import shard_frame_step
from .sharded_raster import rasterize_binned_sharded

FRAME_TIME = 1.0 / 60.0
# The JAX dryrun's frame config (__graft_entry__._make_app), minus its
# fusedShade knob (the port always shades through B4's route), with the
# light atlas at the JAX sharding test's small size (512^2 slices take
# a minute a rank on a CPU).
DRYRUN_CONFIG = {"renderer": "deferred", "hdrBloom": True,
                 "shadowMapResolution": 64, "postAA": "none",
                 "clusteredLightsShadowsResolution": 64}


def setup_arrays(setup: TriangleSetup) -> dict:
    """A TriangleSetup as numpy arrays (for a rank's arguments)."""
    return {k: v.cpu().numpy() for k, v in setup._asdict().items()}


def setup_from_arrays(arrays: dict, device) -> TriangleSetup:
    return TriangleSetup(**{k: torch.from_numpy(np.ascontiguousarray(v))
                            .to(device) for k, v in arrays.items()})


def sphere_field_setup(width: int, height: int, device="cpu"
                       ) -> TriangleSetup:
    """The JAX dryrun's field of 24 spheres (sphere_mesh(10), seed 2,
    stratified in y, x in [-4, 4], scale 0.45; __graft_entry__.py
    `_dryrun_sharded_raster_1080p`) seen from z = 8."""
    from ..math.muglm import look_at_matrix, perspective
    from ..renderer.scene_renderer import pack_scene, transform_vertices
    from ..scene.mesh_util import sphere_mesh
    from ..scene.scene import Scene
    from ..scene.scene_formats import NodeData, SceneInfo
    info = SceneInfo()
    rng = np.random.RandomState(2)
    info.meshes = [sphere_mesh(10, 1)]
    nodes = [NodeData(name="root")]
    for i in range(24):
        t = (rng.uniform(-4, 4), -3.2 + 6.4 * (i + 0.5) / 24,
             rng.uniform(-1, 1))
        nodes.append(NodeData(name=f"s{i}", meshes=[0],
                              translation=np.array(t, np.float32),
                              scale=np.full(3, 0.45, np.float32)))
    nodes[0].children = list(range(1, len(nodes)))
    info.nodes = nodes
    info.roots = [0]
    packed = pack_scene(info, device=device)
    s = Scene()
    for i, nd in enumerate(info.nodes):
        s.create_node(parent=0 if i else -1, translation=nd.translation,
                      rotation=nd.rotation, scale=nd.scale)
    s.update_transform_tree()
    n = s.num_nodes
    world = torch.from_numpy(s.world[:n].copy()).to(device)
    nmats = torch.from_numpy(np.linalg.inv(s.world[:n, :3, :3])
                             .transpose(0, 2, 1).astype(np.float32)).to(device)
    view = look_at_matrix(np.array([0, 0, 8.0]), np.zeros(3), (0, 1, 0))
    proj = perspective(0.9, width / height, 0.1)
    vp = torch.from_numpy((proj @ view).astype(np.float32)).to(device)
    clip = transform_vertices(packed, world, nmats, vp)[0]
    return setup_triangles(clip, packed.indices, width, height)


def make_viewer(cfg: dict, bench_scene: bool, device):
    from ..app.scene_viewer import SceneViewerApplication
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    try:
        return SceneViewerApplication(types.SimpleNamespace(
            config=f.name, bench_scene=bench_scene, scene=None,
            camera_index=-1), device=str(device))
    finally:
        os.unlink(f.name)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frame_leg(mesh, cfg: dict, width: int, height: int, warmup: int = 0,
              frames: int = 1, bench_scene: bool = False) -> dict:
    """warmup + frames chained frames of the viewer (a still camera, one
    params) through shard_frame_step.  -> this rank's band rows, its
    luminance history, the kernel launches and the collectives of each
    timed frame, ms/frame (CUDA events on a card, else the host clock),
    the placement of each pass, the launches of the whole leg (set-up
    included); rank 0 adds the gathered backbuffer and the same frames
    run whole in this process (and the launches of the last of them)."""
    dev = mesh.device
    before = dict(K.LAUNCHES)
    t0 = time.monotonic()
    app = make_viewer(cfg, bench_scene, dev)
    app.swapchain_updated(width, height)
    params = app.build_frame_params(FRAME_TIME, 0.0)
    runner = shard_frame_step(app.graph, mesh)
    history = app.graph.initial_history(dev)
    for _ in range(warmup):
        out, history = runner(params, history)
    _sync(dev)
    setup_s = time.monotonic() - t0
    per_frame, seconds = [], []
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t1 = time.perf_counter()
    for _ in range(frames):
        launches, counts = dict(K.LAUNCHES), dict(mesh.counts)
        secs = dict(mesh.seconds)
        out, history = runner(params, history)
        per_frame.append({
            "launches": {k: K.LAUNCHES[k] - launches[k] for k in launches},
            "collectives": {k: mesh.counts[k] - counts[k] for k in counts}})
        seconds.append({k: (mesh.seconds[k] - secs[k]) * 1e3 for k in secs})
    if dev.type == "cuda":
        end.record()
    _sync(dev)
    host_ms = (time.perf_counter() - t1) * 1e3 / frames
    ms = start.elapsed_time(end) / frames if dev.type == "cuda" else host_ms
    launches = {k: K.LAUNCHES[k] - before[k] for k in before}
    full = mesh.gather_rows_to(out, 0)
    result = dict(rank=mesh.rank, band_rows=int(out.shape[0]),
                  luminance=float(history["luminance"]), frames=per_frame,
                  collective_ms=seconds, ms=ms, host_ms=host_ms,
                  setup_s=setup_s, launches=launches,
                  placement=dict(runner.placement),
                  history_rows={k: int(v.shape[0]) if v.dim() else 0
                                for k, v in history.items()})
    if mesh.rank == 0:
        result["frame"] = full.cpu().numpy()
        ref_hist = app.graph.initial_history(dev)
        for _ in range(warmup + frames):
            counted = dict(K.LAUNCHES)
            ref, ref_hist = app.graph.execute(params, ref_hist)
        result["reference_launches"] = {
            k: K.LAUNCHES[k] - counted[k] for k in counted}
        result["reference"] = ref.cpu().numpy()
        result["reference_luminance"] = float(ref_hist["luminance"])
    return result


def raster_leg(mesh, arrays: dict, width: int, height: int) -> dict:
    """rasterize_binned_sharded on the setup `arrays` -> the band counts,
    the binner's counters of every band, this rank's B1 launches in the
    call; rank 0 adds the gathered depth and triangle ids."""
    setup = setup_from_arrays(arrays, mesh.device)
    before = K.LAUNCHES["B1"]
    depth, tri, counts, stats = rasterize_binned_sharded(setup, width,
                                                         height, mesh)
    _sync(mesh.device)
    result = dict(rank=mesh.rank, counts=counts.cpu().numpy(),
                  stats={k: v.cpu().numpy() for k, v in stats.items()},
                  b1_launches=K.LAUNCHES["B1"] - before)
    if mesh.rank == 0:
        result.update(depth=depth.cpu().numpy(), tri=tri.cpu().numpy())
    return result


def toy_graph(height: int, width: int) -> RenderGraph:
    """tests/test_parallel.py's two passes: a flat colour, then the image
    over its global mean; both honour the row window."""
    g = RenderGraph()
    g.set_backbuffer_dimensions(width, height)
    info = AttachmentInfo(size_class=SizeClass.ABSOLUTE, size_x=width,
                          size_y=height, channels=3)

    def shade(ctx):
        rows = ctx.rows("img")
        h = height if rows is None else rows[1] - rows[0]
        return {"img": ctx.params["color"].expand(h, width, 3) * 1.0}

    def post(ctx):
        img = ctx.input("img")
        return {"out": img / (1e-6 + ctx.mean("img", img))}

    g.add_pass("shade").add_color_output("img", info) \
        .set_execute(shade).set_row_banded()
    g.add_pass("post").add_texture_input("img") \
        .add_color_output("out", info).set_execute(post).set_row_banded()
    g.set_backbuffer_source("out")
    g.bake()
    return g


def toy_leg(mesh, height: int, width: int, color) -> dict:
    """The toy graph's frame through shard_frame_step -> this rank's rows
    and the collectives it ran."""
    g = toy_graph(height, width)
    runner = shard_frame_step(g, mesh)
    before = dict(mesh.counts)
    out, _ = runner({"color": torch.tensor(color, dtype=torch.float32,
                                           device=mesh.device)},
                    g.initial_history(mesh.device))
    return dict(rank=mesh.rank, rows=out.cpu().numpy(),
                collectives={k: mesh.counts[k] - before[k] for k in before},
                placement=dict(runner.placement))


LEGS = {"frame": frame_leg, "raster": raster_leg, "toy": toy_leg}


def dryrun_rank(mesh, legs: dict, fail_rank: int | None = None) -> dict:
    """Several legs in one launch: legs maps a name to (kind, kwargs),
    kind a key of LEGS, run in order -> {name: result}.  fail_rank: that
    rank raises DryrunFailure before its legs (a failing rank must fail
    the whole run, with its traceback)."""
    if mesh.rank == fail_rank:
        raise DryrunFailure(f"rank {mesh.rank} fails as asked (fail_rank)")
    return {name: LEGS[kind](mesh, **kwargs)
            for name, (kind, kwargs) in legs.items()}


class DryrunFailure(RuntimeError):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise DryrunFailure(what)


def check_frame(results: list, height: int) -> dict:
    """frame_leg's gates over every rank's result (rank order): each rank
    holds height / n rows, the luminance history is equal on every rank,
    every timed frame ran 1 all_reduce and >= 1 all_gather, and rank 0's
    gathered backbuffer is within JAX's sharded-frame gate of the
    unsharded one (u8 max |diff| <= 2, mean |diff| < 0.05).
    -> the differences."""
    n = len(results)
    for r in results:
        _check(r["band_rows"] == height // n,
               f"rank {r['rank']} holds {r['band_rows']} rows, not "
               f"{height // n}")
        for i, f in enumerate(r["frames"]):
            c = f["collectives"]
            _check(c["all_reduce"] == 1 and c["all_gather"] >= 1,
                   f"rank {r['rank']} frame {i}: collectives {c}")
    lums = [r["luminance"] for r in results]
    _check(len(set(lums)) == 1, f"luminance history differs: {lums}")
    out = dict(luminance=lums[0])
    frame = results[0]["frame"]
    _check(frame.shape[0] == height and np.isfinite(frame).all(),
           f"gathered backbuffer {frame.shape}")
    if "reference" in results[0]:
        diff = np.abs(frame.astype(np.int64)
                      - results[0]["reference"].astype(np.int64))
        out.update(max_diff=int(diff.max()), mean_diff=float(diff.mean()))
        _check(out["max_diff"] <= 2 and out["mean_diff"] < 0.05,
               f"sharded frame vs unsharded: max {out['max_diff']}, mean "
               f"{out['mean_diff']}")
    return out


def check_raster(results: list, setup: TriangleSetup, width: int,
                 height: int, kernel: bool, balanced: bool = True) -> dict:
    """raster_leg's gates: the gathered depth and ids equal the unsharded
    rasterize_binned on `setup` exactly, the band counts sum to < 2x the
    valid total (bands share only the triangles across their seams), no
    band overflows, and with `kernel` (a CUDA run) each rank launched B1
    once.  balanced adds the JAX test's gate for a scene spread evenly
    over the rows (the sphere fields): max <= max(3 * total / n, 64).
    -> counts, total, the unsharded result's covered pixels."""
    from ..ops.raster_binned import rasterize_binned
    n = len(results)
    d_ref, t_ref = rasterize_binned(setup, width, height)
    d_ref, t_ref = d_ref.cpu().numpy(), t_ref.cpu().numpy()
    r0 = results[0]
    _check(np.array_equal(r0["depth"], d_ref),
           f"sharded depth differs at {int((r0['depth'] != d_ref).sum())} "
           "pixels")
    _check(np.array_equal(r0["tri"], t_ref),
           f"sharded ids differ at {int((r0['tri'] != t_ref).sum())} pixels")
    counts = r0["counts"]
    total = int(setup.valid.sum())
    _check(counts.sum() < 2.0 * total, f"counts {counts} total {total}")
    _check(not balanced or counts.max() <= max(3.0 * total / n, 64),
           f"counts {counts} total {total}")
    for k in ("visible_overflow", "huge_overflow", "clamped_entries"):
        _check(not r0["stats"][k].any(), f"band {k} {r0['stats'][k]}")
    if kernel:
        launched = [r["b1_launches"] for r in results]
        _check(launched == [1] * n, f"B1 launches a rank {launched}")
    return dict(counts=counts.tolist(), total=total,
                covered=int((t_ref >= 0).sum()))
