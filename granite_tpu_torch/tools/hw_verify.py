"""Hardware image verification gate (port of tools/hw_verify.py): render
the bench config at bench resolution on --device (default cuda), write
the PNG, and assert on the rgb planes (a black RGBA frame has mean
63.75 because of alpha: the planes are the only honest signal).

Checks:
  1. per-plane (r, g, b) means are inside (2, 250) (not black, not
     blown out);
  2. black-tile census: at most 1% of the 32x128 screen tiles may have
     rgb content that is entirely zero;
  3. the chain ran every frame: its checksum (the float32 sum of every
     chained frame's backbuffer but the last) is present, finite and
     within 0.5-1.5x of (frames - 1) times the last frame's sum, as in
     the JAX tool; and render_frames_chained(n) executed the render graph
     n times, and on the card kernel B2 (the G-buffer raster) launched n
     times in it;
  4. sequential frame N and chained frame N agree exactly from the same
     initial history (the chain is the timed path: it must render the
     same image).

Reference analogue: application_headless.cpp:440-461 PNG dump +
tools/image_compare.cpp gates, run as a deploy gate.

  python -m granite_tpu_torch.tools.hw_verify [--width 1920 --height 1080]
      [--frames 4] [--out dir] [--config config.json] [--device cuda]
Writes bench_frame.png and hw_verify.json into --out and prints the
report; exit 0 = gate passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import types

import numpy as np

BENCH_CONFIG = {"renderer": "deferred", "hdrBloom": True,
                "shadowMapResolution": 2048}


def chained_counts(app, frames: int):
    """render_frames_chained(1/60, 1/60, frames) with the render graph's
    execute calls and B2's launches counted -> (last frame (H, W, 4)
    uint8 on the host, executes, B2 launches)."""
    from ..kernels import build as K
    execute = app.graph.execute
    calls = [0]

    def counted(params, history):
        calls[0] += 1
        return execute(params, history)

    app.graph.execute = counted
    b2 = K.LAUNCHES["B2"]
    try:
        out = app.render_frames_chained(1 / 60, 1 / 60, frames)
        out = out.cpu().numpy()
    finally:
        del app.graph.execute
    return out, calls[0], K.LAUNCHES["B2"] - b2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "hw_verify"))
    ap.add_argument("--config", default=None,
                    help="config.json (default: the bench config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from ..app.scene_viewer import SceneViewerApplication
    from ..utils.image_io import save_png

    cfg_path = args.config
    if cfg_path is None:
        cfg_path = os.path.join(args.out, "bench_config.json")
        with open(cfg_path, "w") as f:
            json.dump(BENCH_CONFIG, f)

    app = SceneViewerApplication(types.SimpleNamespace(
        scene=None, config=cfg_path, camera_index=-1, bench_scene=True),
        device=args.device)
    app.swapchain_updated(args.width, args.height)

    failures = []

    # Like-for-like: N sequential frames vs N chained frames, both from
    # freshly-cleared history (exposure adaptation otherwise makes frame
    # 1 differ from frame N by construction).  The first sequential
    # frame also builds the static shadow map and the params the chain
    # reuses.
    seq = None
    for _ in range(args.frames):
        seq = app.render_frame(1 / 60, 0.0)
    seq = seq.cpu().numpy()
    app.reset_history()
    chained, executes, b2 = chained_counts(app, args.frames)
    chk = app._last_chain_checksum
    chk = float(chk) if chk is not None else None
    on_card = app.device.type == "cuda"

    png = os.path.join(args.out, "bench_frame.png")
    save_png(png, chained)

    rgb = chained[..., :3].astype(np.float64)
    means = rgb.reshape(-1, 3).mean(axis=0)
    # 1. plane means: the bench scene is a lit interior; anything below
    # 2/255 per plane means a black or near-black frame, anything above
    # 250 a blown-out one.
    for c, m in zip("rgb", means):
        if not (2.0 < m < 250.0):
            failures.append(f"plane {c} mean {m:.2f} outside (2, 250)")

    # 2. black-tile census (32x128 tiles, the sampler/raster tile size)
    H, W = rgb.shape[:2]
    th, tw = 32, 128
    ph, pw = -(-H // th) * th, -(-W // tw) * tw
    padded = np.zeros((ph, pw, 3))
    padded[:H, :W] = rgb
    tiles = padded.reshape(ph // th, th, pw // tw, tw, 3)
    tile_max = tiles.max(axis=(1, 3, 4))
    n_black = int((tile_max == 0).sum())
    n_tiles = tile_max.size
    if n_black > 0.01 * n_tiles:
        failures.append(f"{n_black}/{n_tiles} screen tiles are all-black "
                        f"(zeroed/NaN-clamped sampler rects?)")

    # 3. the chain ran every frame
    if chk is None:
        failures.append("no chain checksum (the chain ran frame by frame?)")
    elif not np.isfinite(chk):
        failures.append(f"chain checksum not finite: {chk}")
    else:
        # the frames are static: every chained frame sums like the last
        # (the exposure history converges fast)
        per_frame = chained.astype(np.float64).sum()
        n_summed = args.frames - 1
        if n_summed and not (0.5 * n_summed * per_frame <= chk
                             <= 1.5 * n_summed * per_frame):
            failures.append(
                f"checksum {chk:.3e} vs ~{n_summed}x frame sum "
                f"{n_summed * per_frame:.3e}: the chained frames diverge")
    if executes != args.frames:
        failures.append(f"the chain executed the render graph {executes} "
                        f"times for {args.frames} frames")
    if on_card and b2 != args.frames:
        failures.append(f"kernel B2 launched {b2} times in a chain of "
                        f"{args.frames} frames")

    # 4. sequential frame N == chained frame N (static scene, same
    # initial history)
    if not np.array_equal(seq, chained):
        diff = int((seq != chained).sum())
        failures.append(f"sequential final frame != chained final frame "
                        f"({diff} bytes differ)")

    report = {
        "width": args.width, "height": args.height,
        "device": str(app.device),
        "plane_means": [round(float(m), 3) for m in means],
        "black_tiles": n_black, "total_tiles": n_tiles,
        "chain_checksum": chk,
        "chain_frames": args.frames,
        "chain_graph_executes": executes,
        "chain_b2_launches": b2 if on_card else None,
        "png": png,
        "ok": not failures,
        "failures": failures,
    }
    with open(os.path.join(args.out, "hw_verify.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
