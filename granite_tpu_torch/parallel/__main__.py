"""python -m granite_tpu_torch.parallel --ranks N [--device cuda]

The legs of the JAX engine's `dryrun_multichip` on N ranks of one
torch.distributed group (launch.spawn_ranks): one frame of the deferred
graph at 128 x 16N (the JAX dryrun's size) through shard_frame_step, held
against the same frame unsharded; the sharded binned raster on the
24-sphere field at --raster-size (default 1920x1088), held exactly
against the unsharded raster, with the ownership gates; with
--bench-scene also the bench scene's frame at 1920x1080.  --backend
gloo (default: CPU tensors, or ranks sharing a card) or nccl (a card a
rank).  Exits 0 when every gate holds.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..kernels import build as K
from ..app.bench_scene import BENCH_CONFIG
from .dryrun import DRYRUN_CONFIG, check_frame, check_raster, dryrun_rank, \
    setup_arrays, sphere_field_setup
from .launch import spawn_ranks


def _size(text: str) -> tuple[int, int]:
    w, h = text.lower().split("x")
    return int(w), int(h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m granite_tpu_torch.parallel")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--raster-size", type=_size, default=(1920, 1088))
    ap.add_argument("--bench-scene", action="store_true",
                    help="also the bench scene's frame at 1920x1080")
    args = ap.parse_args(argv)
    n = args.ranks
    w, h = 128, 16 * n
    rw, rh = args.raster_size
    device = torch.device(args.device)
    if device.type == "cuda":
        K.build()           # once, before the ranks load it
    setup = sphere_field_setup(rw, rh, device)
    legs = {"frame": ("frame", dict(cfg=DRYRUN_CONFIG, width=w,
                                    height=h)),
            "raster": ("raster", dict(arrays=setup_arrays(setup), width=rw,
                                      height=rh))}
    if args.bench_scene:
        legs["bench"] = ("frame", dict(cfg=BENCH_CONFIG, width=1920,
                                       height=1080, bench_scene=True))
    results = spawn_ranks(n, dryrun_rank, legs,
                          backend=args.backend, device=str(device))
    for leg, height in [("frame", h)] + (
            [("bench", 1080)] if args.bench_scene else []):
        got = check_frame([r[leg] for r in results], height)
        print(f"sharded {leg} leg over {n} ranks ({args.backend}, "
              f"{device.type}): {got}; placement "
              f"{results[0][leg]['placement']}", flush=True)
    got = check_raster([r["raster"] for r in results], setup, rw, rh,
                       kernel=device.type == "cuda")
    print(f"sharded raster {rw}x{rh} over {n} ranks: {got}", flush=True)
    print(f"parallel dryrun over {n} ranks: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
