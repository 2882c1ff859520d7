#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process:

    python3 benchmark/control.py --workload deferred_hdr.orbit_2160p \
        --sound 12 --control 3 --seconds 2 --out bench_out/control.json

  sound    runs of the viewer as the configuration states (a short window
           each, a seed each): the lower readings
  bf16     the plain reference at bfloat16 stage outputs put in the
           viewer's place: the control (the step below float32)
  fp16     the viewer with its own half-precision path on
           (renderTargetFp16: the HDR targets and the bloom chain in
           float16), read beside the control
Each prints one JSON line; the last line holds each number's largest
sound reading and smallest control reading.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--out", default=os.path.join(ROOT, "bench_out",
                                                  "control.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    from gbench.cell import compare, run_cell
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg_file = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, cfg_file["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)
    fp16 = json.loads(json.dumps(config))
    fp16["viewer"]["renderTargetFp16"] = True
    refs: dict = {}
    rows = []

    def quiet(*a):
        pass

    def one(kind, seed, cfg, control=False):
        res = run_cell(cfg, traffic, seed, args.seconds, False, "cuda",
                       log=quiet)
        out = compare(res, config, "cuda", control=control,
                      log=quiet, refs=refs)
        row = {"kind": kind, "seed": seed, "frames": res["frames"],
               "numbers": out["numbers"],
               "counters": {f: d["counters"]
                            for f, d in out["detail"].items()},
               "errors": {f: d["errors"] for f, d in out["detail"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "rows": rows}, f)

    seeds = [args.first_seed + 7919 * k for k in range(args.sound)]
    for s in seeds:
        one("sound", s, config)
    for s in seeds[:args.control]:
        one("fp16", s, fp16)
        one("bf16", s, config, control=True)
    summary = {}
    for k in config["limits"]:
        sound = [r["numbers"][k] for r in rows if r["kind"] == "sound"]
        summary[k] = {"lower": max(sound),
                      "fp16": min(r["numbers"][k] for r in rows
                                  if r["kind"] == "fp16"),
                      "bf16": min(r["numbers"][k] for r in rows
                                  if r["kind"] == "bf16"),
                      "limit": config["limits"][k]}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "rows": rows,
                   "summary": summary}, f)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
