#!/usr/bin/env python3
"""One run of one benchmark cell of granite_tpu_torch on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json's `workloads`)
names a configuration (benchmark/configs/<config>.json) and a traffic mix
(benchmark/traffic/<traffic>.json); each per-layer metric is read by
benchmark/metrics/<metric>.py.  The last line of standard output is one
JSON object (correct, attempted, failed, metrics, device[, breakdown]);
--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
ones.  Each run writes the pose list, the judged frames' numbers and
raster counters and the kernel launches to
bench_out/<workload>.<seed>.<trace>.json.  Exits 2 with no result when
the configuration's reference does not model one of its viewer knobs (or
the reference or a judged map is not known), before the card is looked
for; 3 without a card; non-zero with no result when jax, jaxlib, flax or
granite_tpu is loaded.
"""

import os
import sys
import time

T0 = time.perf_counter()

# One process with one math thread and a fixed string hash, so that runs
# of one cell do the same host work in the same order and no idle worker
# thread spins beside the frame loop: the process starts again under
# PYTHONHASHSEED=0 (the same process, so set-up still counts from its
# start), and the math libraries run on the calling thread.
if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.execv(sys.executable, [sys.executable] + sys.argv)
HOST_THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(HOST_THREADS)
os.environ["OMP_WAIT_POLICY"] = "PASSIVE"

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "granite_tpu")


def eprint(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _unique(pairs) -> dict:
    keys = [k for k, _v in pairs]
    if len(set(keys)) != len(keys):
        raise ValueError(f"a key given twice in {keys}")
    return dict(pairs)


def load_json(*parts) -> dict:
    """A JSON file of the benchmark; a key given twice is refused (the
    later one would silently win)."""
    with open(os.path.join(*parts)) as f:
        return json.load(f, object_pairs_hook=_unique)


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        eprint(f"unknown workload {args.workload!r}")
        return 2
    cell = cells[args.workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT, cfg_entry["file"])
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")

    # Every build and kernel cache of the program inside the checkout.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    os.environ["USE_FLAX"] = "0"
    import torch
    torch.set_num_threads(HOST_THREADS)
    sys.path.insert(0, HERE)
    sys.path.insert(0, ROOT)
    from gbench.cell import ConfigError, reference_for
    try:
        reference_for(config)
    except ConfigError as e:
        eprint(f"{cell['config']} ({cfg_entry['file']}): {e}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        eprint(f"{args.workload} needs {cell['chips']} CUDA card(s); "
               f"available: {torch.cuda.is_available()}, "
               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    from gbench import timing
    from gbench.cell import compare, run_cell
    from gbench.roofline import b2_frame_bound, b4_bound

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = run_cell(config, traffic, args.seed, args.seconds,
                   bool(args.trace), "cuda", T0, log=eprint)
    cmp_ = compare(res, config, "cuda", log=eprint)
    ref = cmp_.pop("ref")
    limits = config["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in cmp_["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and set(checks) == set(limits)
    failed = sum(1 for d in cmp_["detail"].values()
                 if any(d["numbers"][k] > limits[k] for k in d["numbers"]))

    done = res["done_ms"]
    res["intervals_ms"] = timing.intervals_ms(done)
    res["latencies_ms"] = timing.latencies_ms(done, res["call_s"])
    e2e = {"frame_ms": timing.frame_ms(done),
           "frame_interval_p95_ms": timing.p95(res["intervals_ms"]),
           "frame_latency_p95_ms": timing.p95(res["latencies_ms"]),
           "setup_s": res["setup_s"]}
    metrics: dict = {}
    if args.trace:
        # what a per-layer reader may read besides the run's readings
        res["ref"], res["config"] = ref, config
        pos, rot = res["poses"]["positions"], res["poses"]["rotations"]
        mv = config["viewer"].get("rasterMaxVisible", 0)
        res["b2_bound_ms"] = [
            b2_frame_bound(ref, pos[i], rot[i], mv)["bound_ms"]
            for i in res["trace_poses"]]
        # the viewer's light table: 8 rows a block of 8 lights, up to 32
        rows = min(32, max(8, -(-ref.n_lights // 8) * 8)) \
            if ref.n_lights else 0
        res["b4_bound_ms"] = b4_bound(res["width"], res["height"],
                                      ref.k_shadow, rows)["bound_ms"]
        for m in bench["per_layer"]:
            if listed(m, args.workload):
                v = reader(m["name"])(res)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if listed(m, args.workload):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    os.makedirs(os.path.join(ROOT, "bench_out"), exist_ok=True)
    with open(os.path.join(ROOT, "bench_out", f"{args.workload}."
                           f"{args.seed}.{args.trace}.json"), "w") as f:
        json.dump({"workload": args.workload, "seed": args.seed,
                   "frames": res["frames"], "end_to_end": e2e,
                   "launches": res["launches"], "poses": res["poses"],
                   "done_ms": res["done_ms"],
                   "render_call_ms": res["render_call_ms"],
                   "render_cpu_ms": res["render_cpu_ms"],
                   "host": res["host"], "window_s": res["window_s"],
                   "checks": checks, "judged": cmp_["detail"],
                   "metrics": metrics}, f)
    bad = forbidden_modules()
    if bad:
        eprint(f"modules that must not load on the card path: {bad}")
        return 4
    props = torch.cuda.get_device_properties(0)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": res["memory_peak_bytes"],
              "memory_total_bytes": int(props.total_memory)}
    out = {"correct": bool(correct), "attempted": len(cmp_["detail"]),
           "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        tr = res["trace"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": [list(x) for x in
                                           tr["device_ops"]],
                            "idle_gaps": [list(x) for x in tr["idle_gaps"]]}
    for k, c in checks.items():
        eprint(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
