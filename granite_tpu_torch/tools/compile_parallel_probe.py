"""Can two nvcc builds overlap?  (port of tools/compile_parallel_probe.py)

The JAX probe asks whether two Pallas/Mosaic compiles overlap when run
from threads.  The card's version of that question is about nvcc, which
builds the port's kernels at first use (kernels/build.py, one process a
source): build two distinct copies of kernel B5 (n_iters 96 and 97) one
after the other, then two more (98 and 99) from two threads at once,
each thread driving its own nvcc process, and print the serial and the
threaded wall seconds with OVERLAPS when the threaded pair took under
0.75 of the serial pair, else serialized (the JAX probe's rule).  Then
each of the four bodies runs once on the card through the main library's
B5 (the JAX probe only compiles them).

Kernel B5 (csrc/compile_probe.cu) is the probe's body: acc = acc * 1.0001
+ i for i in 0 .. n_iters-1, elementwise over (R, 256) f32, one element
a thread, launched with programmatic dependent launch.  Its wrapper
probe_body launches the main library's instance on a CUDA tensor and
takes the plain PyTorch version probe_body_plain on a CPU tensor.
latency_bound is the floor it is held to: its dependent chain or its
instruction issue, whichever is longer.

Run on the card:
  python -m granite_tpu_torch.tools.compile_parallel_probe
The builds go to build/granite_tpu_torch/compile_probe/ (gitignored),
emptied first, so no build is reused.
"""

from __future__ import annotations

import argparse
import shutil
import threading
import time

import torch

from ..core.device import card_identity, resolve_device
from ..kernels import build as K

# n_iters -> (rows, 256) of the JAX probe's four compiles.
PROBE_SHAPES = {96: (256, 256), 97: (384, 256), 98: (512, 256),
                99: (640, 256)}
SERIAL, THREADED = (96, 97), (98, 99)
OVERLAP_SHARE = 0.75
PROBE_SOURCE = K.CSRC_DIR / "compile_probe.cu"
PROBE_BUILD_DIR = K.BUILD_DIR / "compile_probe"
# Hopper's FP32 pipe: cycles from one FMUL/FADD to an instruction that
# reads its result, and FP32 lanes of an SM (4 schedulers x 32).
FP32_DEPENDENT_CYCLES = 4
FP32_LANES_PER_SM = 128


def probe_body_plain(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5: n_iters rounds of a multiply,
    then an add, each rounded to f32."""
    acc = x
    for i in range(n_iters):
        acc = acc * 1.0001
        acc = acc + float(i)
    return acc


def probe_body(x: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Kernel B5 (replaces tools/compile_parallel_probe.py's body): the
    plain version on a CPU tensor; on a CUDA tensor the main library's
    instance for n_iters (96-99) or a raise."""
    dev = x.device
    if dev.type == "cpu":
        return probe_body_plain(x, n_iters)
    if dev.type != "cuda":
        raise ValueError(f"probe_body: unsupported device {dev}")
    if n_iters not in PROBE_SHAPES:
        raise ValueError(f"probe_body: n_iters {n_iters} not in "
                         f"{sorted(PROBE_SHAPES)}")
    K.check(x, "x", torch.float32, dev)
    out = torch.empty_like(x)
    K.launch("B5", "granite_compile_probe", K.ptr(x), K.ptr(out), x.numel(),
             n_iters)
    return out


def latency_bound(chain: int, numel: int, sms: int,
                  clock_mhz: float) -> dict:
    """B5's latency/issue floor.  `chain`: the dependent FP32
    instructions of one element (the FMUL/FADD count of the kernel's
    SASS, 2 n_iters); chain_ms: chain x FP32_DEPENDENT_CYCLES cycles;
    issue_ms: chain x numel instructions over sms x FP32_LANES_PER_SM
    lanes a cycle; at an SM clock of clock_mhz.  latency_bound_ms is the
    larger.  It holds no launch: a launch's cost depends on what runs
    before it on the stream (programmatic dependent launch hides part of
    it behind the kernel before), so it is reported beside the bound."""
    cycle_ms = 1e-3 / clock_mhz
    chain_ms = chain * FP32_DEPENDENT_CYCLES * cycle_ms
    issue_ms = chain * numel / (sms * FP32_LANES_PER_SM) * cycle_ms
    return dict(latency_bound_ms=max(chain_ms, issue_ms),
                latency_bound_by="chain" if chain_ms >= issue_ms
                else "issue", chain_ms=chain_ms, issue_ms=issue_ms)


def variant_library(n_iters: int):
    """Path of the probe's own build of B5 for n_iters."""
    return PROBE_BUILD_DIR / f"libcompile_probe_{n_iters}.so"


def build_probe_variant(n_iters: int):
    """One nvcc build of compile_probe.cu with -DGRANITE_PROBE_N_ITERS."""
    return K.build_variant(PROBE_SOURCE,
                           {"GRANITE_PROBE_N_ITERS": n_iters},
                           variant_library(n_iters))


def run_probe() -> dict:
    """The serial pair, then the threaded pair; -> their wall seconds
    and the verdict.  A failed build raises (in the thread's case, after
    both threads are joined)."""
    shutil.rmtree(PROBE_BUILD_DIR, ignore_errors=True)
    t0 = time.monotonic()
    for n in SERIAL:
        build_probe_variant(n)
    serial = time.monotonic() - t0

    errors = []

    def build(n):
        try:
            build_probe_variant(n)
        except Exception as e:            # re-raised below, after join
            errors.append(e)

    threads = [threading.Thread(target=build, args=(n,)) for n in THREADED]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    threaded = time.monotonic() - t0
    if errors:
        raise errors[0]
    verdict = "OVERLAPS" if threaded < OVERLAP_SHARE * serial \
        else "serialized"
    return {"serial_s": serial, "threaded_s": threaded, "verdict": verdict}


def run_bodies(device) -> dict:
    """Launch the main library's B5 once for each n_iters of the probe at
    its shape (zeros in) -> n_iters -> out[0, 0] (sum of 0 .. n-1
    scaled by 1.0001^k).  Syncs the device."""
    return {n: float(probe_body(torch.zeros(shape, device=device), n)[0, 0])
            for n, shape in PROBE_SHAPES.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the card the builds are for (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("the compile probe builds CUDA kernels: it needs "
                         "the card")
    print("device:", card_identity(), flush=True)
    # Warm the dispatch path once, as the JAX probe does.
    float((torch.ones((8, 128), device=dev) + 1)[0, 0])
    r = run_probe()
    print(f"serial 2-compile wall: {r['serial_s']:.2f}s", flush=True)
    print(f"threaded 2-compile wall: {r['threaded_s']:.2f}s "
          f"({r['verdict']})", flush=True)
    # the four bodies, run once each through the main library's kernel
    print("bodies out[0, 0]:", run_bodies(dev), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
