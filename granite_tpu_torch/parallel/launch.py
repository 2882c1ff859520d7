"""Start the ranks of a row-banded run (no JAX counterpart: a JAX mesh
lives in one process).

`spawn_ranks(n, fn, *args, backend=, device=)` starts n processes with
the `spawn` start method (never `fork`: the caller may run threads,
jax's among them in a test process), joins them into one
torch.distributed group through a file store in a fresh directory (a
file cannot clash with another run's port), builds each rank's TileMesh
and calls fn(mesh, *args) with one torch thread a rank.  It returns
every rank's result in rank order (pickled through files, so numpy
arrays and plain objects; move tensors to the host first).  An exception
in any rank is raised again in the caller with that rank's traceback; a
rank that dies, or a run past `timeout`, fails the call too, and the
other ranks are then terminated (they would wait in a collective).

fn must be importable by the new processes (a module-level function of
an importable module, or of the main script run as a file).  Build the
CUDA kernels in the caller before spawning: `kernels.build.build()` then
runs once, and ranks only load the library (the build also holds a file
lock).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait

from .framebuffer_sharding import check_backend


class RankFailure(RuntimeError):
    """A rank of spawn_ranks raised or died."""


def _rank_main(rank: int, n: int, backend: str, device: str, store: str,
               out_dir: str, timeout_s: float, fn, args) -> None:
    import torch
    import torch.distributed as dist
    from .framebuffer_sharding import make_tile_mesh, rank_device
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        dev = rank_device(device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=n,
                                timeout=timedelta(seconds=timeout_s))
        try:
            result = fn(make_tile_mesh(n, device=dev, backend=backend),
                        *args)
        finally:
            dist.destroy_process_group()
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(path + ".tmp", path + ".pkl")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def _failure(rank: int, out_dir: str, exitcode) -> str | None:
    err = os.path.join(out_dir, f"rank{rank}.err")
    if os.path.exists(err):
        with open(err) as f:
            return f"rank {rank} raised:\n{f.read()}"
    if exitcode not in (0, None):
        return f"rank {rank} died with exit code {exitcode}"
    return None


def spawn_ranks(n: int, fn, *args, backend: str = "gloo",
                device: str = "cuda", tmpdir: str | None = None,
                timeout: float = 600.0) -> list:
    """Run fn(mesh, *args) on n ranks; -> their results in rank order.
    Raises ValueError / RuntimeError (check_backend) before starting any
    process, RankFailure when a rank raises, dies or outlasts timeout
    seconds."""
    check_backend(backend, n, device)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="granite_ranks_",
                                     dir=tmpdir) as out_dir:
        store = os.path.join(out_dir, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n, backend, str(device), store,
                                   out_dir, timeout, fn, args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failure = None
        try:
            live = list(procs)
            while live and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = f"the ranks outlasted {timeout} s"
                    break
                for s in wait([p.sentinel for p in live], timeout=left):
                    p = next(q for q in live if q.sentinel == s)
                    p.join()
                    live.remove(p)
                    failure = failure or _failure(
                        procs.index(p), out_dir, p.exitcode)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        if failure is not None:
            raise RankFailure(failure)
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
