"""Multi-device framebuffer (port of granite_tpu/parallel/framebuffer_sharding.py).

The JAX engine splits a frame's rows over the devices of a mesh and lets
GSPMD place every array and insert the collectives.  Eager PyTorch has
no GSPMD, so here the placement is stated explicitly.  The ranks of a
torch.distributed process group form the row axis (`TileMesh`); every
rank holds the same scene, params and history, as JAX replicates them.

Placement rule (JAX's `_row_sharded`): a resource with at least 2 dims
whose rows (axis 0) divide by the rank count n is *banded*: a rank holds
rows [r * h / n, (r + 1) * h / n).  Anything else is replicated.  The
rule applies to the outputs of passes that can compute just their band
(`RenderPass.set_row_banded`; they read the band from
`PassContext.rows`), to the carried history and to the backbuffer.
Every other pass runs whole on each rank: a banded input is first
gathered from all ranks (`all_gather`), which is what GSPMD does for an
op it cannot partition.  The frame returns this rank's backbuffer rows
and the history under the same rule (a history resource a whole pass
wrote is cut to the band; read again, it is gathered first).

The deferred bench frame (app/scene_viewer.py, hdrBloom, 1920x1080) on
n = 4 ranks:

| pass | placement | why |
| --- | --- | --- |
| shadow-main | whole | a 2048^2 map of the sun (the static map is cached at set-up) |
| gbuffer | whole | B2 and B3 (kernels over the whole target; B2's 32-row tiles) |
| lighting | whole | B3 and B4 (32-row planes, 64-px light clusters: a 270-row band aligns with neither) |
| bloom-threshold | banded, 135 of 540 rows | its 2:1 reduce reads only its band's rows of the whole `hdr` |
| luminance | reduced | the band's sum and pixel count, one `all_reduce` (the JAX mean's psum) |
| bloom-down0 | whole, after an `all_gather` of `bloom-thresh` | 270 rows do not divide by 4; its filter reads across the band edges |
| bloom-down1..3, bloom-up0..1 | whole | 135..17 rows, whole inputs |
| tonemap + sRGB encode | banded, 270 of 1080 rows | per pixel (the bloom upsample computes its band's rows) |

Per frame: 1 `all_reduce` (4 bytes x 2) and 1 `all_gather` (the
threshold target, 540x960x4 f32).  At a size whose `bloom-d0` rows
divide by n the carried `bloom-d0` history is banded too and bloom-down0
gathers it as well.

Collectives count their calls and host seconds (`TileMesh.counts`,
`TileMesh.seconds`).  Backends: `nccl` when each rank has a card of its
own (NCCL refuses two ranks on one device, so fewer cards than ranks
raise ValueError before any init), `gloo` for CPU tensors or for CUDA
tensors of ranks that share one card; under gloo a CUDA tensor is
copied to the host and back explicitly around each collective (counted
in `counts["host_copies"]`).  The backend is never switched silently.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from ..graph.render_graph import RenderGraphError

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, n: int, device) -> None:
    """Raise unless `backend` can carry `n` ranks' tensors on `device`:
    ValueError for an unknown backend, nccl off CUDA, or nccl with fewer
    cards than ranks; RuntimeError for CUDA without a card."""
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl carries CUDA tensors only: pass "
                             "device='cuda' or use gloo")
        cards = torch.cuda.device_count()
        if cards < n:
            raise ValueError(
                f"nccl needs a card a rank: {n} ranks, {cards} cards "
                "(NCCL refuses two ranks on one device); use gloo for "
                "ranks that share a card")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda asked for, but "
                           "torch.cuda.is_available() is False")


def rank_device(device, backend: str, rank: int) -> torch.device:
    """A rank's device: the CPU, its own card under nccl, or under gloo
    card rank % count (every rank on card 0 of a one-card machine)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    cards = torch.cuda.device_count()
    return torch.device("cuda", rank if backend == "nccl" else rank % cards)


class TileMesh:
    """The ranks of a process group as one row axis ("tile"), with the
    collectives a row-banded frame needs.  Each collective adds one to
    `counts[name]` and its host seconds to `seconds[name]` (under gloo
    these include the staging copies, which synchronize; under nccl only
    the enqueue)."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.counts = {"all_gather": 0, "all_reduce": 0, "gather": 0,
                       "host_copies": 0}
        self.seconds = {"all_gather": 0.0, "all_reduce": 0.0, "gather": 0.0}

    def band(self, rows: int) -> tuple[int, int]:
        """This rank's rows [y0, y1) of a resource with `rows` rows."""
        h = rows // self.size
        return self.rank * h, (self.rank + 1) * h

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend carries: gloo takes CUDA tensors through
        an explicit, counted host copy."""
        t = t.contiguous()
        if self.backend == "gloo" and t.is_cuda:
            self.counts["host_copies"] += 1
            return t.cpu()
        return t

    def _done(self, name: str, t0: float) -> None:
        self.counts[name] += 1
        self.seconds[name] += time.perf_counter() - t0

    def all_gather_rows(self, band: torch.Tensor) -> torch.Tensor:
        """Every rank's band (equal shapes), concatenated in rank order on
        axis 0, on every rank."""
        t0 = time.perf_counter()
        x = self._wire(band)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat(parts).to(band.device)
        self._done("all_gather", t0)
        return out

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of `t` over the ranks, on every rank (the
        same bits on each)."""
        t0 = time.perf_counter()
        x = self._wire(t).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        out = x.to(t.device)
        self._done("all_reduce", t0)
        return out

    def gather_rows_to(self, band: torch.Tensor, dst: int = 0):
        """Every rank's band concatenated in rank order on rank `dst`;
        None on the other ranks."""
        t0 = time.perf_counter()
        x = self._wire(band)
        parts = [torch.empty_like(x) for _ in range(self.size)] \
            if self.rank == dst else None
        dist.gather(x, parts, dst=dst, group=self.group)
        out = torch.cat(parts).to(band.device) if self.rank == dst else None
        self._done("gather", t0)
        return out


def make_tile_mesh(n: int | None = None, group=None, device="cuda",
                   backend: str | None = None) -> TileMesh:
    """A TileMesh over `group` (the default group when None), which must
    be initialised (parallel.launch.spawn_ranks does it).  n, when given,
    must be the group's size; backend, when given, is checked first (see
    check_backend) and must be the group's."""
    device = torch.device(device)
    size = n
    if size is None and dist.is_initialized():
        size = dist.get_world_size(group)
    if backend is not None:
        check_backend(backend, size or 1, device)
    elif device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda asked for, but "
                           "torch.cuda.is_available() is False")
    if not dist.is_initialized():
        raise RuntimeError("make_tile_mesh needs an initialised process "
                           "group (parallel.launch.spawn_ranks, or "
                           "torch.distributed.init_process_group)")
    got = dist.get_backend(group)
    if size != dist.get_world_size(group):
        raise ValueError(f"n={n}, but the group has "
                         f"{dist.get_world_size(group)} ranks")
    if backend is not None and backend != got:
        raise ValueError(f"backend {backend!r}, but the group runs {got!r}")
    rank = dist.get_rank(group)
    return TileMesh(group, rank, size, rank_device(device, got, rank), got)


def row_banded(mesh: TileMesh, shape) -> bool:
    """JAX's `_row_sharded` rule: at least 2 dims and rows divisible by
    the rank count."""
    return len(shape) >= 2 and shape[0] % mesh.size == 0


class _Bands:
    """One frame's placement state: which resources this rank holds as
    bands, and which outputs the running pass must return as bands.  It
    is the `bands` a PassContext reads (rows, all_reduce_sum)."""

    def __init__(self, graph, mesh: TileMesh):
        self.graph = graph
        self.mesh = mesh
        self.held: set = set()
        self.writing: set = set()

    def banded(self, name: str) -> bool:
        return row_banded(self.mesh, self.graph.resource_shape(name))

    def rows(self, name: str):
        if name in self.held or name in self.writing:
            return self.mesh.band(self.graph.resource_shape(name)[0])
        return None

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_sum(t)

    def placed(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A frame output under the rule: its band when banded (cut from
        the whole when a whole pass wrote it), else all of it."""
        if name in self.held or not self.banded(name):
            return t
        y0, y1 = self.mesh.band(t.shape[0])
        return t[y0:y1]


class FrameRunner:
    """runner(params, history) -> (this rank's backbuffer rows,
    new_history) for a baked graph; `placement` maps each pass of the
    last frame to "banded", "whole" or "whole after all_gather of ...".
    """

    def __init__(self, graph, mesh: TileMesh):
        self.graph = graph
        self.mesh = mesh
        self.placement: dict = {}

    def __call__(self, params, history):
        g = self.graph
        if not g._order:
            raise RenderGraphError("graph not baked")
        bands = _Bands(g, self.mesh)
        hist = dict(history)
        # history arrives whole (frame 0) or as the bands a frame returned
        hist_bands = {name for name, t in hist.items()
                      if bands.banded(name)
                      and t.shape[0] != g.resource_shape(name)[0]}
        pool: dict = {}
        placement = {}
        for pname in g._order:
            rp = g._passes[pname]
            gathered = []
            for name in rp.history_inputs:
                if name in hist_bands:
                    hist[name] = self.mesh.all_gather_rows(hist[name])
                    hist_bands.discard(name)
                    gathered.append(f"{name} (history)")
            if rp.row_banded:
                bands.writing = {o for o in rp.outputs if bands.banded(o)}
            else:
                for name in rp.inputs:
                    if name in bands.held:
                        pool[name] = self.mesh.all_gather_rows(pool[name])
                        bands.held.discard(name)
                        gathered.append(name)
            outs = g.run_pass(pname, pool, hist, params, bands=bands)
            for name in rp.outputs:
                if name in bands.writing:
                    y0, y1 = bands.rows(name)
                    if outs[name].shape[0] != y1 - y0:
                        raise RenderGraphError(
                            f"pass '{pname}' returned {outs[name].shape[0]}"
                            f" rows of '{name}', its band is {y1 - y0}")
                    bands.held.add(name)
                else:
                    bands.held.discard(name)
            placement[pname] = "banded" if bands.writing else (
                "reduced" if rp.row_banded and any(
                    bands.rows(i) is not None for i in rp.inputs)
                else "whole")
            if gathered:
                placement[pname] += " after all_gather of " + \
                    ", ".join(gathered)
            bands.writing = set()
        self.placement = placement
        back = bands.placed(g._backbuffer, pool[g._backbuffer])
        new_history = {name: bands.placed(name, pool[name])
                       for name in g._history_resources}
        return back, new_history


def shard_frame_step(graph, mesh: TileMesh) -> FrameRunner:
    """The baked graph's frame with the rows banded over the mesh's
    ranks (see the module docstring).  Params are the same on every
    rank.  -> runner(params, history) -> (this rank's backbuffer rows,
    new_history)."""
    return FrameRunner(graph, mesh)
