"""RenderGraph — declarative pass DAG, baked and executed eagerly (port of
granite_tpu/graph/render_graph.py; reference renderer/render_graph).

Passes declare typed outputs and inputs by name; bake() walks back from
the backbuffer, drops dead passes and fixes a deterministic topological
order; execute() runs the passes in that order on the current stream
and carries history resources (inputs read from LAST frame) to the next
frame.  No tracing or compilation: PyTorch runs eagerly, and CUDA graphs
are left to a later change.

A pass that can compute just a band of its output rows declares so with
`set_row_banded()` and reads its row window from `PassContext.rows`:
parallel/framebuffer_sharding.py's runner then hands it the rows one
rank owns.  Run whole (`execute`), every window is None.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..utils.logging import LOGI
from ..utils.timeline_trace import span


class RenderGraphError(RuntimeError):
    pass


class SizeClass(enum.Enum):
    ABSOLUTE = 0
    SWAPCHAIN_RELATIVE = 1


class Queue(enum.IntFlag):
    """Kept as metadata for logs (one CUDA stream executes every pass)."""
    GRAPHICS = 1
    COMPUTE = 2
    ASYNC_COMPUTE = 4


@dataclass
class AttachmentInfo:
    size_class: SizeClass = SizeClass.SWAPCHAIN_RELATIVE
    size_x: float = 1.0
    size_y: float = 1.0
    channels: int = 4
    dtype: Any = torch.float32
    layers: int = 1

    def resolve_hw(self, sw_w: int, sw_h: int) -> tuple[int, int]:
        if self.size_class == SizeClass.SWAPCHAIN_RELATIVE:
            return (max(int(self.size_y * sw_h), 1),
                    max(int(self.size_x * sw_w), 1))
        return int(self.size_y), int(self.size_x)

    def shape(self, sw_w: int, sw_h: int) -> tuple:
        h, w = self.resolve_hw(sw_w, sw_h)
        s = (h, w, self.channels) if self.channels > 1 else (h, w)
        return (self.layers,) + s if self.layers > 1 else s


@dataclass
class BufferInfo:
    shape: tuple = ()
    dtype: Any = torch.float32


@dataclass
class _Resource:
    name: str
    info: Any = None
    writer: Optional[str] = None
    readers: list = field(default_factory=list)
    history_readers: list = field(default_factory=list)
    is_external: bool = False


class RenderPass:
    def __init__(self, graph: "RenderGraph", name: str, queue: Queue):
        self.graph = graph
        self.name = name
        self.queue = queue
        self.outputs: list[str] = []
        self.inputs: list[str] = []
        self.history_inputs: list[str] = []
        self._execute: Optional[Callable] = None
        self.row_banded = False

    def add_color_output(self, name: str,
                         info: Optional[AttachmentInfo] = None
                         ) -> "RenderPass":
        self.graph._declare(name, info or AttachmentInfo(), self.name)
        self.outputs.append(name)
        return self

    def add_depth_stencil_output(self, name: str,
                                 info: Optional[AttachmentInfo] = None
                                 ) -> "RenderPass":
        return self.add_color_output(name, info or AttachmentInfo(channels=1))

    def add_storage_output(self, name: str,
                           info: Optional[BufferInfo] = None
                           ) -> "RenderPass":
        self.graph._declare(name, info or BufferInfo(), self.name)
        self.outputs.append(name)
        return self

    def add_texture_input(self, name: str) -> "RenderPass":
        self.graph._read(name, self.name)
        self.inputs.append(name)
        return self

    add_attachment_input = add_texture_input

    def add_history_input(self, name: str) -> "RenderPass":
        """Read LAST frame's version of `name`."""
        self.graph._resource(name).history_readers.append(self.name)
        self.history_inputs.append(name)
        return self

    def add_external_input(self, name: str) -> "RenderPass":
        """Read params['external'][name]."""
        self.graph._resource(name).is_external = True
        return self.add_texture_input(name)

    def set_execute(self, fn: Callable) -> "RenderPass":
        """fn(ctx: PassContext) -> {output_name: tensor}."""
        self._execute = fn
        return self

    def set_row_banded(self) -> "RenderPass":
        """Declare that the execute fn honours `ctx.rows`: for each output
        with a row window it returns only those rows, and it accepts an
        input held as a band (`ctx.rows(input)` not None)."""
        self.row_banded = True
        return self


class PassContext:
    """What a pass's execute fn sees.  `bands` is the row-banded runner's
    frame state (parallel/framebuffer_sharding.py: rows,
    all_reduce_sum), None when the graph runs whole."""

    def __init__(self, graph: "RenderGraph", rp: RenderPass, pool: dict,
                 history: dict, params: Any, bands=None):
        self._graph = graph
        self._rp = rp
        self._pool = pool
        self._history = history
        self.params = params
        self._bands = bands

    def input(self, name: str):
        if name not in self._rp.inputs:
            raise RenderGraphError(
                f"pass '{self._rp.name}' reads undeclared input '{name}'")
        if name in self._pool:
            return self._pool[name]
        if self._graph._resources[name].is_external:
            return self.params["external"][name]
        raise RenderGraphError(f"input '{name}' not yet produced")

    def history(self, name: str):
        if name not in self._rp.history_inputs:
            raise RenderGraphError(
                f"pass '{self._rp.name}' reads undeclared history '{name}'")
        return self._history[name]

    def size(self, name: str) -> tuple[int, int]:
        return self._graph._resources[name].info.resolve_hw(
            self._graph._sw_w, self._graph._sw_h)

    def backbuffer_size(self) -> tuple[int, int]:
        return self._graph._sw_h, self._graph._sw_w

    def rows(self, name: str):
        """(y0, y1): the rows of resource `name` that this rank holds (an
        input) or must return (an output of a `set_row_banded` pass) when
        the frame runs row-banded; None when the pass sees or writes all
        of it."""
        return None if self._bands is None else self._bands.rows(name)

    def mean(self, name: str, values):
        """The mean of `values` (one value a pixel of what this rank holds
        of resource `name`) over the whole resource: `.mean()` when the
        rank holds all of it, else the band's sum and pixel count summed
        over the ranks by one all_reduce."""
        if self.rows(name) is None:
            return values.mean()
        total = self._bands.all_reduce_sum(torch.stack(
            [values.sum(), values.new_tensor(float(values.numel()))]))
        return total[0] / total[1]


class RenderGraph:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._passes: dict[str, RenderPass] = {}
        self._resources: dict[str, _Resource] = {}
        self._backbuffer: Optional[str] = None
        self._sw_w = 0
        self._sw_h = 0
        self._order: list[str] = []
        self._history_resources: list[str] = []

    def add_pass(self, name: str, queue: Queue = Queue.GRAPHICS
                 ) -> RenderPass:
        if name in self._passes:
            raise RenderGraphError(f"duplicate pass '{name}'")
        rp = RenderPass(self, name, queue)
        self._passes[name] = rp
        return rp

    def set_backbuffer_source(self, name: str) -> None:
        self._backbuffer = name

    def set_backbuffer_dimensions(self, width: int, height: int) -> None:
        self._sw_w = width
        self._sw_h = height

    def _resource(self, name: str) -> _Resource:
        if name not in self._resources:
            self._resources[name] = _Resource(name)
        return self._resources[name]

    def _declare(self, name: str, info, writer: str) -> None:
        res = self._resource(name)
        if res.writer is not None and res.writer != writer:
            raise RenderGraphError(
                f"resource '{name}' written by both '{res.writer}' and "
                f"'{writer}'")
        res.writer = writer
        res.info = res.info or info

    def _read(self, name: str, reader: str) -> None:
        self._resource(name).readers.append(reader)

    def bake(self) -> None:
        """Validate, walk back from the backbuffer (dead passes dropped),
        topological order in declaration order among ready passes."""
        if self._backbuffer is None:
            raise RenderGraphError("no backbuffer source set")
        bb = self._resources.get(self._backbuffer)
        if bb is None or bb.writer is None:
            raise RenderGraphError(
                f"backbuffer '{self._backbuffer}' has no writer")
        for res in self._resources.values():
            if (res.readers or res.history_readers) and res.writer is None \
                    and not res.is_external:
                raise RenderGraphError(
                    f"resource '{res.name}' is read but never written")
        for rp in self._passes.values():
            if rp._execute is None:
                raise RenderGraphError(f"pass '{rp.name}' has no execute fn")

        alive: set[str] = set()
        stack = [bb.writer]
        while stack:
            pname = stack.pop()
            if pname in alive:
                continue
            alive.add(pname)
            rp = self._passes[pname]
            for r in rp.inputs + rp.history_inputs:
                res = self._resources[r]
                if res.writer is not None and not res.is_external:
                    stack.append(res.writer)

        declared = list(self._passes)
        indeg = {p: 0 for p in alive}
        edges: dict[str, list[str]] = {p: [] for p in alive}
        for pname in alive:
            for r in self._passes[pname].inputs:
                res = self._resources[r]
                if res.writer in alive and res.writer != pname \
                        and not res.is_external:
                    edges[res.writer].append(pname)
                    indeg[pname] += 1
        ready = [p for p in declared if p in alive and indeg[p] == 0]
        order: list[str] = []
        while ready:
            p = ready.pop(0)
            order.append(p)
            for q in edges[p]:
                indeg[q] -= 1
                if indeg[q] == 0:
                    ready.append(q)
                    ready.sort(key=declared.index)
        if len(order) != len(alive):
            raise RenderGraphError("cycle detected in pass graph")
        self._order = order
        self._history_resources = [
            r.name for r in self._resources.values()
            if any(p in alive for p in r.history_readers)]

    def resource_shape(self, name: str) -> tuple:
        """The whole shape of resource `name` at the current size."""
        info = self._resources[name].info
        return info.shape(self._sw_w, self._sw_h) \
            if isinstance(info, AttachmentInfo) else tuple(info.shape)

    def initial_history(self, device) -> dict:
        """Zero-cleared history resources for frame 0."""
        return {name: torch.zeros(self.resource_shape(name),
                                  dtype=self._resources[name].info.dtype,
                                  device=device)
                for name in self._history_resources}

    def run_pass(self, pname: str, pool: dict, history, params,
                 bands=None) -> dict:
        """Run pass `pname`, cast its outputs to their targets' types and
        add them to `pool`; -> those outputs.  bands: see PassContext."""
        rp = self._passes[pname]
        # A named span per pass: torch.profiler attributes host and
        # device time to it (nothing is opened when tracing is off).
        with span(f"pass:{pname}"):
            outs = rp._execute(PassContext(self, rp, pool, history, params,
                                           bands))
        if set(outs) != set(rp.outputs):
            raise RenderGraphError(
                f"pass '{pname}' returned {sorted(outs)}, declared "
                f"{sorted(rp.outputs)}")
        for name, val in outs.items():
            want = self._resources[name].info.dtype
            if val.dtype != want:
                outs[name] = val.to(want)
        pool.update(outs)
        return outs

    def execute(self, params, history):
        """Run one baked frame eagerly -> (backbuffer, new_history)."""
        if not self._order:
            raise RenderGraphError("graph not baked")
        pool: dict[str, Any] = {}
        for pname in self._order:
            self.run_pass(pname, pool, history, params)
        new_history = {n: pool[n] for n in self._history_resources}
        return pool[self._backbuffer], new_history

    def execute_chain(self, static_params, banks, history):
        """Run one frame per entry of `banks`, each with {**static_params,
        **bank} and the history carried -> (last backbuffer, final history,
        checksum).  banks: the per-frame params as a list, or an iterable
        that makes each frame's just before it runs (the viewer's
        time-varying chain builds a frame's params from the pose at its
        time).  JAX's execute_chain takes banks stacked on a leading axis
        of n instead; eager frames need no stacking.

        checksum: the float32 sum of every backbuffer but the last,
        accumulated on the device with no host read between frames (0 for
        a single frame), as in JAX, whose checksum keeps XLA from dropping
        the scanned frames' history-free passes.  Here it is a whole-run
        integrity probe: a NaN in any frame shows in it."""
        out = checksum = None
        for bank in banks:
            if out is not None:
                checksum = checksum + out.to(torch.float32).sum()
            out, history = self.execute({**static_params, **bank}, history)
            if checksum is None:
                checksum = torch.zeros((), dtype=torch.float32,
                                       device=out.device)
        if out is None:
            raise RenderGraphError("execute_chain needs at least one frame")
        return out, history, checksum

    def log(self) -> None:
        LOGI("RenderGraph: %d passes baked (backbuffer='%s', %dx%d)",
             len(self._order), self._backbuffer, self._sw_w, self._sw_h)
        for i, pname in enumerate(self._order):
            rp = self._passes[pname]
            LOGI("  [%02d] %-24s q=%-14s in=%s hist=%s out=%s", i, pname,
                 rp.queue.name, rp.inputs, rp.history_inputs, rp.outputs)
