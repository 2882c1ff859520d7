"""Device probe, numeric policy and the frame ring (counterpart of
granite_tpu/core/device.py; reference vulkan/context.hpp:249 Context and
vulkan/device.hpp:167 Device).

TF32 is switched off for float32 matmuls and cuDNN: vertex transforms
run through matmuls (renderer/scene_renderer.transform_vertices) and
TF32 keeps about three decimal digits, which moves triangle edges and
breaks parity with the JAX reference.

The frame ring: `Device` holds `frames_in_flight` FrameContexts.  The
headless runner tracks each timed frame's output in the current context
(one CUDA event on the stream the frame ran on) and moves the ring on;
`next_frame_context` then waits for the frame `frames_in_flight` back
and nothing newer (Device::next_frame_context, device.cpp:2669-2704), so
the host never queues more than that many frames ahead of the card.

Staging: on a card each FrameContext holds a StagingArena, pinned host
memory that utils/timeline_trace.upload copies the frame's host data
through (a copy without blocking, where a pageable copy would drain the
stream).  The ring's move records an event after the copies staged in
the slot it leaves, and the slot's arena is rewritten only after
begin() has waited on its events, so nothing is overwritten before its
copy has run.

Nothing here falls back: asking for `cuda` without a usable card raises,
and a fault while waiting on a frame surfaces where it happens.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np
import torch

from ..utils.environment import get_environment_int
from ..utils.logging import LOGI
from ..utils.timeline_trace import span, stage_through
from .stats import TimestampIntervalStats

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """'cuda' / 'cpu' / torch.device -> torch.device; raises when CUDA is
    requested but absent (no silent CPU continuation)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def nvcc_path() -> str | None:
    """Path of the CUDA compiler (PATH first, then CUDA_HOME and the
    toolkit's default prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def card_identity() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output (one line per
    card); raises when nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def describe() -> dict:
    """Versions and toolchain for logs and the smoke script."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc_path(),
            "cuda_available": torch.cuda.is_available()}
    if info["cuda_available"]:
        info["device_name"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
    return info


class Backend:
    """Device query (the Context analogue, context.hpp:249) for one
    torch device.  Not ported, being XLA's and the TPU's:
    ContextCreationFlags (prefer_tpu, enable_x64) and XLA's persistent
    compilation cache with GRANITE_DISABLE_PIPELINE_CACHE; the port's
    counterpart of that cache is kernels/build.py's content-hashed build
    directory."""

    def __init__(self, device="cuda"):
        self.default_device = resolve_device(device)
        if self.default_device.type == "cuda":
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
            self.platform = "gpu"
            self.device_kind = torch.cuda.get_device_name(
                self.default_device)
        else:
            self.devices = [self.default_device]
            self.platform = "cpu"
            self.device_kind = "cpu"
        self.num_devices = len(self.devices)

    def gpu_name(self) -> str:
        """The stat JSON's `gpu` field: the card's name, or "cpu"."""
        return self.device_kind

    def memory_stats(self) -> dict:
        """torch.cuda.memory_stats of the card ({} on the CPU)."""
        if self.platform == "gpu":
            return torch.cuda.memory_stats(self.default_device)
        return {}


# torch dtypes whose host bytes numpy holds as they are, and numpy's
# name for each
_NUMPY_DTYPES = {t: np.dtype(n) for t, n in (
    (torch.bool, "bool"), (torch.uint8, "uint8"), (torch.int8, "int8"),
    (torch.int16, "int16"), (torch.int32, "int32"), (torch.int64, "int64"),
    (torch.float16, "float16"), (torch.float32, "float32"),
    (torch.float64, "float64"), (torch.complex64, "complex64"),
    (torch.complex128, "complex128"))}
_FROM_NUMPY = set(_NUMPY_DTYPES.values())


class StagingArena:
    """Pinned host bytes that a frame's uploads are staged through: each
    copy takes the next ALIGN-aligned block, is written on the host and
    copied to a fresh tensor on `device` without blocking.  One stream an
    epoch (between resets): the one current at its first copy, which the
    slot's fence is recorded on.  Used by the frame path's one thread."""

    ALIGN = 64
    BYTES = 256 * 1024

    def __init__(self, device: torch.device, buf: torch.Tensor | None = None):
        """buf: the uint8 host bytes (default: BYTES pinned ones)."""
        self.device = device
        self.buf = buf if buf is not None else torch.empty(
            self.BYTES, dtype=torch.uint8, pin_memory=True)
        self.bytes = self.buf.numpy()
        self.offset = 0
        self.stream = None      # the epoch's stream, once a copy is staged
        self.unfenced = False   # copies staged since the last fence

    def stage(self, a, dtype=None) -> torch.Tensor | None:
        """torch.as_tensor(a, dtype) on the device, or None where that is
        not host data numpy can hold, the rest of the arena is too small or
        the current stream is not the epoch's (the caller then copies it
        itself).  A numpy array of the dtype asked for is written into the
        block as it is (a third cheaper on the card's host than going
        through torch.as_tensor first, which anything else does)."""
        if not isinstance(a, np.ndarray) or a.dtype not in _FROM_NUMPY \
                or (dtype is not None and _NUMPY_DTYPES.get(dtype) != a.dtype):
            h = torch.as_tensor(a, dtype=dtype)
            if h.device.type != "cpu" or h.dtype not in _NUMPY_DTYPES:
                return None
            a = h.numpy()
        start = self.offset
        end = start + a.nbytes
        if end > len(self.bytes):
            return None
        if self.device.type == "cuda":
            raw = torch._C._cuda_getCurrentRawStream(self.device.index)
            if self.stream is None:
                self.stream = torch.cuda.current_stream(self.device)
            elif raw != self.stream.cuda_stream:
                return None
        self.offset = -(-end // self.ALIGN) * self.ALIGN
        host = self.bytes[start:end].view(a.dtype).reshape(a.shape)
        np.copyto(host, a)
        self.unfenced = True
        return torch.from_numpy(host).to(self.device, non_blocking=True,
                                         copy=True)

    def reset(self) -> None:
        """Free every block: only once the copies out of them have run."""
        self.offset = 0
        self.stream = None


class FrameContext:
    """One slot of the frame ring (PerFrame, device.hpp:641-700): the
    events of the frames tracked in it, host scratch released when the
    slot is reused, and on a card the slot's staging arena."""

    def __init__(self, index: int, device: torch.device):
        self.index = index
        self.device = device
        self.in_flight: list = []   # what begin() waits on
        self.recycle: list = []     # deferred-destroy analogue
        self.arena = StagingArena(device) if device.type == "cuda" \
            else None

    def track(self, *tensors) -> None:
        """Record one event on the current stream of the card (the stream
        the frame was enqueued on).  The CPU's work is done when its call
        returns, so there it records nothing."""
        if tensors and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.in_flight.append(event)

    def fence(self) -> None:
        """Record an event after the copies staged in this slot's arena
        since its last fence (none where nothing was staged)."""
        arena = self.arena
        if arena is not None and arena.unfenced:
            event = torch.cuda.Event()
            event.record(arena.stream)
            self.in_flight.append(event)
            arena.unfenced = False

    def begin(self) -> None:
        """Wait until the work tracked in this slot is complete (the
        timeline-fence wait of PerFrame::begin), then clear the slot and
        free its arena."""
        self.fence()
        for event in self.in_flight:
            event.synchronize()
        self.in_flight.clear()
        self.recycle.clear()
        if self.arena is not None:
            self.arena.reset()


class Device:
    """The frame ring and the named-interval stats of one device (the
    Device hub, device.hpp:167, without command machinery)."""

    FRAMES_IN_FLIGHT_DEFAULT = 2

    def __init__(self, device="cuda", frames_in_flight: int | None = None):
        """frames_in_flight: the ring's size; None (or 0) reads
        GRANITE_VULKAN_SWAPCHAIN_IMAGES, else 2; at least 1."""
        self.backend = Backend(device)
        n = frames_in_flight or get_environment_int(
            "GRANITE_VULKAN_SWAPCHAIN_IMAGES", self.FRAMES_IN_FLIGHT_DEFAULT)
        dev = self.backend.default_device
        self._frames = [FrameContext(i, dev) for i in range(max(n, 1))]
        self._frame_index = 0
        self.frame_counter = 0
        self.stats = TimestampIntervalStats()
        if dev.type == "cuda":
            stage_through(self._frames[0].arena)
        LOGI("Device created on %s (%d frame contexts)",
             self.backend.gpu_name(), len(self._frames))

    def frame(self) -> FrameContext:
        return self._frames[self._frame_index]

    def next_frame_context(self) -> FrameContext:
        """Fence the slot's staged copies, move the ring on and wait for
        the frame len(ring) back (the span `frame:ring_wait`, in the frame
        that was just tracked); uploads then stage through the new
        slot's arena."""
        with span("ring_wait"):
            self._frames[self._frame_index].fence()
            self._frame_index = (self._frame_index + 1) % len(self._frames)
            self.frame_counter += 1
            f = self._frames[self._frame_index]
            f.begin()
            if f.arena is not None:
                stage_through(f.arena)
        return f

    def wait_idle(self) -> None:
        for f in self._frames:
            f.begin()

    def register_time_interval(self, tag: str, seconds: float) -> None:
        """Named interval aggregation (query_pool.hpp:200)."""
        self.stats.accumulate(tag, seconds)
