"""The port's frame ring (granite_tpu_torch/core/device.py: Backend,
FrameContext, Device) against granite_tpu/core/device.py: with 1, 2 or 3
frames in flight, or the count from GRANITE_VULKAN_SWAPCHAIN_IMAGES,
both rings wait on the same frames in the same order as frames are
tracked and the ring moves on (tracked fakes count their waits), and
wait_idle waits on the rest; register_time_interval averages as the
original's.  The port's begin() lets a fault through, where the
original's swallows it."""

import pytest

from granite_tpu.core import device as JD
from granite_tpu_torch.app.application import Application
from granite_tpu_torch.core import device as TD

FRAMES = 7


@pytest.fixture(autouse=True)
def _no_xla_cache(monkeypatch):
    """The JAX Backend turns on XLA's persistent compilation cache under
    the home directory unless this is set."""
    monkeypatch.setenv("GRANITE_DISABLE_PIPELINE_CACHE", "1")


class _Tracked:
    """Stands for a tracked frame: the JAX ring waits on it through
    block_until_ready (its readback probe fails on it), the port's
    through synchronize, as on a CUDA event."""

    def __init__(self, frame: int, log: list, fail: bool = False):
        self.frame = frame
        self.log = log
        self.fail = fail

    def synchronize(self):
        if self.fail:
            raise RuntimeError("simulated device fault")
        self.log.append(self.frame)

    block_until_ready = synchronize


def _waits(hub) -> tuple:
    """Track FRAMES frames, moving the ring on after each; -> (the frames
    waited on after each move, the frames wait_idle waited on, the slot
    index after each move, frame_counter)."""
    log, per_move, slots = [], [], []
    for k in range(FRAMES):
        hub.frame().in_flight.append(_Tracked(k, log))
        n = len(log)
        slot = hub.next_frame_context()
        per_move.append(log[n:])
        slots.append(slot.index)
        assert slot is hub.frame() and slot.in_flight == []
    n = len(log)
    hub.wait_idle()
    return per_move, sorted(log[n:]), slots, hub.frame_counter


@pytest.mark.parametrize("n,env", [(1, None), (2, None), (3, None),
                                   (None, "3"), (None, None), (2, "5")])
def test_ring_waits_match_jax(n, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("GRANITE_VULKAN_SWAPCHAIN_IMAGES", raising=False)
    else:
        monkeypatch.setenv("GRANITE_VULKAN_SWAPCHAIN_IMAGES", env)
    got = _waits(TD.Device("cpu", frames_in_flight=n))
    want = _waits(JD.Device(frames_in_flight=n))
    assert got == want
    ring = n or int(env or 2)
    per_move, idle, _slots, counter = got
    # after frame k the ring waits for frame k - (ring - 1), no newer
    assert per_move == [[k - ring + 1] if k >= ring - 1 else []
                        for k in range(FRAMES)]
    assert idle == list(range(FRAMES - ring + 1, FRAMES))
    assert counter == FRAMES


def test_time_intervals_match_jax():
    got, want = TD.Device("cpu"), JD.Device()
    for hub in (got, want):
        for tag, s in (("pass:a", 1e-3), ("pass:b", 2.5e-3),
                       ("pass:a", 4e-3), ("decode", 0.0123)):
            hub.register_time_interval(tag, s)
    assert got.stats.averages_us() == want.stats.averages_us()
    assert set(got.stats.averages_us()) == {"pass:a", "pass:b", "decode"}


def test_cpu_backend_and_track():
    """On the CPU the backend names "cpu" (the stat JSON's gpu field),
    has no memory stats, and track records nothing: a CPU frame's work
    is done when its call returns."""
    hub = TD.Device("cpu", frames_in_flight=2)
    b = hub.backend
    assert (b.platform, b.device_kind, b.gpu_name(), b.num_devices) == \
        ("cpu", "cpu", "cpu", 1)
    assert b.memory_stats() == {}
    hub.frame().track(object(), object())
    assert hub.frame().in_flight == []
    app = Application("cpu", frames_in_flight=3)
    assert app.device.type == "cpu" and app.hub.backend.platform == "cpu"
    assert len(app.hub._frames) == 3
    app.teardown()


def test_begin_lets_a_fault_through():
    """A fault while waiting on a frame surfaces in the port (the JAX
    ring's begin() swallows it)."""
    log = []
    hub = TD.Device("cpu", frames_in_flight=1)
    hub.frame().in_flight.append(_Tracked(0, log, fail=True))
    with pytest.raises(RuntimeError, match="simulated device fault"):
        hub.next_frame_context()
    ref = JD.Device(frames_in_flight=1)
    ref.frame().in_flight.append(_Tracked(0, log, fail=True))
    ref.next_frame_context()
    assert log == []


def test_cuda_hub_raises_without_a_card():
    """cuda without a card raises; nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TD.Device("cuda")
