"""Uploads of the frame path (granite_tpu_torch/utils/timeline_trace.upload)
and the frame ring's staging arenas (granite_tpu_torch/core/device.py).

On the CPU: a CPU target gets what torch.as_tensor gave, as before, with
or without a card's arena current; the arena's blocks start ALIGN-aligned
and a block past its end is refused, nothing moved; the ring fences a
slot's staged copies when it moves on and frees the arena only after
begin() has waited on them (a fake CUDA event logs the order); the
counters `uploads`, `upload_bytes` and `uploads_staged` under a recorder.

On a card (marked `card`, skipped without one; run with
`python -m pytest tests/test_torch_upload.py -m card`), at the benchmark
cells' configurations and sizes: a frame's synchronizing calls are its
7 binning readbacks and every upload is staged; a run of frames behind a
long kernel, more than the ring has slots, reads each frame's own host
values; frames rendered with the staged path are bit-identical to frames
rendered with the blocking copies."""

import json
import os
import tempfile
import types
import warnings

import numpy as np
import pytest
import torch

from granite_tpu_torch.core import device as TD
from granite_tpu_torch.utils import timeline_trace as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA0 = torch.device("cuda", 0)


class _CardArena:
    """Stands for a card's arena on the CPU: its device is cuda:0; it
    stages what fits in `room` bytes (a CPU copy) and refuses the rest."""

    def __init__(self, room: int = 1 << 20):
        self.device = CUDA0
        self.room = room
        self.staged = []

    def stage(self, a, dtype=None):
        h = torch.as_tensor(a, dtype=dtype)
        if h.nbytes > self.room:
            return None
        self.staged.append(h.nbytes)
        return h.clone()


class _CardTensor:
    """What a blocking copy to cuda:0 returns, as far as the counters read
    it."""

    def __init__(self, t):
        self.device = CUDA0
        self.nbytes = t.nbytes


def _as_tensor_on_fake_card(a, dtype=None, device=None):
    t = torch.as_tensor(a, dtype=dtype)
    return _CardTensor(t) if device == CUDA0 else t


CPU_CASES = {
    "float32": (lambda: np.arange(6, dtype=np.float32).reshape(2, 3), None),
    "float64_to_float32": (lambda: np.linspace(0, 1, 5), torch.float32),
    "float64": (lambda: np.linspace(0, 1, 5), None),
    "bool": (lambda: np.array([True, False, True]), torch.bool),
    "int32": (lambda: np.arange(7, dtype=np.int32), None),
    "scalar_0d": (lambda: np.float32(2.5), None),
    "python_float": (lambda: 0.5, None),
    "python_list": (lambda: [1.0, 2.0, 3.0], None),
    "python_int_list": (lambda: [[1, 2], [3, 4]], torch.int32),
    "tensor": (lambda: torch.arange(4.0), None),
}


@pytest.mark.parametrize("arena", [False, True],
                         ids=["no_arena", "card_arena_current"])
@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_target_as_before(case, arena, monkeypatch):
    """A CPU target gets torch.as_tensor's tensor: dtype, shape, values,
    and memory shared with the source exactly where as_tensor shares it;
    a tensor comes back as itself.  A card's arena being current changes
    nothing, and nothing is counted."""
    make, dtype = CPU_CASES[case]
    card = _CardArena()
    monkeypatch.setattr(TT, "_arena", card if arena else None)
    a = make()
    ref = torch.as_tensor(make() if not isinstance(a, torch.Tensor) else a,
                          dtype=dtype, device="cpu")
    with TT.FrameRecorder(types.SimpleNamespace(frame_counter=0)) as rec:
        t = TT.upload(a, dtype=dtype, device=torch.device("cpu"))
    assert t.dtype == ref.dtype and t.shape == ref.shape
    assert torch.equal(t, ref)
    if isinstance(a, torch.Tensor):
        assert t is a
    elif isinstance(a, np.ndarray) and a.ndim:
        src = a.__array_interface__["data"][0]
        shares = torch.as_tensor(a, dtype=dtype).data_ptr() == src
        assert (t.data_ptr() == src) == shares
    assert card.staged == [] and rec.counters == {}


def _cpu_arena(nbytes: int) -> TD.StagingArena:
    return TD.StagingArena(torch.device("cpu"),
                           torch.zeros(nbytes, dtype=torch.uint8))


@pytest.mark.parametrize("source", ["numpy", "tensor"])
@pytest.mark.parametrize("dtype,n", [(torch.float32, 3), (torch.float64, 5),
                                     (torch.bool, 17), (torch.int32, 16),
                                     (torch.int64, 1), (torch.float32, 0)])
def test_arena_blocks_aligned(dtype, n, source):
    """Each block starts at a multiple of ALIGN after the one before and
    holds the staged bytes, from a numpy array or a tensor; the tensor
    returned is a copy, not a view of the arena."""
    arena = _cpu_arena(1024)
    first = arena.stage(np.ones(3, np.uint8))
    assert arena.offset == TD.StagingArena.ALIGN
    h = (torch.arange(n) % 2 == 1).to(dtype) if dtype == torch.bool \
        else torch.arange(n).to(dtype) + 1
    t = arena.stage(h.numpy() if source == "numpy" else h)
    start = TD.StagingArena.ALIGN
    assert torch.equal(t, h) and t.dtype == dtype
    assert torch.equal(arena.buf[start:start + h.nbytes].view(dtype), h)
    assert arena.offset == start + -(-h.nbytes // TD.StagingArena.ALIGN) \
        * TD.StagingArena.ALIGN
    assert arena.offset % TD.StagingArena.ALIGN == 0
    arena.buf.zero_()
    assert torch.equal(t, h) and torch.equal(first, torch.ones(3).byte())
    assert arena.unfenced


@pytest.mark.parametrize("shape", [(), (4,), (2, 3), (2, 2, 2)])
def test_arena_keeps_shapes(shape):
    """Shapes, a transposed (non-contiguous) source's values, and
    as_tensor's dtypes: a cast asked for, a Python float as float32."""
    arena = _cpu_arena(512)
    a = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
    for src in (a, a.T, torch.from_numpy(a)):
        ref = torch.as_tensor(src)
        t = arena.stage(src)
        assert t.shape == ref.shape and t.dtype == torch.float64
        assert torch.equal(t, ref)
    t = arena.stage(a.T, torch.float32)
    assert t.dtype == torch.float32
    assert torch.equal(t, torch.as_tensor(a.T, dtype=torch.float32))
    t = arena.stage(2.5)
    assert t.dtype == torch.float32 and t.shape == () and float(t) == 2.5


def test_arena_refuses_past_its_end():
    """A block that does not fit in what is left is refused, the offset
    unchanged; a block that ends exactly at the end fits; reset frees the
    whole arena."""
    arena = _cpu_arena(256)
    arena.stage(torch.zeros(3))                       # 12 B -> offset 64
    assert arena.stage(torch.zeros(49)) is None       # 196 B > 192 left
    assert arena.offset == 64
    t = arena.stage(torch.full((48,), 7.0))           # 192 B: ends at 256
    assert t is not None and arena.offset == 256
    assert arena.stage(torch.zeros(1)) is None
    assert arena.stage(torch.zeros(0)).numel() == 0   # empty: fits
    arena.reset()
    assert arena.offset == 0 and arena.stream is None
    assert arena.stage(torch.zeros(64)) is not None
    assert arena.stage(torch.zeros(65)) is None


class _FakeEvent:
    """A CUDA event on the CPU: logs its record and its wait, with the
    offset of the arena it fences at the wait (still unfreed)."""

    log: list = []
    arenas: list = []

    def record(self, stream=None):
        self.log.append(("record", stream))

    def synchronize(self):
        self.log.append(("wait", [a.offset for a in self.arenas]))


@pytest.mark.parametrize("frames_in_flight", [1, 2, 3])
def test_ring_fences_then_frees(frames_in_flight, monkeypatch):
    """Each slot's arena is fenced when the ring moves on and freed only
    after begin() has waited on that fence, frames_in_flight moves later;
    a slot with nothing staged records no fence; upload() stages through
    the current slot's arena; wait_idle fences the current slot first."""
    monkeypatch.setattr(TT, "_arena", None)
    monkeypatch.setattr(TD.torch.cuda, "Event", _FakeEvent)
    log = []
    monkeypatch.setattr(_FakeEvent, "log", log)
    hub = TD.Device("cpu", frames_in_flight=frames_in_flight)
    for f in hub._frames:
        f.arena = _cpu_arena(1024)
    monkeypatch.setattr(_FakeEvent, "arenas", [f.arena for f in hub._frames])
    n = len(hub._frames)
    for k in range(2 * n + 1):
        slot = hub.frame()
        if k != 1:                                  # frame 1 stages nothing
            assert slot.arena.stage(torch.full((4,), float(k))) is not None
        del log[:]
        nxt = hub.next_frame_context()
        assert TT._arena is nxt.arena
        fenced = [("record", None)] if k != 1 else []
        assert log[:len(fenced)] == fenced
        waits = [e for e in log if e[0] == "wait"]
        if n == 1 and k != 1:
            # the slot left is the slot begun: waited on, then freed
            assert waits == [("wait", [64])]
        elif n > 1 and k >= n - 1 and k - (n - 1) != 1:
            # the slot begun held frame k - (n - 1): its fence is waited
            # on while its arena still holds that frame's block
            offsets = waits[0][1]
            assert waits == [("wait", offsets)] and offsets[nxt.index] == 64
        else:
            assert waits == []
        assert nxt.arena.offset == 0 and nxt.in_flight == []
    del log[:]
    hub.frame().arena.stage(torch.zeros(2))
    hub.wait_idle()
    i = log.index(("record", None))
    assert [e[0] for e in log[i + 1:]] == ["wait"] * (len(log) - i - 1) \
        and len(log) > i + 1
    assert all(f.arena.offset == 0 and not f.arena.unfenced
               for f in hub._frames)


@pytest.mark.parametrize("case", ["staged", "too_large", "cpu_target",
                                  "no_arena"])
def test_counters(case, monkeypatch):
    """Under a recorder: a staged upload counts in uploads, upload_bytes
    and uploads_staged; one the arena refuses (or with no arena) is the
    blocking copy, counted in uploads and upload_bytes alone; a CPU
    target counts nothing."""
    card = _CardArena(room=64)
    monkeypatch.setattr(TT, "_arena", None if case == "no_arena" else card)
    monkeypatch.setattr(TT, "torch", types.SimpleNamespace(
        as_tensor=_as_tensor_on_fake_card, Tensor=torch.Tensor))
    a = np.zeros(32 if case == "too_large" else 4, np.float32)
    device = torch.device("cpu") if case == "cpu_target" else CUDA0
    hub = types.SimpleNamespace(frame_counter=5)
    with TT.FrameRecorder(hub) as rec:
        TT.upload(a, device=device)
        TT.upload(a.astype(np.float64), dtype=torch.float32, device=device)
    expect = {"staged": {"uploads": 2, "upload_bytes": 32,
                         "uploads_staged": 2},
              "too_large": {"uploads": 2, "upload_bytes": 256},
              "no_arena": {"uploads": 2, "upload_bytes": 32},
              "cpu_target": {}}[case]
    assert rec.frames() == ([{"frame": 5, "total_ms": {}, "self_ms": {},
                              "counters": expect}] if expect else [])
    assert card.staged == ([16, 16] if case == "staged" else [])


# -- on the card --------------------------------------------------------------

CELLS = {"forward_pcf": ("forward_pcf.json", 1920, 1080),
         "deferred_hdr": ("deferred_hdr.json", 3840, 2160)}
ORBIT_RADIUS, EYE_HEIGHT = 55.21653874716373, 25.86809656
LOOK = np.array([0.0, 2.896628, 0.0], np.float32)
STEP = 1.0 / 60.0
WARMUP = 6
SYNC_FRAMES = 16
SAME_FRAMES = 4
READBACKS = 7


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", torch.cuda.current_device())


def _cell_app(name: str, device: str = "cuda"):
    """The cell's viewer on the card: its configuration's knobs on the
    bench atrium, forward_pcf's loaded from .gltf, at the cell's size."""
    from granite_tpu_torch.app.bench_scene import build_bench_scene
    from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
    from granite_tpu_torch.scene_export import export_gltf
    file, width, height = CELLS[name]
    with open(os.path.join(ROOT, "benchmark", "configs", file)) as f:
        cfg = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "config.json")
        with open(path, "w") as f:
            json.dump(cfg["viewer"], f)
        args = types.SimpleNamespace(config=path, bench_scene=False,
                                     scene=None, camera_index=-1)
        if cfg["scene"]["load"] == "gltf":
            args.scene = os.path.join(tmp, "scene.gltf")
            export_gltf(build_bench_scene(), args.scene)
        else:
            args.bench_scene = True
        app = SceneViewerApplication(args, device=device)
    app.swapchain_updated(width, height)
    app._pose = 0
    for _ in range(WARMUP):
        _frame(app)
    return app


def _render(app, pose: int):
    a = pose * 0.01
    app.camera.look_at(np.array([ORBIT_RADIUS * np.cos(a), EYE_HEIGHT,
                                 ORBIT_RADIUS * np.sin(a)], np.float32),
                       LOOK)
    return app.render_frame(STEP, (pose + 1) * STEP)


def _frame(app):
    out = _render(app, app._pose)
    app.hub.frame().track(out)
    app.hub.next_frame_context()
    app.post_frame()
    app._pose += 1
    return out


@pytest.fixture(scope="module")
def cell_apps(card):
    apps = {}
    yield lambda name: apps.setdefault(name, _cell_app(name))
    apps.clear()
    torch.cuda.empty_cache()


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_card_syncs_are_the_readbacks(cell_apps, name):
    """SYNC_FRAMES frames at the cell's size: render_frame makes exactly
    READBACKS synchronizing calls a frame, its readbacks, and every
    upload of the frame is staged."""
    app = cell_apps(name)
    for _ in range(SYNC_FRAMES):
        with TT.FrameRecorder(app.hub) as rec:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = _render(app, app._pose)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        app.hub.frame().track(out)
        app.hub.next_frame_context()
        app.post_frame()
        app._pose += 1
        n_sync = sum("synchronizing CUDA operation" in str(w.message)
                     for w in caught)
        c = rec.frames()[-1]["counters"]
        assert (n_sync, c.get("readbacks")) == (READBACKS, READBACKS), c
        assert c["uploads"] > 0 and c.get("uploads_staged") == c["uploads"]


@pytest.mark.card
@pytest.mark.parametrize("tracked", [True, False])
def test_card_arena_not_overwritten_in_flight(card, tracked):
    """A long kernel first, then frames (3 x the ring's slots) that each
    upload the one host array rewritten with the frame's number: every
    frame's tensor holds its own number, the first ones copied while the
    kernel still ran.  tracked False: the frames track nothing, so the
    ring's fences of the staged copies alone keep the arena."""
    hub = TD.Device(card, frames_in_flight=2)
    src = np.zeros(4096, np.float32)
    outs = []
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e8))                  # ~0.1 s on the card
    with TT.FrameRecorder(hub) as rec:
        for k in range(3 * len(hub._frames)):
            src[:] = k
            outs.append(TT.upload(src, device=card))
            if k == 0:
                assert not torch.cuda.current_stream(card).query()
            if tracked:
                hub.frame().track(outs[-1])
            hub.next_frame_context()
    torch.cuda.synchronize()
    for k, t in enumerate(outs):
        assert bool((t == k).all()), (k, t[:4].tolist())
    assert sum(f["counters"].get("uploads_staged", 0)
               for f in rec.frames()) == len(outs)
    hub.wait_idle()


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_card_staged_frames_bit_identical(cell_apps, name, monkeypatch):
    """SAME_FRAMES frames from a cleared history at the same poses, first
    with the staged uploads, then with every upload the blocking copy
    (the arena refusing each): the backbuffers are bit-identical."""
    app = cell_apps(name)

    def run(staged: bool):
        app.reset_history()
        app._param_cache = None
        app._pose = 1000
        frames = []
        with TT.FrameRecorder(app.hub) as rec:
            for _ in range(SAME_FRAMES):
                frames.append(_frame(app).cpu())
        c = [f["counters"] for f in rec.frames()]
        assert all(f.get("uploads_staged", 0)
                   == (f["uploads"] if staged else 0) for f in c), c
        return frames

    staged = run(True)
    monkeypatch.setattr(TD.StagingArena, "stage",
                        lambda self, a, dtype=None: None)
    blocking = run(False)
    for a, b in zip(staged, blocking):
        assert torch.equal(a, b)
