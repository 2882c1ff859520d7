"""The port's copies of the OS services (granite_tpu_torch/filesystem,
threading_) through tests/test_os_services.py's cases: VFS protocols and
notifications (mtime polling and inotify), ThreadGroup dependencies, the
TaskComposer pipeline, AssetManager budget/LRU and dedup.  Then what the
copies do differently on purpose: wait_idle waits for a task still
running, and a worker's exception re-raises at the next iterate() where
the JAX AssetManager loses it.  No sleeps: mtimes are set explicitly, and
tasks block on events."""

import os
import threading

import pytest

from granite_tpu.filesystem import AssetManager as JaxAssetManager
from granite_tpu.threading_ import ThreadGroup as JaxThreadGroup
from granite_tpu_torch.filesystem import (
    AssetClass, AssetManager, Filesystem, MemoryBackend, OSFilesystem,
)
from granite_tpu_torch.filesystem.asset_manager import (
    AssetInstantiatorInterface,
)
from granite_tpu_torch.filesystem.vfs import _Inotify
from granite_tpu_torch.threading_ import TaskComposer, ThreadGroup

WAIT_S = 30.0


def test_vfs_protocols(tmp_path):
    fs = Filesystem()
    fs.register_protocol("assets", OSFilesystem(str(tmp_path)))
    fs.register_protocol("builtin", MemoryBackend(
        {"shaders/x.comp": b"kernel"}))
    assert fs.write_file("assets://sub/hello.txt", "world")
    assert fs.read_file_to_string("assets://sub/hello.txt") == "world"
    assert fs.read_file("builtin://shaders/x.comp") == b"kernel"
    assert fs.stat("assets://sub/hello.txt")["size"] == 5
    assert "hello.txt" in fs.list_dir("assets://sub")
    assert fs.read_file("assets://missing") is None
    m = fs.map_file("assets://sub/hello.txt")
    assert bytes(m[:5]) == b"world"
    # paths stay inside the served root
    (tmp_path.parent / "escape.txt").write_bytes(b"outside")
    assert fs.read_file("assets://../escape.txt") is None
    with pytest.raises(PermissionError):
        fs.get_backend("assets")._full("../escape.txt")


def test_vfs_notifications(tmp_path, monkeypatch):
    """The mtime-polling route (no inotify): one 'modified' delivery for
    a changed mtime."""
    monkeypatch.setattr(OSFilesystem, "__init__", _no_inotify_init)
    fs = Filesystem()
    fs.register_protocol("assets", OSFilesystem(str(tmp_path)))
    fs.write_file("assets://watch.me", "v1")
    events = []
    fs.install_notification("assets://watch.me", events.append)
    fs.poll_notifications()
    assert events == []
    fs.write_file("assets://watch.me", "v2")
    path = os.path.join(str(tmp_path), "watch.me")
    mtime = os.stat(path).st_mtime + 10.0
    os.utime(path, (mtime, mtime))
    fs.poll_notifications()
    assert len(events) == 1 and events[0].type == "modified"


_os_fs_init = OSFilesystem.__init__


def _no_inotify_init(self, base):
    _os_fs_init(self, base)
    self._ino = None


def _need_inotify():
    try:
        _Inotify().close()
    except OSError:
        pytest.skip("no inotify on this kernel")


def test_inotify_notifications(tmp_path):
    _need_inotify()
    fs = OSFilesystem(str(tmp_path))
    assert fs._ino is not None
    events = []
    h = fs.install_notification("watched.txt", events.append)
    assert h > 0 and h in fs._ino_watch
    (tmp_path / "watched.txt").write_bytes(b"one")
    fs.poll_notifications()
    kinds = [e.type for e in events]
    assert "created" in kinds or "modified" in kinds
    events.clear()
    (tmp_path / "watched.txt").write_bytes(b"two")
    fs.poll_notifications()
    assert any(e.type == "modified" for e in events)
    events.clear()
    (tmp_path / "other.txt").write_bytes(b"x")   # unwatched file
    (tmp_path / "watched.txt").unlink()
    fs.poll_notifications()
    assert [e.type for e in events] == ["deleted"]
    fs.uninstall_notification(h)
    (tmp_path / "watched.txt").write_bytes(b"three")
    fs.poll_notifications()
    assert events[-1].type == "deleted"          # no new deliveries


def test_inotify_directory_watch(tmp_path):
    _need_inotify()
    fs = OSFilesystem(str(tmp_path))
    sub = tmp_path / "assets"
    sub.mkdir()
    events = []
    fs.install_notification("assets", events.append)
    (sub / "a.bin").write_bytes(b"a")
    fs.poll_notifications()
    assert any(e.type in ("created", "modified") for e in events)


def test_thread_group_dependencies():
    tg = ThreadGroup(num_workers=4)
    order = []
    g1 = tg.create_task(lambda: order.append("a"))
    g2 = tg.create_task(lambda: order.append("b"))
    g3 = tg.create_task(lambda: order.append("c"))
    g2.add_dependency(g1)
    g3.add_dependency(g2)
    g3.flush()
    g2.flush()
    g1.flush()
    assert g3.wait(WAIT_S)
    assert order == ["a", "b", "c"]
    tg.shutdown()


def test_task_composer_pipeline():
    tg = ThreadGroup(num_workers=4)
    out = []
    comp = TaskComposer(tg)
    for stage in range(4):
        s = comp.begin_pipeline_stage(f"s{stage}")
        s.enqueue_task(lambda i=stage: out.append(i))
    final = comp.get_outgoing_task()
    assert final.wait(WAIT_S)
    assert out == [0, 1, 2, 3]
    tg.shutdown()


class CountingInstantiator(AssetInstantiatorInterface):
    def __init__(self):
        self.released = []

    def instantiate(self, path, asset_class):
        return (f"payload:{path}", 100)

    def fallback(self, asset_class):
        return f"fallback:{asset_class.name}"

    def release(self, payload):
        self.released.append(payload)


def test_asset_manager_budget_lru():
    tg = ThreadGroup(num_workers=2)
    inst = CountingInstantiator()
    am = AssetManager(inst, tg)
    am.set_asset_budget(250)      # fits 2 of 100
    ids = [am.register_asset(f"tex{i}.png", AssetClass.COLOR)
           for i in range(3)]
    # Fallback until resident.
    assert am.get_asset(ids[0]).startswith("fallback")
    am.iterate()                   # kicks instantiation of tex0
    tg.wait_idle()
    am.iterate()                   # publishes tex0
    assert am.get_asset(ids[0]) == "payload:tex0.png"
    # Touch 1 and 2, iterate twice to stream them in.
    am.get_asset(ids[1])
    am.get_asset(ids[2])
    am.iterate()
    tg.wait_idle()
    am.iterate()
    # Budget 250 forces eviction of the least recently used.
    resident = [am._assets[i].resident for i in ids]
    assert sum(resident) <= 2
    assert am.current_cost <= 250
    assert inst.released           # something was evicted
    assert am.evictions == len(inst.released) == 1
    tg.shutdown()


def test_asset_manager_dedup():
    tg = ThreadGroup(num_workers=1)
    am = AssetManager(CountingInstantiator(), tg)
    a = am.register_asset("same.png")
    b = am.register_asset("same.png")
    assert a == b
    tg.shutdown()


@pytest.mark.parametrize("workers", [2, 4])
def test_wait_idle_waits_for_a_running_task(workers):
    """A task still running when wait_idle is called: the copy returns
    only after it ends (the original's barrier no-ops can all run on the
    other workers first).  The task ends once wait_idle has queued."""
    tg = ThreadGroup(num_workers=workers, num_background=workers)
    started, release, done = threading.Event(), threading.Event(), []

    def slow():
        started.set()
        release.wait(WAIT_S)
        done.append(1)

    tg.create_task(slow).flush()
    assert started.wait(WAIT_S)
    timer = threading.Timer(0.05, release.set)
    timer.start()
    tg.wait_idle()
    assert done == [1]
    timer.join(WAIT_S)
    tg.shutdown()


class FailingInstantiator(CountingInstantiator):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def instantiate(self, path, asset_class):
        self.calls += 1
        if self.calls == 1:
            raise ValueError(f"cannot decode {path}")
        return super().instantiate(path, asset_class)


def test_worker_exception_reraises_at_iterate():
    """The first instantiation raises on its worker: the next iterate()
    re-raises it (naming the asset), the asset is no longer pending, and
    a later request instantiates it.  The JAX AssetManager, given the
    same sequence, raises nothing and leaves the asset pending for
    good."""
    tg = ThreadGroup(num_workers=1, num_background=1)
    am = AssetManager(FailingInstantiator(), tg)
    aid = am.register_asset("broken.png")
    am.get_asset(aid)
    am.iterate()
    tg.wait_idle()
    with pytest.raises(ValueError, match="cannot decode broken.png") as exc:
        am.iterate()
    assert any("broken.png" in n for n in exc.value.__notes__)
    assert not am._assets[aid].pending and not am.is_resident(aid)
    am.get_asset(aid)
    am.iterate()
    tg.wait_idle()
    am.iterate()
    assert am.get_asset(aid) == "payload:broken.png"
    tg.shutdown()

    jtg = JaxThreadGroup(num_workers=1, num_background=1)
    jam = JaxAssetManager(FailingInstantiator(), jtg)
    jaid = jam.register_asset("broken.png")
    jam.get_asset(jaid)
    jam.iterate()
    jtg.wait_idle()
    for _ in range(3):
        jam.iterate()
        jam.get_asset(jaid)
    assert jam._assets[jaid].pending and not jam.is_resident(jaid)
    jtg.shutdown()
