"""Protocol-based virtual filesystem (copy of granite_tpu/filesystem/vfs.py;
reference: filesystem/filesystem.hpp).

Granite's Filesystem routes protocol paths (builtin://, assets://,
cache://, file://) to FilesystemBackend instances (filesystem.hpp:133,167)
with an mmap-only File API and change notifications (inotify on Linux,
via a raw libc ctypes binding — no external package needed —
linux/os_filesystem.cpp).  Here: same protocol registry; files map via
np.memmap / bytes; change notification is inotify (raw libc ctypes,
filesystem/linux/os_filesystem.cpp parity) with mtime-polling as the
portable fallback, pumped from Application.poll — same delivery
contract (poll_notifications -> handlers).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..utils.logging import LOGW


@dataclass
class FileNotifyInfo:
    path: str
    type: str          # 'modified' | 'created' | 'deleted'
    handle: int


class FilesystemBackend:
    def read_file(self, path: str) -> Optional[bytes]:
        raise NotImplementedError

    def write_file(self, path: str, data: bytes) -> bool:
        raise NotImplementedError

    def stat(self, path: str) -> Optional[dict]:
        raise NotImplementedError

    def list_dir(self, path: str) -> list[str]:
        return []

    def map_file(self, path: str):
        """mmap analogue: returns a read-only numpy uint8 view."""
        data = self.read_file(path)
        return None if data is None else np.frombuffer(data, np.uint8)

    # notification interface
    def install_notification(self, path: str, cb: Callable) -> int:
        return -1

    def uninstall_notification(self, handle: int) -> None:
        pass

    def poll_notifications(self) -> None:
        pass


class _Inotify:
    """Raw Linux inotify via libc (no external binding needed).

    Watches DIRECTORIES and reports per-entry events, the same protocol
    the reference uses (filesystem/linux/os_filesystem.cpp): editors
    replace files by rename, which kills per-file watches but not
    per-directory ones."""

    IN_MODIFY = 0x002
    IN_ATTRIB = 0x004
    IN_CLOSE_WRITE = 0x008
    IN_MOVED_FROM = 0x040
    IN_MOVED_TO = 0x080
    IN_CREATE = 0x100
    IN_DELETE = 0x200
    IN_NONBLOCK = 0x800
    MASK = (IN_MODIFY | IN_ATTRIB | IN_CLOSE_WRITE | IN_MOVED_FROM
            | IN_MOVED_TO | IN_CREATE | IN_DELETE)

    def __init__(self):
        import ctypes
        self._libc = ctypes.CDLL("libc.so.6", use_errno=True)
        self.fd = self._libc.inotify_init1(self.IN_NONBLOCK)
        if self.fd < 0:
            raise OSError("inotify_init1 failed")

    def add_watch(self, dir_path: str) -> int:
        wd = self._libc.inotify_add_watch(
            self.fd, dir_path.encode(), self.MASK)
        if wd < 0:
            raise OSError(f"inotify_add_watch failed: {dir_path}")
        return wd

    def rm_watch(self, wd: int) -> None:
        self._libc.inotify_rm_watch(self.fd, wd)

    def read_events(self):
        """Drain: list of (wd, mask, name)."""
        import struct
        out = []
        while True:
            try:
                buf = os.read(self.fd, 16384)
            except BlockingIOError:
                break
            except OSError:
                break
            if not buf:
                break
            off = 0
            while off + 16 <= len(buf):
                wd, mask, _cookie, nlen = struct.unpack_from(
                    "iIII", buf, off)
                name = buf[off + 16:off + 16 + nlen].split(b"\0")[0] \
                    .decode(errors="replace")
                out.append((wd, mask, name))
                off += 16 + nlen
        return out

    def close(self):
        try:
            os.close(self.fd)
        except OSError:
            pass


class OSFilesystem(FilesystemBackend):
    """filesystem/linux/os_filesystem.cpp analogue: inotify change
    notification when the kernel provides it, mtime polling otherwise."""

    def __init__(self, base: str):
        self.base = os.path.abspath(base)
        self._watch: dict[int, tuple[str, Callable, float]] = {}
        self._next_handle = 1
        try:
            self._ino = _Inotify()
        except OSError:
            self._ino = None
        self._ino_dirs: dict[str, int] = {}        # dir -> wd
        self._ino_watch: dict[int, tuple] = {}     # handle -> record

    def _full(self, path: str) -> str:
        """Resolve `path` under base, confined to base.

        Absolute paths and '..' escapes are clamped: os.path.join discards
        base for absolute inputs, so strip leading separators and verify
        the realpath stays inside the served root (a netfs server hands
        client-supplied paths straight here).
        """
        if not path:
            return self.base
        full = os.path.join(self.base, path.lstrip("/\\"))
        resolved = os.path.realpath(full)
        root = os.path.realpath(self.base)
        prefix = root if root.endswith(os.sep) else root + os.sep
        if resolved != root and not resolved.startswith(prefix):
            raise PermissionError(f"path escapes filesystem root: {path}")
        return full

    def read_file(self, path: str) -> Optional[bytes]:
        try:
            with open(self._full(path), "rb") as f:
                return f.read()
        except OSError:
            return None

    def write_file(self, path: str, data: bytes) -> bool:
        try:
            full = self._full(path)
            os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
            with open(full, "wb") as f:
                f.write(data)
            return True
        except OSError:
            return False

    def stat(self, path: str) -> Optional[dict]:
        try:
            st = os.stat(self._full(path))
            return {"size": st.st_size, "mtime": st.st_mtime,
                    "is_dir": os.path.isdir(self._full(path))}
        except OSError:
            return None

    def list_dir(self, path: str) -> list[str]:
        try:
            return sorted(os.listdir(self._full(path)))
        except OSError:
            return []

    def map_file(self, path: str):
        try:
            return np.memmap(self._full(path), dtype=np.uint8, mode="r")
        except (OSError, ValueError):
            return None

    def install_notification(self, path: str, cb: Callable) -> int:
        h = self._next_handle
        self._next_handle += 1
        if self._ino is not None:
            full = self._full(path)
            is_dir = os.path.isdir(full)
            wdir = full if is_dir else (os.path.dirname(full) or ".")
            try:
                if wdir not in self._ino_dirs:
                    self._ino_dirs[wdir] = self._ino.add_watch(wdir)
                wd = self._ino_dirs[wdir]
                name = "" if is_dir else os.path.basename(full)
                self._ino_watch[h] = (path, cb, wd, name)
                return h
            except OSError:
                pass               # fall through to mtime polling
        st = self.stat(path)
        self._watch[h] = (path, cb, st["mtime"] if st else -1.0)
        return h

    def uninstall_notification(self, handle: int) -> None:
        self._watch.pop(handle, None)
        self._ino_watch.pop(handle, None)

    def poll_notifications(self) -> None:
        if self._ino is not None and self._ino_watch:
            I = _Inotify
            fired = set()      # coalesce raw event storms per poll
            for wd, mask, name in self._ino.read_events():
                if mask & (I.IN_DELETE | I.IN_MOVED_FROM):
                    kind = "deleted"
                elif mask & (I.IN_CREATE | I.IN_MOVED_TO):
                    kind = "created"
                else:
                    kind = "modified"
                for h, (path, cb, w, fname) in list(
                        self._ino_watch.items()):
                    if w == wd and (fname == "" or fname == name) \
                            and (h, kind) not in fired:
                        fired.add((h, kind))
                        cb(FileNotifyInfo(path=path, type=kind, handle=h))
        for h, (path, cb, mtime) in list(self._watch.items()):
            st = self.stat(path)
            new_mtime = st["mtime"] if st else -1.0
            if new_mtime != mtime:
                self._watch[h] = (path, cb, new_mtime)
                kind = ("deleted" if st is None
                        else ("created" if mtime < 0 else "modified"))
                cb(FileNotifyInfo(path=path, type=kind, handle=h))


class MemoryBackend(FilesystemBackend):
    """BlobFilesystem analogue (filesystem.hpp:285) for builtin:// data."""

    def __init__(self, files: Optional[dict[str, bytes]] = None):
        self.files = dict(files or {})

    def read_file(self, path: str) -> Optional[bytes]:
        return self.files.get(path)

    def write_file(self, path: str, data: bytes) -> bool:
        self.files[path] = bytes(data)
        return True

    def stat(self, path: str) -> Optional[dict]:
        if path in self.files:
            return {"size": len(self.files[path]), "mtime": 0.0,
                    "is_dir": False}
        return None

    def list_dir(self, path: str) -> list[str]:
        prefix = path.rstrip("/") + "/" if path else ""
        out = set()
        for p in self.files:
            if p.startswith(prefix):
                out.add(p[len(prefix):].split("/")[0])
        return sorted(out)


class Filesystem:
    """Protocol router (filesystem.hpp:167)."""

    def __init__(self):
        self._protocols: dict[str, FilesystemBackend] = {}
        self.register_protocol("file", OSFilesystem("/"))
        self.register_protocol("memory", MemoryBackend())

    def register_protocol(self, proto: str,
                          backend: FilesystemBackend) -> None:
        self._protocols[proto] = backend

    def get_backend(self, proto: str) -> Optional[FilesystemBackend]:
        return self._protocols.get(proto)

    @staticmethod
    def split(path: str) -> tuple[str, str]:
        if "://" in path:
            proto, rest = path.split("://", 1)
            return proto, rest
        return "file", path

    def _route(self, path: str):
        proto, rest = self.split(path)
        be = self._protocols.get(proto)
        if be is None:
            LOGW("unknown filesystem protocol '%s'", proto)
        return be, rest

    def read_file(self, path: str) -> Optional[bytes]:
        be, rest = self._route(path)
        return be.read_file(rest) if be else None

    def read_file_to_string(self, path: str) -> Optional[str]:
        data = self.read_file(path)
        return data.decode("utf-8") if data is not None else None

    def write_file(self, path: str, data) -> bool:
        be, rest = self._route(path)
        if isinstance(data, str):
            data = data.encode("utf-8")
        return be.write_file(rest, data) if be else False

    def stat(self, path: str) -> Optional[dict]:
        be, rest = self._route(path)
        return be.stat(rest) if be else None

    def list_dir(self, path: str) -> list[str]:
        be, rest = self._route(path)
        return be.list_dir(rest) if be else []

    def map_file(self, path: str):
        be, rest = self._route(path)
        return be.map_file(rest) if be else None

    def install_notification(self, path: str, cb: Callable) -> tuple:
        be, rest = self._route(path)
        return (be, be.install_notification(rest, cb)) if be else (None, -1)

    def poll_notifications(self) -> None:
        for be in self._protocols.values():
            be.poll_notifications()
