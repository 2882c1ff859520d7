"""Network filesystem: TCP asset protocol (copy of
granite_tpu/network/netfs.py, on the port's filesystem/vfs and
utils/logging; reference: network/netfs.hpp:36-68 NETFS_READ_FILE/...
opcodes, network/netfs_server.cpp, client backend
filesystem/netfs/fs-netfs.cpp).

The wire format is the original's, byte for byte: each package's client
talks to the other's server (tests/test_torch_network_video.py).  Two
faults of the original are fixed here:
  * its _recv_exact grew the message by `bytes +=`, which copies all
    received so far on every recv, so a payload that arrives in c-byte
    pieces costs n^2 / 2c bytes of copies; this copy receives into one
    preallocated buffer (recv_into);
  * its stop() closed the listening socket under a thread blocked in
    accept(), which Linux does not wake: stop() waited out its 2 s join
    and the thread went on accepting and serving on the port; this copy
    shuts the listener down first, which wakes accept().

Wire format (fresh design, length-prefixed):
    request:  u32 opcode | u32 path_len | path | [u64 payload_len | payload]
    response: u32 status | u64 payload_len | payload
Opcodes: 1=READ, 2=STAT (payload = json), 3=LIST (json list), 4=WRITE.
Status: 0=OK, 1=NOT_FOUND, 2=ERROR.

The server serves a Filesystem protocol root; the client is a
FilesystemBackend, so `netfs://` mounts like any other protocol — the
reference's "pull assets from a host machine to the device" flow.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Optional

from ..filesystem.vfs import FilesystemBackend
from ..utils.logging import LOGI, LOGW

OP_READ, OP_STAT, OP_LIST, OP_WRITE = 1, 2, 3, 4
OK, NOT_FOUND, ERROR = 0, 1, 2

# Request-size caps: unbounded length prefixes would let a client make the
# server allocate arbitrary memory before any validation runs.
MAX_PATH_LEN = 4096
MAX_PAYLOAD_LEN = 256 * 1024 * 1024


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("netfs: peer closed")
        got += k
    return bytes(buf)


def _send_response(sock, status: int, payload: bytes = b"") -> None:
    sock.sendall(struct.pack("<IQ", status, len(payload)) + payload)


class NetfsServer:
    """Serves a FilesystemBackend over TCP (netfs_server.cpp analogue)."""

    def __init__(self, backend: FilesystemBackend, host: str = "127.0.0.1",
                 port: int = 0):
        self.backend = backend
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        LOGI("netfs server listening on port %d", self.port)

    def stop(self) -> None:
        self._running = False
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=2.0)

    def _serve(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while True:
                head = _recv_exact(conn, 8)
                op, plen = struct.unpack("<II", head)
                if plen > MAX_PATH_LEN:
                    LOGW("netfs: path length %d exceeds cap, dropping "
                         "connection", plen)
                    return
                path = _recv_exact(conn, plen).decode("utf-8")
                if op == OP_WRITE:
                    (dlen,) = struct.unpack("<Q", _recv_exact(conn, 8))
                    if dlen > MAX_PAYLOAD_LEN:
                        LOGW("netfs: payload %d exceeds cap, dropping "
                             "connection", dlen)
                        return
                    data = _recv_exact(conn, dlen)
                # Backends confine paths themselves (OSFilesystem._full
                # realpath check); treat any backend raise as ERROR
                # rather than killing the connection.
                try:
                    if op == OP_WRITE:
                        ok = self.backend.write_file(path, data)
                        _send_response(conn, OK if ok else ERROR)
                    elif op == OP_READ:
                        rdata = self.backend.read_file(path)
                        if rdata is None:
                            _send_response(conn, NOT_FOUND)
                        else:
                            _send_response(conn, OK, rdata)
                    elif op == OP_STAT:
                        st = self.backend.stat(path)
                        if st is None:
                            _send_response(conn, NOT_FOUND)
                        else:
                            _send_response(conn, OK,
                                           json.dumps(st).encode())
                    elif op == OP_LIST:
                        _send_response(conn, OK, json.dumps(
                            self.backend.list_dir(path)).encode())
                    else:
                        _send_response(conn, ERROR)
                except Exception as e:  # noqa: BLE001 — serve loop
                    LOGW("netfs: request failed: %s", e)
                    _send_response(conn, ERROR)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()


class NetfsBackend(FilesystemBackend):
    """TCP-backed FilesystemBackend (fs-netfs.cpp analogue)."""

    def __init__(self, host: str, port: int):
        self._addr = (host, port)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self._addr, timeout=5.0)
        return self._sock

    def _request(self, op: int, path: str,
                 payload: Optional[bytes] = None):
        with self._lock:
            try:
                sock = self._conn()
                p = path.encode("utf-8")
                msg = struct.pack("<II", op, len(p)) + p
                if payload is not None:
                    msg += struct.pack("<Q", len(payload)) + payload
                sock.sendall(msg)
                status, plen = struct.unpack("<IQ", _recv_exact(sock, 12))
                data = _recv_exact(sock, plen) if plen else b""
                return status, data
            except (ConnectionError, OSError) as e:
                LOGW("netfs request failed: %s", e)
                self._sock = None
                return ERROR, b""

    def read_file(self, path: str):
        status, data = self._request(OP_READ, path)
        return data if status == OK else None

    def write_file(self, path: str, data: bytes) -> bool:
        status, _ = self._request(OP_WRITE, path, data)
        return status == OK

    def stat(self, path: str):
        status, data = self._request(OP_STAT, path)
        return json.loads(data) if status == OK else None

    def list_dir(self, path: str):
        status, data = self._request(OP_LIST, path)
        return json.loads(data) if status == OK else []
