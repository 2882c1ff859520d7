"""The port's netfs (granite_tpu_torch/network) and pyro protocol
(granite_tpu_torch/video/pyro.py) against the JAX package's, on loopback.
Both are wire protocols, so each package's client talks to the other's
server, the same raw requests get byte-equal replies, packetize's
datagrams are byte-equal, and each Reassembler rebuilds the other's
datagrams with a lost subpacket recovered from its FEC stripe.  Also the
reference faults the copies fix (netfs's quadratic receive, the
listeners that stop() and close() leave accepting, pyro's lost first
subpacket).  Every server is stopped in `finally`."""

import socket
import struct
import sys
import time

import numpy as np
import pytest

from granite_tpu.filesystem import vfs as JV
from granite_tpu.network import netfs as JN
from granite_tpu.video import pyro as JPY
from granite_tpu_torch.filesystem import vfs as TV
from granite_tpu_torch.network import netfs as TN
from granite_tpu_torch.video import pyro as TPY
from test_torch_ecs import time_limit

RNG_SEED = 37
HOST = "127.0.0.1"
SOCKET_TIMEOUT_S = 5.0
TEST_LIMIT_S = 30
NETFS = {"jax": (JN, JV), "torch": (TN, TV)}
PYRO = {"jax": JPY, "torch": TPY}
# frame sizes around the 1024-byte payload: empty, one byte, a payload
# less, exact, one more, and a few stripes' worth
FRAME_SIZES = (0, 1, 1023, 1024, 1025, 5000, 20480, 33333)
# (xor_blocks_even, xor_blocks_odd)
FEC = ((0, 0), (1, 1), (2, 2), (3, 1), (4, 4))


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(TEST_LIMIT_S):
        yield


def _stop(srv) -> None:
    """Stop a NetfsServer of either package.  The JAX package's stop()
    closes its listener under the accept() thread without waking it (see
    test_netfs_stop_closes_the_listener) and waits out a 2 s join; shut
    the listener down first so that each test does not pay it."""
    try:
        srv._sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    srv.stop()


def _files(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"tex/a.bin": b"\x01\x02\x03", "tex/b.bin": b"hello",
            "tex/deep/c.bin": rng.bytes(300_000),
            "strip.bin": rng.bytes(1 << 20)}


# -- netfs --------------------------------------------------------------------

@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_netfs_across_packages(server, client):
    """One package's NetfsBackend against the other's NetfsServer: read,
    missing, stat, list, write, and the client mounted as a protocol in
    the port's Filesystem."""
    files = _files(RNG_SEED)
    store = NETFS[server][1].MemoryBackend(files)
    srv = NETFS[server][0].NetfsServer(store)
    srv.start()
    try:
        cli = NETFS[client][0].NetfsBackend(HOST, srv.port)
        for path, data in files.items():
            assert cli.read_file(path) == data, path
        assert cli.read_file("missing") is None
        assert cli.stat("missing") is None
        assert cli.stat("tex/b.bin") == {"size": 5, "mtime": 0.0,
                                         "is_dir": False}
        assert cli.list_dir("tex") == ["a.bin", "b.bin", "deep"]
        assert cli.list_dir("nothing") == []
        assert cli.write_file("tex/new.bin", b"xyz" * 1000)
        assert store.files["tex/new.bin"] == b"xyz" * 1000
        fs = TV.Filesystem()
        fs.register_protocol("netfs", cli)
        assert fs.read_file("netfs://tex/deep/c.bin") == \
            files["tex/deep/c.bin"]
        assert fs.stat("netfs://strip.bin")["size"] == 1 << 20
        assert fs.list_dir("netfs://tex/deep") == ["c.bin"]
        assert fs.write_file("netfs://w.bin", b"\0\1")
        assert store.files["w.bin"] == b"\0\1"
    finally:
        _stop(srv)


class _Raising(TV.MemoryBackend):
    def read_file(self, path):
        raise OSError("backend fault")


def _request(op: int, path: str, payload: bytes = None) -> bytes:
    p = path.encode()
    msg = struct.pack("<II", op, len(p)) + p
    if payload is not None:
        msg += struct.pack("<Q", len(payload)) + payload
    return msg


def _replies(N, backend, requests) -> list:
    """Each raw request on one connection to package N's server; -> the
    raw replies (b"" where the server closed the connection)."""
    srv = N.NetfsServer(backend)
    srv.start()
    out = []
    try:
        with socket.create_connection((HOST, srv.port),
                                      timeout=SOCKET_TIMEOUT_S) as s:
            for req in requests:
                s.sendall(req)
                head = s.recv(12)
                if len(head) < 12:
                    out.append(head)
                    break
                (n,) = struct.unpack_from("<Q", head, 4)
                body = b""
                while len(body) < n:
                    body += s.recv(n - len(body))
                out.append(head + body)
    finally:
        _stop(srv)
    return out


def test_netfs_raw_replies_byte_equal():
    """The same raw requests to both servers: the replies byte for byte,
    the backend fault's ERROR and the dropped connection of a path past
    MAX_PATH_LEN included."""
    reqs = [_request(TN.OP_READ, "tex/b.bin"),
            _request(TN.OP_READ, "missing"),
            _request(TN.OP_STAT, "tex/a.bin"),
            _request(TN.OP_LIST, "tex"),
            _request(TN.OP_WRITE, "tex/z.bin", b"zz"),
            _request(TN.OP_LIST, ""),
            _request(99, "tex/a.bin"),
            struct.pack("<II", TN.OP_READ, TN.MAX_PATH_LEN + 1)]
    got = [_replies(N, V.MemoryBackend(_files(RNG_SEED)), reqs)
           for N, V in NETFS.values()]
    assert got[0] == got[1]
    assert len(got[0]) == len(reqs) and got[0][-1] == b""
    assert [struct.unpack_from("<I", r)[0] for r in got[0][:-1]] == \
        [TN.OK, TN.NOT_FOUND, TN.OK, TN.OK, TN.OK, TN.OK, TN.ERROR]
    faults = [_replies(N, _Raising({"a": b"1"}),
                       [_request(TN.OP_READ, "a"), _request(TN.OP_STAT, "a")])
              for N, _V in NETFS.values()]
    assert faults[0] == faults[1]
    assert struct.unpack_from("<I", faults[0][0])[0] == TN.ERROR
    assert (TN.OP_READ, TN.OP_STAT, TN.OP_LIST, TN.OP_WRITE, TN.OK,
            TN.NOT_FOUND, TN.ERROR, TN.MAX_PATH_LEN, TN.MAX_PAYLOAD_LEN) == \
        (JN.OP_READ, JN.OP_STAT, JN.OP_LIST, JN.OP_WRITE, JN.OK,
         JN.NOT_FOUND, JN.ERROR, JN.MAX_PATH_LEN, JN.MAX_PAYLOAD_LEN)


class _Chunk(bytes):
    """A received piece that counts the bytes `buf += piece` copies."""
    copied = 0

    def __radd__(self, other):
        _Chunk.copied += len(other) + len(self)
        return bytes(other) + bytes(self)


class _ChunkedSocket:
    """Hands out `data` at most `step` bytes a call, counting copies."""

    def __init__(self, data: bytes, step: int):
        self.data, self.pos, self.step = data, 0, step
        self.copied = 0

    def recv(self, n: int) -> bytes:
        k = min(n, self.step)
        self.pos += k
        return _Chunk(self.data[self.pos - k:self.pos])

    def recv_into(self, view, n: int) -> int:
        k = min(n, self.step, len(self.data) - self.pos)
        view[:k] = self.data[self.pos:self.pos + k]
        self.pos += k
        self.copied += k
        return k


def _wait_in_accept(thread, timeout: float = 5.0) -> None:
    """Return once `thread` is blocked in socket.accept(): a server loop
    back at its accept after handing a client to its handler."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        frame = sys._current_frames().get(thread.ident)
        if frame is not None and frame.f_code.co_name == "accept":
            return
        time.sleep(0.001)
    raise AssertionError("the server thread never returned to accept()")


def test_netfs_stop_closes_the_listener():
    """After stop() with a client served: the JAX package's accept thread
    is still blocked (closing a listening socket does not wake accept()
    on Linux) and serves a new client on the port; the port's stop()
    shuts the listener down, its thread ends and the port refuses.
    stop() comes once the thread is back in accept(): stopped before it
    gets there, either loop sees `_running` False and ends."""
    out = {}
    for name, (N, V) in NETFS.items():
        srv = N.NetfsServer(V.MemoryBackend({"a": b"1"}))
        srv.start()
        try:
            assert N.NetfsBackend(HOST, srv.port).read_file("a") == b"1"
            _wait_in_accept(srv._thread)
        finally:
            srv.stop()
        # (the JAX thread's next accept() returns this client, after
        # which the closed socket ends it)
        out[name] = (srv._thread.is_alive(),
                     N.NetfsBackend(HOST, srv.port).read_file("a"))
    assert out == {"jax": (True, b"1"), "torch": (False, None)}


def test_netfs_receive_is_linear():
    """The JAX package's _recv_exact copies all it has received on every
    recv: 1 MiB in 4 KiB pieces costs ~n^2 / 2c = 128 MiB of copies.  The
    port's receives into one buffer: each byte is copied in once."""
    n, step = 1 << 20, 4096
    data = np.random.default_rng(RNG_SEED).bytes(n)
    _Chunk.copied = 0
    assert JN._recv_exact(_ChunkedSocket(data, step), n) == data
    sock = _ChunkedSocket(data, step)
    got = TN._recv_exact(sock, n)
    assert type(got) is bytes and got == data
    assert sock.copied == n
    assert _Chunk.copied >= n * (n // step) // 2


# -- pyro ---------------------------------------------------------------------

def test_pyro_constants_and_codec():
    names = [k for k in vars(JPY) if k.isupper()]
    assert names and all(getattr(TPY, k) == getattr(JPY, k) for k in names)
    for t in range(16):
        for size in (0, 2, 4, 8, 24, 40, 255):
            m = TPY.make_message_type(t, size)
            assert m == JPY.make_message_type(t, size)
            assert TPY.validate_magic(m) and JPY.validate_magic(m)
            assert TPY.message_length(m) == JPY.message_length(m) == size
    assert not TPY.validate_magic(0x12345678)
    rng = np.random.default_rng(RNG_SEED)
    for _ in range(8):
        vals = [int(v) for v in rng.integers(0, 1 << 15, size=9)]
        a, b = TPY.CodecParameters(*vals), JPY.CodecParameters(*vals)
        # 28 bytes, though MSG_CODEC_PARAMETERS declares 24: a fault of
        # the reference kept for wire compatibility (ROADMAP C)
        assert a.pack() == b.pack() and len(a.pack()) == 28
        assert TPY.CodecParameters.unpack(b.pack()) == a
        assert JPY.CodecParameters.unpack(a.pack()) == b
    assert TPY.PayloadHeader.SIZE == JPY.PayloadHeader.SIZE == 24


def _frames(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(n) for n in FRAME_SIZES]


@pytest.mark.parametrize("fec", FEC, ids=[f"fec{e}{o}" for e, o in FEC])
def test_packetize_byte_equal(fec):
    """packetize's datagrams for seeded key and delta frames, with pts
    past 32 bits, a dts delta and packet_seq across the 14-bit wrap."""
    for k, frame in enumerate(_frames(RNG_SEED)):
        for key in (True, False):
            args = dict(pts=(1 << 33) + 977 * k, dts_delta=k * 3,
                        xor_blocks_even=fec[0], xor_blocks_odd=fec[1])
            seq = (1 << 14) - 2 + k
            got = TPY.packetize(frame, seq, key, **args)
            assert got == JPY.packetize(frame, seq, key, **args)
            hdr = TPY.PayloadHeader.unpack(got[0])
            assert hdr.payload_size == len(frame)
            assert (hdr.encoded >> TPY.PACKET_SEQ_OFFSET) \
                & TPY.PACKET_SEQ_MASK == seq & TPY.PACKET_SEQ_MASK


def _reassemble(R, datagrams, drop=()) -> tuple:
    r = R.Reassembler()
    out = [r.feed(d) for i, d in enumerate(datagrams) if i not in drop]
    out.append(r.flush())
    return ([f for f in out if f is not None], r.total_received_packets,
            r.total_recovered_packets, r.total_received_key_frames,
            r.progress_report())


@pytest.mark.parametrize("sender,receiver", [("jax", "torch"),
                                             ("torch", "jax")])
def test_reassembler_across_packages(sender, receiver):
    """Each Reassembler on the other package's datagrams, whole and with
    one data subpacket dropped a frame (the second and the short tail),
    recovered from its FEC stripe: the same frames and counters as the
    sender's own Reassembler."""
    frames = _frames(RNG_SEED + 1)[5:]
    S, R = PYRO[sender], PYRO[receiver]
    for drop_at in (None, 1, -1):
        dgs, drop = [], set()
        for seq, f in enumerate(frames):
            pk = S.packetize(f, seq, key_frame=seq == 0,
                             xor_blocks_even=2, xor_blocks_odd=2)
            if drop_at is not None:
                n_data = (len(f) + 1023) // 1024
                drop.add(len(dgs) + drop_at % n_data)
            dgs += pk
        got = _reassemble(R, dgs, drop)
        assert got == _reassemble(S, dgs, drop)
        assert got[0] == frames
        assert got[2] == (0 if drop_at is None else len(frames))


def _stream(server, client) -> tuple:
    """pyro between one package's PyroServer and the other's PyroClient:
    the handshake, then frames with FEC; -> (codec, frames, key frames)."""
    codec = PYRO[server].CodecParameters(
        video_codec=PYRO[server].VIDEO_CODEC_PYROWAVE, width=320,
        height=180, frame_rate_num=60, channels=2, rate=48000)
    srv = PYRO[server].PyroServer(codec)
    cli = None
    try:
        srv.serve_handshake()
        cli = PYRO[client].PyroClient(HOST, srv.tcp_port, srv.udp_port)
        got = cli.handshake()
        frames = _frames(RNG_SEED + 2)[1:6]
        for i, f in enumerate(frames):
            srv.send_frame(f, key_frame=i == 0, pts=i * 1000,
                           xor_blocks_even=1, xor_blocks_odd=1)
        srv.send_frame(b"", key_frame=False)      # starts frame 6: flushes 5
        recv = [cli.recv_frame(timeout=SOCKET_TIMEOUT_S) for _ in frames]
        assert recv == frames
        srv._thread.join(SOCKET_TIMEOUT_S)
        return got.pack(), codec.pack(), \
            cli.reassembler.total_received_key_frames
    finally:
        srv.close()
        if cli is not None:
            cli.close()


@pytest.mark.parametrize("server,client", [("torch", "jax"),
                                           ("jax", "torch")])
def test_pyro_handshake_across_packages(server, client):
    got, sent, keys = _stream(server, client)
    assert got == sent and keys == 1


def _raw_handshake(P) -> list:
    """KICK before HELLO, then a bad magic, on a raw connection to package
    P's server; -> the raw replies."""
    srv = P.PyroServer(P.CodecParameters())
    out = []
    try:
        srv.serve_handshake()
        with socket.create_connection((HOST, srv.tcp_port),
                                      timeout=SOCKET_TIMEOUT_S) as s:
            s.sendall(struct.pack("<II", P.MSG_KICK, P.KICK_VIDEO_BIT))
            out.append(s.recv(4))
            s.sendall(struct.pack("<I", 0x12345678))
            out.append(s.recv(4))
            out.append(s.recv(4))                 # closed: b""
        srv._thread.join(SOCKET_TIMEOUT_S)
        out.append(srv._thread.is_alive())
    finally:
        srv.close()
    return out


def test_pyro_server_refusals_byte_equal():
    got = [_raw_handshake(P) for P in PYRO.values()]
    assert got[0] == got[1]
    nak = struct.pack("<I", TPY.MSG_NAK)
    assert got[0] == [nak, nak, b"", False]


def test_pyro_close_ends_the_handshake_thread():
    """close() before any client: the JAX package's handshake thread stays
    blocked in accept() and its port still takes a connection; the port's
    close() shuts the listener down and the thread ends."""
    out = {}
    for name, P in PYRO.items():
        srv = P.PyroServer(P.CodecParameters())
        srv.serve_handshake()
        time.sleep(0.1)                  # into accept()
        srv.close()
        srv._thread.join(1.0)
        alive = srv._thread.is_alive()
        try:
            # the JAX thread takes this connection, then ends on EOF
            with socket.create_connection((HOST, srv.tcp_port),
                                          timeout=SOCKET_TIMEOUT_S):
                accepted = True
        except ConnectionRefusedError:
            accepted = False
        out[name] = (alive, accepted)
    assert out == {"jax": (True, True), "torch": (False, False)}


def test_reassembler_recovers_a_lost_first_subpacket():
    """Subpacket 0 (the one with PAYLOAD_PACKET_BEGIN_BIT) lost: the JAX
    package's Reassembler drops the whole frame although its stripe could
    rebuild it; the port's opens the frame on its first datagram and
    recovers it.  Datagrams of an older frame stay dropped in both."""
    frames = _frames(RNG_SEED + 3)[5:]
    dgs, drop = [], set()
    for seq, f in enumerate(frames):
        drop.add(len(dgs))
        dgs += JPY.packetize(f, seq, key_frame=True, xor_blocks_even=1,
                             xor_blocks_odd=1)
    assert _reassemble(TPY, dgs, drop)[0] == frames
    assert _reassemble(JPY, dgs, drop)[0] == []
    late = [dgs[1], *JPY.packetize(frames[0], 9, True), dgs[2]]
    for R in (TPY, JPY):
        r = R.Reassembler()
        for d in late:
            r.feed(d)
        assert r.flush() == frames[0]
        assert r.total_dropped_video_packets == 2
