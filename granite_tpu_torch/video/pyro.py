"""pyro low-latency streaming protocol (copy of granite_tpu/video/pyro.py;
wire format of video/pyro_protocol.h; server flow video/pyro_server.cpp).

The wire format is the original's, byte for byte: each package's client
handshakes with the other's server and reassembles its datagrams
(tests/test_torch_network_video.py).  One fault of the original's
Reassembler is fixed here: it opened a frame only on the datagram with
PAYLOAD_PACKET_BEGIN_BIT (subpacket 0) and counted every other datagram
of that frame as dropped, so losing subpacket 0 lost the frame although
its parity stripe could rebuild it.  This copy also opens a frame on the
first datagram of a newer packet_seq (mod 2^14), and still drops the
datagrams of older frames; nothing on the wire changes.  And as in the
port's netfs, PyroServer.close() shuts its TCP listener down before
closing it, so a handshake thread blocked in accept() ends (the
original's stays blocked, and its port keeps accepting).

Wire-compatible subset: message magic/typing (PYRO_MAKE_MESSAGE_TYPE
with the version mask), the TCP handshake (HELLO -> COOKIE -> UDP
cookie ack -> KICK -> CODEC_PARAMETERS), UDP payload packetization with
packet/subpacket sequence fields, BEGIN/KEY-FRAME/stream-type flag
bits, the 24-byte pyro_payload_header on every datagram, and
client-side reassembly + progress accounting.  FEC: XOR parity stripes
over even/odd subpacket sets (header fields num_fec_blocks /
num_xor_blocks_even/odd; the reference's generator is out-of-tree, see
packetize's docstring for the stripe contract).
"""

from __future__ import annotations

import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Optional

PYRO_VERSION_MASK = 0xAA02 << 16
PYRO_MAX_PAYLOAD_SIZE = 1024


def make_message_type(t: int, size: int) -> int:
    v = ((ord("P") << 26) | (ord("Y") << 20) | (ord("R") << 14)
         | t | (size << 6)) & 0xFFFFFFFF          # C uint32 semantics
    return v ^ PYRO_VERSION_MASK


MESSAGE_MAGIC_MASK = (0xFFFFFFFF << 14) & 0xFFFFFFFF

MSG_OK = make_message_type(0, 0)
MSG_NAK = make_message_type(1, 0)
MSG_AGAIN = make_message_type(2, 0)
MSG_HELLO = make_message_type(3, 0)
MSG_COOKIE = make_message_type(4, 8)
MSG_KICK = make_message_type(5, 4)
MSG_PROGRESS = make_message_type(6, 40)
MSG_CODEC_PARAMETERS = make_message_type(7, 24)
MSG_PHASE_OFFSET = make_message_type(8, 4)
MSG_GAMEPAD_STATE = make_message_type(9, 16)
MSG_PING = make_message_type(10, 2)

VIDEO_CODEC_NONE = 0
VIDEO_CODEC_H264 = 1
VIDEO_CODEC_H265 = 2
VIDEO_CODEC_AV1 = 3
VIDEO_CODEC_PYROWAVE = 4

KICK_VIDEO_BIT = 1 << 0
KICK_AUDIO_BIT = 1 << 1

PAYLOAD_KEY_FRAME_BIT = 1 << 0
PAYLOAD_STREAM_TYPE_BIT = 1 << 1
PAYLOAD_PACKET_FEC_BIT = 1 << 2
PAYLOAD_PACKET_BEGIN_BIT = 1 << 3
PACKET_SEQ_OFFSET = 4
PACKET_SEQ_BITS = 14
SUBPACKET_SEQ_OFFSET = 18
SUBPACKET_SEQ_BITS = 14
PACKET_SEQ_MASK = (1 << PACKET_SEQ_BITS) - 1
SUBPACKET_SEQ_MASK = (1 << SUBPACKET_SEQ_BITS) - 1


def validate_magic(v: int) -> bool:
    return make_message_type(0, 0) == (v & MESSAGE_MAGIC_MASK)


def message_length(v: int) -> int:
    return (v >> 6) & 0xFF


@dataclass
class CodecParameters:
    """struct pyro_codec_parameters (little-endian wire layout)."""
    video_codec: int = VIDEO_CODEC_NONE
    video_color_profile: int = 0
    audio_codec: int = 0
    frame_rate_num: int = 60
    frame_rate_den: int = 1
    width: int = 0
    height: int = 0
    channels: int = 0
    rate: int = 0

    _FMT = "<iiiHHHHII"

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.video_codec,
                           self.video_color_profile, self.audio_codec,
                           self.frame_rate_num, self.frame_rate_den,
                           self.width, self.height, self.channels,
                           self.rate)

    @classmethod
    def unpack(cls, b: bytes) -> "CodecParameters":
        vals = struct.unpack(cls._FMT, b[:struct.calcsize(cls._FMT)])
        return cls(*vals)


def payload_flags(packet_seq: int, subpacket_seq: int, begin: bool,
                  key_frame: bool, is_audio: bool = False) -> int:
    f = 0
    if key_frame:
        f |= PAYLOAD_KEY_FRAME_BIT
    if is_audio:
        f |= PAYLOAD_STREAM_TYPE_BIT
    if begin:
        f |= PAYLOAD_PACKET_BEGIN_BIT
    f |= (packet_seq & PACKET_SEQ_MASK) << PACKET_SEQ_OFFSET
    f |= (subpacket_seq & SUBPACKET_SEQ_MASK) << SUBPACKET_SEQ_OFFSET
    return f


@dataclass
class PayloadHeader:
    """struct pyro_payload_header (pyro_protocol.h:219-227, 24 bytes,
    little-endian): every UDP datagram leads with it."""
    pts_lo: int = 0
    pts_hi: int = 0
    dts_delta: int = 0
    payload_size: int = 0
    num_fec_blocks: int = 0
    num_xor_blocks_even: int = 0
    num_xor_blocks_odd: int = 0
    encoded: int = 0

    _FMT = "<IIIIHBBI"
    SIZE = struct.calcsize("<IIIIHBBI")

    def pack(self) -> bytes:
        return struct.pack(self._FMT, self.pts_lo, self.pts_hi,
                           self.dts_delta, self.payload_size,
                           self.num_fec_blocks, self.num_xor_blocks_even,
                           self.num_xor_blocks_odd, self.encoded)

    @classmethod
    def unpack(cls, b: bytes) -> "PayloadHeader":
        return cls(*struct.unpack_from(cls._FMT, b))


def _xor_into(acc: bytearray, chunk: bytes) -> None:
    for i, c in enumerate(chunk):
        acc[i] ^= c


def packetize(frame: bytes, packet_seq: int, key_frame: bool,
              pts: int = 0, dts_delta: int = 0,
              xor_blocks_even: int = 0, xor_blocks_odd: int = 0) -> list:
    """Split one encoded frame into UDP datagrams (pyro_payload_header +
    <=PYRO_MAX_PAYLOAD_SIZE chunks), optionally followed by FEC parity.

    FEC (header fields num_fec_blocks / num_xor_blocks_even/odd,
    pyro_protocol.h:224-225; the reference's FEC generator lives in the
    out-of-tree pyrofling server, so the stripe layout here is this
    implementation's contract, mirrored by Reassembler): data subpackets
    are split into even/odd index sets; set members are striped over the
    set's parity blocks (member k of the even set XORs into parity
    k % num_xor_blocks_even).  Parity datagrams carry
    PAYLOAD_PACKET_FEC_BIT with an unwrapped subpacket_seq numbering
    even parities first.  One lost subpacket per stripe is recoverable.
    """
    out = []
    n = max(1, (len(frame) + PYRO_MAX_PAYLOAD_SIZE - 1)
            // PYRO_MAX_PAYLOAD_SIZE)
    xor_blocks_even = min(xor_blocks_even, (n + 1) // 2)
    xor_blocks_odd = min(xor_blocks_odd, n // 2)
    nfec = xor_blocks_even + xor_blocks_odd
    hdr = PayloadHeader(pts_lo=pts & 0xFFFFFFFF,
                        pts_hi=(pts >> 32) & 0xFFFFFFFF,
                        dts_delta=dts_delta, payload_size=len(frame),
                        num_fec_blocks=nfec,
                        num_xor_blocks_even=xor_blocks_even,
                        num_xor_blocks_odd=xor_blocks_odd)
    parity = [bytearray(PYRO_MAX_PAYLOAD_SIZE) for _ in range(nfec)]
    for i in range(n):
        chunk = frame[i * PYRO_MAX_PAYLOAD_SIZE:
                      (i + 1) * PYRO_MAX_PAYLOAD_SIZE]
        hdr.encoded = payload_flags(packet_seq, i, begin=(i == 0),
                                    key_frame=key_frame)
        out.append(hdr.pack() + chunk)
        if i % 2 == 0 and xor_blocks_even:
            _xor_into(parity[(i // 2) % xor_blocks_even], chunk)
        elif i % 2 == 1 and xor_blocks_odd:
            _xor_into(parity[xor_blocks_even
                             + (i // 2) % xor_blocks_odd], chunk)
    for j in range(nfec):
        hdr.encoded = payload_flags(packet_seq, j, begin=False,
                                    key_frame=key_frame) \
            | PAYLOAD_PACKET_FEC_BIT
        out.append(hdr.pack() + bytes(parity[j]))
    return out


@dataclass
class Reassembler:
    """Client-side packet reassembly + pyro_progress_report stats."""
    total_received_packets: int = 0
    total_dropped_video_packets: int = 0
    total_received_key_frames: int = 0
    total_recovered_packets: int = 0
    _cur_seq: int = -1
    _parts: dict = field(default_factory=dict)
    _fec: dict = field(default_factory=dict)
    _hdr: object = None
    _key: bool = False

    def feed(self, datagram: bytes) -> Optional[bytes]:
        """Returns a completed frame when the next BEGIN arrives."""
        hdr = PayloadHeader.unpack(datagram)
        flags = hdr.encoded
        data = datagram[PayloadHeader.SIZE:]
        self.total_received_packets += 1
        pseq = (flags >> PACKET_SEQ_OFFSET) & PACKET_SEQ_MASK
        sseq = (flags >> SUBPACKET_SEQ_OFFSET) & SUBPACKET_SEQ_MASK
        done = None
        if flags & PAYLOAD_PACKET_BEGIN_BIT or self._is_newer(pseq):
            done = self._complete()
            self._cur_seq = pseq
            self._parts = {}
            self._fec = {}
            self._key = bool(flags & PAYLOAD_KEY_FRAME_BIT)
        if pseq != self._cur_seq:
            self.total_dropped_video_packets += 1
            return done
        self._hdr = hdr
        if flags & PAYLOAD_PACKET_FEC_BIT:
            self._fec[sseq] = data
        else:
            self._parts[sseq] = data
        return done

    def flush(self) -> Optional[bytes]:
        return self._complete()

    def _is_newer(self, pseq: int) -> bool:
        """pseq starts a frame after the current one (sequence numbers wrap
        at 2^14; the nearer half-range ahead counts as newer)."""
        if self._cur_seq < 0:
            return True
        ahead = (pseq - self._cur_seq) & PACKET_SEQ_MASK
        return 0 < ahead < (1 << (PACKET_SEQ_BITS - 1))

    def _try_fec_recover(self, n: int) -> None:
        """Recover single missing subpackets per XOR stripe (layout in
        packetize's docstring)."""
        h = self._hdr
        if h is None or h.num_fec_blocks == 0:
            return
        E, O = h.num_xor_blocks_even, h.num_xor_blocks_odd
        stripes = {}
        for i in range(n):
            if i % 2 == 0 and E:
                stripes.setdefault((i // 2) % E, []).append(i)
            elif i % 2 == 1 and O:
                stripes.setdefault(E + (i // 2) % O, []).append(i)
        for j, members in stripes.items():
            if j not in self._fec:
                continue
            missing = [i for i in members if i not in self._parts]
            if len(missing) != 1:
                continue
            acc = bytearray(self._fec[j])
            for i in members:
                if i != missing[0]:
                    _xor_into(acc, self._parts[i])
            i = missing[0]
            if i == n - 1:
                tail = h.payload_size - i * PYRO_MAX_PAYLOAD_SIZE
                self._parts[i] = bytes(acc[:tail])
            else:
                self._parts[i] = bytes(acc[:PYRO_MAX_PAYLOAD_SIZE])
            self.total_recovered_packets += 1

    def _complete(self) -> Optional[bytes]:
        if self._cur_seq < 0 or not self._parts:
            return None
        h = self._hdr
        n = max(self._parts) + 1
        if h is not None and h.payload_size:
            n = max(1, (h.payload_size + PYRO_MAX_PAYLOAD_SIZE - 1)
                    // PYRO_MAX_PAYLOAD_SIZE)
        if any(i not in self._parts for i in range(n)):
            self._try_fec_recover(n)
        if any(i not in self._parts for i in range(n)):
            self.total_dropped_video_packets += 1
            return None
        if self._key:
            self.total_received_key_frames += 1
        out = b"".join(self._parts[i] for i in range(n))
        self._parts = {}
        self._fec = {}
        return out

    def progress_report(self) -> bytes:
        return struct.pack("<QQQQQ", self.total_received_packets, 0,
                           self.total_dropped_video_packets, 0,
                           self.total_received_key_frames)


class PyroServer:
    """Minimal pyro server: TCP handshake + UDP frame streaming
    (video/pyro_server.cpp flow)."""

    def __init__(self, codec: CodecParameters, host="127.0.0.1"):
        self.codec = codec
        self._tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._tcp.bind((host, 0))
        self._tcp.listen(1)
        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp.bind((host, 0))
        self.tcp_port = self._tcp.getsockname()[1]
        self.udp_port = self._udp.getsockname()[1]
        self._cookie = 0xC0FFEE0012345678
        self._client_addr = None
        self._packet_seq = 0
        self._thread = None

    def serve_handshake(self) -> None:
        """Handle one client handshake on a background thread."""
        def run():
            try:
                conn, _ = self._tcp.accept()
            except OSError:             # close() shut the listener down
                return
            with conn:
                while True:
                    hdr = conn.recv(4)
                    if len(hdr) < 4:
                        return
                    (mtype,) = struct.unpack("<I", hdr)
                    if not validate_magic(mtype):
                        conn.sendall(struct.pack("<I", MSG_NAK))
                        return
                    body = conn.recv(message_length(mtype)) \
                        if message_length(mtype) else b""
                    if mtype == MSG_HELLO:
                        conn.sendall(struct.pack("<IQ", MSG_COOKIE,
                                                 self._cookie))
                        # wait for the UDP cookie ack
                        data, addr = self._udp.recvfrom(64)
                        if len(data) >= 8 and struct.unpack(
                                "<Q", data[:8])[0] == self._cookie:
                            self._client_addr = addr
                    elif mtype == MSG_KICK:
                        if self._client_addr is None:
                            conn.sendall(struct.pack("<I", MSG_NAK))
                        else:
                            conn.sendall(struct.pack(
                                "<I", MSG_CODEC_PARAMETERS)
                                + self.codec.pack())
                            return
                    elif mtype == MSG_PROGRESS:
                        pass
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def send_frame(self, frame: bytes, key_frame: bool = False,
                   pts: int = 0, xor_blocks_even: int = 0,
                   xor_blocks_odd: int = 0) -> None:
        assert self._client_addr is not None
        for dg in packetize(frame, self._packet_seq, key_frame, pts=pts,
                            xor_blocks_even=xor_blocks_even,
                            xor_blocks_odd=xor_blocks_odd):
            self._udp.sendto(dg, self._client_addr)
        self._packet_seq = (self._packet_seq + 1) & PACKET_SEQ_MASK

    def close(self):
        try:
            self._tcp.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._tcp.close()
        self._udp.close()


class PyroClient:
    def __init__(self, host: str, tcp_port: int, udp_port: int):
        self._tcp = socket.create_connection((host, tcp_port), timeout=5)
        self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp.bind((host, 0))
        self._server_udp = (host, udp_port)
        self.reassembler = Reassembler()
        self.codec: Optional[CodecParameters] = None

    def handshake(self) -> CodecParameters:
        self._tcp.sendall(struct.pack("<I", MSG_HELLO))
        hdr = self._tcp.recv(4)
        (mtype,) = struct.unpack("<I", hdr)
        assert mtype == MSG_COOKIE, hex(mtype)
        (cookie,) = struct.unpack("<Q", self._tcp.recv(8))
        self._udp.sendto(struct.pack("<Q", cookie), self._server_udp)
        self._tcp.sendall(struct.pack("<II", MSG_KICK, KICK_VIDEO_BIT))
        (mtype,) = struct.unpack("<I", self._tcp.recv(4))
        assert mtype == MSG_CODEC_PARAMETERS, hex(mtype)
        self.codec = CodecParameters.unpack(self._tcp.recv(64))
        return self.codec

    def recv_frame(self, timeout: float = 2.0) -> Optional[bytes]:
        self._udp.settimeout(timeout)
        while True:
            data, _ = self._udp.recvfrom(
                PYRO_MAX_PAYLOAD_SIZE + PayloadHeader.SIZE)
            frame = self.reassembler.feed(data)
            if frame is not None:
                return frame

    def close(self):
        self._tcp.close()
        self._udp.close()
