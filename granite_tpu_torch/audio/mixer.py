"""Audio mixer (copy of granite_tpu/audio/mixer.py; reference:
audio/audio_mixer.hpp:88-146 Mixer).  The code is the original's but for
one fault it fixes: the original's WavStream reads every sample width
other than 2 and 4 bytes as unsigned 8-bit, so a 24-bit WAV plays three
times too many samples of noise; this copy decodes 24-bit PCM
(tests/test_torch_audio.py).

Same API shape: fixed MaxSources slots with generation-counted
StreamIDs, an active bitmask consulted by the mix callback, atomic-in-
spirit parameter updates (a mutex stands in for the reference's
bitcast-atomics — Python has no audio-critical thread priority), gain
in dB, panning -1..1 (constant-power), play cursors, kill/dispose
garbage collection, and a message queue receiving stream-stopped
events for the main thread (the render-thread message flow the
reference routes through Util::LockFreeMessageQueue).

Streams implement MixerStream: setup(sample_rate, channels, max_frames)
+ accumulate_samples(buffers, gain_l, gain_r, frames) -> frames
written.  WavStream plays 16-bit/float PCM WAV (stb_vorbis has no
Python analogue in this environment; the vorbis role — compressed
streamed music — maps to WAV streaming with the same interface).
"""

from __future__ import annotations

import enum
import queue
import threading
import wave
from typing import Optional

import numpy as np

MAX_SOURCES = 128
GENERATION_BITS = 24


class StreamState(enum.Enum):
    Playing = 0
    Paused = 1
    Dead = 2


class MixerStream:
    """audio_mixer.hpp MixerStream interface."""

    def setup(self, sample_rate: float, channels: int,
              max_frames: int) -> None:
        pass

    def accumulate_samples(self, buffers: np.ndarray, gain_l: float,
                           gain_r: float, frames: int) -> int:
        """Mix up to `frames` into buffers (2, frames); returns frames
        actually written (< frames means the stream ended)."""
        raise NotImplementedError


class SineStream(MixerStream):
    """Test tone (the reference's audio_test oscillator role)."""

    def __init__(self, freq: float = 440.0,
                 duration: Optional[float] = None):
        self.freq = freq
        self.duration = duration
        self._rate = 48000.0
        self._phase = 0.0
        self._remaining = None

    def setup(self, sample_rate, channels, max_frames):
        self._rate = sample_rate
        if self.duration is not None:
            self._remaining = int(self.duration * sample_rate)

    def accumulate_samples(self, buffers, gain_l, gain_r, frames):
        n = frames if self._remaining is None else \
            min(frames, self._remaining)
        if n <= 0:
            return 0
        t = self._phase + np.arange(n)
        s = np.sin(2 * np.pi * self.freq * t / self._rate) \
            .astype(np.float32)
        buffers[0, :n] += s * gain_l
        buffers[1, :n] += s * gain_r
        self._phase += n
        if self._remaining is not None:
            self._remaining -= n
        return n


class WavStream(MixerStream):
    """PCM WAV playback with on-the-fly linear SRC + optional loop."""

    def __init__(self, path: str, looping: bool = False):
        with wave.open(path, "rb") as w:
            self._src_rate = w.getframerate()
            ch = w.getnchannels()
            raw = w.readframes(w.getnframes())
            sw = w.getsampwidth()
        if sw == 2:
            data = np.frombuffer(raw, np.int16).astype(np.float32) \
                / 32768.0
        elif sw == 4:
            data = np.frombuffer(raw, np.int32).astype(np.float32) \
                / 2147483648.0
        elif sw == 3:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            data = ((v << 8) >> 8).astype(np.float32) / 8388608.0
        else:
            data = np.frombuffer(raw, np.uint8).astype(np.float32) \
                / 127.5 - 1.0
        data = data.reshape(-1, ch)
        self._data = np.stack([data[:, 0],
                               data[:, min(1, ch - 1)]], axis=0)
        self.looping = looping
        self._pos = 0.0
        self._step = 1.0

    def setup(self, sample_rate, channels, max_frames):
        self._step = self._src_rate / sample_rate

    def accumulate_samples(self, buffers, gain_l, gain_r, frames):
        n_src = self._data.shape[1]
        t = self._pos + np.arange(frames) * self._step
        if self.looping:
            t = np.mod(t, n_src)
            n = frames
        else:
            valid = t < n_src - 1
            n = int(valid.sum())
            if n == 0:
                return 0
            t = t[:n]
        i0 = np.floor(t).astype(int)
        i1 = np.minimum(i0 + 1, n_src - 1)
        f = (t - i0).astype(np.float32)
        s = self._data[:, i0] * (1 - f) + self._data[:, i1] * f
        buffers[0, :n] += s[0] * gain_l
        buffers[1, :n] += s[1] * gain_r
        self._pos += n * self._step
        if self.looping:
            self._pos = float(np.mod(self._pos, n_src))
        return n


class Mixer:
    """audio_mixer.hpp:88 Mixer — slots + bitmask + mix callback."""

    def __init__(self):
        self._lock = threading.Lock()
        self._streams: list[Optional[MixerStream]] = \
            [None] * MAX_SOURCES
        self._generation = [0] * MAX_SOURCES
        self._active = 0            # bitmask (active_channel_mask)
        self._paused = 0
        self._kill = 0              # kill_channel_mask
        self._gain = np.ones(MAX_SOURCES, np.float32)
        self._pan = np.zeros(MAX_SOURCES, np.float32)
        self._cursor = np.zeros(MAX_SOURCES, np.float64)
        self._rate = 48000.0
        self._channels = 2
        self._max_frames = 256
        self._latency_usec = 0
        self.message_queue: "queue.Queue" = queue.Queue()

    # -- BackendCallback -------------------------------------------------
    def set_backend_parameters(self, sample_rate: float, channels: int,
                               max_frames: int) -> None:
        self._rate = sample_rate
        self._channels = channels
        self._max_frames = max_frames

    def set_latency_usec(self, usec: int) -> None:
        self._latency_usec = usec

    def on_backend_start(self) -> None:
        pass

    def on_backend_stop(self) -> None:
        pass

    # -- stream management (non-critical thread) -------------------------
    def add_mixer_stream(self, stream: MixerStream,
                         start_playing: bool = True,
                         initial_gain_db: float = 0.0,
                         initial_panning: float = 0.0) -> int:
        with self._lock:
            for i in range(MAX_SOURCES):
                if self._streams[i] is None:
                    stream.setup(self._rate, self._channels,
                                 self._max_frames)
                    self._streams[i] = stream
                    self._gain[i] = 10.0 ** (initial_gain_db / 20.0)
                    self._pan[i] = np.clip(initial_panning, -1.0, 1.0)
                    self._cursor[i] = 0.0
                    bit = 1 << i
                    self._active |= bit
                    if start_playing:
                        self._paused &= ~bit
                    else:
                        self._paused |= bit
                    return (self._generation[i] << GENERATION_BITS) | i
        return -1       # no vacant slot (the reference disposes too)

    @staticmethod
    def get_stream_index(stream_id: int) -> int:
        return stream_id & ((1 << GENERATION_BITS) - 1)

    def _check(self, stream_id: int) -> Optional[int]:
        if stream_id < 0:
            return None
        i = self.get_stream_index(stream_id)
        if i >= MAX_SOURCES or \
                (stream_id >> GENERATION_BITS) != self._generation[i] \
                or self._streams[i] is None:
            return None
        return i

    def kill_stream(self, stream_id: int) -> None:
        with self._lock:
            i = self._check(stream_id)
            if i is not None:
                self._kill |= (1 << i)

    def dispose_dead_streams(self) -> None:
        """Garbage collection from a non-critical thread."""
        with self._lock:
            kill = self._kill
            self._kill = 0
            for i in range(MAX_SOURCES):
                if kill & (1 << i) and self._streams[i] is not None:
                    self._streams[i] = None
                    self._generation[i] += 1
                    self._active &= ~(1 << i)

    def set_stream_mixer_parameters(self, stream_id: int, gain_db: float,
                                    panning: float) -> None:
        with self._lock:
            i = self._check(stream_id)
            if i is not None:
                self._gain[i] = 10.0 ** (gain_db / 20.0)
                self._pan[i] = np.clip(panning, -1.0, 1.0)

    def get_play_cursor(self, stream_id: int) -> float:
        with self._lock:
            i = self._check(stream_id)
            if i is None:
                return -1.0
            lat = self._latency_usec * 1e-6
            return max(self._cursor[i] / self._rate - lat, 0.0)

    def get_stream_state(self, stream_id: int) -> StreamState:
        with self._lock:
            i = self._check(stream_id)
            if i is None:
                return StreamState.Dead
            return StreamState.Paused if (self._paused & (1 << i)) \
                else StreamState.Playing

    def pause_stream(self, stream_id: int) -> bool:
        with self._lock:
            i = self._check(stream_id)
            if i is None:
                return False
            self._paused |= (1 << i)
            return True

    def play_stream(self, stream_id: int) -> bool:
        with self._lock:
            i = self._check(stream_id)
            if i is None:
                return False
            self._paused &= ~(1 << i)
            return True

    def get_message_queue(self) -> "queue.Queue":
        return self.message_queue

    # -- mix callback (critical thread) ----------------------------------
    def mix_samples(self, channels: np.ndarray, num_frames: int) -> None:
        """channels: (2, num_frames) f32, accumulated into in place."""
        with self._lock:
            mask = self._active & ~self._paused & ~self._kill
            scratch = np.zeros((2, num_frames), np.float32)
            for i in range(MAX_SOURCES):
                bit = 1 << i
                if not (mask & bit):
                    continue
                pan = float(self._pan[i])
                g = float(self._gain[i])
                gl = g * float(np.cos((pan + 1.0) * np.pi / 4.0))
                gr = g * float(np.sin((pan + 1.0) * np.pi / 4.0))
                scratch[:] = 0.0
                done = self._streams[i].accumulate_samples(
                    scratch, gl, gr, num_frames)
                channels[:, :done] += scratch[:, :done]
                self._cursor[i] += done
                if done < num_frames:
                    # stream ended: flag for disposal + notify main
                    self._kill |= bit
                    self.message_queue.put(
                        ("stream_stopped",
                         (self._generation[i] << GENERATION_BITS) | i))
