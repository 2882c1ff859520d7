"""Audio backends (copy of granite_tpu/audio/backend.py, unchanged code;
reference: audio/audio_interface.hpp Backend +
WASAPI/Pulse/Oboe implementations).

No sound device exists in this environment, so the shipped backends
are: NullBackend (pull-driven, for tests and the app heartbeat) and
WavFileBackend (renders the mix to a .wav — the headless analogue of a
device sink, like the video module's file encoder).  Both drive the
Mixer through the same BackendCallback contract
(set_backend_parameters -> on_backend_start -> mix_samples pulls ->
on_backend_stop)."""

from __future__ import annotations

import wave

import numpy as np


class AudioBackend:
    def __init__(self, callback, sample_rate: float = 48000.0,
                 channels: int = 2, block_frames: int = 256):
        self.callback = callback
        self.sample_rate = sample_rate
        self.channels = channels
        self.block_frames = block_frames
        callback.set_backend_parameters(sample_rate, channels,
                                        block_frames)

    def start(self) -> None:
        self.callback.on_backend_start()

    def stop(self) -> None:
        self.callback.on_backend_stop()


class NullBackend(AudioBackend):
    """Pull the mix on demand (tests / headless heartbeat)."""

    def pull(self, frames: int) -> np.ndarray:
        out = np.zeros((self.channels, frames), np.float32)
        done = 0
        while done < frames:
            n = min(self.block_frames, frames - done)
            self.callback.mix_samples(out[:, done:done + n], n)
            done += n
        return out


class WavFileBackend(NullBackend):
    """Render the mix to a 16-bit stereo WAV file."""

    def __init__(self, path: str, callback,
                 sample_rate: float = 48000.0, channels: int = 2,
                 block_frames: int = 256):
        super().__init__(callback, sample_rate, channels, block_frames)
        self.path = path

    def render(self, seconds: float) -> None:
        frames = int(seconds * self.sample_rate)
        mix = self.pull(frames)
        pcm = np.clip(mix.T, -1.0, 1.0)
        pcm16 = (pcm * 32767.0).astype(np.int16)
        with wave.open(self.path, "wb") as w:
            w.setnchannels(self.channels)
            w.setsampwidth(2)
            w.setframerate(int(self.sample_rate))
            w.writeframes(pcm16.tobytes())
