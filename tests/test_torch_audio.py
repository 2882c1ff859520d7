"""The port's audio (granite_tpu_torch/audio) held equal to the JAX
package's: one seeded session of sine and WAV streams, gains, pans,
pause, play, kill and dispose drives both Mixers through NullBackend.pull
and mix_samples, and every block, stream id, state, play cursor,
generation and stream_stopped message must be equal (float32 blocks bit
for bit: tolerance 0).  Also sinc_resample and one_pole_filter on seeded
signals, and WavFileBackend renders byte-equal."""

import wave

import numpy as np
import pytest

from granite_tpu import audio as JA
from granite_tpu_torch import audio as TA
from granite_tpu_torch.audio import mixer as TM
from granite_tpu.audio import mixer as JM
from test_torch_ecs import time_limit

RNG_SEED = 29
RATE, BLOCK = 48000.0, 256
SESSION_OPS = 160
TEST_LIMIT_S = 30
PKGS = {"jax": JA, "torch": TA}
# (sample width, channels, rate) of the seeded WAV sources
WAVS = ((2, 1, 22050), (2, 2, 44100), (4, 1, 48000), (1, 2, 16000))


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(TEST_LIMIT_S):
        yield


def _write_wavs(directory, seed: int) -> list:
    rng = np.random.default_rng(seed)
    paths = []
    for k, (width, ch, rate) in enumerate(WAVS):
        n = int(rng.integers(2000, 9000))
        x = rng.uniform(-1, 1, (n, ch))
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        if width == 1:
            pcm = ((x + 1.0) * 127.5).astype(dtype)
        else:
            pcm = (x * (np.iinfo(dtype).max * 0.9)).astype(dtype)
        path = str(directory / f"src{k}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(ch)
            w.setsampwidth(width)
            w.setframerate(rate)
            w.writeframes(pcm.tobytes())
        paths.append(path)
    return paths


def _session(A, wavs: list, seed: int) -> list:
    """One seeded session on package A's Mixer; -> everything it saw."""
    rng = np.random.default_rng(seed)
    m = A.Mixer()
    be = A.NullBackend(m, sample_rate=RATE, block_frames=BLOCK)
    m.set_latency_usec(2500)
    be.start()
    log, ids = [], []
    for _ in range(SESSION_OPS):
        op = int(rng.integers(0, 10))
        sid = ids[int(rng.integers(0, len(ids)))] if ids else -1
        if op <= 1:
            if rng.integers(0, 2):
                dur = None if rng.integers(0, 3) == 0 else \
                    float(rng.uniform(0.002, 0.05))
                stream = A.SineStream(float(rng.uniform(50, 4000)), dur)
            else:
                stream = A.WavStream(wavs[int(rng.integers(0, len(wavs)))],
                                     looping=bool(rng.integers(0, 2)))
            sid = m.add_mixer_stream(
                stream, start_playing=bool(rng.integers(0, 4)),
                initial_gain_db=float(rng.uniform(-30, 6)),
                initial_panning=float(rng.uniform(-1.5, 1.5)))
            ids.append(sid)
            log.append(("add", sid))
        elif op == 2:
            m.set_stream_mixer_parameters(sid, float(rng.uniform(-40, 3)),
                                          float(rng.uniform(-1.2, 1.2)))
        elif op == 3:
            log.append(("pause", m.pause_stream(sid)))
        elif op == 4:
            log.append(("play", m.play_stream(sid)))
        elif op == 5:
            m.kill_stream(sid)
        elif op == 6:
            m.dispose_dead_streams()
        elif op == 7:
            # straight through the callback, onto a block that holds audio
            buf = rng.uniform(-0.1, 0.1, (2, BLOCK)).astype(np.float32)
            m.mix_samples(buf, int(rng.integers(1, BLOCK + 1)))
            log.append(("mix", buf))
        else:
            log.append(("pull", be.pull(int(rng.integers(1, 3 * BLOCK)))))
        log.append(("state", sid, m.get_stream_state(sid).name,
                    m.get_play_cursor(sid), A.Mixer.get_stream_index(sid)))
        q = m.get_message_queue()
        while not q.empty():
            log.append(("message", q.get_nowait()))
    be.stop()
    log.append(("slots", list(m._generation), m._active, m._paused,
                m._kill, m._cursor.copy(), m._gain.copy(), m._pan.copy()))
    return log


def _same(a, b, where="") -> None:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where          # tolerance 0
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("seed", [RNG_SEED, RNG_SEED + 1, RNG_SEED + 2])
def test_mixer_session_matches_jax(tmp_path, seed):
    wavs = _write_wavs(tmp_path, seed)
    got, want = _session(TA, wavs, seed), _session(JA, wavs, seed)
    _same(got, want, "session")
    kinds = {e[0] for e in got}
    assert {"add", "pull", "mix", "message", "pause", "play"} <= kinds
    loud = [e[1] for e in got if e[0] == "pull" and np.abs(e[1]).max() > 0]
    assert loud


def test_mixer_capacity_and_generations():
    """All MAX_SOURCES slots, the -1 of a full mixer, and a reused slot's
    next generation, on both."""
    out = []
    for A in (TA, JA):
        m = A.Mixer()
        A.NullBackend(m)
        ids = [m.add_mixer_stream(A.SineStream(100.0 + i))
               for i in range(TM.MAX_SOURCES)]
        full = m.add_mixer_stream(A.SineStream(9.0))
        m.kill_stream(ids[5])
        m.kill_stream(ids[77])
        m.dispose_dead_streams()
        again = [m.add_mixer_stream(A.SineStream(9.0)) for _ in range(3)]
        out.append((ids, full, again, m.get_stream_state(ids[5]).name))
    assert out[0] == out[1]
    assert out[0][1] == -1 and out[0][2][2] == -1
    assert (TM.MAX_SOURCES, TM.GENERATION_BITS) == \
        (JM.MAX_SOURCES, JM.GENERATION_BITS) == (128, 24)


def test_wav_render_byte_equal(tmp_path):
    """WavFileBackend.render of the same mix (sines, every WAV source,
    looping and not) through both packages: the files byte for byte; then
    each package's WavStream plays the other's file back, equal again."""
    wavs = _write_wavs(tmp_path, RNG_SEED)
    files = {}
    for name, A in PKGS.items():
        m = A.Mixer()
        path = str(tmp_path / f"mix_{name}.wav")
        be = A.WavFileBackend(path, m, sample_rate=RATE, block_frames=BLOCK)
        m.add_mixer_stream(A.SineStream(440.0, duration=0.03),
                           initial_gain_db=-6.0, initial_panning=-0.4)
        m.add_mixer_stream(A.SineStream(97.0), initial_gain_db=-12.0)
        for k, w in enumerate(wavs):
            m.add_mixer_stream(A.WavStream(w, looping=k % 2 == 1),
                               initial_gain_db=-9.0,
                               initial_panning=0.5 - 0.3 * k)
        be.render(0.25)
        files[name] = path
    data = {k: open(p, "rb").read() for k, p in files.items()}
    assert data["jax"] == data["torch"]
    with wave.open(files["torch"], "rb") as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                w.getnframes()) == (2, 2, int(RATE), int(0.25 * RATE))
    back = []
    for A, other in ((TA, "jax"), (JA, "torch")):
        m = A.Mixer()
        be = A.NullBackend(m, sample_rate=44100.0, block_frames=100)
        m.add_mixer_stream(A.WavStream(files[other]))
        back.append(be.pull(13000))
    _same(back[0], back[1], "playback")
    assert np.abs(back[0]).max() > 0.01


@pytest.mark.parametrize("src,dst,taps", [(48000.0, 32000.0, 16),
                                          (22050.0, 48000.0, 16),
                                          (44100.0, 44100.0, 8),
                                          (48000.0, 8000.0, 12)])
def test_sinc_resample_matches(src, dst, taps):
    rng = np.random.default_rng(RNG_SEED)
    for x in (rng.normal(size=1500).astype(np.float32),
              rng.uniform(-1, 1, (900, 2))):
        got = TA.sinc_resample(x, src, dst, taps)
        _same(got, JA.sinc_resample(x, src, dst, taps), f"{src}->{dst}")
        assert got.shape[0] == int(round(len(x) * dst / src))


def test_one_pole_filter_matches():
    rng = np.random.default_rng(RNG_SEED)
    for x, c in ((rng.normal(size=2000), 0.9),
                 (rng.normal(size=(700, 2)).astype(np.float32), 0.35),
                 (np.eye(64, dtype=np.float32)[0], 0.999)):
        _same(TA.one_pole_filter(x, c), JA.one_pole_filter(x, c), str(c))


def test_wav_stream_24_bit(tmp_path):
    """A 24-bit WAV: the JAX package's WavStream reads its bytes as 8-bit
    samples (three times as many, noise); the port decodes 24-bit PCM and
    plays what the 16-bit file of the same signal plays, within two
    16-bit steps (2/32768): the 16-bit file's rounding (half a step) and
    its 32767-in, 32768-out scale (0.8 of a step at amplitude 0.8)."""
    t = np.arange(4000)
    x = 0.8 * np.sin(2 * np.pi * 330.0 * t / 24000.0)
    v24 = np.round(x * 8388607).astype(np.int32)
    b = np.stack([(v24 >> s) & 0xFF for s in (0, 8, 16)], 1).astype(np.uint8)
    files = {}
    for width, raw in ((3, b.tobytes()),
                       (2, np.round(x * 32767).astype(np.int16).tobytes())):
        files[width] = str(tmp_path / f"tone{width}.wav")
        with wave.open(files[width], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(width)
            w.setframerate(24000)
            w.writeframes(raw)
    assert TA.WavStream(files[3])._data.shape == (2, 4000)
    assert JA.WavStream(files[3])._data.shape == (2, 12000)
    out = {}
    for width in (3, 2):
        m = TA.Mixer()
        be = TA.NullBackend(m, sample_rate=RATE, block_frames=BLOCK)
        m.add_mixer_stream(TA.WavStream(files[width]), initial_panning=-1.0)
        out[width] = be.pull(6000)
    assert np.abs(out[3] - out[2]).max() <= 2.0 / 32768.0
    assert np.abs(out[3][0]).max() > 0.7
