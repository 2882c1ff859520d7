"""The port's video player (granite_tpu_torch/app/video_player.py,
video_source.py) and the sRGB pieces it needs (ops/srgb.srgb_to_linear,
encode_rgba8's alpha), each against the JAX package on the same seeded
inputs: tests/test_video_player.py's two cases on the port; a 96x54
render of a seeded PNG sequence through both players, 4 frames (the
last one past the end of the stream) at >= 48 dB luma PSNR each; the
ffmpeg branch through a fake `ffmpeg` on a temporary PATH, byte-equal;
the entry point on the CPU, and without --device (cuda) raising here."""

import json
import logging
import os
import stat
import sys
import types

import imageio.v2 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import psnr
from granite_tpu.app.video_player import VideoPlayerApplication as JaxPlayer
from granite_tpu.app.video_source import VideoSource as JaxSource
from granite_tpu.ops import srgb as JS
from granite_tpu_torch.app import video_player as VP
from granite_tpu_torch.app.video_source import VideoSource
from granite_tpu_torch.ops import srgb as TS
from granite_tpu_torch.utils.image_io import load_image

PSNR_GATE_DB = 48.0
SEED = 11


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (the Tier-1 run's xdist workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_png_seq(d, n=3, size=32):
    """tests/test_video_player.py's sequence: frame i bright in channel
    i % 3 only."""
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        img = np.zeros((size, size, 4), np.uint8)
        img[..., i % 3] = 230
        img[..., 3] = 255
        iio.imwrite(os.path.join(d, f"f{i:04d}.png"), img)


def _write_seeded_seq(d, n=3, height=40, width=48):
    """n seeded RGBA frames of another size than the texture (so both
    players resize them nearest), with varying alpha."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(SEED)
    for i in range(n):
        img = rng.integers(0, 256, (height, width, 4), dtype=np.uint8)
        iio.imwrite(os.path.join(d, f"f{i:04d}.png"), img)


def test_video_player_quad_follows_stream(tmp_path):
    """Each rendered frame is dominated by the current video frame's
    colour; the stream advances and holds the last frame at EOS."""
    seq = str(tmp_path / "vid")
    _write_png_seq(seq, n=3)
    app = VP.VideoPlayerApplication(types.SimpleNamespace(
        video=seq, video_size=32), device="cpu")
    app.swapchain_updated(96, 54)
    expect_channel = [0, 1, 2, 2]      # EOS holds blue
    for i in range(4):
        out = app.render_frame(1 / 30, i / 30).numpy()
        rgb = out[..., :3].astype(np.float32)
        bright = rgb.max(-1) > 100
        assert bright.mean() > 0.15, bright.mean()
        dom = rgb[bright].argmax(-1)
        assert (dom == expect_channel[i]).mean() > 0.95, (i, dom[:8])
    assert app._frames_decoded == 3
    app.teardown()


def test_video_source_png_fallback_eos(tmp_path):
    seq = str(tmp_path / "vid2")
    _write_png_seq(seq, n=2, size=16)
    src = VideoSource(seq, 16, 16)
    assert src.read_frame() is not None
    assert src.read_frame() is not None
    assert src.read_frame() is None
    src.close()
    with pytest.raises(FileNotFoundError):
        VideoSource(str(tmp_path / "missing.mp4"), 16, 16)


def test_video_player_matches_jax(tmp_path):
    """96x54, video_size 32, 4 frames over a 3-frame seeded sequence of
    48x40 PNGs: every frame within 48 dB luma PSNR of the JAX player's,
    the same frames decoded, the same passes."""
    seq = str(tmp_path / "seeded")
    _write_seeded_seq(seq)
    args = types.SimpleNamespace(video=seq, video_size=32)
    jax_app = JaxPlayer(args)
    app = VP.VideoPlayerApplication(args, device="cpu")
    for a in (jax_app, app):
        a.swapchain_updated(96, 54)
    assert app.graph._order == ["screen", "blit"]
    for i in range(4):
        want = np.asarray(jax_app.render_frame(1 / 30, 0.8 * i))
        got = app.render_frame(1 / 30, 0.8 * i)
        assert got.dtype == torch.uint8 and got.shape == (54, 96, 4)
        p = psnr(got.numpy(), want)
        assert p >= PSNR_GATE_DB, (i, p)
    assert app._frames_decoded == jax_app._frames_decoded == 3


FAKE_FFMPEG = """#!{python}
import sys
args = sys.argv[1:]
w, h = (int(v) for v in args[args.index("-s") + 1].split("x"))
for i in range({frames}):
    sys.stdout.buffer.write(bytes((i * 7 + k * 13) % 256
                                  for k in range(w * h * 4)))
"""


def test_ffmpeg_branch_matches_jax(tmp_path, monkeypatch):
    """A video file with an `ffmpeg` on the PATH: both sources start it
    with the same rawvideo/rgba arguments and read the same frames, byte
    for byte, then None at the end of the stream."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "ffmpeg"
    fake.write_text(FAKE_FFMPEG.format(python=sys.executable, frames=3))
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", str(bin_dir) + os.pathsep
                       + os.environ.get("PATH", ""))
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"not decoded by the fake")
    got, want = VideoSource(str(clip), 6, 5), JaxSource(str(clip), 6, 5)
    assert got._proc is not None and want._proc is not None
    n = 0
    while True:
        a, b = got.read_frame(), want.read_frame()
        if a is None or b is None:
            assert a is None and b is None
            break
        assert a.shape == (5, 6, 4) and a.dtype == np.uint8
        assert a.tobytes() == b.tobytes()
        n += 1
    assert n == 3
    got.close()
    want.close()
    assert got._proc is None


def test_entry_point_on_the_cpu(tmp_path, caplog):
    """python -m granite_tpu_torch.app.video_player --device cpu writes its
    PNG and the stat JSON; teardown logs the frames decoded."""
    seq = str(tmp_path / "vid")
    _write_png_seq(seq, n=3)
    png, stat_path = tmp_path / "out.png", tmp_path / "stat.json"
    with caplog.at_level(logging.INFO, logger="granite_tpu_torch"):
        assert VP.main(["--video", seq, "--video-size", "32",
                        "--device", "cpu", "--width", "96", "--height",
                        "54", "--frames", "3", "--warmup-frames", "1",
                        "--time-step", "0.0333", "--png-path", str(png),
                        "--stat", str(stat_path)]) == 0
    img = load_image(str(png))
    assert img.shape == (54, 96, 4)
    doc = json.loads(stat_path.read_text())
    assert doc["gpu"] == "cpu" and doc["frames"] == 3
    # 1 warm-up + 3 timed frames of a 3-frame stream: the last is held
    assert "VideoPlayer: 3 frames decoded" in caplog.text


def test_entry_point_needs_video_and_a_card(tmp_path):
    """--video is required; without --device the player asks for cuda,
    which raises where there is no card (nothing falls back)."""
    with pytest.raises(SystemExit):
        VP.main(["--device", "cpu", "--frames", "1"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda does not raise")
    seq = str(tmp_path / "vid")
    _write_png_seq(seq, n=1)
    with pytest.raises(RuntimeError, match="cuda"):
        VP.main(["--video", seq, "--width", "32", "--height", "18"])


def _srgb_inputs(shape=(37, 23, 3)):
    """Seeded values in [-0.5, 1.5] (out of range included, no NaN)."""
    rng = np.random.default_rng(SEED)
    return rng.uniform(-0.5, 1.5, size=shape).astype(np.float32)


def test_srgb_to_linear_matches_jax():
    x = _srgb_inputs()
    got = TS.srgb_to_linear(torch.from_numpy(x)).numpy()
    want = np.asarray(JS.srgb_to_linear(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("alpha", ["none", "hw", "hw1"])
def test_encode_rgba8_alpha_matches_jax(alpha):
    x = _srgb_inputs()
    a = None if alpha == "none" else _srgb_inputs(
        (37, 23) if alpha == "hw" else (37, 23, 1))
    got = TS.encode_rgba8(torch.from_numpy(x), None if a is None
                          else torch.from_numpy(a)).numpy()
    want = np.asarray(JS.encode_rgba8(jnp.asarray(x), None if a is None
                                      else jnp.asarray(a)))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (37, 23, 4)
    assert np.array_equal(got, want)
