"""The port's texture codec (granite_tpu_torch/native/texture_codec.cpp, a
copy of the texture half of granite_tpu/native/granite_native.cpp) held
against granite_tpu.native, and its use by the streaming instantiator.

Tolerances: none.  Decoded images and encoded blocks are byte-equal
(BC6H's float output compared as its bit patterns, NaN included): the
codec is the same C++.  A malformed sidecar falls back to the image with
a warning; a codec that does not build raises, in the bindings and
through the instantiator."""

import logging
import stat

import numpy as np
import pytest

from granite_tpu import native as JN
from granite_tpu_torch import native as TN
from granite_tpu_torch.assets.streaming import ImageInstantiator
from granite_tpu_torch.filesystem import AssetClass
from granite_tpu_torch.native import texture as TX
from granite_tpu_torch.ops.srgb import srgb_u8_to_linear_np

SEED = 31
W = H = 64
BLOCK_FORMATS = [f for f in TX.GTPX_FORMATS if f != "rgba8"]


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_formats_match_jax():
    assert TX.GTPX_FORMATS == JN.GTPX_FORMATS
    assert len([f for f in TX.GTPX_FORMATS if f.startswith("astc_")]) == 14


@pytest.mark.parametrize("fmt", BLOCK_FORMATS)
def test_decoder_matches_jax(fmt):
    """Random blocks (every mode bit pattern the generator hits, reserved
    and error blocks included) decode byte-equal at 64x64, which leaves
    partial blocks for the 5-, 6-, 10- and 12-texel ASTC footprints."""
    rng = np.random.default_rng([SEED, BLOCK_FORMATS.index(fmt)])
    data = rng.integers(0, 256, TX.payload_bytes(fmt, W, H), dtype=np.uint8)
    if fmt in ("bc6h", "bc6h_s"):
        signed = fmt == "bc6h_s"
        got = TX.decode_bc6h(data, W, H, signed=signed)
        want = JN.decode_bc6h(data, W, H, signed=signed)
    else:
        got = TX.decode_blocks(fmt, data, W, H)
        want = JN.decode_blocks(fmt, data, W, H)
    assert _same_bits(got, want)


def test_decoders_refuse_short_payloads():
    """The port's bindings check the payload before the native call (the
    JAX bindings read past a short one)."""
    with pytest.raises(ValueError):
        TX.decode_blocks("bc7", np.zeros(TX.payload_bytes("bc7", W, H) - 1,
                                         np.uint8), W, H)
    with pytest.raises(ValueError):
        TX.decode_bc6h(np.zeros(16, np.uint8), 8, 4)
    with pytest.raises(ValueError):
        TX.decode_blocks("bc6h", np.zeros(16, np.uint8), 4, 4)


@pytest.mark.parametrize("shape", [(64, 64), (37, 53)])
@pytest.mark.parametrize("name", ["bc1", "bc3", "bc4", "bc5", "bc7", "bc6h"])
def test_encoder_matches_jax(name, shape):
    rng = np.random.default_rng([SEED, len(name), shape[0]])
    img = rng.integers(0, 256, (*shape, 4), dtype=np.uint8)
    if name == "bc6h":
        hdr = srgb_u8_to_linear_np(img)[..., :3] * 6.0
        hdr[::5, ::3, 1] *= -1.0          # negatives clamp to 0
        got, want = TX.encode_bc6h(hdr), JN.encode_bc6h(hdr)
    else:
        got = getattr(TX, f"encode_{name}")(img)
        want = getattr(JN, f"encode_{name}")(img)
    assert _same_bits(got, want)
    decoded = TX.decode_bc6h(got, shape[1], shape[0]) if name == "bc6h" \
        else TX.decode_blocks(name, got, shape[1], shape[0])
    assert decoded.shape[:2] == shape


@pytest.mark.parametrize("fmt", ["rgba8", "bc1", "bc6h_s", "astc_12x12"])
def test_gtpx_header_round_trips(tmp_path, fmt):
    """A file the port writes reads back through both packages, and one
    the JAX package writes through the port, fields and payload equal."""
    payload = bytes(range(256)) * 3
    ours, theirs = str(tmp_path / "a.gtpx"), str(tmp_path / "b.gtpx")
    TX.gtpx_save(ours, payload, fmt, 1024, 512, levels=3, flags=5)
    JN.gtpx_save(theirs, payload, fmt, 1024, 512, levels=3, flags=5)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    want = (fmt, 1024, 512, 3, 5, payload)
    assert TX.gtpx_load(ours) == want
    assert JN.gtpx_load(ours) == want
    assert TX.gtpx_load(theirs) == want


def _instantiator(tmp_path, img):
    png = str(tmp_path / "img.png")
    return ImageInstantiator([img], [True], [png], 16), png


def _write_malformed(path: str, img: np.ndarray, case: str) -> None:
    if case == "bad magic":
        TX.gtpx_save(path, TX.encode_bc7(img).tobytes(), "bc7", 32, 32)
        data = bytearray(open(path, "rb").read())
        data[0:4] = b"XTPG"
    elif case == "truncated header":
        data = b"GTPX"
    elif case == "short payload":        # a valid header, 1/16 the blocks
        TX.gtpx_save(path, TX.encode_bc7(img).tobytes()[:256], "bc7", 32,
                     32)
        return
    elif case == "unknown format":
        TX.gtpx_save(path, b"", "bc1", 32, 32)
        data = bytearray(open(path, "rb").read())
        data[8:12] = (99).to_bytes(4, "little")      # the format field
    else:                                # rgba8 one texel short
        TX.gtpx_save(path, img.tobytes()[:-4], "rgba8", 32, 32)
        return
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize("case", ["bad magic", "truncated header",
                                  "short payload", "unknown format",
                                  "rgba8 size"])
def test_malformed_sidecar_falls_back_with_a_warning(tmp_path, caplog, case):
    """The image's own decode, bit-equal, and a warning naming the
    sidecar malformed."""
    rng = np.random.default_rng(SEED)
    img = rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
    inst, png = _instantiator(tmp_path, img)
    want, cost = ImageInstantiator([img], [True], [None], 16).instantiate(
        "img://0", AssetClass.COLOR)
    _write_malformed(png + ".gtpx", img, case)
    with caplog.at_level(logging.WARNING, logger="granite_tpu_torch"):
        got, got_cost = inst.instantiate("img://0", AssetClass.COLOR)
    assert np.array_equal(got, want) and got_cost == cost
    assert any("malformed" in r.getMessage() for r in caplog.records)


def _fake_compiler(tmp_path) -> str:
    gxx = tmp_path / "g++"
    gxx.write_text("#!/bin/sh\necho 'broken compiler' >&2\nexit 1\n")
    gxx.chmod(gxx.stat().st_mode | stat.S_IEXEC)
    return str(gxx)


@pytest.mark.parametrize("compiler", ["fails", "missing"])
def test_broken_compiler_raises(tmp_path, monkeypatch, compiler):
    """With no usable g++ the codec raises at first use, in the bindings
    and through a sidecar's decode (no silent fallback to the image)."""
    gxx = _fake_compiler(tmp_path) if compiler == "fails" \
        else str(tmp_path / "no-such-g++")
    monkeypatch.setattr(TN, "GXX", gxx)
    monkeypatch.setattr(TX, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(TX, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TX.build()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TX.decode_blocks("bc1", np.zeros(8, np.uint8), 4, 4)
    img = np.zeros((8, 8, 4), np.uint8)
    inst, png = _instantiator(tmp_path, img)
    with open(png + ".gtpx", "wb") as f:
        f.write(b"GTPX")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        inst.instantiate("img://0", AssetClass.COLOR)
    assert not list((tmp_path / "build").glob("*.so"))
