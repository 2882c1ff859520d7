"""ctypes bindings for the port's texture codec (texture_codec.cpp, a copy of
the texture half of granite_tpu/native/granite_native.cpp), under the JAX
package's names: decode_blocks, decode_bc6h, encode_bc1/3/4/5/7/6h,
gtpx_save, gtpx_load and GTPX_FORMATS.

Built like the meshlet codec (native/__init__.py): g++ at first use into
build/granite_tpu_torch/ under a source-and-flags hash; a failed build
raises.  Unlike the original bindings, the decoders check that the
payload holds every block of the image before any native call, and
gtpx_load raises ValueError for an unknown format as for a bad header.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from ..kernels.build import BUILD_DIR
from . import compile_library

SOURCE = Path(__file__).resolve().with_name("texture_codec.cpp")

GTPX_FORMATS = {"rgba8": 0, "bc1": 1, "bc3": 3, "bc4": 4,
                "bc5": 5, "bc7": 7, "etc2": 8, "etc2a": 9,
                "etc2p": 10, "eac_r11": 11, "eac_rg11": 12,
                "bc6h": 13, "bc6h_s": 14}
# ASTC LDR, all 14 legal 2D footprints (texture_decoder.cpp:30-120).
ASTC_FOOTPRINTS = ((4, 4), (5, 4), (5, 5), (6, 5), (6, 6), (8, 5), (8, 6),
                   (8, 8), (10, 5), (10, 6), (10, 8), (10, 10), (12, 10),
                   (12, 12))
GTPX_FORMATS.update({f"astc_{w}x{h}": 16 + i
                     for i, (w, h) in enumerate(ASTC_FOOTPRINTS)})

# Bytes of one 4x4 block (ASTC: one block of its footprint).
_BLOCK_BYTES = {"bc1": 8, "bc3": 16, "bc4": 8, "bc5": 16, "bc7": 16,
                "etc2": 8, "etc2a": 16, "etc2p": 8, "eac_r11": 8,
                "eac_rg11": 16, "bc6h": 16, "bc6h_s": 16}

_lib = None


def build() -> Path:
    """Compile texture_codec.cpp (see native.compile_library)."""
    return compile_library(SOURCE, BUILD_DIR)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        c_int = ctypes.c_int
        for name in ("decode_bc1", "decode_bc3", "decode_bc4", "decode_bc5",
                     "decode_bc7", "encode_bc1", "encode_bc3", "encode_bc4",
                     "encode_bc5", "encode_bc7"):
            fn = getattr(lib, name)
            fn.argtypes = [u8p, u8p, c_int, c_int]
            fn.restype = None
        for name in ("decode_etc2", "decode_eac"):
            fn = getattr(lib, name)
            fn.argtypes = [u8p, u8p, c_int, c_int, c_int]
            fn.restype = None
        lib.decode_bc6h.argtypes = [u8p, f32p, c_int, c_int, c_int]
        lib.decode_bc6h.restype = None
        lib.encode_bc6h.argtypes = [f32p, u8p, c_int, c_int]
        lib.encode_bc6h.restype = None
        lib.decode_astc.argtypes = [u8p, u8p, c_int, c_int, c_int, c_int]
        lib.decode_astc.restype = None
        lib.gtpx_write_header.argtypes = [u8p] + [ctypes.c_uint32] * 5
        lib.gtpx_write_header.restype = c_int
        lib.gtpx_read_header.argtypes = [u8p, c_int] + [u32p] * 5
        lib.gtpx_read_header.restype = c_int
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def payload_bytes(fmt: str, width: int, height: int) -> int:
    """Bytes of one level of `fmt` at width x height (whole blocks)."""
    if fmt == "rgba8":
        return width * height * 4
    if fmt.startswith("astc_"):
        bw, bh = (int(t) for t in fmt[5:].split("x"))
        return -(-width // bw) * -(-height // bh) * 16
    return -(-width // 4) * -(-height // 4) * _BLOCK_BYTES[fmt]


def _payload(fmt: str, data, width: int, height: int) -> np.ndarray:
    if fmt not in GTPX_FORMATS or fmt == "rgba8":
        raise ValueError(f"not a block format: {fmt!r}")
    if width <= 0 or height <= 0:
        raise ValueError(f"bad size {width}x{height}")
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    need = payload_bytes(fmt, width, height)
    if data.size < need:
        raise ValueError(f"{fmt} payload of {data.size} bytes, "
                         f"{width}x{height} needs {need}")
    return data


def decode_blocks(fmt: str, data: np.ndarray, width: int,
                  height: int) -> np.ndarray:
    """Decode a block-compressed level to (H, W, 4) uint8.

    Formats: bc1/bc3/bc4/bc5/bc7, etc2 (RGB8), etc2a (RGB8A8),
    etc2p (punchthrough RGB8A1), eac_r11, eac_rg11, and astc_WxH for the
    14 legal 2D footprints (LDR profile: HDR blocks decode to the spec
    error color)."""
    if fmt in ("bc6h", "bc6h_s"):
        raise ValueError("BC6H decodes to float: use decode_bc6h")
    data = _payload(fmt, data, width, height)
    lib = get_lib()
    out = np.empty((height, width, 4), np.uint8)
    if fmt in ("etc2", "etc2a", "etc2p"):
        alpha_bits = {"etc2": 0, "etc2a": 8, "etc2p": 1}[fmt]
        lib.decode_etc2(_u8(data), _u8(out), width, height, alpha_bits)
    elif fmt in ("eac_r11", "eac_rg11"):
        lib.decode_eac(_u8(data), _u8(out), width, height,
                       1 if fmt == "eac_r11" else 2)
    elif fmt.startswith("astc_"):
        bw, bh = (int(t) for t in fmt[5:].split("x"))
        lib.decode_astc(_u8(data), _u8(out), width, height, bw, bh)
    else:
        getattr(lib, f"decode_{fmt}")(_u8(data), _u8(out), width, height)
    return out


def decode_bc6h(data: np.ndarray, width: int, height: int,
                signed: bool = False) -> np.ndarray:
    """Decode BC6H (UF16/SF16) to (H, W, 3) float32 linear HDR."""
    data = _payload("bc6h", data, width, height)
    lib = get_lib()
    out = np.empty((height, width, 3), np.float32)
    lib.decode_bc6h(_u8(data), _f32(out), width, height, 1 if signed else 0)
    return out


def _encode_bcn(rgba: np.ndarray, fn_name: str, block: int) -> np.ndarray:
    rgba = np.ascontiguousarray(rgba, np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"{fn_name}: (H, W, 4) uint8 expected, got "
                         f"{rgba.shape}")
    lib = get_lib()
    h, w = rgba.shape[:2]
    out = np.empty(((h + 3) // 4) * ((w + 3) // 4) * block, np.uint8)
    getattr(lib, fn_name)(_u8(rgba), _u8(out), w, h)
    return out


def encode_bc1(rgba: np.ndarray) -> np.ndarray:
    """RGBA -> BC1 (opaque four-colour blocks)."""
    return _encode_bcn(rgba, "encode_bc1", 8)


def encode_bc3(rgba: np.ndarray) -> np.ndarray:
    """RGBA -> BC3 (BC1 colour + BC4 alpha)."""
    return _encode_bcn(rgba, "encode_bc3", 16)


def encode_bc4(rgba: np.ndarray) -> np.ndarray:
    """R channel -> BC4/RGTC1."""
    return _encode_bcn(rgba, "encode_bc4", 8)


def encode_bc5(rgba: np.ndarray) -> np.ndarray:
    """RG channels -> BC5/RGTC2 (normal-map XY)."""
    return _encode_bcn(rgba, "encode_bc5", 16)


def encode_bc7(rgba: np.ndarray) -> np.ndarray:
    """RGBA -> BC7 (mode-6 single-subset encoder)."""
    return _encode_bcn(rgba, "encode_bc7", 16)


def encode_bc6h(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3+) float32 linear HDR -> BC6H UF16 (mode-3 10.10 encoder;
    negatives clamp to 0 per the unsigned profile)."""
    if rgb.ndim != 3 or rgb.shape[2] < 3:
        raise ValueError(f"encode_bc6h: (H, W, 3) float expected, got "
                         f"{rgb.shape}")
    rgb = np.ascontiguousarray(rgb[..., :3], np.float32)
    lib = get_lib()
    h, w = rgb.shape[:2]
    out = np.empty(((h + 3) // 4) * ((w + 3) // 4) * 16, np.uint8)
    lib.encode_bc6h(_f32(rgb), _u8(out), w, h)
    return out


def gtpx_save(path: str, payload: bytes, fmt: str, width: int, height: int,
              levels: int = 1, flags: int = 0) -> None:
    lib = get_lib()
    hdr = np.zeros(32, np.uint8)
    n = lib.gtpx_write_header(_u8(hdr), GTPX_FORMATS[fmt], width, height,
                              levels, flags)
    with open(path, "wb") as f:
        f.write(bytes(hdr[:n]))
        f.write(payload)


def gtpx_load(path: str):
    """-> (format_name, width, height, levels, flags, payload); raises
    ValueError for a bad header or an unknown format."""
    lib = get_lib()
    data = np.fromfile(path, np.uint8)
    fields = [ctypes.c_uint32() for _ in range(5)]
    n = lib.gtpx_read_header(_u8(data), len(data),
                             *(ctypes.byref(f) for f in fields))
    if n < 0:
        raise ValueError(f"bad GTPX file: {path} (rc={n})")
    fmt, w, h, levels, flags = (f.value for f in fields)
    names = {v: k for k, v in GTPX_FORMATS.items()}
    if fmt not in names:
        raise ValueError(f"bad GTPX file: {path} (format {fmt})")
    return names[fmt], w, h, levels, flags, bytes(data[n:])
