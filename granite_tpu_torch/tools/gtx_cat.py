"""GTPX container inspector (port of tools/gtx_cat.py; reference:
tools/gtx_cat.cpp, which prints the header of a .gtx archive; GTPX is
this engine's byte-stable equivalent container).

  python -m granite_tpu_torch.tools.gtx_cat file.gtpx [file2.gtpx ...]
"""

from __future__ import annotations

import sys


def block_bytes(fmt: str) -> tuple[int, int, int]:
    """(block_w, block_h, bytes_per_block); rgba8 reports per-pixel."""
    if fmt == "rgba8":
        return 1, 1, 4
    if fmt.startswith("astc_"):
        w, h = (int(t) for t in fmt[5:].split("x"))
        return w, h, 16
    eight = {"bc1", "bc4", "etc2", "eac_r11"}
    return 4, 4, (8 if fmt in eight else 16)


def level_size(fmt: str, w: int, h: int) -> int:
    bw, bh, nb = block_bytes(fmt)
    return (-(-w // bw)) * (-(-h // bh)) * nb


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print(__doc__)
        return 1
    from ..native.texture import gtpx_load
    for path in args:
        fmt, w, h, levels, flags, payload = gtpx_load(path)
        print(f"{path}: GTPX {fmt} {w}x{h} levels={levels} "
              f"flags={flags:#x} payload={len(payload)} bytes")
        lw, lh = w, h
        off = 0
        for lvl in range(levels):
            n = level_size(fmt, lw, lh)
            print(f"  level {lvl}: {lw}x{lh}  {n} bytes @ {off}")
            off += n
            lw = max(lw // 2, 1)
            lh = max(lh // 2, 1)
        if off != len(payload):
            print(f"  WARNING: computed {off} bytes != payload "
                  f"{len(payload)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
