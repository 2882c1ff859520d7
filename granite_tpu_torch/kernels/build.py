"""Build, load and launch the port's CUDA kernels.

All kernels live in `granite_tpu_torch/csrc/*.cu`, each with a plain C
entry point that returns `cudaGetLastError()`.  At first use they are
compiled by nvcc for Hopper (`sm_90a`), one nvcc process per source, all
started together, and linked into ONE shared library under the
repository's gitignored `build/` directory, bound with ctypes (no
PyTorch headers: the build takes seconds, not minutes).  The library
name carries a hash of the sources and flags, so an edited kernel is
rebuilt rather than reused.  The build holds an exclusive file lock
(`fcntl.flock` on `<library>.lock`): several processes that start on a
fresh build directory (the ranks of `granite_tpu_torch.parallel`) would
otherwise write, link and delete each other's object files, which are
named after the library.  The first builds; the others wait for it and
find the library.

`build_variant` builds one source with extra `-D` defines into a library
of its own, under the same flags (the compile probe,
granite_tpu_torch/tools/compile_parallel_probe.py, times such builds).

Every wrapper counts its launches in `LAUNCHES` (a plain int per
kernel, incremented only where the kernel is launched), so a run can
show that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import re
import subprocess
from pathlib import Path

import torch

from ..core.device import nvcc_path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "granite_tpu_torch"

# --fmad=false: the raster edge/z terms must round like the reference's
# separate multiply and add (a*(px-ex) + b*(py-ey) + c); a contracted
# FMA flips coverage of pixels on shared edges.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-lineinfo", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes (every pointer and the stream as c_void_p).
SIGNATURES = {
    # B1: items, n_items, packets, huge_rows, scratch, depth, tri,
    #     tiles_x, tiles_y, n_window, stride, stream
    "granite_raster_binned": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _P),
    # B2: items, n_items, packets, huge_rows, scratch, planes, tiles_x,
    #     tiles_y, n_window, stride, has_prev, stream
    "granite_raster_resolve": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P),
    # B3: strip, half, n_bundles, rows, size, channels, bundle, u, v, lod,
    #     width, row strides of bundle, u, v, lod, out, n_pixels, levels,
    #     stream
    "granite_sample_lod": (_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _L,
                           _L, _L, _L, _L, _P, _L, _I, _P),
    # B3T: img, h, w, channels, u, v, live, out, n_pixels, stream
    "granite_sample_bilinear": (_P, _I, _I, _I, _P, _P, _P, _P, _I, _P),
    # B4: planes, n_planes, ph, pw, lights, n_light_cap, tile_masks,
    #     tm_w, uniforms, k_shadow, has_env, has_lights, has_ao, ambient,
    #     out, stream
    "granite_shade_fused": (_P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                            _I, _I, _P, _P),
    # B5: x, out, n, n_iters, stream
    "granite_compile_probe": (_P, _P, _L, _I, _P),
}

LAUNCHES = {"B1": 0, "B2": 0, "B3": 0, "B3T": 0, "B4": 0, "B5": 0}

_library = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libgranite_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library (no-op when the library
    for these exact sources exists).  Raises on any compiler error."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (PATH, CUDA_HOME, /usr/local/cuda)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_name(out.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():        # another process built it meanwhile
            _compile_and_link(nvcc, out)
    return out


def _compile_and_link(nvcc: str, out: Path) -> None:
    """One nvcc a source, all started together, then the link into a
    temporary name renamed over `out` (atomic for readers that do not
    take the lock).  Called with build()'s lock held."""
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in _sources()]
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in jobs]
    failed = []
    for cmd, proc in procs:          # wait for every job before raising
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out.with_name(out.name + ".tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
           *[str(o) for o in objs]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    tmp.replace(out)
    for obj in objs:
        obj.unlink()


def variant_command(nvcc: str, src: Path, defines: dict, out: Path) -> list:
    """The nvcc command that builds one source, with `-D` defines, into a
    shared library of its own under the main library's NVCC_FLAGS."""
    flags = [f"-D{k}={v}" for k, v in sorted(defines.items())]
    return [nvcc, *NVCC_FLAGS, *flags, "-shared", "-o", str(out), str(src)]


def build_variant(src: Path, defines: dict, out: Path) -> Path:
    """Build `src` with extra `-D` defines into the shared library `out`
    (one nvcc process; rebuilt every call).  Raises on a compiler error.
    The main library keeps its own one-nvcc-per-source build (build())."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (PATH, CUDA_HOME, /usr/local/cuda)")
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = variant_command(nvcc, src, defines, out)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return out


def library() -> ctypes.CDLL:
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _library = lib
    return _library


def drop_library() -> None:
    """Forget the loaded library: the next launch builds (or finds) the
    library of the sources as they are now, under its own hash.  The
    viewer's GRANITE_WATCH_KERNELS calls this when a csrc file changes."""
    global _library
    _library = None


def launch(kernel_id: str, entry: str, *args) -> None:
    """Call a kernel's C entry point on the current stream; raise on a
    non-zero cudaError.  Counts the launch under `kernel_id`."""
    fn = getattr(library(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed to launch: cudaError {err}")
    LAUNCHES[kernel_id] += 1


def kernel_attributes(entry: str, variant: int = 0) -> dict:
    """What the compiler gave one kernel (cudaFuncGetAttributes): registers
    and local (spill) bytes a thread, static shared bytes a block.
    `entry` is a kernel source's `granite_attrs_*` C entry point
    (int variant, int out[4])."""
    fn = getattr(library(), entry)
    fn.argtypes = [_I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(variant, out)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "static_shared_bytes": out[2], "max_threads": out[3]}


def parse_sass_counts(sass: str, ops=("FMUL", "FADD", "FFMA")) -> dict:
    """`cuobjdump -sass` text -> {mangled kernel name: {op: count}}: each
    function's instructions whose opcode (modifiers after a dot aside)
    is one of `ops`, predicated or not."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(ops, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if name and m and m.group(1) in counts[name]:
            counts[name][m.group(1)] += 1
    return counts


def sass_counts(lib: Path, ops=("FMUL", "FADD", "FFMA")) -> dict:
    """parse_sass_counts of a built library's SASS (cuobjdump from the
    CUDA toolkit that holds nvcc).  Raises when it cannot be read."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: no cuobjdump beside it")
    cmd = [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    return parse_sass_counts(proc.stdout, ops)


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, dtype, device: torch.device,
          ndim: int | None = None) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor on `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-D, expected {ndim}-D")
