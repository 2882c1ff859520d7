"""The port's compile probe (granite_tpu_torch/tools/compile_parallel_probe)
and kernel B5's plain version held against the JAX probe's Pallas body,
run in interpret mode on the CPU.

tools/compile_parallel_probe.py has no package (tools/ has no
__init__.py), so it is loaded by path; its pallas_call takes no
interpret flag, so the test wraps jax.experimental.pallas.pallas_call
with interpret=True while it runs (_kernel_fn looks `pl` up when called).

Tolerance: 1e-6 relative.  XLA on the CPU contracts the multiply-add
into an FMA, the plain version rounds the two apart (as B5 does on the
card): measured 2.14e-7 relative at most, 21,996 of the 65,536 elements
of (256, 256) differing, and 2.09e-7 at (384, 256).  No nvcc here: the
probe's build command is checked as assembled, a build without nvcc
must raise, and B5's launch, its SASS count, its latency bound and
the card whose clock that bound reads are checked as source, text,
arithmetic and a faked nvidia-smi listing."""

import functools
import importlib.util
import os
import subprocess
import types

import numpy as np
import pytest
import torch

from granite_tpu_torch.kernels import build as K
from granite_tpu_torch.tools import compile_parallel_probe as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread a test process (several xdist workers share
    the cores; see tests/test_torch_ocean.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "compile_parallel_probe_jax",
        os.path.join(REPO, "tools", "compile_parallel_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_iters", sorted(P.PROBE_SHAPES))
def test_plain_body_matches_jax_probe(monkeypatch, n_iters):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    shape = P.PROBE_SHAPES[n_iters]
    x = np.random.default_rng(SEED).uniform(-2.0, 2.0, shape) \
        .astype(np.float32)
    want = np.asarray(_jax_probe()._kernel_fn(n_iters)(x))
    got = P.probe_body(torch.as_tensor(x), n_iters)       # CPU: plain
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert np.array_equal(P.probe_body_plain(torch.as_tensor(x),
                                             n_iters).numpy(), got.numpy())


def test_probe_shapes_follow_jax_probe():
    """The four builds and their shapes are the JAX probe's."""
    src = open(os.path.join(REPO, "tools",
                            "compile_parallel_probe.py")).read()
    for n, (rows, cols) in P.PROBE_SHAPES.items():
        assert f"_kernel_fn({n}), ({rows}, {cols})" in src
    assert P.SERIAL == (96, 97) and P.THREADED == (98, 99)
    assert P.OVERLAP_SHARE == 0.75 and "0.75 * serial" in src


def test_variant_build_command():
    out = P.variant_library(98)
    cmd = K.variant_command("nvcc", P.PROBE_SOURCE,
                            {"GRANITE_PROBE_N_ITERS": 98}, out)
    assert cmd[0] == "nvcc"
    assert cmd[1:1 + len(K.NVCC_FLAGS)] == list(K.NVCC_FLAGS)
    assert "-DGRANITE_PROBE_N_ITERS=98" in cmd
    assert cmd[-4:] == ["-shared", "-o", str(out), str(P.PROBE_SOURCE)]
    assert out.parent == K.BUILD_DIR / "compile_probe"
    assert P.PROBE_SOURCE.exists()
    src = P.PROBE_SOURCE.read_text()
    assert "#ifdef GRANITE_PROBE_N_ITERS" in src
    assert "__fmul_rn" in src and "__fadd_rn" in src


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(K, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        K.build_variant(P.PROBE_SOURCE, {"GRANITE_PROBE_N_ITERS": 96},
                        tmp_path / "lib.so")


def test_probe_body_rejects_other_devices():
    with pytest.raises(ValueError):
        P.probe_body(torch.zeros(4, device="meta"), 96)


def test_b5_launches_one_way():
    """One launch path: cudaLaunchKernelEx with programmatic stream
    serialization, the kernel waiting on the grid dependency before it
    reads x and triggering after its store; no <<<>>> launch, no switch."""
    src = P.PROBE_SOURCE.read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert code.count("cudaLaunchKernelEx(") == 1
    assert "<<<" not in code and "getenv" not in code
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in code
    assert "programmaticStreamSerializationAllowed = 1" in code
    body = code[code.index("compile_probe_kernel(const float"):
                code.index("template <int N>\nint launch_compile_probe")]
    assert (body.index("cudaGridDependencySynchronize()")
            < body.index("x[i]") < body.index("out[i] = acc")
            < body.index("cudaTriggerProgrammaticLaunchCompletion()"))


SASS = """
\t\tFunction : _ZN7granite20compile_probe_kernelILi96EEEvPKfPfx
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   FMUL R0, R2, 1.0001 ;    /* 0x000fe20000400000 */
        /*0020*/                   FADD R0, R0, 1 ;         /* 0x000fe20000000000 */
        /*0030*/              @!P0 FADD.FTZ R5, R0, 2 ;     /* 0x000fe20000000000 */
                                                            /* 0x000fc00000000000 */
\t\tFunction : _ZN7granite20compile_probe_kernelILi97EEEvPKfPfx
        /*0000*/                   FFMA R0, R2, R3, R4 ;    /* 0x000fe20000000000 */
        /*0010*/                   FMUL.RZ R0, R0, 2 ;      /* 0x000fe20000000000 */
"""


def test_parse_sass_counts():
    got = K.parse_sass_counts(SASS)
    assert got == {
        "_ZN7granite20compile_probe_kernelILi96EEEvPKfPfx":
            {"FMUL": 1, "FADD": 2, "FFMA": 0},
        "_ZN7granite20compile_probe_kernelILi97EEEvPKfPfx":
            {"FMUL": 1, "FADD": 0, "FFMA": 1}}
    assert K.parse_sass_counts(SASS, ("LDC",))[
        "_ZN7granite20compile_probe_kernelILi96EEEvPKfPfx"] == {"LDC": 1}


@pytest.mark.parametrize("n_iters,by,floor_us", [
    (96, "chain", 0.387879), (97, "issue", 0.570064),
    (98, "issue", 0.767922), (99, "issue", 0.969697)])
def test_latency_bound(n_iters, by, floor_us):
    """2N dependent instructions at 4 cycles, or 2N x numel over 132 SMs
    x 128 lanes, at 1980 MHz, whichever is longer; no launch term."""
    numel = P.PROBE_SHAPES[n_iters][0] * P.PROBE_SHAPES[n_iters][1]
    b = P.latency_bound(2 * n_iters, numel, 132, 1980.0)
    assert b["latency_bound_by"] == by
    assert b["chain_ms"] == pytest.approx(2 * n_iters * 4 / 1980e3)
    assert b["issue_ms"] == pytest.approx(
        2 * n_iters * numel / (132 * 128) / 1980e3)
    assert b["latency_bound_ms"] == pytest.approx(floor_us * 1e-3, abs=1e-8)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("uuid,want", [
    ("58a1c5e3-0000-1111", 1980.0), ("GPU-58A1C5E3-0000-1111", 1980.0),
    ("77777777-0000-1111", None)])
def test_sm_clock_is_torch_cards(monkeypatch, uuid, want):
    """The latency bound's clock is read from the nvidia-smi line whose
    UUID is torch's card 0, not from nvidia-smi's card 0."""
    S = _chip_smoke()
    listing = "GPU-0a0a0a0a-0000-1111, 1755\nGPU-58a1c5e3-0000-1111, 1980\n"
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid=uuid))
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: types.SimpleNamespace(stdout=listing))
    if want is None:
        with pytest.raises(S.SmokeFailure):
            S.sm_max_clock_mhz()
    else:
        assert S.sm_max_clock_mhz() == want
