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
of (256, 256) differing, and 2.09e-7 at (384, 256).  No nvcc here: the probe's build command is checked as assembled,
and a build without nvcc must raise."""

import functools
import importlib.util
import os

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


@pytest.mark.parametrize("n_iters", [96, 97])
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
