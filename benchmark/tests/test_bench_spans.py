"""The readers of the lighting pass's stage ranges on synthetic traces, and
the trace's split of device work from the program's named ranges: the
stage ranges the program opens inside a pass are kept out of the card's
busy time, the kernels and copies of the cells' traces are not."""

import pytest

from gbench.trace import _named

STAGE_READERS = {
    "pass_ms.lighting.sun_shadow": "pass:lighting/light.sun_shadow",
    "pass_ms.lighting.point_shadows": "pass:lighting/light.point_shadows",
}
# The kernels that took the most card time in the cells' traced frames
# (names cut to 64 characters as a run's breakdown keeps them), and the
# port's own kernels and copies.
DEVICE_WORK = (
    "void_at::native::vectorized_gather_kernel_16__long__char___char_",
    "void_at::native::_anonymous_namespace_::CatArrayBatchedCopy_alig",
    "void_at::native::elementwise_kernel_128__2__at::native::gpu_kern",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::CU",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::Bi",
    "std::enable_if_true__void_::type_internal::gemvx::kernel_int__in",
    "void_at::native::_anonymous_namespace_::CatArrayBatchedCopy_at::",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::AU",
    "raster_walk_kernel", "raster_fused_resolve_kernel",
    "sample_lod_kernel<half, 12>", "shade_fused_kernel",
    "Memcpy HtoD (Pageable -> Device)", "Memcpy DtoH (Device -> Pinned)",
    "Memset (Device)",
)


@pytest.mark.parametrize("metric", sorted(STAGE_READERS))
def test_stage_readers(metric):
    """A number from a trace that holds the range, nothing where the range
    is missing (a program that opens none) or the trace's card times
    disagree."""
    import run as R
    read = R.reader(metric)
    trace = {"device_ok": True,
             "ranges_ms": {"pass:lighting": 23.5,
                           STAGE_READERS[metric]: 4.25}}
    assert read({"trace": trace}) == 4.25
    assert read({"trace": {"device_ok": True,
                           "ranges_ms": {"pass:lighting": 23.5}}}) is None
    trace["device_ok"] = False
    assert read({"trace": trace}) is None


def test_stage_ranges_are_not_device_work():
    """The ranges the program opens with a device-side annotation (the
    passes, their stages and readbacks, decals) are named; the kernels
    and copies are device work."""
    for name in ("pass:lighting", "pass:lighting/light.sun_shadow",
                 "pass:forward/raster.bin",
                 "pass:gbuffer/readback.bin.huge_dst", "decals",
                 "bench:render_frame"):
        assert _named(name), name
    for name in DEVICE_WORK:
        assert not _named(name), name
