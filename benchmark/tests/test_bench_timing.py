"""The end-to-end arithmetic on synthetic completion times (the rate over
the whole window and the 95th percentile over all frames), and the
kernel readers' trust in a trace."""

import pytest

from gbench import timing


def test_frame_ms_is_window_over_frames():
    done = [10.0 * (i + 1) for i in range(100)]
    assert timing.frame_ms(done) == pytest.approx(10.0)
    # a stall anywhere counts in full
    done2 = done[:50] + [t + 500.0 for t in done[50:]]
    assert timing.frame_ms(done2) == pytest.approx(15.0)


def test_intervals_start_at_the_window():
    assert timing.intervals_ms([4.0, 9.0, 15.0]) == [4.0, 5.0, 6.0]


def test_p95_over_all_frames_moves_with_stalls():
    done = [10.0 * (i + 1) for i in range(200)]
    steady = timing.p95(timing.intervals_ms(done))
    assert steady == pytest.approx(10.0)
    stalled = list(done)
    for k in range(0, 200, 10):      # a 40 ms stall every tenth frame
        stalled[k:] = [t + 40.0 for t in stalled[k:]]
    assert timing.p95(timing.intervals_ms(stalled)) == pytest.approx(50.0)


def test_latency_is_card_completion_minus_call():
    done = [12.0, 30.0, 41.0]
    calls = [0.001, 0.012, 0.025]
    assert timing.latencies_ms(done, calls) == pytest.approx(
        [11.0, 18.0, 16.0])


def test_kernel_readers_report_nothing_from_a_disagreeing_trace():
    """A trace whose card time disagrees with the card-only trace's
    (device_ok False) gives no kernel share and no pass range."""
    import run as R
    trace = {"device_ok": True, "ranges_ms": {"pass:lighting": 6.0},
             "device": [(0.0, 100.0, "shade_fused_kernel"),
                        (200.0, 300.0, "shade_fused_kernel")]}
    reading = {"trace": trace, "b4_bound_ms": 0.05}
    assert R.reader("B4_roofline")(reading) == 50.0
    assert R.reader("pass_ms.lighting")(reading) == 6.0
    trace["device_ok"] = False
    assert R.reader("B4_roofline")(reading) is None
    assert R.reader("pass_ms.lighting")(reading) is None
