"""End-to-end arithmetic over one window's frames (pure functions of the
times, so the tests can feed them synthetic ones).

done_ms[i]: frame i's completion on the card, ms after the event recorded
at the window's synchronized start.  call_s[i]: the host clock when
render_frame was called for it, in seconds after that same start.
"""

from __future__ import annotations

import statistics


def p95(values) -> float:
    """The 95th percentile over all values (statistics.quantiles,
    'inclusive' method, as the contract's spreads are taken)."""
    vals = list(values)
    if len(vals) < 2:
        raise ValueError("a percentile needs at least two values")
    return statistics.quantiles(vals, n=20, method="inclusive")[18]


def frame_ms(done_ms) -> float:
    """Window ms (start to the last frame's completion) over the frames
    the card completed in it."""
    if not done_ms:
        raise ValueError("no frame completed")
    return done_ms[-1] / len(done_ms)


def intervals_ms(done_ms) -> list:
    """Between consecutive completions, the first from the start."""
    prev, out = 0.0, []
    for t in done_ms:
        out.append(t - prev)
        prev = t
    return out


def latencies_ms(done_ms, call_s) -> list:
    """Card completion minus the host time of the render_frame call."""
    return [d - 1e3 * c for d, c in zip(done_ms, call_s)]


def mean(values) -> float:
    vals = list(values)
    return sum(vals) / len(vals)
