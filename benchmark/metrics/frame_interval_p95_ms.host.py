"""95th percentile of the intervals between frames' completions on the
card over the window, where the card is idle most of the time and the
tail is the host's."""

from gbench.timing import p95


def read(run):
    return p95(run["intervals_ms"])
