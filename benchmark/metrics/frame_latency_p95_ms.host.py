"""95th percentile over the window of card completion minus the host
time of the frame's render_frame call, where the card is idle most of
the time and the tail is the host's."""

from gbench.timing import p95


def read(run):
    return p95(run["latencies_ms"])
