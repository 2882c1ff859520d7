"""Share of a frame in which no kernel, copy or set runs on the card, in
percent: 1 - the card's busy ms a frame (the union of their intervals in
the card-only trace, which records no host event, over its frames) / the
untraced window's frame_ms.  The traced frames themselves run slower on
the host, so their own window would read the card idler than it is."""

from gbench.timing import frame_ms


def read(run):
    tr = run["trace"]
    busy_ms = 1e3 * tr["busy_s"] / tr["frames"]
    return 100.0 * (1.0 - busy_ms / frame_ms(run["done_ms"]))
