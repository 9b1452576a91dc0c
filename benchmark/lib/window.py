"""The arithmetic of a measured window, kept apart from the card so that it
is tested on synthetic timings.

Times are seconds on the host's ``time.perf_counter`` clock.  A device
event's time reaches that clock through one anchor: an event recorded on
an idle card right after a synchronize, read at the host time ``t0``;
event ``e`` then completed at ``t0 + anchor.elapsed_time(e) / 1000``."""


def rate(count, start, end):
    """Work a second: ``count`` over the window ``[start, end]``."""
    if end <= start:
        raise ValueError('empty window [%r, %r]' % (start, end))
    return count / (end - start)


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted, disjoint
    intervals (overlapping and touching ones joined)."""
    out = []
    for s, e in sorted(intervals):
        if e < s:
            raise ValueError('interval ends before it starts: %r' % ((s, e),))
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals, start=None, end=None):
    """The length of the union of ``intervals``, clipped to ``[start,
    end]`` when given: overlapping kernels count once."""
    total = 0.0
    for s, e in merged(intervals):
        if start is not None:
            s = max(s, start)
        if end is not None:
            e = min(e, end)
        total += max(0.0, e - s)
    return total


def idle_gaps(intervals, start, end):
    """The ``(start, end)`` stretches of ``[start, end]`` that no interval
    covers, in order."""
    out, at = [], start
    for s, e in merged(intervals):
        if s > at:
            out.append((at, min(s, end)))
        at = max(at, e)
        if at >= end:
            break
    if at < end:
        out.append((at, end))
    return [(s, e) for s, e in out if e > s]


def idle_share(intervals, start, end):
    """The share of ``[start, end]`` with no interval running."""
    return 1.0 - busy_seconds(intervals, start, end) / (end - start)
