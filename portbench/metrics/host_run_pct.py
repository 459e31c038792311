"""The host thread's share of the wall it ran on a core, in percent, over
the window's pure host work: 100 x thread CPU seconds / wall seconds of
the program's ``ccvm.parse`` and ``ccvm.statistics`` spans.  Below 100,
the thread waited for a core (shared cores) or for the disk."""

from portbench import spans

HOST_SPANS = ("ccvm.parse", "ccvm.statistics")


def read(run):
    records = spans.of_window(run)
    if records is None:
        return None
    host = [s for s in records if s.name in HOST_SPANS]
    wall = sum(s.end - s.start for s in host)
    return 100.0 * sum(s.cpu_s for s in host) / wall if wall > 0 else None
