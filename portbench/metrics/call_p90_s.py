"""The 90th percentile of the walls of the window's calls, each from entry
to statistics on the host."""

from portbench import window


def read(run):
    walls = [c.wall for c in run.window.done]
    return window.percentile(walls, 90) if walls else None
