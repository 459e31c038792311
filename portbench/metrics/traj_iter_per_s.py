"""Trajectory-iterations per second: over the calls of the window,
instances x batch x iterations, over the window's seconds."""

from portbench import window


def read(run):
    return window.rate(run.window)
