"""Plotting and TTS statistics for CCVM solver results: a copy of
``ccvm_tpu/ccvmplotlib/`` (which imports no JAX), kept here so the port
imports nothing of the JAX package.

Host-only: ``problem_metadata`` needs pandas and ``ccvmplotlib`` matplotlib
as well, and both are imported only when those parts are first used, so
``utils`` (``SampleTTSMetric``: numpy and scipy) imports on a host that
lacks them.  Nothing else of the port imports this package.
"""

__all__ = ["ccvmplotlib"]
# The host libraries that problem_metadata and ccvmplotlib need.
HOST_LIBRARIES = ("pandas", "matplotlib")


def __getattr__(name):
    if name == "ccvmplotlib":
        from ccvm_tpu_torch.ccvmplotlib.ccvmplotlib import ccvmplotlib

        # The submodule's import bound its own name here; the class wins.
        globals()["ccvmplotlib"] = ccvmplotlib
        return ccvmplotlib
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
