"""The program's own spans and counters (``ccvm_tpu_torch.profiling``) over
the measured window, for the per-layer metrics that read them.

A traced run opens its profiler only around the window, and the program
records spans only while a profiler runs, so the window's records are the
ones that start inside it.  A program without the span store (or a run
without the profiler) has no records: the metrics read None.
"""

from ccvm_tpu_torch import profiling


def of_window(run):
    """The records that start inside the window, oldest first; None when
    there are none."""
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    w = run.window
    records = [s for s in spans() if w.start <= s.start <= w.end]
    return records or None


def ms(records, name):
    """Summed walls of the records named ``name``, in milliseconds; None
    when there are none."""
    walls = [s.end - s.start for s in records or () if s.name == name]
    return 1e3 * sum(walls) if walls else None


def counted(records, counter):
    """Counter ``counter`` summed over the records; None when no record
    counted it."""
    counts = [s.counts[counter] for s in records or () if counter in s.counts]
    return sum(counts) if counts else None


def per_call(run, value):
    """``value`` over the window's completed calls."""
    calls = len(run.window.done)
    return value / calls if value is not None and calls else None


def per_instance(run, value):
    """``value`` over the instances the window's completed calls solved."""
    instances = sum(c.instances for c in run.window.done)
    return value / instances if value is not None and instances else None
