"""Rows the readout recomputed in float64 an instance solved: the
program's ``rows64`` counter (the rows its float32 pass cannot classify,
the 64 best among them)."""

from portbench import spans


def read(run):
    return spans.per_instance(run, spans.counted(spans.of_window(run), "rows64"))
