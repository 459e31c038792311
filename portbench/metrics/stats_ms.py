"""The statistics' wall a call, in milliseconds: the program's
``ccvm.statistics`` spans (each Solution's best objective and gap
fractions)."""

from portbench import spans


def read(run):
    return spans.per_call(run, spans.ms(spans.of_window(run), "ccvm.statistics"))
