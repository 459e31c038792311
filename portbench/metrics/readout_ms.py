"""The readout's wall a call, in milliseconds: the program's
``ccvm.readout`` span (the float32 energy pass and its copy to the host,
the rows it cannot classify picked, copied and recomputed in float64)."""

from portbench import spans


def read(run):
    return spans.per_call(run, spans.ms(spans.of_window(run), "ccvm.readout"))
