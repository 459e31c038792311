"""Set-up: process start to the first timed call (imports, the card's
context, loading, building and warming every shape the cell uses)."""


def read(run):
    return run.setup_s
