"""Self time of the program's ``ccvm.call`` span a call, in milliseconds:
its wall less its direct children's (``ccvm.sync``, ``ccvm.postprocess``,
``ccvm.readout``, ``ccvm.statistics``, and the sweep's ``ccvm.scale``).
What is left is the façade's or the sweep's own host work: parameters,
S, the step table, the launch's enqueue, the change of variables, the
stacking, the Solutions built."""

from portbench import spans


def read(run):
    records = spans.of_window(run)
    if records is None:
        return None
    calls = {id(s) for s in records if s.name == "ccvm.call"}
    if not calls:
        return None
    own = sum(s.end - s.start for s in records if id(s) in calls)
    children = sum(s.end - s.start for s in records
                   if s.parent is not None and id(s.parent) in calls)
    return spans.per_call(run, 1e3 * (own - children))
