"""Times the host waited for device results a call, loads included: the
program's ``host_syncs`` counter (explicit synchronises, device-to-host
copies, Python numbers of device tensors)."""

from portbench import spans


def read(run):
    return spans.per_call(run, spans.counted(spans.of_window(run), "host_syncs"))
