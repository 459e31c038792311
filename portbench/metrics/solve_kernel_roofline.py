"""The solve kernel's share of its roofline over the traced window: the
summed least times of the window's launches (``portbench/roofline.py``)
over the kernel's summed device time, by its name in the trace."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    kernel = run.config["kernel"]
    device_s = run.trace.device_seconds(kernel)
    if not device_s:
        return None
    least = sum(roofline.least_seconds(kernel, instances=c.instances, batch=c.batch,
                                       n=c.size, iterations=run.config["iterations"])[0]
                for c in run.window.done)
    return 100.0 * least / device_s
