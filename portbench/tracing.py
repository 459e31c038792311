"""The traced run: ``torch.profiler`` (host and CUDA activity) over the
whole window, reduced to the device's busy time, device time by operation
name, and the idle gaps by what the host was doing.

The benchmark opens its own profiler here and reads the Chrome-format
trace it exports (into a temporary directory under ``TMPDIR``, removed
once read), so edits to the program's own profiling cannot move it.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "portbench.call"
LABELLED_GAPS = 400  # gaps given their innermost host event too
HARNESS_SPANS = ("portbench.call", "portbench.solve", "portbench.load")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list  # (name, seconds) summed by name, longest first
    idle_gaps: list  # (what the host was doing, idle seconds), longest first

    def device_seconds(self, substring):
        """Device seconds of the operations whose name holds ``substring``;
        None when there is none."""
        hits = [s for name, s in self.device_ops if substring in name]
        return sum(hits) if hits else None


class Profiler:
    def __enter__(self):
        self.dir = tempfile.mkdtemp(prefix="portbench-trace-")
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        self.path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def read(self):
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
        return reduce(events)


def reduce(events):
    """A Trace of Chrome-format events; the window runs from the first
    ``portbench.call`` span's start to the last one's end."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo = min(float(e["ts"]) for e in spans)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                  and float(e["ts"]) + float(e["dur"]) > lo and float(e["ts"]) < hi),
                 key=lambda x: x[0])
    merged = []
    for a, b, _ in dev:
        a, b = max(a, lo), min(b, hi)
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    by_name = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    return Trace(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                 device_ops=sorted(by_name.items(), key=lambda x: -x[1]),
                 idle_gaps=label_gaps(gaps, host))


def label_gaps(gaps, host):
    """Idle seconds by what the host was doing at each gap's midpoint: the
    innermost of the benchmark's own spans (``portbench.*``), and for the
    longest gaps also the innermost host event under it."""
    if not gaps:
        return []
    mids = np.array([0.5 * (a + b) for a, b in gaps])
    labels = np.array(["(between calls)"] * len(gaps), dtype=object)
    for name in HARNESS_SPANS:  # outermost first; each kind never overlaps itself
        spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in host if e["name"] == name)
        if not spans:
            continue
        starts = np.array([a for a, _ in spans])
        ends = np.array([b for _, b in spans])
        k = np.searchsorted(starts, mids, side="right") - 1
        inside = (k >= 0) & (mids <= ends[np.maximum(k, 0)])
        labels[inside] = name
    ts = np.array([float(e["ts"]) for e in host])
    te = ts + np.array([float(e["dur"]) for e in host])
    names = [e["name"] for e in host]
    out = {}
    longest_first = sorted(range(len(gaps)), key=lambda j: gaps[j][0] - gaps[j][1])
    for rank, i in enumerate(longest_first):
        label = labels[i]
        if rank < LABELLED_GAPS:
            hit = np.flatnonzero((ts <= mids[i]) & (te >= mids[i]))
            if hit.size:
                inner = names[hit[np.argmin(te[hit] - ts[hit])]]
                if inner != label:
                    label = f"{label} / {inner}"
        out[label] = out.get(label, 0.0) + (gaps[i][1] - gaps[i][0]) / 1e6
    return sorted(out.items(), key=lambda x: -x[1])
