"""The one traffic generator: a traffic mix's parameters and a seed give
the run's plan of calls.

A mix (``portbench/traffic/<mix>.json``) is a closed loop of one client:
each call is sent when the previous one has returned.  A call solves
``instances_per_call`` instances of one size at ``batch`` trajectories
each, through the façade (``entry`` "facade", one instance a call) or one
stacked sweep (``entry`` "sweep"); with ``load_in_call`` its instances are
read from disk inside the call.  Calls go through the mix's ``sizes`` in
passes: every pass holds each size once, in an order drawn from the seed,
and a size's instances are taken in passes over a seeded permutation, so
every seed sends the same work in another order.  A call's noise seed is
``seed + seed_stride * index`` (a sweep's instance i adds i).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Call:
    index: int
    size: int
    files: tuple
    seed: int
    batch: int
    entry: str
    load_in_call: bool

    @property
    def work(self):
        """Trajectory-iterations per call, without the iterations."""
        return len(self.files) * self.batch


def plan(traffic, files, seed, calls):
    """The first ``calls`` calls of the mix for ``seed``; ``files`` maps
    each size to its instance files."""
    rng = np.random.default_rng([int(seed), 3])
    sizes = [int(s) for s in traffic["sizes"]]
    per_call = int(traffic["instances_per_call"])
    cursors = {s: [] for s in sizes}
    out = []
    while len(out) < calls:
        for size in rng.permutation(sizes).tolist():
            if len(out) == calls:
                break
            chosen = []
            while len(chosen) < per_call:
                if not cursors[size]:
                    cursors[size] = rng.permutation(len(files[size])).tolist()
                chosen.append(files[size][cursors[size].pop(0)])
            if traffic["entry"] == "sweep":
                chosen.sort()
            k = len(out)
            out.append(Call(index=k, size=size, files=tuple(chosen),
                            seed=int(seed) + int(traffic["seed_stride"]) * k,
                            batch=int(traffic["batch"]), entry=traffic["entry"],
                            load_in_call=bool(traffic["load_in_call"])))
    return out
