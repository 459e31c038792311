"""The system under test, ``ccvm_tpu_torch``, as the benchmark drives it.

The configuration names the façade class (``solver``), its post-processor
and the names of the Solution variables the check reads.  A call runs the
façade on one instance, or loads its instances (with ``load_in_call``) and
runs one ``ccvm_tpu_torch.parallel.sweep_solve`` over them; it returns when
every Solution, statistics included, is on the host.
"""

from __future__ import annotations

import time

import torch


class Program:
    def __init__(self, config, traffic, device="cuda"):
        import ccvm_tpu_torch.solvers as solvers
        from ccvm_tpu_torch.parallel import sweep_solve
        from ccvm_tpu_torch.problem_classes.boxqp import ProblemInstance

        self.config, self.traffic, self.device = config, traffic, device
        self._instance_cls, self._sweep = ProblemInstance, sweep_solve
        self.solver = getattr(solvers, config["solver"])(
            device=device, batch_size=int(traffic["batch"]))
        self.solver.parameter_key = {
            int(size): {**params, "iterations": int(config["iterations"])}
            for size, params in config["parameters"].items()
            if int(size) in traffic["sizes"]}
        self.pp = config["post_processor"]
        self.loaded = {}
        self.load_spans = []  # host seconds of each instance's load and scaling

    def load(self, path):
        """One instance read from disk and scaled as the solver scales it."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.load"):
            inst = self._instance_cls(device=self.device, instance_type="tuning",
                                      file_path=path)
            inst.scale_coefs(self.solver.get_scaling_factor(inst.q_matrix))
        self.load_spans.append(time.perf_counter() - t0)
        return inst

    def preload(self, paths):
        """Set-up: load the instances of a traffic whose calls do not load
        their own."""
        for path in paths:
            self.loaded[path] = self.load(path)

    def __call__(self, call):
        """Run one call; returns its Solutions, in the order of its files."""
        with torch.profiler.record_function("portbench.call"):
            if call.load_in_call:
                instances = [self.load(p) for p in call.files]
            else:
                instances = [self.loaded[p] for p in call.files]
            with torch.profiler.record_function("portbench.solve"):
                if call.entry == "facade":
                    return [self.solver(instances[0], post_processor=self.pp,
                                        seed=call.seed)]
                return self._sweep(self.solver, instances, post_processor=self.pp,
                                   seed=call.seed, scale=False)
