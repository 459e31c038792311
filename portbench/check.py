"""What decides ``correct``: the outputs of calls the window drove, held
against the plain reference in ``portbench/reference``.

Before the window a few calls are chosen from the seed (``check.per_size``
calls of each size among the first ``check.call_pool``); their Solutions
are kept.  After the window, for each instance those calls solved (a
*group*), the reference

- reads and scales the instance itself and follows ``check.rows`` rows of
  its batch, drawn from the seed, through the whole SDE with the same
  Philox noise, in float32 (``state_gap``: a row's largest gap between the
  program's final state and the reference's, over the row's largest
  reference value; its 90th percentile over a group's rows; the median of
  those over the groups of each stratum, each size and each slot of a
  stacked sweep; and the largest of those medians.  A median, because a
  few instances amplify round-off far more than the rest; per stratum, so
  that a fault confined to one size or one slot still fails);
- refines its own readout as the configuration's post-processor does
  (``pv_gap``: the same of a row's largest gap between the problem
  variables);
- computes the float64 energy of every row the program returned from the
  program's problem variables (``energy_gap``: the largest relative gap to
  the energies the program reported);
- recomputes the statistics from those energies (``stats_mismatch``: how
  many of the Solution's fractions and best objective differ).

A workload file names the numbers it compares and their limits.  The
control (:func:`control_outputs`) is the reference computed in TF32 and put
in the program's place.
"""

from __future__ import annotations

import importlib
import os
import sys

import numpy as np
import torch

from portbench.reference import boxqp
from portbench.reference.sde import Groups, matmul_for

STAT_KEYS = tuple(boxqp.GAP_THRESHOLDS) + ("best",)
BEST_RTOL = 1e-9  # float64 sums in another order


def family(config):
    return importlib.import_module(f"portbench.reference.{config['family']}")


def kept_calls(plan, check, seed):
    """Indices of the calls whose outputs the check keeps: ``per_size`` of
    each size among the first ``call_pool`` calls of the plan."""
    rng = np.random.default_rng([int(seed), 7])
    pool = plan[:int(check["call_pool"])]
    keep = []
    for size in sorted({c.size for c in pool}):
        idx = [c.index for c in pool if c.size == size]
        keep += rng.choice(idx, size=min(int(check["per_size"]), len(idx)),
                           replace=False).tolist()
    return set(int(i) for i in keep)


def sample_rows(seed, call_index, group, batch, rows):
    rng = np.random.default_rng([int(seed), int(call_index), int(group), 11])
    return np.sort(rng.choice(int(batch), size=min(int(rows), int(batch)), replace=False))


def groups_of(kept, config, check, seed):
    """One entry per instance the kept calls solved: its file, seed, size,
    followed rows and the program's Solution."""
    out = []
    for call, solutions in kept:
        for k, (path, sol) in enumerate(zip(call.files, solutions)):
            out.append({"path": path, "seed": call.seed + k, "size": call.size,
                        "rows": sample_rows(seed, call.index, k, call.batch, check["rows"]),
                        "solution": sol, "call": call.index, "slot": k})
    return out


def program_outputs(group, config):
    """The program's outputs of one group as the check reads them."""
    sol = group["solution"]
    rows = torch.as_tensor(group["rows"])
    names = config["outputs"]
    pv = sol.variables[names["pv"]]
    state = {k: sol.variables[v][rows.to(sol.variables[v].device)].float()
             for k, v in names["state"].items()}
    stats = dict(sol.solution_performance)
    stats["best"] = sol.best_objective_value
    return {"state": state, "pv_rows": pv[rows.to(pv.device)].float(), "pv_all": pv,
            "energies": np.asarray(sol.objective_values, np.float64), "stats": stats}


def _reference_groups(groups, config, device):
    fam = family(config)
    items = []
    for gr in groups:
        inst = _instance(gr["path"])
        q, v = inst.scaled32(fam.SCALING_MULTIPLIER)
        params = {k: x for k, x in config["parameters"][str(gr["size"])].items()}
        items.append({"q": q, "v": v, "seed": gr["seed"], "rows": gr["rows"],
                      "params": params})
    return fam, Groups(items, device)


_INSTANCES = {}


def _instance(path):
    if path not in _INSTANCES:
        _INSTANCES[path] = boxqp.read_instance(path)
    return _INSTANCES[path]


def reference_solve(groups, config, device, precision="float32"):
    """The reference's final state and problem variables of every group's
    followed rows: ({name: [(R, n_g) per group]}, [(R, n_g) per group])."""
    fam, g = _reference_groups(groups, config, device)
    with _no_tf32():
        state = fam.solve(g, config["iterations"], precision=precision)
        pv = fam.readout(state, g, precision=precision)
    per = {k: [g.unpad(state[k], i) for i in range(len(groups))] for k in fam.STATE}
    return per, [g.unpad(pv, i) for i in range(len(groups))]


def control_outputs(groups, config, device):
    """The control in the program's place: the reference in TF32, over the
    followed rows only (its energies in TF32 too, its statistics over those
    rows)."""
    fam = family(config)
    state, pv = reference_solve(groups, config, device, precision="tf32")
    mm = matmul_for("tf32")
    out = []
    for i, gr in enumerate(groups):
        inst = _instance(gr["path"])
        x = fam.box(pv[i])
        q = torch.as_tensor(inst.q64, dtype=torch.float32, device=x.device)
        v = torch.as_tensor(inst.v64, dtype=torch.float32, device=x.device)
        with _no_tf32():
            e = 0.5 * (mm(x, q) * x).sum(-1) + mm(x, v[:, None])[:, 0]
        e = e.double().cpu().numpy()
        out.append({"state": {k: state[k][i] for k in fam.STATE}, "pv_rows": pv[i],
                    "pv_all": pv[i], "energies": e,
                    "stats": boxqp.statistics(e, inst.optimal)})
    return out


def row_gaps(groups, outputs, config, device, ref, names):
    """Each followed row's gap to the reference, per group: {name: [(R,)
    float64 arrays]}.  ``state_gap``: the row's largest gap between the
    final states over the row's largest reference value; ``pv_gap``: the
    row's largest gap between the problem variables."""
    fam = family(config)
    ref_state, ref_pv = ref
    out = {}
    if "state_gap" in names:
        out["state_gap"] = []
        for i, o in enumerate(outputs):
            diff = torch.stack([(o["state"][k].to(device) - ref_state[k][i]).abs().amax(-1)
                                for k in fam.STATE]).amax(0)
            scale = torch.stack([ref_state[k][i].abs().amax(-1)
                                 for k in fam.STATE]).amax(0).clamp(min=1e-6)
            out["state_gap"].append((diff / scale).double().cpu().numpy())
    if "pv_gap" in names:
        out["pv_gap"] = [(o["pv_rows"].to(device) - ref_pv[i]).abs().amax(-1).double()
                         .cpu().numpy() for i, o in enumerate(outputs)]
    return out


def compare(groups, outputs, config, limits, device, ref=None):
    """Each compared number of ``limits`` with its value: {name: (value,
    limit)}; ``outputs`` are the program's (or the control's) per group,
    ``ref`` the reference's solve of the groups when already at hand."""
    fam = family(config)
    want = set(limits)
    numbers = {}
    gap_names = want & {"state_gap", "pv_gap"}
    if gap_names:
        gaps = row_gaps(groups, outputs, config, device,
                        ref or reference_solve(groups, config, device), gap_names)
        for name, per_group in gaps.items():
            numbers[name] = stratified_gap(per_group, groups)
    if want & {"energy_gap", "stats_mismatch"}:
        worst, mismatches = 0.0, 0
        for gr, out in zip(groups, outputs):
            inst = _instance(gr["path"])
            e = boxqp.energies64(fam.box(out["pv_all"].to(device)), inst.q64, inst.v64)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.abs(out["energies"] - e) / np.abs(e)
            worst = max(worst, float(np.max(rel)) if np.all(np.isfinite(rel)) else np.inf)
            ref = boxqp.statistics(e, inst.optimal)
            for k in STAT_KEYS:
                a, b = out["stats"][k], ref[k]
                same = abs(a - b) <= BEST_RTOL * abs(b) if k == "best" else a == b
                mismatches += not same
                if not same and mismatches <= 20:
                    print(f"portbench: call {gr['call']} {os.path.basename(gr['path'])} "
                          f"{k}: program {a!r}, reference {b!r}", file=sys.stderr)
        numbers["energy_gap"] = worst
        numbers["stats_mismatch"] = float(mismatches)
    return {k: (numbers[k], float(limits[k])) for k in limits}


def passed(numbers):
    return all(value <= limit for value, limit in numbers.values())


def stratified_gap(per_group, groups):
    """The largest, over the strata of groups (each size, and each slot of
    a stacked sweep), of the median over a stratum's groups of a group's
    90th percentile over its rows.  A median within a stratum passes the
    few instances that amplify round-off; taking the worst stratum fails a
    fault confined to one size or one slot."""
    q = [float(np.quantile(a, 0.9)) if np.all(np.isfinite(a)) else float("inf")
         for a in (np.asarray(a, np.float64).ravel() for a in per_group)]
    strata = {}
    for gr, x in zip(groups, q):
        strata.setdefault(("size", gr["size"]), []).append(x)
        strata.setdefault(("slot", gr["slot"]), []).append(x)
    return max(float(np.median(v)) for v in strata.values())


class _no_tf32:
    """float32 matrix products in IEEE float32 while the reference runs."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.prev
