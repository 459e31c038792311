"""The readings a cell's limits are set from: the numbers the check compares,
for the program over many seeds and for the control (the reference in TF32
put in the program's place) over a few, at the cell's own sizes.

    python3 portbench/control.py --workload <cell> [--workload <cell> ...] \\
        --seeds 11,12,... --control-seeds 11,12,13 [--look-seeds 11,12] \\
        [--looks float64-sums,3xtf32] [--out FILE]

For each seed it runs the calls a run with that seed keeps for the check,
one after another (set-up once a cell), then prints one JSON line for the
program and, on the control seeds, one for the control.  Benchmark runs
never run this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import check  # noqa: E402
from portbench.run import _synchronize, prepare, set_up  # noqa: E402

def detail(groups, outputs, config, ref, device):
    """Per group: [instance file, size, slot, call, each followed row's
    state gap, each row's count of state coordinates that ended more than
    half the row's widest reference value away (another corner of the box,
    for DL)]."""
    gaps = check.row_gaps(groups, outputs, config, device, ref, ("state_gap",))["state_gap"]
    fam = check.family(config)
    out = []
    for i, (gr, o) in enumerate(zip(groups, outputs)):
        far = 0
        for k in fam.STATE:
            r = ref[0][k][i]
            d = (o["state"][k].to(device) - r).abs()
            far = far + (d > 0.5 * r.abs().amax(-1, keepdim=True)).sum(-1)
        out.append([os.path.basename(gr["path"]), gr["size"], gr["slot"], gr["call"],
                    [float(f"{x:.4g}") for x in gaps[i]], far.cpu().tolist()])
    return out


def readings(name, seeds, control_seeds, look_seeds=(), looks=("float64-sums",),
             device="cuda", shrink=None, emit=print):
    """``emit`` one dict of readings per seed for the program and, on the
    control seeds, one for the control; on the look seeds, one for the
    reference in each precision of ``looks`` put in the program's place
    (how far round-off alone moves each group)."""
    program = None
    for seed in seeds:
        cell, config, traffic, chk, files, calls, keep = prepare(name, seed, 1, shrink)
        limits = cell["workload"]["limits"]
        if program is None:
            program = set_up(config, traffic, files, seed, device)
        kept = [(c, program(c)) for c in calls if c.index in keep]
        groups = check.groups_of(kept, config, chk, seed)
        outputs = [check.program_outputs(g, config) for g in groups]
        for g in groups:
            del g["solution"]
        del kept
        t0 = time.perf_counter()
        ref = check.reference_solve(groups, config, device)
        _synchronize(device)
        ref_s = time.perf_counter() - t0
        sides = [("program", outputs)]
        for precision in looks if seed in look_seeds else ():
            alt_state, alt_pv = check.reference_solve(groups, config, device,
                                                      precision=precision)
            sides.append((f"look {precision}",
                          [{"state": {k: v[i] for k, v in alt_state.items()},
                            "pv_rows": alt_pv[i]} for i in range(len(groups))]))
        if seed in control_seeds:
            sides.append(("control", check.control_outputs(groups, config, device)))
        for side, outs in sides:
            lims = {k: limits[k] for k in limits
                    if not side.startswith("look") or k in ("state_gap", "pv_gap")}
            nums = check.compare(groups, outs, config, lims, device, ref=ref)
            emit({"cell": name, "seed": seed, "side": side, "groups": len(groups),
                  **({"reference_s": ref_s} if side == "program" else {}),
                  **{k: v for k, (v, _) in nums.items()},
                  "detail": detail(groups, outs, config, ref, device)})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--look-seeds", default="")
    ap.add_argument("--looks", default="float64-sums",
                    help="precisions of the reference put in the program's place on the look seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    look = {int(s) for s in args.look_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(d):
        line = json.dumps(d)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        for name in args.workload:
            readings(name, seeds, control, look, args.looks.split(","), emit=emit)
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
