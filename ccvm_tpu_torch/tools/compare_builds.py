"""The production DL kernel's builds in this checkout against another's.

``csrc/dl_solve.cu`` shares its tensor-core matvec with the race harness's
variants through ``csrc/ccvm_mma.cuh``.  A change there must leave every
production build computing what it computed: this tool builds, in both
checkouts, every DL specialisation that ``chip_smoke.py``'s phase 2 builds
(:func:`phase2_dl_specs`), each into a fresh directory, and compares
ptxas's registers and spills of each (and, where the toolkit has
``cuobjdump``, a digest of its SASS); then it runs DL and DL-Adam (beta2
0.999) in both, one seed, batch 1024, the scaled N=70 instance, 300 steps,
noise on, and compares the outputs bit for bit.  Run on a machine with the
card, from the root of a checkout, after unpacking the other one into an
ignored directory::

    mkdir -p build/before && git archive <commit> | tar -x -C build/before
    python -m ccvm_tpu_torch.tools.compare_builds --against build/before

Each checkout builds and runs in a child process of its own (its package
on the path).  Exits non-zero on any difference.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# Runs in each checkout (argv: the checkout, the JSON of specs, the output
# directory); uses only what both checkouts' packages have.
_CHILD = r"""
import hashlib, json, os, re, shutil, subprocess, sys
tree, specs_json, out = sys.argv[1:4]
sys.path.insert(0, tree)
import numpy as np
from ccvm_tpu_torch import AdamParameters, DLSolver, ProblemInstance
from ccvm_tpu_torch.ops import build, dl_kernels
from ccvm_tpu_torch.tools import breakdown
types = {"DLSpec": build.DLSpec, "ProbeDLSpec": breakdown.DLProbeSpec}
specs = [types[kind](*fields) for kind, fields in json.loads(specs_json)]
build.BUILD_DIR = os.path.join(out, "kernels")
logs = build.build(specs)
tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
result = {}
os.makedirs(os.path.join(out, "sass"), exist_ok=True)
for index, spec in enumerate(specs):
    sass = None
    if os.path.exists(tool):
        text = subprocess.run([tool, "-sass", build.library_path(spec)],
                              capture_output=True, text=True, check=True).stdout
        # The instructions only, with the anonymous namespace's symbols (named
        # after the source file's path) left out.
        code = [re.sub(r"\S*_GLOBAL__N__\S*", "<anon>", ln.strip())
                for ln in text.splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
        with open(os.path.join(out, "sass", f"{index}.txt"), "w") as f:
            f.write("\n".join(code))
        sass = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16] if code else None
    result[f"{type(spec).__name__}{tuple(spec)}"] = {
        "report": build.kernel_report(logs[spec]), "sass": sass, "index": index}
path = os.path.join(tree, "examples", "benchmarking_instances", "Size70",
                    "tuningH070-100-0.in")
inst = ProblemInstance(device="cuda", instance_type="tuning", file_path=path)
solver = DLSolver(device="cuda")
inst.scale_coefs(solver.get_scaling_factor(inst.q_matrix))
solver.solution_bounds = inst.solution_bounds
p = solver._make_params(12.0, 1.0, 0.001, 1.0, 200.0, 0.05, 300)
arrays = {}
for name, hp in (("dl", None), ("dl_adam", AdamParameters(beta2=0.999).to_hyperparameters())):
    c, s = dl_kernels.dl_solve(5, inst.q_matrix, inst.v_vector, p, iterations=300,
                               batch_size=1024, pump_rate_flag=True,
                               pump_is_gt_one=True, rng="popcount16", hp=hp)
    arrays[name + "_c"], arrays[name + "_s"] = c.cpu().numpy(), s.cpu().numpy()
np.savez(os.path.join(out, "outputs.npz"), **arrays)
print(json.dumps(result))
"""


def phase2_dl_specs():
    """The DL specialisations of ``chip_smoke.py``'s phase 2, as (type
    name, fields): its DL cases (N = 20..70, noise on and off, DL-Adam
    beta2 0.999 and 1.0, the CUDA-core race row), phase 12's and 15's
    feature builds, phase 16's step builds and phase 17's (the validation
    tool's popcount32 cases and ``breakdown --family dl``'s probe rows)."""
    from ccvm_tpu_torch import AdamParameters
    from ccvm_tpu_torch.ops import dl_kernels
    from ccvm_tpu_torch.tools import breakdown, validate

    hps = {b2: AdamParameters(beta2=b2).to_hyperparameters() for b2 in (0.999, 1.0)}
    adam = hps[0.999]
    cases = [(70, None, 1, True), (70, None, 0, True), (70, adam, 1, True),
             (70, adam, 0, True), (70, hps[1.0], 0, True), (20, None, 1, True),
             (20, None, 0, True), (20, adam, 1, True), (70, None, 1, False),
             (70, None, 0, False), (70, adam, 0, False)]
    cases += [(n, hp, noise, True) for n in (30, 40, 50, 60)
              for hp, noise in ((None, 1), (None, 0), (adam, 0))]
    specs = [dl_kernels._spec(n, hp, noise, "popcount16", mma)
             for n, hp, noise, mma in cases]
    for hp in (None, adam):
        for noise, cols, seg, elem in ((1, 0, True, False), (0, 1, False, False),
                                       (1, 1, False, False), (1, 1, True, False),
                                       (0, 2, False, False), (1, 2, False, False),
                                       (0, 1, False, True), (1, 1, False, True),
                                       (0, 2, False, True), (1, 2, False, True)):
            specs.append(dl_kernels._spec(70, hp, noise, "popcount16", True, cols, seg, elem))
        for noise in (1, 0):
            specs.append(dl_kernels._spec(8, hp, noise, "popcount16", True)._replace(ext=True))
    v_hp = validate.VARIANTS[1][1].to_hyperparameters()
    specs += [dl_kernels._spec(20, hp, 1.0, "popcount32", True) for hp in (None, v_hp)]
    specs += [row[4] for row in breakdown.dl_rows("cpu")]
    return [(type(s).__name__, list(s)) for s in dict.fromkeys(specs)]


def run_tree(tree, specs, out):
    """One checkout's reports (by spec) and outputs, from a child process."""
    os.makedirs(out, exist_ok=True)
    proc = subprocess.run([sys.executable, "-c", _CHILD, tree, json.dumps(specs), out],
                          cwd=tree, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": tree})
    if proc.returncode != 0:
        raise RuntimeError(f"the build and run in {tree} failed:\n{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for entry in result.values():
        path = os.path.join(out, "sass", f"{entry['index']}.txt")
        entry["lines"] = open(path).read().splitlines() if os.path.exists(path) else []
    with np.load(os.path.join(out, "outputs.npz")) as arrays:
        return result, dict(arrays)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, help="the other checkout's root")
    args = ap.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    specs = phase2_dl_specs()
    trees = {"this": here, "against": os.path.abspath(args.against)}
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(here, "build")) as tmp:
        got = {k: run_tree(t, specs, os.path.join(tmp, k)) for k, t in trees.items()}
    (mine, my_out), (theirs, their_out) = got["this"], got["against"]
    differ = []
    for key in mine:
        a, b = mine[key], theirs[key]
        same = a["report"] == b["report"] and a["sass"] == b["sass"]
        print(f"{key}: {a['report']}; SASS {a['sass'] or 'not compared'}"
              + ("" if same else f"  DIFFERS from {b['report']}; SASS {b['sass']}"))
        if not same:
            if not differ:  # the first differing instruction of the first
                first = next((i for i, (x, y) in enumerate(zip(a["lines"], b["lines"]))
                              if x != y), min(len(a["lines"]), len(b["lines"])))
                print(f"  first difference, instruction {first} of "
                      f"{len(a['lines'])} / {len(b['lines'])}: "
                      f"{a['lines'][first:first + 1]} / {b['lines'][first:first + 1]}")
            differ.append(key)
    for name in my_out:
        equal = np.array_equal(my_out[name], their_out[name])
        print(f"{name}: {my_out[name].shape} {'equal bit for bit' if equal else 'DIFFERS'}")
        if not equal:
            differ.append(name)
    print(f"{len(mine)} DL builds and {len(my_out)} outputs against {args.against}: "
          + ("all equal" if not differ else f"{len(differ)} differ"))
    if differ:
        sys.exit(1)


if __name__ == "__main__":
    main()
