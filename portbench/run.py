"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``BENCHMARK.json`` and the files it names), sets up the
program and warms up every shape the cell's traffic uses, runs the closed
loop for ``--seconds``, checks the outputs of calls drawn from the seed
against the plain reference, and prints one JSON line last on standard
output (the numbers it compared, each beside its limit, also last on
standard error).  With ``--trace 1`` the window runs under the profiler
and the line carries the per-layer metrics instead of the end-to-end ones.
Without a card, or with fewer than the cell asks for, it exits with 3 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)
# Build and kernel caches at fixed paths inside the checkout.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))

import torch  # noqa: E402

from portbench import check, generator, spec, tracing, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ccvm_tpu")


def reader(metric):
    """The metric's reader, ``portbench/metrics/<name>.py``; a metric split
    over groups of cells (``<name>.<group>``) reads as ``<name>`` does."""
    base = metric.split(".")[0]
    path = os.path.join(spec.HERE, "metrics", f"{base}.py")
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{base}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def prepare(name, seed, seconds, shrink=None):
    """The cell's files and its plan for ``seed``: (cell, config, traffic,
    check settings, instance files by size, calls, indices of kept calls).
    ``shrink`` ({"batch", "iterations", "call_pool"}) makes it smaller, for
    tests on a host without a card."""
    cell = spec.cell(name)
    config, traffic = cell["config"], cell["traffic"]
    chk = dict(cell["workload"]["check"])
    if shrink:
        traffic = {**traffic, "batch": shrink["batch"]}
        config = {**config, "iterations": shrink["iterations"]}
        chk.update(rows=min(chk["rows"], shrink["batch"]), call_pool=shrink["call_pool"])
    files = spec.instance_files(config)
    digest = spec.instance_digest(files)
    if digest != config["instances"]["sha256"]:
        raise RuntimeError(f"the instance set differs from the configuration's: sha256 "
                           f"{digest}, expected {config['instances']['sha256']}")
    files = {s: files[s] for s in traffic["sizes"]}
    calls = generator.plan(traffic, files, seed, int(chk["call_pool"]) + 40 * int(seconds) + 100)
    return cell, config, traffic, chk, files, calls, check.kept_calls(calls, chk, seed)


def set_up(config, traffic, files, seed, device):
    """The program with its instances loaded (where calls do not load their
    own) and one call of every size the traffic sends already run."""
    from portbench.program import Program

    program = Program(config, traffic, device)
    if not traffic["load_in_call"]:
        program.preload(sorted({p for fs in files.values() for p in fs}))
    warm = generator.plan(traffic, files, seed + int(traffic["seed_stride"]) * 10**6,
                          4 * len(files))
    for size in files:
        program(next(c for c in warm if c.size == size))
    _synchronize(device)
    program.load_spans.clear()
    return program


def run_cell(name, seed, seconds, trace, device="cuda", shrink=None, start=T_START):
    """One run of cell ``name``; returns (result dict, compared numbers)."""
    cell, config, traffic, chk, files, calls, keep = prepare(name, seed, seconds, shrink)
    workload = cell["workload"]
    iterations = int(config["iterations"])
    program = set_up(config, traffic, files, seed, device)

    kept = []

    def execute(call):
        sols = program(call)
        if call.index in keep:
            kept.append((call, sols))
        pp = sum(s.pp_time for s in sols) * call.batch if config["post_processor"] else 0.0
        return {"work": call.work * iterations, "pp_s": pp, "instances": len(call.files),
                "batch": call.batch}

    setup_s = time.perf_counter() - start
    profiler = tracing.Profiler() if trace else contextlib.nullcontext()
    with profiler:
        win = window.run(calls, execute, seconds)
        _synchronize(device)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    traced = profiler.read() if trace else None
    run = SimpleNamespace(window=win, setup_s=setup_s, trace=traced, config=config,
                          load_spans=list(program.load_spans))
    kinds = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell["metrics"][kinds]:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The check, once the program's own state is freed.
    groups = check.groups_of(kept, config, chk, seed)
    outputs = [check.program_outputs(g, config) for g in groups]
    for g in groups:
        del g["solution"]
    del program, kept
    numbers = check.compare(groups, outputs, config, workload["limits"], device) if groups else {}
    failed = sum(c.failed for c in win.calls)
    result = {"correct": bool(groups) and failed == 0 and check.passed(numbers),
              "attempted": len(win.calls), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu", "kind": _device_name(device),
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        result["breakdown"] = {"device_ops": [[n[:160], t] for n, t in traced.device_ops[:10]],
                               "idle_gaps": [list(x) for x in traced.idle_gaps[:10]]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result, numbers


def _synchronize(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _device_name(device):
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = spec.cell(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    print(f"portbench: card {_power_limit()}", file=sys.stderr)
    for k, (value, limit) in numbers.items():
        print(f"check {k} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
