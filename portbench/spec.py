"""The benchmark's files, found by the names in ``BENCHMARK.json``."""

from __future__ import annotations

import hashlib
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name, root=ROOT):
    """Everything one cell runs from: its entry in ``BENCHMARK.json``, its
    configuration, traffic mix and workload file, and the metrics it
    reports ({"end_to_end": [...], "per_layer": [...]})."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{entry['traffic']}.json"))
    workload = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    metrics = {kind: [m for m in bench[kind] if name in m.get("workloads", [name])]
               for kind in ("end_to_end", "per_layer")}
    return {"entry": entry, "config": config, "traffic": traffic, "workload": workload,
            "metrics": metrics, "run_seconds": bench["run_seconds"]}


def instance_files(config, root=ROOT):
    """{size: sorted .in paths} of the configuration's instance set."""
    base = os.path.join(root, config["instances"]["dir"])
    out = {}
    for size in config["instances"]["sizes"]:
        d = os.path.join(base, f"Size{size}")
        out[int(size)] = sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".in"))
    return out


def instance_digest(files, root=ROOT):
    """sha256 over each file's path relative to the root and its bytes, in
    order of size and name."""
    h = hashlib.sha256()
    for size in sorted(files):
        for path in files[size]:
            h.update(os.path.relpath(path, root).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()
