"""The benchmark of ``ccvm_tpu_torch``: one command runs one cell once.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` reads the cell from ``BENCHMARK.json`` at the root of the
checkout, its configuration from ``portbench/configs/``, its traffic mix
from ``portbench/traffic/``, its limits from ``portbench/workloads/`` and
each metric's reader from ``portbench/metrics/``, all by name.
"""
