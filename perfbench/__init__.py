"""The benchmark of ``mlvectordb_tpu_torch``, the PyTorch and CUDA port.

One run drives one cell (a configuration under a traffic mix, both named in
``BENCHMARK.json`` at the repository root) for a fixed window and prints one JSON line:
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
Configurations, traffic mixes and metrics are files of their own under ``configs/``,
``traffic/`` and ``metrics/``, found by name.  The float64 reference, the comparison that
decides ``correct`` and the work counts of the roofline metrics live here too, and
import nothing of the port.
"""
