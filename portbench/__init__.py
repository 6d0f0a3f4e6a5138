"""The benchmark of ``patchaugnet_tpu_torch`` on one NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The
yardstick lives here: the traffic generators, the weight initialiser, the
plain reference, the bounds and peaks, the trace reduction and the checks.
Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the port.
"""
