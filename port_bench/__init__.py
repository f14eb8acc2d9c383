"""The benchmark of ``vihmc_torch``, the PyTorch and CUDA port.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
"""
