"""kbbench: the benchmark of the PyTorch and CUDA port ``kubebrain_tpu_torch``.

Run one cell with ``python3 kbbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; ``BENCHMARK.json``
names the cells, their configurations (``kbbench/configs/``), traffic mixes
(``kbbench/traffic/``) and per-layer metrics (``kbbench/metrics/``).
"""
