"""The benchmark of the PyTorch and CUDA port (``repro_torch``) of G-TADOC.

``python3 tadoc_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card; see
``harness.py``.  Nothing here imports JAX or the JAX package ``repro``.
"""
