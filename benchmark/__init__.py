"""The benchmark of the PyTorch/H100 port (``pointwise_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line.  Everything here is the yardstick: traffic
generation, the plain reference, the work count and the readers of the
per-layer metrics.  It imports nothing of JAX or of ``pointwise_tpu``.
"""
