"""The benchmark of ``ptrt_tpu_torch`` on one or more CUDA cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Everything that belongs to one configuration, traffic
mix, layer or metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<cell>.json``, ``layers/<layer>.json``, ``metrics/<metric>.py``
and ``scenes/<scene>.py``.  ``reference/`` is the plain PyTorch reference
that decides ``correct``; it imports nothing of the port.
"""
