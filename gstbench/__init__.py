"""The benchmark of the PyTorch and CUDA port (``gstx_torch``).

``python3 gstbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/`` (data read
by a driver in ``drivers/``), each per-layer metric's reader in
``metrics/``.  The yardstick (peaks, operation and byte counts, the plain
reference and the comparison that decides ``correct``) lives here too.
"""
