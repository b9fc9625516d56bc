"""The benchmark harness of the PyTorch port (``repro_torch``).

It reads ``BENCHMARK.json`` and finds everything else by name: a cell's
configuration in ``configs/<config>.json``, its traffic in
``traffic/<traffic>.json`` (whose ``runner`` names ``runners/<runner>.py``),
its limits in ``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  A new cell, mix or metric is new files and
entries, never an edit of a file that is here.
"""
