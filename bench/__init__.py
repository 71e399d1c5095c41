"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its configuration in
``bench/configs/<config>.json`` (with the plain reference it names in
``bench/reference/``), its traffic in ``bench/traffic/<traffic>.json``,
and each metric's reader in ``bench/metrics/<name>.py`` (or the file of the
name's part before its first dot).  See ``bench/README.md``.
"""
