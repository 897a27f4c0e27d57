"""The benchmark of ``repro_torch`` on one NVIDIA card.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line. Everything a
cell needs is found by name: ``BENCHMARK.json`` names the cell's
configuration (``configs/<config>.json``) and traffic mix
(``traffic/<mix>.json``); ``cells/<cell>.json`` holds its engine geometry
and its output limits; each per-layer metric is read by
``metrics/<metric>.py``; each kernel's operations and bytes are counted by
``roofline/<kernel>.py``. The plain reference that decides ``correct`` is
``reference/``; ``frozen/`` holds arithmetic copied from the program.
Nothing here imports JAX or the JAX package.
"""
