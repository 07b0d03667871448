"""The benchmark of ``deeplip_tpu_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line. Everything a cell needs is found by name:

- ``workloads/<cell>.json``: the configuration, the traffic mix, the driver,
  the chips, the end-to-end rate it reports and the limits of its checks;
- ``configs/<config>.json``: the model's sizes and recipe, its source,
  ``reduced`` and ``assumed``;
- ``traffic/<traffic>.json``: the parameters that ``traffic.py`` (the one
  generator) reads;
- ``drivers/<driver>.py``: the entry of the program that a window drives;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``reference/<config with - as _>.py``: the plain reference that decides
  ``correct``.

Nothing here imports JAX or the JAX package; the references import nothing
of the program either.
"""
