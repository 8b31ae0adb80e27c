"""The benchmark of ``sphax_torch`` on one CUDA card.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. The harness is data-driven: a configuration is
``configs/<name>.json``, a traffic mix ``traffic/<name>.json``, a cell's
check ``workloads/<name>.json`` and a per-layer metric
``metrics/<name>.py``, each found by the name the manifest gives it (see
README.md). Nothing here imports JAX or the JAX package ``sphax``.
"""
