"""The benchmark of ``erpl_monte_carlo_sim_tpu_torch`` on one NVIDIA GPU.

One command runs one cell once (``python3 -m gpu_bench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``) and prints one JSON line. A cell of
``BENCHMARK.json`` pairs a configuration (``configs/<config>.json``) with a
traffic mix (``mixes/<mix>.json``, which names its entry point,
``entries/<entry>.py``); every metric is read by ``metrics/<metric>.py``; a
cell's comparison limits are ``limits/<cell>.json``. The plain reference that
decides ``correct`` lives in ``reference/``.
"""
