"""The benchmark of ``light_transport_tpu_torch``: camera renders timed
through ``api.render`` on one CUDA card, per-layer numbers read from a
traced run, and every run's frames held against a plain PyTorch
reference (``ltbench/reference``).  ``python ltbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>``; see README.md."""
