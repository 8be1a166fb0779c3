"""The benchmark of ``vulcan_tpu_torch``, the PyTorch and CUDA port: one
cell a run (``python3 -m benchmark.run``), its cells, configurations,
traffic mixes, per-layer metrics and checks found by name from
``BENCHMARK.json`` and the configurations (``spec.py``), and the plain
references that decide ``correct`` (``reference/``, ``checks/``,
``check.py``).  Imports nothing of JAX or of the JAX
package."""
