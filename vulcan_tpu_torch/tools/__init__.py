"""Kernel probes of the port: the counterparts of the JAX package's
``tools/bench_pallas_stencil.py``, ``tools/bench_pallas_gather.py`` and
``tools/bench_subsample.py``, each with its hand-written Hopper kernel.

    python -m vulcan_tpu_torch.tools.bench_stencil [HxW]
    python -m vulcan_tpu_torch.tools.bench_gather
    python -m vulcan_tpu_torch.tools.bench_subsample

Each runs on the CUDA card by default; ``--device cpu`` runs the plain
versions (for the tests) and its times are host times, not the card's.
"""
