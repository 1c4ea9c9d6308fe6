"""The port's benches, profiles and entry points: counterparts of the JAX
repository's root scripts (``bench.py``, ``train_bench.py``,
``profile_step.py``, ``scaling_bench.py``, ``__graft_entry__.py``) and of
its ``scripts/`` (the sharded compress pipeline, the multi-process dry
run, the adaptive-budget A/B, the validation plot).

Each tool drives the port's own main path (``ops/``, ``train/``,
``parallel/``, ``cli/``), runs on ``cuda`` unless ``--device cpu`` is
given, and prints one JSON line. None writes the JAX repository's records
(``BENCH_*.json``, ``SCALING_*.json``, ``MULTIHOST_DRYRUN.json``): their
outputs go under ``runs/torch_*`` or a path given on the command line.
Run one with ``python -m mvs_gaussian_splatting_tpu_torch.tools.<name>``.
"""
