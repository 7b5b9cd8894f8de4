"""The benchmark of the PyTorch and CUDA port (``obs_color_monitor_tpu_torch``).

``BENCHMARK.json`` at the repository's root names the cells; a run is
``python3 -m bench_torch.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` on a machine with the cell's cards.  Everything that
belongs to one configuration, traffic mix or metric is a file found by its
name: ``configs/<config>.json``, ``traffic/<mix>.json`` (read by
``traffic/generator.py``) and ``metrics/<metric>.py``.  The plain
reference that decides ``correct`` is ``reference/``; nothing here imports
JAX or the JAX package.
"""
