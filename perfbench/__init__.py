"""The benchmark of the PyTorch and CUDA port, ``rustrobotics_tpu_torch``.

Run one cell from the root of a checkout::

    python3 -m perfbench.run --workload intel-solve --seed 7 \
        --seconds 20 --trace 0

``BENCHMARK.json`` names the cells, configurations and metrics;
``harness.py`` says how a run goes.
"""
