"""Example scripts (counterparts of the JAX package's ``examples/``).

Each runs as a script (``python rustrobotics_tpu_torch/examples/<name>.py``)
or as a module (``python -m rustrobotics_tpu_torch.examples.<name>``); its
``main(argv)`` takes the command line. The CLI wrappers pass it on to
``rustrobotics_tpu_torch.cli.main``.
"""
