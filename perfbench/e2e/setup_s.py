"""Set-up: from the start of the run's process to the end of the warm
requests (importing the port, bringing up CUDA, the generator, the guess
pool, the optimizer's host planning, building or loading the kernels, the
warm requests)."""


def read(window):
    return window.setup_s
