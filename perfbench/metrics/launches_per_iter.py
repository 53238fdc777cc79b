"""Kernel-launch runtime calls in the traced slice (cluster launches
included) over the optimizer iterations the slice completed."""


def read(s, config):
    if s.launches == 0 or s.iterations == 0:
        return None
    return s.launches / s.iterations
