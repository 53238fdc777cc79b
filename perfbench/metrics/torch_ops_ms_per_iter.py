"""Device time of every device event not of the factorization, the
substitution or the band assembly (linearization, assembly of the triplet
values, scaling, retraction, chi^2: the port's PyTorch operations), in ms
an iteration of the traced slice."""

from perfbench import kernels


def read(s, config):
    named, _ = s.kernel_s(kernels.FACTOR + kernels.SUBST
                          + kernels.ASSEMBLY)
    rest = sum(s.device_s.values()) - named
    if rest <= 0 or s.iterations == 0:
        return None
    return 1e3 * rest / s.iterations
