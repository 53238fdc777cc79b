"""The factorization's share of its roofline: the configuration's fixed
factorization bound (the larger of its FLOPs over the f32 peak and its
bytes over the HBM peak) over the device time of K1's kernels a
factorization, one factorization an iteration; in %."""

from perfbench import kernels, work


def read(s, config):
    t, hit = s.kernel_s(kernels.FACTOR)
    if not hit or s.iterations == 0:
        return None
    w = config["work"]
    return 100.0 * work.bound_s(w["factor_flops"], w["factor_bytes"]) \
        * s.iterations / t
