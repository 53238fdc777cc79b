"""The substitution's share of its roofline: the configuration's fixed
substitution bound over the device time of K2 a solve, one solve an
iteration; in %."""

from perfbench import kernels, work


def read(s, config):
    t, hit = s.kernel_s(kernels.SUBST)
    if not hit or s.iterations == 0:
        return None
    w = config["work"]
    return 100.0 * work.bound_s(w["subst_flops"], w["subst_bytes"]) \
        * s.iterations / t
