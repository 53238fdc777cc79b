"""The band assembly's share of its roofline: the configuration's fixed
assembly bound (the kept triplet values read, the band written) over the
device time of K4 (K5 for a fleet) a call, one call an iteration; in %."""

from perfbench import kernels, work


def read(s, config):
    t, hit = s.kernel_s(kernels.ASSEMBLY)
    if not hit or s.iterations == 0:
        return None
    w = config["work"]
    return 100.0 * work.bound_s(w["assembly_flops"], w["assembly_bytes"]) \
        * s.iterations / t
