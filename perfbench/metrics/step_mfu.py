"""The whole optimizer step's share of the f32 peak: the configuration's
fixed FLOPs of one iteration (linearization, factorization, substitution)
times the traced slice's iterations per second, over 67 TFLOP/s; in %."""

from perfbench import work


def read(s, config):
    if s.iterations == 0 or s.busy_s <= 0:
        return None
    rate = s.iterations / s.window_s
    return 100.0 * work.step_flops(config["work"]) * rate \
        / work.PEAK_F32_FLOPS
