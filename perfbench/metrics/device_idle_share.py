"""1 - (union of device event intervals) / the traced slice."""


def read(s, config):
    if s.busy_s <= 0:
        return None
    return 1.0 - s.busy_s / s.window_s
