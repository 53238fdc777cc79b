"""Optimizer iterations completed in the window, over the window's
seconds: every request's iterations, over the time from the window's
start to the return of its last request. All work over all time, so a
stall counts."""


def read(window):
    iters = sum(r.iterations for r in window.requests)
    return iters / (window.end - window.start)
