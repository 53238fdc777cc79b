"""95th percentile, by nearest rank over every request completed in the
window, of one request's time: a whole ``run(graph)`` call from its start
to the synchronize that ends it."""

from perfbench.harness import nearest_rank


def read(window):
    return nearest_rank([1e3 * (r.end - r.start) for r in window.requests],
                        0.95)
