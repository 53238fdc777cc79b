"""Shared helpers of the benchmark's CPU tests: a cell's plan cut to a
size a test run holds, run on the CPU."""

import pytest

from perfbench import harness

SMALL = {"intel-solve": dict(poses=64, closures=100, max_span=20),
         "sphere2500-solve": dict(rings=6, per_ring=8),
         "intel-fleet8": dict(poses=48, closures=60, max_span=16)}
# a fleet of 4 over a pool of 8: two fleets the loop cycles through
SMALL_TRAFFIC = {"intel-fleet8": dict(fleet=4, pool=8)}


@pytest.fixture
def small_plan():
    def make(cell):
        p = harness.plan(cell)
        p["config"] = {**p["config"], **SMALL[cell]}
        p["traffic"] = {**p["traffic"], **SMALL_TRAFFIC.get(cell, {})}
        return p
    return make
