"""``chip_smoke.pivot_gate``, the front end's K1 gate, on synthetic f32
bands on the CPU (where K1's wrapper runs the plain chain, so stand-ins
for K1 play its part).

The gate holds K1 where exact arithmetic has a factorization: on the block
rows before r64, the first row where the f64 chain on the same f32 band
breaks down (nb where it does not), it requires every pivot of K1 and of
the plain chain, and K1 within FE_K1_TOL of the plain chain. A band that
the f64 chain factors whole is gated whole; one indefinite from block row
0 fails (r64 >= 1 is required).
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from rustrobotics_tpu_torch.ops.band_chol_kernels import (
    factorize_kernel,
    factorize_plain,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NB, KB = 6, 8


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


cs = _chip_smoke()


def _band(indefinite_from=None, seed=0):
    """(dsym, lcoup) f32: diagonally dominant SPD blocks and small
    couplings; from block row ``indefinite_from`` on, negative definite
    diagonal blocks (the chain breaks down there in any precision)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(NB, KB, KB)) * 0.1
    dsym = a + a.transpose(0, 2, 1) + 4.0 * np.eye(KB)
    lcoup = rng.normal(size=(NB, KB, KB)) * 0.2
    if indefinite_from is not None:
        dsym[indefinite_from:] = -np.eye(KB)
    return (torch.tensor(dsym, dtype=torch.float32),
            torch.tensor(lcoup, dtype=torch.float32))


def _nan_rows(rows):
    """A stand-in for K1 that loses the pivots of ``rows``."""
    def k1(dsym, lcoup):
        ld, lp = factorize_plain(dsym, lcoup)
        ld = ld.clone()
        ld[rows] = math.nan
        return ld, lp
    return k1


def _off_rows(rows, by):
    """A stand-in for K1 whose factor is off by ``by`` in ``rows``."""
    def k1(dsym, lcoup):
        ld, lp = factorize_plain(dsym, lcoup)
        ld = ld.clone()
        ld[rows] += by * torch.eye(KB)
        return ld, lp
    return k1


def test_gates_only_the_rows_before_the_f64_breakdown():
    band = _band(indefinite_from=3)
    res = cs.pivot_gate(*band, factorize_kernel, factorize_plain)
    assert res["r64"] == 3 and res["nb"] == NB
    assert res["f64_bad"] == [3, 4, 5] and res["plain_bad"] == [3, 4, 5]
    assert res["ok"] and res["resid"] < 1e-5
    # rows from r64 on are printed, not gated
    for k1 in (_nan_rows([4]), _off_rows([3, 4, 5], 1.0)):
        assert cs.pivot_gate(*band, k1, factorize_plain)["ok"]
    # a lost pivot or a wrong factor before r64 fails
    res = cs.pivot_gate(*band, _nan_rows([1]), factorize_plain)
    assert not res["ok"] and res["k1_bad"] == [1, 3, 4, 5]
    assert res["resid"] == math.inf
    res = cs.pivot_gate(*band, _off_rows([2], 1.0), factorize_plain)
    assert not res["ok"] and res["resid"] > cs.FE_K1_TOL


@pytest.mark.parametrize("k1,ok", [(None, True), (_nan_rows([NB - 1]), False),
                                   (_off_rows([NB - 1], 1.0), False),
                                   (_off_rows([0], 1e-3), True)])
def test_gates_the_whole_band_where_f64_keeps_every_pivot(k1, ok):
    band = _band()
    res = cs.pivot_gate(*band, k1 or factorize_kernel, factorize_plain)
    assert res["r64"] == NB and res["f64_bad"] == []
    assert res["ok"] == ok


def test_fails_a_band_indefinite_from_row_0():
    res = cs.pivot_gate(*_band(indefinite_from=0), factorize_kernel,
                        factorize_plain)
    assert res["r64"] == 0 and not res["ok"]


def test_band_checksum_sees_every_bit():
    dsym, lcoup = _band()
    assert cs.band_checksum(dsym, lcoup) == cs.band_checksum(dsym.clone(),
                                                             lcoup.clone())
    bumped = dsym.clone()
    bumped.view(-1)[5] = torch.nextafter(bumped.view(-1)[5],
                                         torch.tensor(math.inf))
    assert cs.band_checksum(bumped, lcoup) != cs.band_checksum(dsym, lcoup)
