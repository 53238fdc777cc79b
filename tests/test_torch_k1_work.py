"""K1's trailing-update work list, as ``band_chol_kernels.k1_work`` and
``k1_panel_items`` count it from the shapes (the card tests hold K1's host
loop to the same counts).

After diagonal panel i at column o = 128 i, the rows below it are cut into
strips of 32 or 64 rows (the source chooses the height from kb, the batch
and the card, and reports it in ``K1_STRIP_ROWS``); each strip of L is
formed once a panel step, the lower update tiles cover the lower trailing
block once, and panel row i's off-diagonal inverse takes o / 16 column
tiles.
"""

import numpy as np
import pytest

from rustrobotics_tpu_torch.ops import band_chol_kernels as bk

KBS = [128, 256, 384, 512, 1024, 2048]


def _per_tile_strip_products(kb, tile=32):
    """Strip products of the design that formed L inside each 32x32 lower
    trailing tile: both strips of an off-diagonal tile, one of a diagonal
    tile, for every panel step of a block row."""
    total = 0
    for o in range(0, kb, bk.PANEL):
        nt = (kb - o - bk.PANEL) // tile
        total += 2 * (nt * (nt + 1) // 2) - nt
    return total


@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("kb", KBS)
def test_k1_work_counts(kb, batch):
    nb = 3
    rows = [kb - bk.PANEL * (i + 1) for i in range(kb // bk.PANEL)]
    for s in (32, 64):
        work = bk.k1_work(nb, kb, batch, s)
        assert work["strips"] == batch * nb * sum(rows) // s
        tiles = [(r // s) * (r // s + 1) // 2 for r in rows]
        assert work["update_tiles"] == batch * nb * sum(tiles)
        assert work["offdiag_tiles"] == batch * nb * sum(
            bk.PANEL * i // 16 for i in range(kb // bk.PANEL))


@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("kb", KBS)
def test_k1_panel_items_cover_once(kb, s):
    """Every panel step: the strips cut the rows below the panel once, the
    update tiles cover the lower trailing block once and lie inside it
    (a diagonal tile also covers its upper triangle), the off-diagonal
    tiles cover the panel row's columns left of the panel once."""
    for i in range(kb // bk.PANEL):
        o = bk.PANEL * i
        r0 = o + bk.PANEL
        strips, tiles, offdiag = bk.k1_panel_items(kb, i, s)
        rows = np.zeros(kb, int)
        for r in strips:
            rows[r:r + s] += 1
        assert (rows[r0:] == 1).all() and (rows[:r0] == 0).all()
        cover = np.zeros((kb, kb), int)
        for m, n in tiles:
            assert r0 <= n <= m and m + s <= kb
            cover[m:m + s, n:n + s] += 1
        lower = np.tril(np.ones((kb, kb), bool))
        lower[:r0] = lower[:, :r0] = False
        assert (cover[lower] == 1).all()
        assert (cover[~lower] <= 1).all()
        cols = np.zeros(kb, int)
        for c in offdiag:
            cols[c:c + bk.OFFDIAG_COLS] += 1
        assert (cols[:o] == 1).all() and (cols[o:] == 0).all()
        assert len(offdiag) == o // 16


def test_k1_strips_once_a_step_against_once_a_tile():
    """At kb 512 the per-tile design formed 144 + 64 + 16 = 224 strips of
    32 rows a block row and graph; once a panel step it is 768 rows of L:
    24 strips of 32 rows at B 1, 12 of 64 at B 32, 9.3x fewer rows of
    strip products."""
    assert _per_tile_strip_products(512) == 144 + 64 + 16 == 224
    assert bk.k1_work(1, 512, 1, 32)["strips"] == 24
    assert bk.k1_work(1, 512, 32, 64)["strips"] == 12 * 32


@pytest.mark.parametrize("rows", [0, 16, 48, 128])
def test_k1_work_takes_the_two_strip_heights(rows):
    """K1's strips have 32 or 64 rows; any other height is refused."""
    with pytest.raises(ValueError, match="32 or 64 rows"):
        bk.k1_work(1, 512, 1, rows)
