"""Host-side layout for map-block (graph-partitioned) distributed
pose-graph optimization (counterpart of
``rustrobotics_tpu/parallel/block_layout.py``; host numpy and scipy's RCM,
copied).

Per-iteration communication is proportional to the SEPARATOR (the RCM
bandwidth h), never to the total dof count n:

1. Nodes (poses + landmarks, all types) are ordered by reverse
   Cuthill-McKee on the NODE adjacency graph, so every edge connects
   nodes within a bounded dof distance h (the band).
2. The node order is cut into ``num_devices`` contiguous chunks of equal
   padded dof size NDOF; rank d of the blocks axis owns global padded
   dofs [d*NDOF, (d+1)*NDOF).
3. Each edge is assigned to the rank owning its lower endpoint; all of
   the edge's normal-equation triplets then land in rows/cols
   [d0, d0 + NDOF + h) -- a one-sided bottom halo of exactly h rows that
   is reduced into the right neighbour(s) once per GN iteration.
4. The CG matvec reads x only at cols [d0 - h, d0 + NDOF + h): a
   two-sided halo of h values exchanged with the neighbours each round.

Everything here is static per graph: build_block_layout emits stacked
(num_devices, ...) numpy arrays; rank d of ``pgo_blocks`` takes row d.
The graph may live on any device: its fields are read to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# quadrant spec per edge family: (nr, nc) block shapes in kernel emission
# order [ii, ij, ji, jj] -- must match pgo_blocks._local_values exactly.
_PP_QUADS = [(3, 3), (3, 3), (3, 3), (3, 3)]
_PL_QUADS = [(3, 3), (3, 2), (2, 3), (2, 2)]
_PL_QUADS_SCHUR = [(3, 3)]   # only the pose-pose (ii) quadrant stays in H
_QQ_QUADS = [(6, 6), (6, 6), (6, 6), (6, 6)]
_PAIR_QUADS = [(3, 3)]       # landmark-clique fill blocks


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Static distributed layout. All (D, ...) arrays are stacked per
    device; rank d of the blocks axis takes row d."""

    num_devices: int
    ndof: int            # owned padded dofs per device
    h: int               # halo width (max edge dof span); 0 when D == 1
    n_pad: int           # num_devices * ndof
    ell_width: int       # W: global max row degree (deduped pattern)
    trash: int           # flat index of the discard slot in the ext table

    # --- per-device node state (ext = owned + halo copies) ---
    p2_state0: np.ndarray   # (D, P2E, 3) initial SE2 poses (0-padded)
    p2_dof: np.ndarray      # (D, P2E) int32 ext-dof start of each row
    p2_orig: np.ndarray     # (D, P2E) int32 row into graph.poses2, -1 pad
    p2_owned: np.ndarray    # (D, P2E) bool — owned (not halo/pad) rows
    l2_state0: np.ndarray   # (D, L2E, 2)
    l2_dof: np.ndarray
    l2_orig: np.ndarray
    l2_owned: np.ndarray
    p3_state0: np.ndarray   # (D, P3E, 7)
    p3_dof: np.ndarray
    p3_orig: np.ndarray
    p3_owned: np.ndarray

    # --- per-device edges (padded with Omega = 0) ---
    pp_from: np.ndarray     # (D, Epp) int32 -> p2 ext row
    pp_to: np.ndarray
    pp_z: np.ndarray        # (D, Epp, 3)
    pp_omega: np.ndarray    # (D, Epp, 3, 3)
    pl_pose: np.ndarray
    pl_lm: np.ndarray
    pl_z: np.ndarray
    pl_omega: np.ndarray
    qq_from: np.ndarray
    qq_to: np.ndarray
    qq_z: np.ndarray        # (D, Eqq, 7)
    qq_omega: np.ndarray    # (D, Eqq, 6, 6)

    # --- per-device assembly maps ---
    schur: bool             # landmark elimination mode
    pair_a: np.ndarray      # (D, Q) int32 obs-pair lists (schur fill)
    pair_b: np.ndarray      # (D, Q) int32
    lm_ind: np.ndarray      # (D, ndof) f64 1.0 on owned-landmark dofs
    ell_order: np.ndarray   # (D, T) int32 permutation of local triplets
    ell_seg: np.ndarray     # (D, T) int32 segment id (dedup groups)
    n_segments: int         # TD (incl. one trash segment)
    ell_pos: np.ndarray     # (D, TD) int64 flat pos into ext table / trash
    nbr: np.ndarray         # (D, ndof, W) int32 ext-x col per owned slot
    diag_pos: np.ndarray    # (D, ndof) int64 flat pos of diag in OWNED table
    pad_diag: np.ndarray    # (D, ndof) f64 1.0 on padded dofs
    prior_diag: np.ndarray  # (D, ndof) f64 1.0 on the gauge-prior dofs

    # --- per-device block-Jacobi maps ---
    dof_block: np.ndarray   # (D, ndof) int32
    dof_pos: np.ndarray     # (D, ndof) int32
    n_blocks: int           # NB (max over devices)
    blk_idx: np.ndarray     # (D, NB, 6, 6) int64 into owned flat table
    blk_mask: np.ndarray    # (D, NB, 6, 6) bool
    pad_eye: np.ndarray     # (D, NB, 6, 6) f64 identity padding

    # --- per-device additive-Schwarz (local banded Cholesky) maps ---
    # each device's OWNED diagonal block of H, as banded block rows
    # (nb_loc, kb_loc, 2*kb_loc) gathered from the owned ELL table — the
    # comm-free subdomain solve that keeps distributed CG iteration
    # counts at direct-solve levels
    kb_loc: int
    nb_loc: int
    band_idx: np.ndarray    # (D, nb_loc, kb_loc, 2*kb_loc) int32
    band_mask: np.ndarray   # (D, nb_loc, kb_loc, 2*kb_loc) bool
    band_pad: np.ndarray    # (nb_loc, kb_loc, 2*kb_loc) f64 identity rows

    # --- result extraction / oracle maps ---
    padded_to_ref: np.ndarray  # (n_pad,) int64 reference dof id, -1 pad


def _np(x, dtype=None):
    """A graph field as a host numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def _chunk_bounds(sizes_ord, num_devices):
    """Cut the node order into D contiguous chunks of ~equal dof."""
    cum = np.concatenate([[0], np.cumsum(sizes_ord)])
    total = cum[-1]
    bounds = [0]
    for d in range(1, num_devices):
        target = total * d / num_devices
        bounds.append(int(np.searchsorted(cum, target, side="left")))
    bounds.append(len(sizes_ord))
    # enforce monotone (tiny graphs can collapse chunks to empty)
    for i in range(1, len(bounds)):
        bounds[i] = max(bounds[i], bounds[i - 1])
    return bounds


def _quad_rowcols(off_i, off_j, quads):
    """Triplet (row, col) arrays for one family, in kernel emission order:
    for each quadrant [ii, ij, ji, jj], for k in rows, for l in cols,
    one (E,) chunk. Returns (rows, cols) each of length sum(nr*nc)*E."""
    rows, cols = [], []
    offs = [(off_i, off_i), (off_i, off_j), (off_j, off_i), (off_j, off_j)]
    for (orow, ocol), (nr, nc) in zip(offs, quads):
        for k in range(nr):
            for l in range(nc):  # noqa: E741
                rows.append(orow + k)
                cols.append(ocol + l)
    return np.concatenate(rows), np.concatenate(cols)


def build_block_layout(graph, num_devices: int,
                       schur: bool = False) -> BlockLayout:
    """Build the static map-block layout for ``num_devices`` devices.

    ``schur=True`` builds the DISTRIBUTED SCHUR variant: 2D landmark
    blocks are eliminated per-device before the halo-CG (SURVEY §5's
    "Schur-eliminate landmarks" in the distributed solve). pl edges
    are then assigned to the LANDMARK's owner (all of a landmark's
    observations live on one device), the reduced pose system gains
    the landmark-clique fill blocks (host-precomputed observation
    pair lists), the halo covers the clique span, and landmark rows
    carry identity diagonals (their dx comes from local
    back-substitution, not CG)."""
    D = num_devices
    n2 = graph.poses2.shape[0]
    l2 = graph.landmarks2.shape[0]
    n3 = graph.poses3.shape[0]
    n_nodes = n2 + l2 + n3
    if n_nodes == 0:
        raise ValueError("empty graph")

    # global node ids: [0, n2) poses2, [n2, n2+l2) landmarks2, rest poses3
    node_size = np.concatenate([
        np.full(n2, 3), np.full(l2, 2), np.full(n3, 6)
    ]).astype(np.int64)
    node_type = np.concatenate([
        np.zeros(n2), np.ones(l2), np.full(n3, 2)
    ]).astype(np.int8)

    pp_i = _np(graph.pp_from, np.int64)
    pp_j = _np(graph.pp_to, np.int64)
    pl_i = _np(graph.pl_pose, np.int64)
    pl_j = _np(graph.pl_lm, np.int64) + n2
    qq_i = _np(graph.qq_from, np.int64) + n2 + l2
    qq_j = _np(graph.qq_to, np.int64) + n2 + l2

    # ---- node-level RCM ordering -------------------------------------
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    ei = np.concatenate([pp_i, pl_i, qq_i])
    ej = np.concatenate([pp_j, pl_j, qq_j])
    adj = sp.coo_matrix(
        (np.ones(2 * len(ei) + n_nodes, np.float32),
         (np.concatenate([ei, ej, np.arange(n_nodes)]),
          np.concatenate([ej, ei, np.arange(n_nodes)]))),
        shape=(n_nodes, n_nodes),
    ).tocsr()
    order = np.asarray(
        reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64
    )  # order[pos] = global node id

    # ---- contiguous chunks of ~equal dof, padded to NDOF -------------
    sizes_ord = node_size[order]
    bounds = _chunk_bounds(sizes_ord, D)
    chunk_dof = [
        int(sizes_ord[bounds[d]:bounds[d + 1]].sum()) for d in range(D)
    ]
    ndof = max(max(chunk_dof), 1)

    pstart = np.zeros(n_nodes, np.int64)  # padded dof start per node id
    owner = np.zeros(n_nodes, np.int32)
    for d in range(D):
        off = d * ndof
        for pos in range(bounds[d], bounds[d + 1]):
            g = order[pos]
            pstart[g] = off
            owner[g] = d
            off += node_size[g]
    n_pad = D * ndof

    # ---- halo width h = max edge dof span ----------------------------
    def spans(gi, gj):
        lo = np.minimum(pstart[gi], pstart[gj])
        hi = np.maximum(pstart[gi] + node_size[gi],
                        pstart[gj] + node_size[gj])
        return hi - lo

    all_spans = [np.zeros(0, np.int64)]
    for gi, gj in [(pp_i, pp_j), (pl_i, pl_j), (qq_i, qq_j)]:
        if len(gi):
            all_spans.append(spans(gi, gj))
    if schur and len(pl_i):
        # Schur fill connects every pair of poses co-observing a
        # landmark: the halo must cover the widest such clique
        o_lm = np.argsort(pl_j, kind="stable")
        lj_s, li_s = pl_j[o_lm], pl_i[o_lm]
        starts = np.searchsorted(lj_s, np.unique(lj_s))
        ps = pstart[li_s]
        pmin = np.minimum.reduceat(ps, starts)
        pmax = np.maximum.reduceat(ps + 3, starts)
        all_spans.append(pmax - pmin)
    h = int(max((s.max() for s in all_spans if len(s)), default=0))
    if D == 1:
        h = 0
    # Clamp to the ring capacity: at h = (D-1)*ndof every device's ext
    # range [d0 - h, d0 + ndof + h) already covers ALL of [0, n_pad), so
    # any edge span is reachable — wide-band graphs (globally observed
    # landmarks) gracefully degrade toward replication instead of failing.
    h = min(h, (D - 1) * ndof)

    # ---- per-device ext node tables ----------------------------------
    # ext coords cover [d*ndof - h, (d+1)*ndof + h), but node STATES are
    # only needed for [d*ndof, (d+1)*ndof + h): every edge assigned to d
    # (by min endpoint) references nodes fully inside that range. The left
    # halo exists only for x/dx VALUES in the matvec/retraction exchange.
    per_dev = []  # per device: dict type -> list of (typed_row, extdof, owned)
    node_end = pstart + node_size
    for d in range(D):
        lo, hi = d * ndof - h, (d + 1) * ndof + h
        state_lo = lo if schur else d * ndof
        in_ext = np.where((pstart >= state_lo) & (node_end <= hi))[0]
        entry = {0: [], 1: [], 2: []}
        lut = {}
        for g in in_ext:
            t = int(node_type[g])
            typed_row = int(g - (0 if t == 0 else n2 if t == 1 else n2 + l2))
            lut[int(g)] = (t, len(entry[t]))
            entry[t].append((typed_row, int(pstart[g] - lo),
                             owner[g] == d))
        per_dev.append((entry, lut))

    def stack_type(t, width, state_src):
        cnt = max(max(len(pd[0][t]) for pd in per_dev), 1)
        st = np.zeros((D, cnt, width))
        dof = np.zeros((D, cnt), np.int32)
        orig = np.full((D, cnt), -1, np.int32)
        owned = np.zeros((D, cnt), bool)
        for d, (entry, _) in enumerate(per_dev):
            for i, (row, ed, own) in enumerate(entry[t]):
                st[d, i] = state_src[row]
                dof[d, i] = ed
                orig[d, i] = row
                owned[d, i] = own
        return st, dof, orig, owned

    p2_state0, p2_dof, p2_orig, p2_owned = stack_type(
        0, 3, _np(graph.poses2, np.float64).reshape(-1, 3))
    l2_state0, l2_dof, l2_orig, l2_owned = stack_type(
        1, 2, _np(graph.landmarks2, np.float64).reshape(-1, 2))
    p3_state0, p3_dof, p3_orig, p3_owned = stack_type(
        2, 7, _np(graph.poses3, np.float64).reshape(-1, 7))
    # pad SE3 rows must be valid group elements: an all-zero quaternion
    # would NaN the pad edges' residuals, and 0 * NaN = NaN poisons chi2
    p3_state0[p3_orig < 0] = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)

    # ---- per-device edge assignment ----------------------------------
    def assign(gi, gj):
        lo = np.minimum(pstart[gi], pstart[gj])
        return (lo // ndof).astype(np.int32)

    def split_edges(gi, gj, z, om, fam_t, by_owner_of=None):
        """Per-device typed-ext endpoint indices + measurements, padded."""
        z = np.asarray(z, np.float64)
        om = np.asarray(om, np.float64)
        if len(gi) == 0:
            dev = np.zeros(0, np.int32)
        elif by_owner_of is not None:
            dev = owner[by_owner_of].astype(np.int32)
        else:
            dev = assign(gi, gj)
        idx_by_dev = [np.where(dev == d)[0] for d in range(D)]
        e_max = max(max(len(ix) for ix in idx_by_dev), 1)
        fr = np.zeros((D, e_max), np.int32)
        to = np.zeros((D, e_max), np.int32)
        zz = np.zeros((D, e_max) + z.shape[1:])
        oo = np.zeros((D, e_max) + om.shape[1:])
        real = np.zeros((D, e_max), bool)
        del fam_t  # endpoint types are implied by the LUT entries
        for d, ix in enumerate(idx_by_dev):
            lut = per_dev[d][1]
            for i, e in enumerate(ix):
                fr[d, i] = lut[int(gi[e])][1]
                to[d, i] = lut[int(gj[e])][1]
                zz[d, i] = z[e]
                oo[d, i] = om[e]
                real[d, i] = True
        return fr, to, zz, oo, real

    pp = split_edges(pp_i, pp_j, _np(graph.pp_z), _np(graph.pp_omega),
                     (0, 0))
    pl = split_edges(pl_i, pl_j, _np(graph.pl_z), _np(graph.pl_omega),
                     (0, 1),
                     by_owner_of=pl_j if schur else None)
    qq = split_edges(qq_i, qq_j, _np(graph.qq_z), _np(graph.qq_omega),
                     (2, 2))
    # pad SE3 measurements -> identity transform, [t, q_wxyz] layout
    # (see p3_state0 note)
    qq[2][~qq[4]] = np.array([0, 0, 0, 1, 0, 0, 0], np.float64)

    # ---- per-device triplet (row, col) lists in kernel order ---------
    def fam_rowcols(d, fam, dof_tab_i, dof_tab_j, quads):
        fr, to, _, _, real = fam
        off_i = dof_tab_i[d][fr[d]]
        off_j = dof_tab_j[d][to[d]]
        r, c = _quad_rowcols(off_i.astype(np.int64),
                             off_j.astype(np.int64), quads)
        nrep = sum(nr * nc for nr, nc in quads)
        mask = np.tile(real[d], nrep)
        return r, c, mask

    # observation-pair lists for the Schur fill (indices into the
    # device's padded pl edge array; pads route to the trash slot)
    if schur:
        pa_lists, pb_lists = [], []
        for d in range(D):
            sl, m = pl[1][d], pl[4][d]
            pa, pb = [], []
            for s in np.unique(sl[m]):
                grp = np.where(m & (sl == s))[0]
                gi_, gj_ = np.meshgrid(grp, grp, indexing="ij")
                pa.append(gi_.ravel())
                pb.append(gj_.ravel())
            pa_lists.append(np.concatenate(pa) if pa
                            else np.zeros(0, np.int64))
            pb_lists.append(np.concatenate(pb) if pb
                            else np.zeros(0, np.int64))
        q_max = max(max(len(a) for a in pa_lists), 1)
        pair_a = np.zeros((D, q_max), np.int32)
        pair_b = np.zeros((D, q_max), np.int32)
        pair_real = np.zeros((D, q_max), bool)
        for d in range(D):
            k = len(pa_lists[d])
            pair_a[d, :k] = pa_lists[d]
            pair_b[d, :k] = pb_lists[d]
            pair_real[d, :k] = True
    else:
        pair_a = np.zeros((D, 1), np.int32)
        pair_b = np.zeros((D, 1), np.int32)
        pair_real = np.zeros((D, 1), bool)

    pl_quads = _PL_QUADS_SCHUR if schur else _PL_QUADS
    dev_triplets = []
    for d in range(D):
        rs, cs, ms = [], [], []
        for fam, ti, tj, quads in [
            (pp, p2_dof, p2_dof, _PP_QUADS),
            (pl, p2_dof, l2_dof, pl_quads),
            (qq, p3_dof, p3_dof, _QQ_QUADS),
        ]:
            r, c, m = fam_rowcols(d, fam, ti, tj, quads)
            rs.append(r)
            cs.append(c)
            ms.append(m)
        if schur:
            # fill blocks between the pose endpoints of each obs pair:
            # rows from pair_a's pose, COLS from pair_b's pose (k-major
            # entry order, matching the kernel's _em(prod) emission)
            off = p2_dof[d][pl[0][d]].astype(np.int64)
            off_a, off_b = off[pair_a[d]], off[pair_b[d]]
            rs_p, cs_p = [], []
            for k in range(3):
                for l in range(3):  # noqa: E741
                    rs_p.append(off_a + k)
                    cs_p.append(off_b + l)
            rs.append(np.concatenate(rs_p))
            cs.append(np.concatenate(cs_p))
            ms.append(np.tile(pair_real[d], 9))
        dev_triplets.append((np.concatenate(rs), np.concatenate(cs),
                             np.concatenate(ms)))
    t_len = len(dev_triplets[0][0])

    # ---- global deduped pattern (union of real triplets + diagonal) --
    grows, gcols = [np.arange(n_pad)], [np.arange(n_pad)]
    for d in range(D):
        r, c, m = dev_triplets[d]
        base = d * ndof - h
        grows.append(r[m] + base)
        gcols.append(c[m] + base)
    grows = np.concatenate(grows)
    gcols = np.concatenate(gcols)
    key = grows * n_pad + gcols
    uniq = np.unique(key)
    uniq_r = uniq // n_pad
    uniq_c = uniq % n_pad
    row_start = np.searchsorted(uniq_r, np.arange(n_pad), side="left")
    slot = np.arange(len(uniq_r)) - row_start[uniq_r]
    width = int(slot.max()) + 1 if len(slot) else 1

    def slot_lookup(keys):
        """(r*n_pad + c) keys -> slot within row; keys must be present."""
        ins = np.searchsorted(uniq, keys)
        assert np.all(uniq[np.minimum(ins, len(uniq) - 1)] == keys)
        return slot[ins]

    nbr_g = np.zeros((n_pad, width), np.int32)
    nbr_g[uniq_r, slot] = uniq_c

    # ---- per-device dedup + scatter maps ------------------------------
    ext_rows = ndof + 2 * h
    trash = ext_rows * width
    seg_counts = []
    orders = np.zeros((D, t_len), np.int32)
    segs = np.zeros((D, t_len), np.int32)
    pos_lists = []
    for d in range(D):
        r, c, m = dev_triplets[d]
        real_idx = np.where(m)[0]
        pad_idx = np.where(~m)[0]
        rr, cc = r[real_idx], c[real_idx]
        o = np.lexsort((cc, rr))
        rs_s, cs_s = rr[o], cc[o]
        new_grp = np.ones(len(rs_s), bool)
        if len(rs_s) > 1:
            new_grp[1:] = (rs_s[1:] != rs_s[:-1]) | (cs_s[1:] != cs_s[:-1])
        seg = np.cumsum(new_grp) - 1 if len(rs_s) else np.zeros(0, np.int64)
        nseg = int(seg[-1]) + 1 if len(seg) else 0
        orders[d] = np.concatenate([real_idx[o], pad_idx]).astype(np.int32)
        segs[d, :len(real_idx)] = seg
        segs[d, len(real_idx):] = nseg  # trash segment (grown to TD-1 later)
        base = d * ndof - h
        ur, uc = rs_s[new_grp], cs_s[new_grp]
        gkey = (ur + base) * n_pad + (uc + base)
        pos = ur * width + slot_lookup(gkey)
        pos_lists.append(pos)
        seg_counts.append(nseg)
    n_segments = max(seg_counts) + 1  # + trash
    ell_pos = np.full((D, n_segments), trash, np.int64)
    for d in range(D):
        ell_pos[d, :seg_counts[d]] = pos_lists[d]
        segs[d][segs[d] == seg_counts[d]] = n_segments - 1  # route pads

    # ---- per-device owned-row maps ------------------------------------
    nbr_loc = np.zeros((D, ndof, width), np.int32)
    diag_pos = np.zeros((D, ndof), np.int64)
    pad_diag = np.zeros((D, ndof))
    prior_diag = np.zeros((D, ndof))
    # which global node carries the gauge prior
    prior_node = -1
    if graph.prior2 >= 0:
        prior_node = int(graph.prior2)
    elif graph.prior3 >= 0:
        prior_node = int(graph.prior3) + n2 + l2
    for d in range(D):
        d0 = d * ndof
        g_rows = np.arange(d0, d0 + ndof)
        cols = nbr_g[g_rows]  # (ndof, W) global cols
        nbr_loc[d] = np.clip(cols - (d0 - h), 0, ext_rows - 1)
        dslots = slot_lookup(g_rows * np.int64(n_pad) + g_rows)
        diag_pos[d] = np.arange(ndof) * width + dslots
    # padded dofs: anything not covered by a node
    covered = np.zeros(n_pad, bool)
    for g in range(n_nodes):
        covered[pstart[g]:pstart[g] + node_size[g]] = True
    for d in range(D):
        pad_diag[d] = (~covered[d * ndof:(d + 1) * ndof]).astype(np.float64)
    if prior_node >= 0:
        d = int(owner[prior_node])
        s = int(pstart[prior_node]) - d * ndof
        prior_diag[d, s:s + int(node_size[prior_node])] = 1.0
    # owned-landmark dofs (schur: identity rows in the reduced system,
    # no LM damping — their dx comes from local back-substitution)
    lm_ind = np.zeros((D, ndof))
    if schur:
        for d in range(D):
            for i in range(l2_dof.shape[1]):
                if l2_owned[d, i]:
                    s = int(l2_dof[d, i]) - h
                    lm_ind[d, s:s + 2] = 1.0

    # ---- block-Jacobi maps (vectorized over all blocks) ---------------
    # blocks per device = owned nodes (in RCM position order) + pseudo
    # blocks of up to 6 padded dofs each
    blk_dev, blk_start, blk_size = [], [], []
    for d in range(D):
        for pos in range(bounds[d], bounds[d + 1]):
            g = order[pos]
            blk_dev.append(d)
            blk_start.append(int(pstart[g]) - d * ndof)
            blk_size.append(int(node_size[g]))
        pads = np.where(pad_diag[d] > 0)[0]
        for i in range(0, len(pads), 6):
            run = pads[i:i + 6]  # contiguous by construction (chunk tail)
            blk_dev.append(d)
            blk_start.append(int(run[0]))
            blk_size.append(len(run))
    blk_dev = np.asarray(blk_dev, np.int64)
    blk_start = np.asarray(blk_start, np.int64)
    blk_size = np.asarray(blk_size, np.int64)
    blk_local = np.concatenate([
        np.arange(np.sum(blk_dev == d)) for d in range(D)
    ]) if len(blk_dev) else np.zeros(0, np.int64)
    n_blocks = int(blk_local.max()) + 1 if len(blk_local) else 1

    dof_block = np.zeros((D, ndof), np.int32)
    dof_pos = np.zeros((D, ndof), np.int32)
    for b in range(len(blk_dev)):
        sl = slice(blk_start[b], blk_start[b] + blk_size[b])
        dof_block[blk_dev[b], sl] = blk_local[b]
        dof_pos[blk_dev[b], sl] = np.arange(blk_size[b])

    # (B, 6, 6) grid of global (row, col) pairs, searched in the pattern
    aa = np.arange(6)
    ra = (blk_dev * ndof + blk_start)[:, None, None] + aa[None, :, None]
    cb = (blk_dev * ndof + blk_start)[:, None, None] + aa[None, None, :]
    in_sz = ((aa[None, :, None] < blk_size[:, None, None])
             & (aa[None, None, :] < blk_size[:, None, None]))
    gkey = ra * n_pad + cb
    ins = np.searchsorted(uniq, gkey)
    ins_c = np.minimum(ins, len(uniq) - 1)
    found = in_sz & (uniq[ins_c] == gkey)
    flat = ((ra - blk_dev[:, None, None] * ndof) * width
            + slot[ins_c])

    blk_idx = np.zeros((D, n_blocks, 6, 6), np.int64)
    blk_mask = np.zeros((D, n_blocks, 6, 6), bool)
    pad_eye = np.zeros((D, n_blocks, 6, 6))
    pad_eye[:, :, aa, aa] = 1.0  # unused block slots stay full identity
    blk_idx[blk_dev, blk_local] = np.where(found, flat, 0)
    blk_mask[blk_dev, blk_local] = found
    pe = np.zeros((len(blk_dev), 6, 6))
    pe[:, aa, aa] = (aa[None, :] >= blk_size[:, None]).astype(np.float64)
    pad_eye[blk_dev, blk_local] = pe

    # ---- additive-Schwarz local banded maps ---------------------------
    # owned-block scalar half-bandwidth: max |r - c| over pattern entries
    # whose row AND col live on the same device
    same_owner = (uniq_r // ndof) == (uniq_c // ndof)
    if np.any(same_owner):
        q_loc = int(np.abs(uniq_r[same_owner]
                           - uniq_c[same_owner]).max())
    else:
        q_loc = 0
    kb_loc = max(128, -(-q_loc // 128) * 128)
    nb_loc = max(-(-ndof // kb_loc), 1)
    band_idx = np.zeros((D, nb_loc, kb_loc, 2 * kb_loc), np.int32)
    band_mask = np.zeros((D, nb_loc, kb_loc, 2 * kb_loc), bool)
    jj = np.arange(nb_loc)[:, None, None]
    ii = np.arange(kb_loc)[None, :, None]
    ll = np.arange(2 * kb_loc)[None, None, :]
    rr_l = jj * kb_loc + ii                     # local owned row
    cc_l = (jj - 1) * kb_loc + ll               # local owned col
    valid = (cc_l >= 0) & (cc_l <= rr_l) & (rr_l < ndof)
    for d in range(D):
        gkey = ((d * ndof + rr_l).astype(np.int64) * n_pad
                + (d * ndof + cc_l))
        ins = np.searchsorted(uniq, gkey)
        ins_c = np.minimum(ins, len(uniq) - 1)
        found = valid & (uniq[ins_c] == gkey)
        band_idx[d] = np.where(found, rr_l * width + slot[ins_c], 0)
        band_mask[d] = found
    band_pad = np.zeros((nb_loc, kb_loc, 2 * kb_loc))
    pad_r = np.arange(ndof, nb_loc * kb_loc)
    band_pad[pad_r // kb_loc, pad_r % kb_loc,
             kb_loc + pad_r % kb_loc] = 1.0

    # ---- reference-layout map -----------------------------------------
    padded_to_ref = np.full(n_pad, -1, np.int64)
    ref_off = np.concatenate([
        _np(graph.pose2_offsets, np.int64) if n2 else
        np.zeros(0, np.int64),
        _np(graph.lm2_offsets, np.int64) if l2 else
        np.zeros(0, np.int64),
        _np(graph.pose3_offsets, np.int64) if n3 else
        np.zeros(0, np.int64),
    ])
    for g in range(n_nodes):
        sz = int(node_size[g])
        padded_to_ref[pstart[g]:pstart[g] + sz] = np.arange(
            ref_off[g], ref_off[g] + sz)

    return BlockLayout(
        num_devices=D, ndof=ndof, h=h, n_pad=n_pad, ell_width=width,
        trash=trash,
        p2_state0=p2_state0, p2_dof=p2_dof, p2_orig=p2_orig,
        p2_owned=p2_owned,
        l2_state0=l2_state0, l2_dof=l2_dof, l2_orig=l2_orig,
        l2_owned=l2_owned,
        p3_state0=p3_state0, p3_dof=p3_dof, p3_orig=p3_orig,
        p3_owned=p3_owned,
        pp_from=pp[0], pp_to=pp[1], pp_z=pp[2], pp_omega=pp[3],
        pl_pose=pl[0], pl_lm=pl[1], pl_z=pl[2], pl_omega=pl[3],
        qq_from=qq[0], qq_to=qq[1], qq_z=qq[2], qq_omega=qq[3],
        schur=schur, pair_a=pair_a, pair_b=pair_b, lm_ind=lm_ind,
        ell_order=orders, ell_seg=segs, n_segments=n_segments,
        ell_pos=ell_pos, nbr=nbr_loc, diag_pos=diag_pos,
        pad_diag=pad_diag, prior_diag=prior_diag,
        dof_block=dof_block, dof_pos=dof_pos, n_blocks=n_blocks,
        blk_idx=blk_idx, blk_mask=blk_mask, pad_eye=pad_eye,
        kb_loc=kb_loc, nb_loc=nb_loc, band_idx=band_idx,
        band_mask=band_mask, band_pad=band_pad,
        padded_to_ref=padded_to_ref,
    )
