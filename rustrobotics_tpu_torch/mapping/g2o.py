"""g2o file parser -> typed, struct-of-arrays pose graph (counterpart of
``rustrobotics_tpu/mapping/g2o.py``).

Parses VERTEX_SE2, VERTEX_XY, VERTEX_SE3:QUAT, EDGE_SE2, EDGE_SE2_XY and
EDGE_SE3:QUAT into dense tensors grouped by type, with integer index
tensors. Quaternions are stored as [qw, qx, qy, qz]. Each vertex gets a
dof offset in file order (SE2: 3, XY: 2, SE3: 6); ``total_dof`` is their
sum. The gauge prior sits on the first SE2 edge's from-pose (or, for a
pure 3D graph, the first SE3 edge's).

``load_g2o_with_meta`` parses with the native C++ parser
(``g2o_native``, the repository's ``native/g2o_parser.cpp``) and takes the
pure-Python tokenizer, copied from the JAX package, when the native parser
is unavailable or rejects the file; both give bit-identical arrays, and
the Python parser owns the error messages. This is host-side parsing:
the tensors land on ``device`` either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rustrobotics_tpu_torch.device import resolve_device

FLOAT_FIELDS = ("poses2", "landmarks2", "poses3", "pp_z", "pp_omega",
                "pl_z", "pl_omega", "qq_z", "qq_omega")
INDEX_FIELDS = ("pp_from", "pp_to", "pl_pose", "pl_lm", "qq_from", "qq_to",
                "pose2_offsets", "lm2_offsets", "pose3_offsets")


@dataclasses.dataclass
class PoseGraphData:
    """Pose graph grouped by node/edge type.

    2D: poses2 (N2, 3) [x, y, theta], landmarks2 (L2, 2).
    3D: poses3 (N3, 7) [t, q_wxyz].
    Edges reference type-local rows (into poses2/landmarks2/poses3);
    index tensors are int64.

    A fleet (``pgo.stack_graphs``) carries a leading batch axis on the
    float fields only; the index fields, ``total_dof`` and the priors are
    the graphs' shared structure.
    """

    # nodes
    poses2: torch.Tensor  # (N2, 3)
    landmarks2: torch.Tensor  # (L2, 2)
    poses3: torch.Tensor  # (N3, 7)
    # SE2-SE2 edges
    pp_from: torch.Tensor  # (E_pp,) -> poses2 row
    pp_to: torch.Tensor
    pp_z: torch.Tensor  # (E_pp, 3)
    pp_omega: torch.Tensor  # (E_pp, 3, 3)
    # SE2-XY edges
    pl_pose: torch.Tensor  # (E_pl,) -> poses2 row
    pl_lm: torch.Tensor  # (E_pl,) -> landmarks2 row
    pl_z: torch.Tensor  # (E_pl, 2)
    pl_omega: torch.Tensor  # (E_pl, 2, 2)
    # SE3-SE3 edges
    qq_from: torch.Tensor  # (E_qq,) -> poses3 row
    qq_to: torch.Tensor
    qq_z: torch.Tensor  # (E_qq, 7)
    qq_omega: torch.Tensor  # (E_qq, 6, 6)
    # reference dof layout
    pose2_offsets: torch.Tensor  # (N2,)
    lm2_offsets: torch.Tensor  # (L2,)
    pose3_offsets: torch.Tensor  # (N3,)
    total_dof: int = 0
    prior2: int = -1
    prior3: int = -1

    @property
    def num_nodes(self) -> int:
        return (self.pose2_offsets.shape[0] + self.lm2_offsets.shape[0]
                + self.pose3_offsets.shape[0])

    @property
    def num_edges(self) -> int:
        return (self.pp_from.shape[0] + self.pl_pose.shape[0]
                + self.qq_from.shape[0])

    @property
    def is_3d(self) -> bool:
        return self.pose3_offsets.shape[0] > 0

    @property
    def batch_shape(self) -> torch.Size:
        """() for one graph, (B,) for a fleet."""
        return self.poses2.shape[:-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.poses2.dtype if self.poses2.numel() else self.poses3.dtype

    @property
    def device(self) -> torch.device:
        return self.poses2.device

    def replace(self, **updates) -> "PoseGraphData":
        return dataclasses.replace(self, **updates)

    def to(self, device=None, dtype=None) -> "PoseGraphData":
        """Move every tensor to ``device`` and cast the float ones to
        ``dtype`` (either may be None: unchanged)."""
        kw = {} if device is None else {"device": device}
        updates = {name: getattr(self, name).to(**kw) for name in INDEX_FIELDS}
        if dtype is not None:
            kw["dtype"] = dtype
        updates.update(
            {name: getattr(self, name).to(**kw) for name in FLOAT_FIELDS})
        return self.replace(**updates)


def graph_from_numpy(fields: dict, total_dof: int, prior2: int = -1,
                     prior3: int = -1, device=None, dtype=None) -> PoseGraphData:
    """Build a graph from numpy arrays named as the dataclass fields (the
    form a JAX graph or a parse dict is carried across in). Float arrays
    keep their numpy dtype unless ``dtype`` is given."""
    device = resolve_device(device)
    tensors = {}
    for name in FLOAT_FIELDS:  # copies: the arrays may be read-only views
        t = torch.tensor(np.asarray(fields[name]))
        tensors[name] = t.to(device=device, dtype=dtype or t.dtype)
    for name in INDEX_FIELDS:
        tensors[name] = torch.tensor(
            np.asarray(fields[name], dtype=np.int64), device=device)
    return PoseGraphData(**tensors, total_dof=int(total_dof),
                         prior2=int(prior2), prior3=int(prior3))


def batch_from_numpy(fields: dict, total_dof: int, prior2: int = -1,
                     prior3: int = -1, device=None,
                     dtype=None) -> PoseGraphData:
    """The fleet counterpart of ``graph_from_numpy``: the arrays of a
    stacked JAX graph (``stack_graphs`` there stacks every leaf, the index
    ones too) carried across as numpy. Float arrays keep their leading B
    axis; each index array must hold one row B times, and that row is kept
    once. Raises ValueError when the rows differ."""
    shared = {}
    for name in INDEX_FIELDS:
        rows = np.asarray(fields[name])
        if (rows != rows[:1]).any():
            raise ValueError(f"index field {name!r} differs between the "
                             f"graphs of the batch")
        shared[name] = rows[0]
    return graph_from_numpy({**fields, **shared}, total_dof, prior2, prior3,
                            device=device, dtype=dtype)


@dataclasses.dataclass
class G2OMeta:
    """Host-side parse metadata. ``pp_file_index`` / ``pl_file_index`` /
    ``qq_file_index`` give, for each typed edge row, its position in the
    file's mixed-type edge order."""

    pp_file_index: np.ndarray
    pl_file_index: np.ndarray
    qq_file_index: np.ndarray


def load_g2o(path: str, dtype=torch.float64, device=None) -> PoseGraphData:
    """Parse a g2o text file."""
    graph, _ = load_g2o_with_meta(path, dtype, device)
    return graph


def load_g2o_with_meta(path: str, dtype=torch.float64, device=None):
    """Parse with the native C++ parser, or with the Python tokenizer when
    the native one is unavailable or rejects the file. Returns (graph,
    G2OMeta)."""
    from rustrobotics_tpu_torch.mapping import g2o_native

    d = g2o_native.parse_native(path)
    if d is None:
        d = _parse_python(path)
    return _build_graph(d, dtype, device)


@dataclasses.dataclass
class _Builder:
    pose2_ids: dict
    lm2_ids: dict
    pose3_ids: dict
    poses2: list
    landmarks2: list
    poses3: list
    offsets: dict  # node id -> dof offset (reference layout)
    next_offset: int = 0


def _parse_python(path: str) -> dict:
    b = _Builder({}, {}, {}, [], [], [], {})
    pp, pl, qq = [], [], []
    prior2 = -1
    prior3 = -1
    edge_file_index = 0

    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            vals = parts[1:]
            if tag == "VERTEX_SE2":
                node_id = int(vals[0])
                b.pose2_ids[node_id] = len(b.poses2)
                b.poses2.append([float(v) for v in vals[1:4]])
                b.offsets[node_id] = b.next_offset
                b.next_offset += 3
            elif tag == "VERTEX_XY":
                node_id = int(vals[0])
                b.lm2_ids[node_id] = len(b.landmarks2)
                b.landmarks2.append([float(v) for v in vals[1:3]])
                b.offsets[node_id] = b.next_offset
                b.next_offset += 2
            elif tag == "VERTEX_SE3:QUAT":
                node_id = int(vals[0])
                x, y, z, qx, qy, qz, qw = (float(v) for v in vals[1:8])
                b.pose3_ids[node_id] = len(b.poses3)
                b.poses3.append([x, y, z, qw, qx, qy, qz])
                b.offsets[node_id] = b.next_offset
                b.next_offset += 6
            elif tag == "EDGE_SE2":
                f, t = int(vals[0]), int(vals[1])
                x, y, th, i11, i12, i13, i22, i23, i33 = (
                    float(v) for v in vals[2:11]
                )
                omega = [[i11, i12, i13], [i12, i22, i23], [i13, i23, i33]]
                pp.append((f, t, [x, y, th], omega, edge_file_index))
                if prior2 < 0:
                    prior2 = f  # gauge prior on the first SE2 edge's from node
                edge_file_index += 1
            elif tag == "EDGE_SE2_XY":
                f, t = int(vals[0]), int(vals[1])
                x, y, i11, i12, i22 = (float(v) for v in vals[2:7])
                pl.append((f, t, [x, y], [[i11, i12], [i12, i22]],
                           edge_file_index))
                edge_file_index += 1
            elif tag == "EDGE_SE3:QUAT":
                f, t = int(vals[0]), int(vals[1])
                x, y, z, qx, qy, qz, qw = (float(v) for v in vals[2:9])
                upper = [float(v) for v in vals[9:30]]
                omega = np.zeros((6, 6))
                k = 0
                for i in range(6):
                    for j in range(i, 6):
                        omega[i, j] = upper[k]
                        omega[j, i] = upper[k]
                        k += 1
                qq.append((f, t, [x, y, z, qw, qx, qy, qz], omega,
                           edge_file_index))
                if prior3 < 0:
                    prior3 = f
                edge_file_index += 1
            else:
                raise ValueError(f"unsupported g2o record {tag!r} in {path}")

    def idx(ids, table):
        return np.asarray([table[i] for i in ids], dtype=np.int32)

    pose2_offsets = [b.offsets[i]
                     for i in sorted(b.pose2_ids, key=b.pose2_ids.get)]
    lm2_offsets = [b.offsets[i] for i in sorted(b.lm2_ids, key=b.lm2_ids.get)]
    pose3_offsets = [b.offsets[i]
                     for i in sorted(b.pose3_ids, key=b.pose3_ids.get)]

    return {
        "poses2": np.asarray(b.poses2, dtype=np.float64).reshape(-1, 3),
        "landmarks2": np.asarray(b.landmarks2, dtype=np.float64).reshape(-1, 2),
        "poses3": np.asarray(b.poses3, dtype=np.float64).reshape(-1, 7),
        "pp_from": idx([e[0] for e in pp], b.pose2_ids),
        "pp_to": idx([e[1] for e in pp], b.pose2_ids),
        "pp_z": np.asarray([e[2] for e in pp], dtype=np.float64).reshape(-1, 3),
        "pp_omega": np.asarray(
            [e[3] for e in pp], dtype=np.float64).reshape(-1, 3, 3),
        "pl_pose": idx([e[0] for e in pl], b.pose2_ids),
        "pl_lm": idx([e[1] for e in pl], b.lm2_ids),
        "pl_z": np.asarray([e[2] for e in pl], dtype=np.float64).reshape(-1, 2),
        "pl_omega": np.asarray(
            [e[3] for e in pl], dtype=np.float64).reshape(-1, 2, 2),
        "qq_from": idx([e[0] for e in qq], b.pose3_ids),
        "qq_to": idx([e[1] for e in qq], b.pose3_ids),
        "qq_z": np.asarray([e[2] for e in qq], dtype=np.float64).reshape(-1, 7),
        "qq_omega": np.asarray(
            [e[3] for e in qq], dtype=np.float64).reshape(-1, 6, 6),
        "pose2_offsets": np.asarray(pose2_offsets, dtype=np.int32),
        "lm2_offsets": np.asarray(lm2_offsets, dtype=np.int32),
        "pose3_offsets": np.asarray(pose3_offsets, dtype=np.int32),
        "pp_file_index": np.asarray([e[4] for e in pp], dtype=np.int64),
        "pl_file_index": np.asarray([e[4] for e in pl], dtype=np.int64),
        "qq_file_index": np.asarray([e[4] for e in qq], dtype=np.int64),
        "total_dof": b.next_offset,
        "prior2": b.pose2_ids.get(prior2, -1) if prior2 >= 0 else -1,
        "prior3": b.pose3_ids.get(prior3, -1) if prior3 >= 0 else -1,
    }


def _build_graph(d: dict, dtype, device):
    """Numpy parse dict (native or Python) -> (graph on ``device``,
    G2OMeta)."""
    graph = graph_from_numpy(d, d["total_dof"], d["prior2"], d["prior3"],
                             device=device, dtype=dtype)
    return graph, G2OMeta(pp_file_index=d["pp_file_index"],
                          pl_file_index=d["pl_file_index"],
                          qq_file_index=d["qq_file_index"])
