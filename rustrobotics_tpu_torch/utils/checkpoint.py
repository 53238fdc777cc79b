"""Checkpoint / resume for optimizer and filter state (counterpart of
``rustrobotics_tpu/utils/checkpoint.py``).

A snapshot is the JAX package's file: a compressed ``.npz`` holding
``__meta__`` (JSON: the leaf count, the step and a description of the
structure) and ``leaf_{i}`` for each leaf in flattening order
(``utils.tree``: a dataclass's array fields in declaration order, dict
keys sorted). The port's ``PoseGraphData`` and the JAX package's flatten
to the same leaves, so a snapshot written by either package restores in
the other; that is how state crosses between them.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from rustrobotics_tpu_torch.utils.tree import leaves, unflatten


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        return type(tree).__name__ + "(" + ", ".join(
            _structure(v) for v in tree) + ")"
    return type(tree).__name__


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path, tree, step: int | None = None) -> str:
    """Snapshot a nested structure of tensors. Returns the written path."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = leaves(tree)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(flat)}
    meta = {"num_leaves": len(flat), "step": step,
            "treedef": _structure(tree)}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
    return str(path)


def _like(x: np.ndarray, template):
    """x as the template leaf's kind: a tensor of its dtype on its device,
    an array of its dtype, or a number."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(x, dtype=template.dtype).to(template.device)
    if isinstance(template, np.ndarray):
        return x.astype(template.dtype)
    return type(template)(x)


def restore_checkpoint(path, tree_template):
    """Restore into the structure of ``tree_template``, each leaf on its
    template's device and in its dtype. Returns (tree, step). The leaf
    count must match the template's."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = [data[f"leaf_{i}"] for i in range(meta["num_leaves"])]
    template_leaves = leaves(tree_template)
    if len(template_leaves) != len(flat):
        raise ValueError(
            f"checkpoint has {len(flat)} leaves, template has "
            f"{len(template_leaves)}"
        )
    restored = [_like(x, t) for x, t in zip(flat, template_leaves)]
    return unflatten(tree_template, restored), meta.get("step")


class CheckpointingOptimizer:
    """Wrap ``mapping.pgo.optimize`` with periodic snapshots and resume.

    The graph is snapshotted every ``every`` iterations and at the end;
    ``resume`` picks up from the newest snapshot in ``directory``.
    """

    def __init__(self, directory, every: int = 10):
        self.directory = pathlib.Path(directory)
        self.every = every

    def latest(self):
        if not self.directory.exists():
            return None
        snaps = sorted(self.directory.glob("pgo_*.npz"))
        return snaps[-1] if snaps else None

    def optimize(self, graph, num_iterations=50, resume=True, **kw):
        from rustrobotics_tpu_torch.mapping.pgo import optimize

        start_iter = 0
        if resume and (snap := self.latest()) is not None:
            graph, start_iter = restore_checkpoint(snap, graph)
            start_iter = int(start_iter or 0)

        def callback(it, g, error, norm_dx, lam):
            total = start_iter + it
            if total % self.every == 0:
                save_checkpoint(
                    self.directory / f"pgo_{total:06d}.npz", g, step=total
                )

        remaining = max(num_iterations - start_iter, 0)
        result = optimize(graph, num_iterations=remaining, callback=callback,
                          **kw)
        save_checkpoint(
            self.directory / f"pgo_{start_iter + result.iterations:06d}.npz",
            result.graph, step=start_iter + result.iterations,
        )
        return result
