"""Checkpoints in the reference's format (the port's copy of
`repro/checkpoint/checkpoint.py`): one ``.npz`` written atomically, keyed by
the reference's tree paths, so a checkpoint written by either package
restores in the other.

Keys are `tree.path_key` of each leaf: dict keys and list indices joined by
``/`` (``params/layers/0/wq``), as `jax.tree_util` renders them. ``.npz``
cannot hold bf16 or fp8, so such leaves are widened to float32 on save and
their dtype is recorded next to them (``__dtype__/<key>``) under the
ml_dtypes name the reference writes (``bfloat16``, ``float8_e4m3fn``, …);
`load_checkpoint` casts back. The recorded dtype wins over the target
tree's leaf dtype, which only fills in for leaves without a record; callers
that want another dtype cast after load. The optional step is stored as
``__step__``.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tr

_DTYPE_KEY = "__dtype__/"

# torch dtypes numpy cannot hold, by the ml_dtypes name the reference records
_WIDENED = {
    name: getattr(torch, name)
    for name in ("bfloat16", "float8_e4m3fn", "float8_e5m2",
                 "float8_e4m3fnuz", "float8_e5m2fnuz")
    if hasattr(torch, name)
}
_NAMES = {dt: name for name, dt in _WIDENED.items()}


def _to_numpy(leaf, key: str, flat: Dict[str, np.ndarray]) -> np.ndarray:
    """``leaf`` (a tensor or an array) as a numpy array for savez; a dtype
    numpy cannot hold is widened to float32 and recorded in ``flat``."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    name = _NAMES.get(t.dtype)
    if name is None:
        return t.numpy()
    flat[_DTYPE_KEY + key] = np.asarray(name)
    return t.float().numpy()


def save_checkpoint(path: str, tree, step: Optional[int] = None) -> None:
    """Write ``tree`` (nested dicts/lists of tensors or arrays) to ``path``
    atomically: a temporary file in the same directory, then `os.replace`."""
    flat: Dict[str, np.ndarray] = {}
    for p, leaf in tr.leaves_with_path(tree):
        key = tr.path_key(p)
        if key.startswith(_DTYPE_KEY) or key == "__step__":
            raise ValueError(f"reserved checkpoint key {key!r}")
        flat[key] = _to_numpy(leaf, key, flat)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _WIDENED:
        raise ValueError(f"checkpoint dtype {name!r} has no torch "
                         "counterpart")
    return _WIDENED[name]


def load_checkpoint(path: str, like_tree=None, *, device=None):
    """Restore a checkpoint. With ``like_tree`` (a tree of tensors): into
    its structure, each leaf on ``device`` or else its like leaf's device (shapes checked;
    recorded dtypes win over the like leaf's, which only fills in for
    unrecorded leaves; like leaves may be ``meta`` tensors when ``device``
    is given). Without: the flat ``{key: tensor}`` dict on ``device`` (the
    CPU by default) with recorded dtypes restored. Returns
    ``(tree_or_flat_dict, step or None)``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__")) if "__step__" in flat else None
    dtypes = {
        k[len(_DTYPE_KEY):]: str(flat.pop(k))
        for k in [k for k in flat if k.startswith(_DTYPE_KEY)]
    }

    def restore(key: str, arr: np.ndarray, like=None):
        # (np.ascontiguousarray would turn a 0-d leaf, the step, into 1-d)
        t = torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())
        name = dtypes.get(key)
        if name is not None:
            dtype = _torch_dtype(name)
        else:
            dtype = t.dtype if like is None else like.dtype
        dev = device
        if dev is None:
            dev = "cpu" if like is None else like.device
        return t.to(device=dev, dtype=dtype)

    if like_tree is None:
        return {k: restore(k, v) for k, v in flat.items()}, step

    def leaf(p, like):
        key = tr.path_key(p)
        if key not in flat:
            raise KeyError(f"checkpoint {path} has no leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{arr.shape}, the target {tuple(like.shape)}")
        return restore(key, arr, like)

    return tr.tree_map_with_path(leaf, like_tree), step
