"""Parameter conversion from the JAX reference.

`ntp_params_from_jax` turns the reference's NTP prototype trees (numpy, e.g.
``jax.tree.map(np.asarray, tree)``: canonical weights from
`repro.core.ntp_train.init_canonical`, packed trees, or AdamW states) into
the port's; the two packages share the layouts, so this is a structural
copy (int32 counters stay int32). Tests use it to feed both packages
identical parameters.

`params_from_jax` turns the JAX package's parameter tree (as numpy arrays,
e.g. ``jax.tree.map(np.asarray, params)``) into the port's parameter dict.
The JAX tree stacks each layer-pattern entry's blocks on a leading cycle
axis (``layers`` is a tuple with one stacked block dict per pattern entry,
``tail`` holds the leftover blocks); the port keeps one block dict per
layer, in the reference's execution order. Weights keep the ``(in, out)``
layout, so the two packages compute the same products. A post-norm block
(gemma2) carries ``ln1_post``/``ln2_post``. Leaves of blocks the port
does not run yet — an encoder, absolute position embeddings, cross
attention, LayerNorm biases, RG-LRU mixers — are refused. An MoE block's FFN
(the reference's `moe_init`) comes across leaf for leaf: ``router`` (d, E)
in f32, the expert-stacked ``w_up`` / ``w_gate`` (E, d, ff) and ``w_down``
(E, ff, d), and the ``shared`` expert or ``dense`` residual MLP; every
leaf keeps its dtype.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import mode

_TOP = {"embed", "final_norm", "lm_head", "layers", "tail"}
_BLOCK = {"ln1", "ln1_post", "mixer", "ln2", "ffn", "ln2_post"}


def _to_torch(tree, device: torch.device):
    """Dicts, lists and tuples are containers (the NTP trees keep their
    layers in a list); every other node is one array."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    return torch.from_numpy(np.array(tree)).to(device)


def ntp_params_from_jax(tree: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """The reference's NTP prototype tree of numpy arrays (canonical or
    packed params, or an optimizer state with ``m``/``v``/``step``) → the
    same tree of tensors on ``device`` (CUDA unless ``device="cpu"``)."""
    return _to_torch(tree, mode.resolve_device(device))


def params_from_jax(tree: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """JAX parameter tree of numpy arrays → the port's parameters on
    ``device`` (CUDA unless ``device="cpu"``)."""
    blocks = list(tree.get("layers", ())) + list(tree.get("tail", ()))
    unknown = set(tree) - _TOP
    for block in blocks:
        unknown |= set(block) - _BLOCK
        unknown |= {f"{k}/b" for k in block if k.startswith("ln")
                    and "b" in block[k]}
        if "lam" in block.get("mixer", {}):
            unknown.add("mixer/lam")
    if unknown:
        raise ValueError(
            f"params_from_jax: leaves {sorted(unknown)} belong to blocks the "
            "port does not run yet"
        )
    dev = mode.resolve_device(device)
    layers = []
    cycles = tree.get("layers", ())
    n_cyc = len(next(iter(cycles[0]["ln1"].values()))) if cycles else 0
    for c in range(n_cyc):
        for block in cycles:
            layers.append(_to_torch(_index(block, c), dev))
    for block in tree.get("tail", ()):
        layers.append(_to_torch(block, dev))
    out = {
        "embed": _to_torch(tree["embed"], dev),
        "final_norm": _to_torch(tree["final_norm"], dev),
        "layers": layers,
    }
    if "lm_head" in tree:
        out["lm_head"] = _to_torch(tree["lm_head"], dev)
    return out


def _index(block, c: int):
    if isinstance(block, dict):
        return {k: _index(v, c) for k, v in block.items()}
    return np.asarray(block)[c]
