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
layer, in the reference's execution order (the cycles, then the tail).
An enc-dec config's ``encoder`` ({``layers``: its stacked ``attn_bidir``
blocks, ``final_norm``}) becomes {``layers``: a list of block dicts,
``final_norm``}. Weights keep the ``(in, out)`` layout, so the two
packages compute the same products, and every leaf keeps its dtype:
a post-norm block's ``ln1_post``/``ln2_post``, a LayerNorm's bias ``b``,
``pos_embed``, an enc-dec block's ``ln_cross``/``cross``, an RG-LRU mixer
(its f32 ``lam``, ``bias_a`` and ``bias_i`` beside the block-diagonal
gates) and an MoE block's FFN (the reference's `moe_init`: ``router``
(d, E) in f32, the expert-stacked ``w_up`` / ``w_gate`` (E, d, ff) and
``w_down`` (E, ff, d), and the ``shared`` expert or ``dense`` residual
MLP) come across leaf for leaf. A leaf the reference's model does not
make is refused.

`opt_state_from_jax` does the same for the reference's AdamW state of such
a tree (`repro.optim.adamw_init` and its updates): ``m``, ``v`` and, with
low-precision params, ``master`` are parameter trees and convert as the
params do; ``step`` stays an int32 scalar. With it both packages can start
a training step from one state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import mode

_TOP = {"embed", "final_norm", "lm_head", "pos_embed", "layers", "tail",
        "encoder"}
_BLOCK = {"ln1", "ln1_post", "ln_cross", "cross", "ln2", "ffn", "ln2_post",
          "mixer"}

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
    enc = tree.get("encoder", {})
    blocks = [*tree.get("layers", ()), *tree.get("tail", ()),
              *enc.get("layers", ())]
    unknown = set(tree) - _TOP
    unknown |= {f"encoder/{k}" for k in set(enc) - {"layers", "final_norm"}}
    for block in blocks:
        unknown |= set(block) - _BLOCK
    if unknown:
        raise ValueError(
            f"params_from_jax: leaves {sorted(unknown)} are not leaves of "
            "the reference's model"
        )
    dev = mode.resolve_device(device)
    out = {
        "embed": _to_torch(tree["embed"], dev),
        "final_norm": _to_torch(tree["final_norm"], dev),
        "layers": (_unstack(tree.get("layers", ()), dev)
                   + [_to_torch(block, dev) for block in tree.get("tail", ())]),
    }
    for name in ("lm_head", "pos_embed"):
        if name in tree:
            out[name] = _to_torch(tree[name], dev)
    if enc:
        out["encoder"] = {"layers": _unstack(enc["layers"], dev),
                          "final_norm": _to_torch(enc["final_norm"], dev)}
    return out


def opt_state_from_jax(state: Dict[str, Any], *, device=None) -> Dict[str, Any]:
    """The reference's AdamW state (numpy) → the port's, on ``device``
    (CUDA unless ``device="cpu"``)."""
    unknown = set(state) - {"m", "v", "master", "step"}
    if unknown:
        raise ValueError(
            f"opt_state_from_jax: keys {sorted(unknown)} are not keys of "
            "the reference's AdamW state"
        )
    out = {k: params_from_jax(state[k], device=device)
           for k in ("m", "v", "master") if k in state}
    out["step"] = _to_torch(state["step"], mode.resolve_device(device))
    return out


def _unstack(cycles, dev):
    """The blocks of stacked pattern entries ``cycles`` (a tuple of block
    dicts whose leaves carry a leading cycle axis), one dict per layer in
    execution order: cycle by cycle, each cycle's entries in order."""
    n_cyc = len(next(iter(cycles[0]["ln1"].values()))) if cycles else 0
    return [_to_torch(_index(block, c), dev)
            for c in range(n_cyc) for block in cycles]


def _index(block, c: int):
    if isinstance(block, dict):
        return {k: _index(v, c) for k, v in block.items()}
    return np.asarray(block)[c]
