"""The port's checkpoints against the JAX package's, on the CPU: a file
written by `repro.checkpoint.save_checkpoint` restores in the port and the
reverse, for f32, bf16 and fp8 leaves, with and without a target tree
(mirrors `tests/test_checkpoint_dtypes.py`); the port's keys are the
reference's `jax.tree_util` path names on the session's real param and
optimizer trees; and a port session's `save` restores bit-identically into
a port session under a different plan."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import checkpoint as jck
from repro_torch import checkpoint as tck
from repro_torch import tree as tr
from repro_torch.core import ntp_train as nt
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

KW = dict(d_model=64, n_kv_groups=4, q_per_kv=2, head_dim=16, d_ff=256,
          unit_rows=64, vocab=128)
DTYPES = ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
# The reference writes float8_e5m2 unwidened (ml_dtypes gives it kind "f",
# which its widening test misses), as '<f1', which np.load cannot read back
# in either package; so files it writes are tested for the other three.
JAX_WRITTEN = DTYPES[:3]


def _values(seed=0):
    """Numpy f32 values every dtype holds exactly (fp8 e5m2 has 2 mantissa
    bits): small multiples of 1/4."""
    rng = np.random.default_rng(seed)
    return {
        "w": (rng.integers(-8, 8, (3, 4)) / 4).astype(np.float32),
        "layers": [(rng.integers(-8, 8, (5,)) / 4).astype(np.float32)
                   for _ in range(2)],
        "step": np.asarray(7, np.int32),
        "ints": np.arange(4, dtype=np.int32),
    }


def _jax_tree(dtype):
    v = _values()
    jd = getattr(jnp, dtype)
    return {"w": jnp.asarray(v["w"], jd),
            "layers": [jnp.asarray(x, jd) for x in v["layers"]],
            "step": jnp.asarray(v["step"]), "ints": v["ints"]}


def _torch_tree(dtype):
    v = _values()
    td = getattr(torch, dtype)
    return {"w": torch.from_numpy(v["w"]).to(td),
            "layers": [torch.from_numpy(x).to(td) for x in v["layers"]],
            "step": torch.from_numpy(v["step"]),
            "ints": torch.from_numpy(v["ints"])}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind in "fV" else a


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("with_target", [True, False])
@pytest.mark.parametrize("dtype", JAX_WRITTEN)
def test_jax_checkpoint_restores_in_port(tmp_path, dtype, with_target):
    path = str(tmp_path / "ck.npz")
    jtree = _jax_tree(dtype)
    jck.save_checkpoint(path, jtree, step=5)
    if with_target:
        # an f32 target: the recorded dtype must win
        like = tr.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32)
                           if t.is_floating_point() else torch.zeros_like(t),
                           _torch_tree(dtype))
        got, step = tck.load_checkpoint(path, like)
        pairs = zip(tr.leaves(got), jax.tree.leaves(jtree))
    else:
        got, step = tck.load_checkpoint(path)
        flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                         for p in path_): leaf
                for path_, leaf in
                jax.tree_util.tree_flatten_with_path(jtree)[0]}
        assert set(got) == set(flat)
        pairs = ((got[k], flat[k]) for k in flat)
    assert step == 5
    for a, b in pairs:
        assert _dtype_name(a) == str(np.asarray(b).dtype), (a.dtype, b.dtype)
        assert np.array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("with_target", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_port_checkpoint_restores_in_jax(tmp_path, dtype, with_target):
    path = str(tmp_path / "ck.npz")
    ttree = _torch_tree(dtype)
    tck.save_checkpoint(path, ttree, step=9)
    if with_target:
        like = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(np.shape(x), jnp.float32)
            if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
            else jax.ShapeDtypeStruct(np.shape(x), jnp.asarray(x).dtype),
            _jax_tree(dtype))
        got, step = jck.load_checkpoint(path, like)
        pairs = zip(jax.tree.leaves(got), tr.leaves(ttree))
    else:
        got, step = jck.load_checkpoint(path)
        flat = {tr.path_key(p): leaf for p, leaf in tr.leaves_with_path(ttree)}
        assert set(got) == set(flat)
        pairs = ((got[k], flat[k]) for k in flat)
    assert step == 9
    for a, b in pairs:
        assert str(np.asarray(a).dtype) == _dtype_name(b)
        assert np.array_equal(_f32(a), _f32(b))


def test_legacy_file_and_reserved_keys(tmp_path):
    path = str(tmp_path / "ck.npz")
    np.savez(path, a=np.ones((3,), np.float32), __step__=np.asarray(7))
    got, step = tck.load_checkpoint(
        path, {"a": torch.zeros(3, dtype=torch.bfloat16)})
    assert step == 7 and got["a"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape"):
        tck.load_checkpoint(path, {"a": torch.zeros(4)})
    with pytest.raises(KeyError, match="b"):
        tck.load_checkpoint(path, {"b": torch.zeros(3)})
    for bad in ({"__step__": torch.zeros(1)},
                {"__dtype__": {"x": torch.zeros(1)}}):
        with pytest.raises(ValueError, match="reserved"):
            tck.save_checkpoint(str(tmp_path / "bad.npz"), bad)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]   # nothing half-written


def _session(plan_events=(), overlap=False):
    cfg = nt.NTPModelConfig(n_layers=2, **KW)
    canon = nt.init_canonical(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    s = NTPSession.create(cfg, (2, 4), local_batch=4, params=canon,
                          optimizer=adamw(AdamWConfig(lr=1e-2)),
                          overlap=overlap, device="cpu")
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, 16, 8, seed=0))
    for i, ev in enumerate(plan_events):
        s.step(pipe._batch_np(i))
        s.apply(ev)
    s.step(pipe._batch_np(len(plan_events)))
    return s


def test_path_keys_match_jax_tree_paths():
    """`tree.path_key` equals the reference's key of every leaf of the
    session's real canonical param and AdamW trees, in flatten order."""
    s = _session()
    state = s._canonical_state()
    ours = [tr.path_key(p) for p, _ in tr.leaves_with_path(state)]
    jstate = tr.tree_map(lambda t: np.asarray(t.numpy()), state)
    theirs = ["/".join(str(p.key) if hasattr(p, "key") else str(p.idx)
                       for p in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert ours == theirs
    assert "opt/m/layers/1/wq" in ours and "opt/step" in ours


def test_session_save_restores_bit_identically_under_another_plan(tmp_path):
    """Save from a session at TP (3, 4) after AdamW steps; restore into a
    fresh session at TP (4, 4) and into one at TP (2, 4): canonical params,
    moments and step come back bit for bit, and the next step agrees."""
    path = str(tmp_path / "session.npz")
    src = _session([FailureEvent(replica=1)])
    assert src.plan.replica_tp == (3, 4)
    src.save(path)
    want = src._canonical_state()
    for events in ((), (FailureEvent(replica=0, n_gpus=2),)):
        dst = _session(events)
        assert dst.plan != src.plan
        assert dst.restore(path) == src.opt_step == 2
        got = dst._canonical_state()
        for a, b in zip(tr.leaves(got), tr.leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for r in range(2):
            for a, b in zip(tr.leaves(dst.canonical_params(r)),
                            tr.leaves(want["params"])):
                assert torch.equal(a, b)
    # the restored session trains on, equal to the saving one
    pipe = SyntheticLMPipeline(DataConfig(src.cfg.vocab, 16, 8, seed=3))
    dst.apply(RecoveryEvent(replica=0, n_gpus=2))
    dst.apply(FailureEvent(replica=1))
    assert dst.plan == src.plan
    a = src.step(pipe._batch_np(0))
    b = dst.step(pipe._batch_np(0))
    assert float(a["loss"]) == float(b["loss"])
    with np.load(path) as data:   # the reference's layout, dense shapes
        assert data["params/embed"].shape == (src.cfg.vocab,
                                              src.cfg.d_model)
        assert int(data["__step__"]) == 2 and "opt/v/head" in data.files
