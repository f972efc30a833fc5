"""KV-cache reshard of the port against the JAX package's, bit for bit:
`ShardedState.apply_tp` chains (fail/repair sequences of TP degrees) give
the same rank buffers, the same dense view and the same traffic ledger
(`bytes_moved`, `moved_units_per_rank`, messages), and the rank-buffer
route `reshard_ranks`/`reshard_group` matches the JAX route with and
without its Pallas kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.core import shard_mapping as jsm
from repro.reshard import engine as jengine
from repro.reshard.state import ShardedState as JShardedState
from repro.reshard.units import cache_unit_resolver as jresolver
from repro_torch.configs.base import ArchConfig
from repro_torch.core import shard_mapping as tsm
from repro_torch.reshard import engine as tengine
from repro_torch.reshard.state import ShardedState
from repro_torch.reshard.units import cache_unit_resolver


def _cfgs(kvh):
    kw = dict(arch_id=f"kv{kvh}", family="dense", citation="test",
              n_layers=2, d_model=64, n_heads=8, n_kv_heads=kvh, head_dim=16,
              d_ff=128, vocab_size=256)
    return JArchConfig(**kw), ArchConfig(**kw)


CHAINS = [
    (4, 4, [3, 2, 3, 4]),          # the serving path: fail, fail, repair, repair
    (2, 4, [3, 1, 4]),             # fewer heads than ranks
    (8, 8, [5, 7, 2, 8]),          # a wider domain
]


@pytest.mark.parametrize("kvh,n1,chain", CHAINS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_tp_chain_bit_identical(kvh, n1, chain, use_kernel):
    jcfg, tcfg = _cfgs(kvh)
    rng = np.random.default_rng(kvh * 10 + n1)
    # (layers, slots, T, kvh, hd): the port's cache leaf layout
    k = rng.normal(size=(2, 3, 5, kvh, 16)).astype(np.float32)
    v = rng.normal(size=(2, 3, 5, kvh, 16)).astype(np.float32)
    jstate = JShardedState({"layers": ({"k": jnp.asarray(k), "v": jnp.asarray(v)},)},
                           jresolver(jcfg), n1, use_kernel=use_kernel)
    tstate = ShardedState({"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
                          cache_unit_resolver(tcfg), n1)
    for tp in chain:
        js = jstate.apply_tp(tp)
        ts = tstate.apply_tp(tp)
        assert ts == js
        for jb, tb in zip(jstate.sharded, tstate.sharded):
            assert np.array_equal(np.asarray(jb), tb.numpy())
        jd, td = jstate.gather()["layers"][0], tstate.gather()
        for name in ("k", "v"):
            assert np.array_equal(np.asarray(jd[name]), td[name].numpy())
    # the chain ends where it started: the dense view is the original
    if chain[-1] == n1:
        assert np.array_equal(tstate.gather()["k"].numpy(), k)


def test_noop_and_roundtrip():
    _, tcfg = _cfgs(4)
    k = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(2, 3, 4, 8)
    st = ShardedState({"k": k, "v": k + 1}, cache_unit_resolver(tcfg), 4, tp=3)
    assert st.apply_tp(3)["bytes_moved"] == 0
    assert torch.equal(st.gather()["k"], k)
    assert torch.equal(st.gather()["v"], k + 1)
    # pad slots of the rank buffers are exact zeros
    assert not st.sharded[0][3].any()
    with pytest.raises(ValueError, match="outside"):
        st.apply_tp(5)


@pytest.mark.parametrize("k,n1,n2", [(8, 4, 3), (7, 4, 2), (28, 4, 3)])
def test_reshard_route_matches_jax(k, n1, n2):
    rng = np.random.default_rng(k + n1 + n2)
    _, _, tpre, _ = tsm.plan(k, n1, n2)
    _, _, jpre, _ = jsm.plan(k, n1, n2)
    x = rng.normal(size=(n1, tpre.buf, 3, 4)).astype(np.float32)
    y = rng.normal(size=(n1, tpre.buf, 5)).astype(np.float32)
    got = tengine.reshard_ranks(torch.from_numpy(x), tpre).numpy()
    for use_kernel in (False, True):
        want = np.asarray(jengine.reshard_ranks(jnp.asarray(x), jpre,
                                                use_kernel=use_kernel))
        assert np.array_equal(got, want)
    got_g = tengine.reshard_group([torch.from_numpy(x), torch.from_numpy(y)], tpre)
    want_g = jengine.reshard_group([jnp.asarray(x), jnp.asarray(y)], jpre)
    for a, b in zip(got_g, want_g):
        assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="mixed-dtype"):
        tengine.reshard_group([torch.from_numpy(x),
                               torch.zeros(y.shape, dtype=torch.int32)], tpre)
