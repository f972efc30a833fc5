"""`serve/kv_shard.py` of the port against the reference's
(`repro.serve.kv_shard`), on the cases of tests/test_kv_shard_properties.py
(random head counts, domain widths and chains of TP degrees, KV heads
fewer than ranks included):

* head layouts, buffer slots and reshard tables equal the reference's bit
  for bit;
* shard ∘ gather is the identity, any chain of TP transitions (degrade
  and restore) keeps the gathered cache exact and its pad slots exact
  zeros, and returning to the start restores the sharded buffers exactly,
  in f32 and in bf16, every hop's buffers equal to the reference's
  (`reshard_pack`'s plain version here);
* NaN planted in every pad slot never reaches the rank-local attention,
  which equals the dense one bit for bit and the reference's within 3e-5;
* `ShardedKV` round-trips a grouped cache through its transitions, with
  the reference's traffic stats, and refuses non-KV leaves.

On the card `reshard_leaf` packs with the hand-written `reshard_pack`:
`test_kernel_route_on_card` holds it against the same reshard of a CPU
copy bit for bit (skipped without one)."""
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="dev dependency: pip install -e .[dev]")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.serve import kv_shard as jkvs  # noqa: E402
from repro_torch.serve import ShardedKV  # noqa: E402
from repro_torch.serve import kv_shard as kvs  # noqa: E402

HD = 4
TOL = 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@st.composite
def shard_case(draw):
    n1 = draw(st.integers(1, 5))
    kvh = draw(st.integers(1, 8))
    tps = draw(st.lists(st.integers(1, n1), min_size=1, max_size=4))
    seed = draw(st.integers(0, 2**16))
    return n1, kvh, tps, seed


def _dense(rng, kvh, b=2, t=3):
    return rng.normal(size=(b, t, kvh, HD)).astype(np.float32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _pads(layout, buf):
    return torch.from_numpy(kvs.slots_at(layout, buf) < 0)


@settings(max_examples=40, deadline=None)
@given(shard_case())
def test_layouts_and_tables_match_reference(case):
    n1, kvh, tps, _ = case
    for tp in range(1, n1 + 1):
        got, want = kvs.head_layout(kvh, tp, n1), jkvs.head_layout(kvh, tp, n1)
        for f in ("k", "n", "max_count"):
            assert getattr(got, f) == getattr(want, f)
        for f in ("assignment", "counts", "local_slot"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(kvs.slots_at(got, kvh),
                                      jkvs.slots_at(want, kvh))
        # fewer heads than live ranks: the rest hold none
        assert (got.counts > 0).sum() == min(kvh, tp)
    for a, b in zip([n1] + tps, tps + [n1]):
        got = kvs.head_reshard_tables(kvh, a, b, n1)
        want = jkvs.head_reshard_tables(kvh, a, b, n1)
        assert (got.n, got.s_max, got.buf) == (want.n, want.s_max, want.buf)
        for f in ("send_idx", "recv_idx", "stay_idx"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@settings(max_examples=40, deadline=None)
@given(case=shard_case())
def test_reshard_chain_preserves_cache_and_pads(dtype, case):
    n1, kvh, tps, seed = case
    dense = _dense(np.random.default_rng(seed), kvh)
    tdense = torch.from_numpy(dense).to(getattr(torch, dtype))
    jdense = jnp.asarray(dense, dtype=getattr(jnp, dtype))

    layout = kvs.head_layout(kvh, n1, n1)
    x0 = kvs.shard_leaf(tdense, layout, kvh)
    jx = jkvs.shard_leaf(jdense, jkvs.head_layout(kvh, n1, n1), kvh)
    np.testing.assert_array_equal(_np(x0.float()), _np(jx))
    assert torch.equal(kvs.gather_leaf(x0, layout), tdense)

    x, tp = x0, n1
    for new_tp in tps + [n1]:            # ... and back to the start
        x = kvs.reshard_leaf(x, kvs.head_reshard_tables(kvh, tp, new_tp, n1))
        jx = jkvs.reshard_leaf(jx, jkvs.head_reshard_tables(kvh, tp, new_tp,
                                                            n1))
        tp = new_tp
        layout = kvs.head_layout(kvh, tp, n1)
        np.testing.assert_array_equal(_np(x.float()), _np(jx),
                                      err_msg=str((n1, kvh, tp)))
        assert torch.equal(kvs.gather_leaf(x, layout), tdense), (n1, kvh, tp)
        assert (x[_pads(layout, kvh)] == 0).all(), (n1, kvh, tp)
    assert torch.equal(x, x0), (n1, kvh, tps)


@settings(max_examples=40, deadline=None)
@given(shard_case())
def test_pad_slots_never_leak_into_attention(case):
    n1, kvh, tps, seed = case
    tp = tps[0]
    rng = np.random.default_rng(seed)
    b, t, g, sq = 2, 4, 2, 4
    q = rng.normal(size=(b, kvh, g, sq, HD)).astype(np.float32)
    k, v = _dense(rng, kvh, b, t), _dense(rng, kvh, b, t)
    mask = np.tril(np.ones((sq, t), bool))

    layout = kvs.head_layout(kvh, tp, n1)
    pads = _pads(layout, kvh)
    sk = kvs.shard_leaf(torch.from_numpy(k), layout, kvh)
    sv = kvs.shard_leaf(torch.from_numpy(v), layout, kvh)
    sk[pads] = float("nan")
    sv[pads] = float("nan")

    tq, tmask = torch.from_numpy(q), torch.from_numpy(mask)
    dense = kvs.attend_heads(tq, torch.from_numpy(k), torch.from_numpy(v),
                             tmask)
    shard = kvs.attend_from_sharded(tq, sk, sv, layout, tmask)
    assert torch.isfinite(shard).all(), (n1, kvh, tp)
    assert torch.equal(dense, shard), (n1, kvh, tp)
    want = jkvs.attend_heads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask))
    np.testing.assert_allclose(shard.numpy(), np.asarray(want), atol=TOL)


@settings(max_examples=20, deadline=None)
@given(shard_case())
def test_sharded_kv_container_roundtrip(case):
    """A grouped cache (two pattern groups and a tail layer) through the
    chain: the dense view is exact after every transition, `update`
    re-scatters into the current layout, and each transition's stats
    equal the reference container's on the same cache."""
    n1, kvh, tps, seed = case
    rng = np.random.default_rng(seed)
    leaves = {n: _dense(rng, kvh) for n in ("k.0", "v.0", "k.t0", "v.t0")}
    cache = {n: torch.from_numpy(a) for n, a in leaves.items()}
    jcache = {"layers": {"k": jnp.asarray(leaves["k.0"]),
                         "v": jnp.asarray(leaves["v.0"])},
              "tail": ({"k": jnp.asarray(leaves["k.t0"]),
                        "v": jnp.asarray(leaves["v.t0"])},)}
    skv, jskv = ShardedKV(cache, kvh, n1), jkvs.ShardedKV(jcache, kvh, n1)
    for new_tp in tps:
        st_, jst = skv.apply_tp(new_tp), jskv.apply_tp(new_tp)
        assert st_["tp_to"] == new_tp and skv.tp == new_tp
        for key in ("tp_from", "tp_to", "moved_units_per_rank",
                    "moved_heads_per_rank", "bytes_moved", "messages"):
            assert st_[key] == jst[key], key
        assert skv.layout.assignment.tolist() == \
            jskv.layout.assignment.tolist()
    got = skv.gather()
    assert all(torch.equal(got[n], cache[n]) for n in cache)
    bumped = {n: a + 1.0 for n, a in got.items()}
    skv.update(bumped)
    again = skv.gather()
    assert all(torch.equal(again[n], bumped[n]) for n in cache)


def test_sharded_kv_rejects_non_kv_leaves():
    for name in ("h", "conv.0", "ek", "ev.t0"):
        with pytest.raises(ValueError, match="k/v leaves only"):
            ShardedKV({name: torch.zeros(2, 3, 4, HD)}, 4, 4)
    with pytest.raises(ValueError, match="k/v leaves only"):
        jkvs.ShardedKV({"h": jnp.zeros((2, 3, 4, HD))}, 4, 4)
    with pytest.raises(ValueError, match="KV heads"):
        kvs.shard_leaf(torch.zeros(2, 3, 4, HD), kvs.head_layout(3, 2, 2), 3)


@pytest.mark.cuda
def test_kernel_route_on_card():
    """On the card `reshard_leaf` packs the send buckets with the
    hand-written `reshard_pack`: the same bits as the same reshard of a
    CPU copy (the plain version), one counted launch a hop, MQA (one head
    on four ranks) included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from repro_torch.kernels import build, mode

    build.build_all()
    rng = np.random.default_rng(7)
    for kvh, n1, chain in ((6, 4, (2, 3, 4)), (1, 4, (3, 2, 4))):
        dense = torch.from_numpy(_dense(rng, kvh)).cuda()
        x = kvs.shard_leaf(dense, kvs.head_layout(kvh, n1, n1), kvh)
        tp = n1
        for new_tp in chain:
            tables = kvs.head_reshard_tables(kvh, tp, new_tp, n1)
            mode.reset_launches()
            a = kvs.reshard_leaf(x, tables)
            assert mode.launches()["reshard_pack"] == 1
            b = kvs.reshard_leaf(x.cpu(), tables)
            assert torch.equal(a.cpu(), b)
            x, tp = a, new_tp
        assert torch.equal(kvs.gather_leaf(x, kvs.head_layout(kvh, n1, n1)),
                           dense)
