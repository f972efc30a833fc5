"""The Hopper designs of `rmsnorm` and `reshard_pack`, checked on the CPU.

The CUDA kernels run only on the card (`tests/test_torch_cuda.py`), so
what can be held here is the arithmetic and the index maps they follow:

* a torch emulation of the `rmsnorm` kernel's partition — the launch
  configuration the wrapper passes it (`rmsnorm.launch_config`: words of
  16 bytes or single elements, threads per row, words per thread), each
  thread's partial sum of squares over its words in order, the warp's xor
  butterfly and the sum over warps in warp order — against the plain
  version and the JAX Pallas kernel in interpret mode;
* that the launch configuration covers every element of a row exactly
  once, for any d and dtype (hypothesis);
* the plain version of the one-launch, all-ranks `reshard_pack_ranks`
  against stacking the one-rank plain version and against the JAX
  package's `reshard/engine.py::gather_send_buckets` (jnp gather and
  Pallas kernel in interpret mode), over a sweep of planner tables.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import shard_mapping as jsm
from repro.kernels import ops as jops
from repro.reshard import engine as jengine
from repro_torch.core import shard_mapping as tsm
from repro_torch.kernels import ref
from repro_torch.kernels.reshard_pack import reshard_pack_ranks
from repro_torch.kernels.rmsnorm import (MAX_TPR, MAX_WORDS, WORD_BYTES,
                                         launch_config, rmsnorm)
from repro_torch.reshard import engine as tengine

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 3e-5, "bf16": 2e-2}


def _words_of_threads(d, itemsize, aligned):
    """(config, the word index each (slot i, thread t) holds, as a
    (per, tpr) array, and its mask of words inside the row). On the loop
    path a thread visits the same words in the same order, just not all in
    registers at once."""
    cfg = launch_config(d, itemsize, aligned)
    words = d // cfg.vec
    per = cfg.words_per_thread or -(-words // cfg.tpr)
    pos = (np.arange(cfg.tpr)[None, :] + np.arange(per)[:, None] * cfg.tpr)
    return cfg, pos, pos < words


def emulate_rmsnorm(x, w, *, eps=1e-6, plus_one=False, aligned=True):
    """The kernel's arithmetic in torch, step for step: f32 partial sums of
    squares per thread (one rounding per fused multiply-add), the warp's
    xor butterfly, the warps' totals summed in warp order, then
    x · rsqrt(total/d + eps) · w in f32, cast to x's type."""
    n, d = x.shape
    cfg, pos, valid = _words_of_threads(d, x.element_size(), aligned)
    x32 = x.float()
    words = x32.reshape(n, d // cfg.vec, cfg.vec)
    held = words[:, torch.from_numpy(np.minimum(pos, d // cfg.vec - 1))]
    held = held * torch.from_numpy(valid)[None, :, :, None]   # (n, per, tpr, vec)
    ss = torch.zeros((n, cfg.tpr), dtype=torch.float32)
    for i in range(held.shape[1]):
        for k in range(cfg.vec):
            v = held[:, i, :, k].double()
            ss = (ss.double() + v * v).float()                # fmaf
    lanes = ss.reshape(n, cfg.tpr // 32, 32)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., lane ^ off]
    total = torch.zeros(n, dtype=torch.float32)
    for warp in range(cfg.tpr // 32):
        total = total + lanes[:, warp, 0]
    r = torch.rsqrt(total / d + eps)[:, None]
    w32 = w.float() + 1.0 if plus_one else w.float()
    return (x32 * r * w32).to(x.dtype)


def _pair(a, name):
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("d", [100, 512, 1536, 3584])
@pytest.mark.parametrize("n", [1, 7, 64])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_partition_matches_plain_and_pallas(n, d, plus_one, name):
    rng = np.random.default_rng(n * d + plus_one)
    xj, xt = _pair(rng.normal(size=(n, d)), name)
    wj, wt = _pair(rng.normal(size=(d,)) * 0.1, name)
    pallas = np.asarray(jops.rmsnorm(xj, wj, plus_one=plus_one,
                                     interpret=True).astype(jnp.float32))
    plain = ref.rmsnorm_ref(xt, wt, plus_one=plus_one)
    assert torch.equal(rmsnorm(xt, wt, plus_one=plus_one), plain)
    for aligned in (True, False):          # 16-byte words / the scalar path
        got = emulate_rmsnorm(xt, wt, plus_one=plus_one, aligned=aligned)
        assert got.dtype == xt.dtype
        for want in (plain.float().numpy(), pallas):
            err = np.abs(got.float().numpy() - want).max()
            assert err < TOL[name], (aligned, err)


def test_rmsnorm_partition_loop_path():
    """A row too wide for registers (the loop path) sums in the same
    order; checked against the plain version at d 40,000 f32."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 40000)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(40000,)).astype(np.float32))
    assert launch_config(40000, 4, True).words_per_thread == 0
    got = emulate_rmsnorm(x, w)
    assert (got - ref.rmsnorm_ref(x, w)).abs().max().item() < 3e-5


@settings(max_examples=300, deadline=None)
@given(d=st.integers(1, 200_000), itemsize=st.sampled_from([4, 2]),
       aligned=st.booleans())
def test_rmsnorm_launch_config_covers_each_element_once(d, itemsize, aligned):
    cfg, pos, valid = _words_of_threads(d, itemsize, aligned)
    vec = WORD_BYTES // itemsize
    assert cfg.vec == (vec if aligned and d % vec == 0 else 1)
    words = d // cfg.vec
    assert words * cfg.vec == d
    assert cfg.tpr in (32, 64, 128, 256, 512, 1024) and cfg.tpr <= MAX_TPR
    if cfg.words_per_thread:          # register path: fewest threads that fit
        assert cfg.words_per_thread <= MAX_WORDS
        assert cfg.tpr * cfg.words_per_thread >= words
        assert cfg.tpr == 32 or (cfg.tpr // 2) * MAX_WORDS < words
    else:                             # loop path only past the registers
        assert words > MAX_TPR * MAX_WORDS and cfg.tpr == MAX_TPR
    elems = (pos[valid][:, None] * cfg.vec + np.arange(cfg.vec)).ravel()
    assert np.array_equal(np.bincount(elems, minlength=d), np.ones(d, int))


TABLE_SWEEP = [(8, 4, 3), (7, 4, 2), (28, 4, 3), (4, 4, 3), (148, 4, 3),
               (12, 8, 5), (48, 4, 2), (5, 2, 1)]


@pytest.mark.parametrize("k,n1,tp", TABLE_SWEEP)
def test_reshard_pack_ranks_plain_matches_per_rank_and_jax(k, n1, tp):
    _, _, tpre, tpost = tsm.plan(k, n1, tp)
    _, _, jpre, jpost = jsm.plan(k, n1, tp)
    rng = np.random.default_rng(k * 100 + n1 * 10 + tp)
    for tables, jtables in ((tpre, jpre), (tpost, jpost)):
        assert np.array_equal(tables.send_idx, jtables.send_idx)
        x = rng.normal(size=(n1, tables.buf + 1, 3, 4)).astype(np.float32)
        x[:, -1] = 0
        xt = torch.from_numpy(x)
        idx = torch.from_numpy(tables.send_idx)
        got = reshard_pack_ranks(xt.reshape(n1, tables.buf + 1, -1), idx)
        assert got.shape == (n1, n1, tables.s_max, 12)
        stacked = torch.stack([ref.reshard_pack_ref(xt[r].reshape(
            tables.buf + 1, -1), idx[r]) for r in range(n1)])
        assert torch.equal(got, stacked)
        buckets = tengine.gather_send_buckets(xt, idx)
        assert torch.equal(buckets.reshape(got.shape), got)
        for use_kernel in (False, True):
            want = jengine.gather_send_buckets(
                jnp.asarray(x), jnp.asarray(jtables.send_idx),
                use_kernel=use_kernel)
            assert np.array_equal(buckets.numpy(), np.asarray(want))


def test_reshard_pack_ranks_contract():
    xp = torch.zeros((3, 5, 8))
    with pytest.raises(ValueError, match="reshard_pack: expected xp"):
        reshard_pack_ranks(xp, torch.zeros((2, 3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="reshard_pack: expected xp"):
        reshard_pack_ranks(xp[0], torch.zeros((3, 3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="reshard_pack: no kernel"):
        reshard_pack_ranks(xp.to("meta"),
                           torch.zeros((3, 3, 1), dtype=torch.int32,
                                       device="meta"))
    with pytest.raises(IndexError):      # the plain version raises on one
        reshard_pack_ranks(xp, torch.full((3, 3, 1), 5, dtype=torch.int32))
