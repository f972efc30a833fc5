"""The port's kernels against the JAX package's: on the CPU each wrapper runs
its plain PyTorch version (`repro_torch.kernels.ref`), held here against
the Pallas kernels in interpret mode (`repro.kernels.ops`) and against
their jnp oracles (`repro.kernels.ref`) on the same numpy inputs, at the
tolerances of `tests/test_kernels.py::_tol`. The CUDA kernels themselves
are held against the same plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mode
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.reshard_pack import reshard_pack
from repro_torch.kernels.rmsnorm import rmsnorm

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bf16" else 3e-5


def _pair(a, name):
    """One numpy array as a JAX array and a torch tensor of the same type."""
    jdt, tdt = DTYPES[name]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


FLASH_CASES = (
    # GQA 2:1, both dtypes
    [((1, 4, 2, 128, 64, 64, 64), kind, name)
     for kind in ("causal", "sliding", "chunked", "bidir")
     for name in ("f32", "bf16")]
    # MHA, batch 2, ragged q/k blocks
    + [((2, 4, 4, 64, 32, 32, 64), kind, "f32")
       for kind in ("causal", "sliding", "chunked", "bidir")]
)


@pytest.mark.parametrize("shape,kind,name", FLASH_CASES)
def test_flash_attention_matches_jax(shape, kind, name):
    b, h, kvh, s, d, bq, bk = shape
    rng = np.random.default_rng([b, h, kvh, s, d, len(kind)])
    qj, qt = _pair(rng.normal(size=(b, h, s, d)), name)
    kj, kt = _pair(rng.normal(size=(b, kvh, s, d)), name)
    vj, vt = _pair(rng.normal(size=(b, kvh, s, d)), name)
    kw = dict(kind=kind, window=24, chunk=32)
    got = flash_attention(qt, kt, vt, block_q=bq, block_k=bk, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = jops.flash_attention(qj, kj, vj, block_q=bq, block_k=bk,
                                  interpret=True, **kw)
    oracle = jref.flash_attention_ref(qj, kj, vj, **kw)
    for want in (pallas, oracle):
        err = np.abs(_np(got) - _np(want)).max()
        assert err < _tol(name), (kind, name, err)


def test_flash_attention_softcap_matches_jax():
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng.normal(size=(1, 4, 64, 32)) * 4, "f32")
    kj, kt = _pair(rng.normal(size=(1, 2, 64, 32)) * 4, "f32")
    vj, vt = _pair(rng.normal(size=(1, 2, 64, 32)), "f32")
    got = flash_attention(qt, kt, vt, softcap=5.0, block_q=32, block_k=32)
    pallas = jops.flash_attention(qj, kj, vj, softcap=5.0, block_q=32,
                                  block_k=32, interpret=True)
    oracle = jref.flash_attention_ref(qj, kj, vj, softcap=5.0)
    for want in (pallas, oracle):
        assert np.abs(_np(got) - _np(want)).max() < 3e-5


@pytest.mark.parametrize("name", ["f32", "bf16"])
@pytest.mark.parametrize("n,d,br", [(64, 128, 32), (32, 384, 32), (8, 512, 256)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_jax(n, d, br, plus_one, name):
    rng = np.random.default_rng(n * d)
    xj, xt = _pair(rng.normal(size=(n, d)), name)
    wj, wt = _pair(rng.normal(size=(d,)) * 0.1, name)
    got = rmsnorm(xt, wt, plus_one=plus_one, block_rows=br)
    assert got.dtype == xt.dtype
    pallas = jops.rmsnorm(xj, wj, plus_one=plus_one, block_rows=br,
                          interpret=True)
    oracle = jref.rmsnorm_ref(xj, wj, plus_one=plus_one)
    for want in (pallas, oracle):
        assert np.abs(_np(got) - _np(want)).max() < _tol(name)


@pytest.mark.parametrize("u,elems,n,smax", [(10, 8, 4, 5), (33, 128, 8, 9)])
def test_reshard_pack_bit_exact(u, elems, n, smax):
    rng = np.random.default_rng(u)
    src = np.vstack([rng.normal(size=(u, elems)), np.zeros((1, elems))])
    src = src.astype(np.float32)
    idx = rng.integers(0, u + 1, size=(n, smax)).astype(np.int32)
    got = reshard_pack(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    pallas = np.asarray(jops.reshard_pack(jnp.asarray(src), jnp.asarray(idx),
                                          interpret=True))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, np.asarray(jref.reshard_pack_ref(src, idx)))


def test_plain_versions_do_not_count_launches():
    mode.reset_launches()
    x = torch.ones(4, 8)
    rmsnorm(x, torch.ones(8))
    q = torch.ones(1, 2, 8, 16)
    flash_attention(q, q, q)
    reshard_pack(x, torch.zeros((2, 1), dtype=torch.int32))
    assert mode.launches() == dict.fromkeys(mode.KERNELS, 0)


def test_plain_versions_are_the_ref_functions():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    assert torch.equal(rmsnorm(x, w, plus_one=True),
                       tref.rmsnorm_ref(x, w, plus_one=True))


# ---------------------------------------------------------------------------
# the shape-error contract of tests/test_kernels.py, same messages

def test_rmsnorm_rejects_indivisible_rows():
    with pytest.raises(ValueError,
                       match=r"rmsnorm: row count n=96 .* block_rows=64"):
        rmsnorm(torch.zeros(96, 8), torch.ones(8), block_rows=64)


def test_flash_attention_rejects_indivisible_blocks():
    q = torch.zeros(1, 2, 48, 16)
    k = torch.zeros(1, 1, 48, 16)
    with pytest.raises(
            ValueError,
            match=r"sequence length s=48 .* query-block size block_q=32"):
        flash_attention(q, k, k, block_q=32, block_k=48)
    with pytest.raises(
            ValueError,
            match=r"sequence length s=48 .* key-block size block_k=32"):
        flash_attention(q, k, k, block_q=48, block_k=32)


def test_default_tiling_takes_any_extent():
    """The tiling arguments default to the whole extent: any row count and
    any S (here neither divides the Pallas defaults 256 / 512)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(300, 8)).astype(np.float32))
    w = torch.ones(8)
    assert torch.equal(rmsnorm(x, w), tref.rmsnorm_ref(x, w))
    q = torch.from_numpy(rng.normal(size=(1, 2, 600, 16)).astype(np.float32))
    assert torch.equal(flash_attention(q, q, q),
                       tref.flash_attention_ref(q, q, q))


def test_flash_attention_rejects_bad_arguments():
    q = torch.zeros(1, 3, 16, 16)
    with pytest.raises(ValueError, match="H % KVH"):
        flash_attention(q, torch.zeros(1, 2, 16, 16), torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError, match="unknown mask kind"):
        flash_attention(q, q, q, kind="local")
    with pytest.raises(ValueError, match="chunk=0"):
        flash_attention(q, q, q, kind="chunked", chunk=0)
