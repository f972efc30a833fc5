"""The Hopper design of `flash_attention`, checked on the CPU.

The CUDA kernel runs only on the card (`tests/test_torch_cuda.py`), so
what is held here is the blocking and arithmetic it follows, emulated in
torch step for step (`emulate_flash`):

* the rows of a block: the G = H/KVH query heads of a KV head packed
  position-major (row r = position r // G, head r % G), in q tiles of the
  rows `tiling` chooses, cut into the slabs a warp owns (16 rows per m16
  tile on the bf16 path, 8 on the f32 path);
* the K/V tiles of the chosen width, zero-filled past S and scored -inf
  there; the live tiles of `live_tiles` only (the dead-tile skip), and the
  per-element mask only on tiles `tile_full` does not clear;
* the scale applied to the f32 scores after Q·Kᵀ; on the bf16 path the
  softmax in the log2 domain, P rounded to bf16 before P·V and l summing
  the rounded P; on the f32 path expf in the natural domain;

against the JAX package: `repro.kernels.ops.flash_attention(...,
interpret=True)` (the Pallas kernel in interpret mode) and
`repro.kernels.ref.flash_attention_ref`, on numpy inputs from a seed, at
the reference's tolerances (`tests/test_kernels.py::_tol`). The host
mirrors of the kernel's tile predicates are checked with hypothesis.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 3e-5, "bf16": 2e-2}
KINDS = ("causal", "sliding", "chunked", "bidir")
LOG2E = 1.4426950408889634
NEG = -1e30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _allowed(kind, window, chunk, qp, kp):
    if kind == "bidir":
        return torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                          dtype=torch.bool)
    ok = kp <= qp
    if kind == "sliding":
        ok &= kp > qp - window
    elif kind == "chunked":
        ok &= (kp // chunk) == (qp // chunk)
    return ok


def emulate_flash(q, k, v, *, kind="causal", window=4096, chunk=8192,
                  softcap=None, skip_dead=True, tiles=None):
    """The kernel's blocking and arithmetic in torch (CPU). q: (B,H,S,D),
    k/v: (B,KVH,S,D), f32 or bf16; returns (B,H,S,D) in q's type.
    ``skip_dead=False`` visits every k tile instead of the live range;
    ``tiles`` = (bq, bk, mt) overrides `tiling`'s choice."""
    b, h, s, d = q.shape
    kvh = k.shape[1]
    g, rows = h // kvh, (h // kvh) * s
    bf16 = q.dtype == torch.bfloat16
    bq, bk, mt = tiles or fa.tiling(b, h, kvh, s, d, bf16)
    slab = 16 * mt if bf16 else 8
    nk = -(-s // bk)
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    neg = NEG * LOG2E if bf16 else NEG
    kz = torch.zeros((b, kvh, nk * bk, d))
    vz = torch.zeros((b, kvh, nk * bk, d))
    kz[:, :, :s], vz[:, :, :s] = k.float(), v.float()
    out = torch.zeros((b, h, s, d))
    for bi in range(b):
        for kv in range(kvh):
            qrows = q[bi, kv * g:(kv + 1) * g].float().permute(1, 0, 2) \
                .reshape(rows, d)
            for t in range(-(-rows // bq)):
                r0 = t * bq
                q_lo, q_hi = r0 // g, (min(r0 + bq, rows) - 1) // g
                kt0, kt1 = (fa.live_tiles(kind, window, chunk, q_lo, q_hi,
                                          s, bk) if skip_dead else (0, nk))
                for w0 in range(r0, r0 + bq, slab):
                    r = torch.arange(w0, w0 + slab)
                    valid = r < rows
                    qs = torch.zeros((slab, d))
                    qs[valid] = qrows[r[valid]]
                    pos = (r // g)[:, None]
                    m = torch.full((slab,), neg)
                    l = torch.zeros(slab)
                    acc = torch.zeros((slab, d))
                    for kt in range(kt0, kt1):
                        k0 = kt * bk
                        kp = torch.arange(k0, k0 + bk)[None, :]
                        sc = qs @ kz[bi, kv, k0:k0 + bk].T
                        full = k0 + bk <= s and fa.tile_full(
                            kind, window, chunk, q_lo, q_hi, k0, k0 + bk - 1)
                        if softcap is not None:
                            sc = softcap * torch.tanh(sc * scale / softcap)
                            sc = sc * LOG2E if bf16 else sc
                        else:
                            sc = sc * (sl2 if bf16 else scale)
                        if not full:
                            ok = _allowed(kind, window, chunk, pos, kp)
                            sc = torch.where(ok, sc, torch.tensor(neg))
                            sc = torch.where(kp >= s, -math.inf, sc)
                        mn = torch.maximum(m, sc.max(dim=1).values)
                        if bf16:
                            corr = torch.exp2(m - mn)
                            p = torch.exp2(sc - mn[:, None]).bfloat16().float()
                        else:
                            corr = torch.exp(m - mn)
                            p = torch.exp(sc - mn[:, None])
                        m = mn
                        l = l * corr + p.sum(dim=1)
                        acc = acc * corr[:, None] + p @ vz[bi, kv, k0:k0 + bk]
                    o = acc * (1.0 / torch.clamp(l, min=1e-30))[:, None]
                    rv = r[valid]
                    out[bi, kv * g + rv % g, rv // g] = o[valid]
    return out.to(q.dtype)


def _inputs(b, h, kvh, s, d, dname, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, h, s, d)) * q_scale,
            rng.normal(size=(b, kvh, s, d)), rng.normal(size=(b, kvh, s, d))]
    jdt, tdt = DTYPES[dname]
    jx = [jnp.asarray(a, jdt) for a in arrs]
    # the same values in torch (bf16 through f32, exactly)
    tx = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in jx]
    return jx, tx


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


# (gqa ratio, d): every D, GQA 1, 2 and 7
GEOMS = [(1, 32), (2, 64), (7, 128), (2, 256)]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("s", [33, 100])
@pytest.mark.parametrize("gqa,d", GEOMS)
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("kind", KINDS)
def test_design_matches_reference(kind, softcap, gqa, d, s, dname):
    """The emulated design against the JAX package's jnp reference and the
    port's plain version, every mask kind, softcap, GQA 1/2/7, every D,
    ragged S (33: one part-filled k tile; 100: a full and a ragged one)."""
    kvh = 2
    (jq, jk, jv), (q, k, v) = _inputs(1, gqa * kvh, kvh, s, d, dname,
                                      seed=s * 7 + d + gqa,
                                      q_scale=4.0 if softcap else 1.0)
    kw = dict(kind=kind, window=21, chunk=24, softcap=softcap)
    got = emulate_flash(q, k, v, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jref.flash_attention_ref(jq, jk, jv, **kw)
    assert _err(got.float(), want) < TOL[dname]
    plain = ref.flash_attention_ref(q, k, v, **kw)
    assert _err(got.float(), plain.float()) < TOL[dname]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("b,gqa,kvh,s,d,softcap", [
    (1, 7, 1, 100, 128, None),     # qwen2-7b's group, ragged S
    (2, 2, 2, 33, 32, 5.0),        # batch 2, softcap
    (1, 1, 2, 70, 256, 5.0),       # MHA at D 256 (32-key tiles)
    (1, 2, 1, 64, 64, None),       # whole tiles
])
@pytest.mark.parametrize("kind", KINDS)
def test_design_matches_pallas_interpret(kind, b, gqa, kvh, s, d, softcap,
                                         dname):
    """The emulated design against the Pallas kernel in interpret mode."""
    (jq, jk, jv), (q, k, v) = _inputs(b, gqa * kvh, kvh, s, d, dname,
                                      seed=11 + s + d,
                                      q_scale=4.0 if softcap else 1.0)
    kw = dict(kind=kind, window=17, chunk=20, softcap=softcap)
    got = emulate_flash(q, k, v, **kw)
    want = jops.flash_attention(jq, jk, jv, interpret=True, **kw)
    assert _err(got.float(), want) < TOL[dname]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("kind", KINDS)
def test_design_two_m_tiles(kind, softcap, d):
    """The bf16 path's 128-row q tiles (two m16 tiles a warp, the long-S
    choice of `tiling`) at a small S, against the Pallas kernel."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 14, 2, 100, d, "bf16", seed=d,
                                      q_scale=4.0 if softcap else 1.0)
    kw = dict(kind=kind, window=30, chunk=40, softcap=softcap)
    got = emulate_flash(q, k, v, tiles=(128, 64, 2), **kw)
    want = jops.flash_attention(jq, jk, jv, interpret=True, **kw)
    assert _err(got.float(), want) < TOL["bf16"]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_dead_tile_skip_is_exact(kind, dname):
    """Visiting every k tile gives the same bits as the live range only:
    before the first valid tile a dead one is corrected away by
    corr = exp(-1e30 - m) = 0, after it it adds exp(-1e30 - m) = 0."""
    _, (q, k, v) = _inputs(1, 4, 2, 300, 32, dname, seed=5)
    kw = dict(kind=kind, window=70, chunk=96)
    assert torch.equal(emulate_flash(q, k, v, **kw),
                       emulate_flash(q, k, v, skip_dead=False, **kw))


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_emulation_runs_the_bf16_rounding(dname):
    """The bf16 path rounds P before P·V: at S=64 bidir its output differs
    from the f32 arithmetic on the same bf16 values, within the
    tolerance; the f32 path does not round."""
    _, (q, k, v) = _inputs(1, 2, 1, 64, 32, dname, seed=3)
    got = emulate_flash(q, k, v, kind="bidir").float()
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    kind="bidir")
    err = (got - exact).abs().max().item()
    if dname == "bf16":
        assert 0 < err < TOL["bf16"]
    else:
        assert err < TOL["f32"]


@pytest.mark.parametrize("b,h,kvh,s,d,bf16,want", [
    (1, 28, 4, 32, 128, True, (64, 64, 1)),      # the served prefill
    (1, 28, 4, 4096, 128, True, (128, 64, 2)),   # long prompt: 896 blocks
    (1, 28, 4, 4096, 256, True, (64, 32, 1)),    # D 256: one m-tile a warp
    (1, 28, 4, 4096, 128, False, (64, 64, 1)),   # f32
    (1, 16, 8, 4096, 64, True, (128, 64, 2)),   # 512 blocks
    (1, 16, 8, 2048, 64, True, (64, 64, 1)),    # 256 < 2 x 132
    (1, 8, 8, 512, 64, True, (64, 64, 1)),       # 256 blocks of 128 rows
])
def test_tiling(b, h, kvh, s, d, bf16, want):
    assert fa.tiling(b, h, kvh, s, d, bf16) == want


def _pairs(kind, window, chunk, q_lo, q_hi, k_lo, k_hi):
    qp = torch.arange(q_lo, q_hi + 1)[:, None]
    kp = torch.arange(k_lo, k_hi + 1)[None, :]
    return _allowed(kind, window, chunk, qp, kp)


@settings(max_examples=400, deadline=None)
@given(kind=st.sampled_from(KINDS), window=st.integers(1, 200),
       chunk=st.integers(1, 200), q_lo=st.integers(0, 400),
       q_w=st.integers(0, 70), k_lo=st.integers(0, 400),
       k_w=st.integers(0, 70))
def test_tile_predicates(kind, window, chunk, q_lo, q_w, k_lo, k_w):
    """tile_dead never skips a tile that holds an allowed (q, k) pair, and
    tile_full clears the mask only when every pair is allowed."""
    args = (kind, window, chunk, q_lo, q_lo + q_w, k_lo, k_lo + k_w)
    ok = _pairs(*args)
    if fa.tile_dead(*args):
        assert not ok.any()
    if fa.tile_full(*args):
        assert ok.all()


@settings(max_examples=300, deadline=None)
@given(kind=st.sampled_from(KINDS), window=st.integers(1, 300),
       chunk=st.integers(1, 300), s=st.integers(1, 500),
       bk=st.sampled_from([32, 64]), data=st.data())
def test_live_tiles_keep_every_allowed_pair(kind, window, chunk, s, bk, data):
    """The k tiles outside a q tile's live range hold no allowed pair, and
    each of the tile's positions finds its own key inside the range."""
    q_lo = data.draw(st.integers(0, s - 1))
    q_hi = data.draw(st.integers(q_lo, min(s - 1, q_lo + 40)))
    kt0, kt1 = fa.live_tiles(kind, window, chunk, q_lo, q_hi, s, bk)
    for kt in list(range(kt0)) + list(range(kt1, -(-s // bk))):
        assert not _pairs(kind, window, chunk, q_lo, q_hi, kt * bk,
                          min(kt * bk + bk, s) - 1).any()
    assert kt0 * bk <= q_lo and q_hi < kt1 * bk
