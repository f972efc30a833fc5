"""The Hopper design of `ssd_scan`, checked on the CPU.

The CUDA kernels run only on the card (`tests/test_torch_cuda.py`), so
what is held here is the decomposition they follow, emulated in torch step
for step (`emulate_ssd`), block by block over the grids the wrapper
launches (`ssd_scan.grids`, `cb_tile`, `out_tile`):

* (a) C·Bᵀ once per (B/C row, chunk), only the causal 64 x 64 tile pairs,
  over ds steps of 32, stored transposed; the tiles above the diagonal are
  never written (NaN here, so a read of one would show); the diagonal
  pairs also write Cᵀ; the blocks after the pairs write each chunk's
  cumsum of dt·A as a warp adds it, step by step with a fused
  multiply-add;
* (b) each chunk's own state contribution (w∘B)ᵀ·x per 64 x 64 (ds, hp)
  tile;
* (c) the state passed over a row's chunks in order, the incoming state
  replacing each chunk's contribution;
* (d) per (row, chunk, 64-row tile, hp tile): the carried term
  cdec·(C·h_in) over ds steps of 64 (skipped for the first chunk), then the
  causal column tiles of M = G∘decay∘dt times x;
* the ragged edges of L, hp and ds zero-padded to the tiles;

against the JAX package: the Pallas kernel in interpret mode
(`repro.kernels.ops.ssd_scan(..., interpret=True)`), the reference model's
jnp `_ssd_chunked` and `ssd_scan_ref`, and the port's `ref.ssd_scan_ref`,
on numpy inputs from a seed, within the reference's 5e-4
(`tests/test_kernels.py::test_ssd_scan`). Hypothesis checks that the
blocks of each kernel cover their work exactly once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import _ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd

TOL = 5e-4          # tests/test_kernels.py::test_ssd_scan
T, D = ssd.TILE, ssd.DEPTH
NAN = float("nan")

# (bh, groups, s, hp, ds, chunk): B/C shared by bh/groups heads or per row
CASES = {
    "shared": (6, 2, 128, 16, 32, 32),
    "per_row": (3, 3, 128, 16, 32, 64),
    "one_chunk": (4, 2, 64, 8, 16, 64),
    "L96": (2, 1, 192, 16, 32, 96),          # L not a multiple of 64
    "ragged": (4, 2, 128, 6, 12, 32),        # hp, ds off the float4 words
    "ds256_L256": (2, 1, 256, 16, 256, 256),
    "two_tiles": (2, 2, 128, 72, 80, 64),    # two hp tiles, two ds tiles
    "long_chunk": (2, 1, 640, 8, 16, 320),   # L = 320: five scan segments
}


def _clip_exp(v):
    return torch.exp(torch.clamp(v, -60.0, 0.0))


def _pad(t, rows, cols):
    """t zero-padded to (rows, cols)."""
    out = torch.zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def chunk_cumsum(dt, a):
    """The chunk's acum as (b) computes it: acum_i = fma(dt_i, a, acum_i-1)
    in f32 (the product not rounded; emulated in f64, exact for the product
    of two f32)."""
    out, run = torch.empty(dt.shape[0]), 0.0
    for i, d in enumerate(dt.double().tolist()):
        run = float(torch.tensor(d * float(a) + run).float())
        out[i] = run
    return out


def emulate_ssd(x, dt, A, B, C, chunk):
    """The four kernels of one call, block by block. Returns y (BH,S,hp)
    and the final state (BH,hp,ds)."""
    bh, s, hp = x.shape
    groups, _, ds = B.shape
    L = min(chunk, s)
    nc, nt, div = s // L, -(-L // T), bh // groups
    grid = ssd.grids(bh, groups, s, L, hp, ds)

    gt = torch.full((groups, nc, L, L), NAN)                     # (a)
    ct = torch.full((groups, nc, ds, L), NAN)
    acum = torch.full((bh, s), NAN)
    pairs = ssd.cb_pairs(groups, nc, nt)
    for blk in range(grid["cb"][0]):
        if blk >= pairs:
            q0 = (blk - pairs) * ssd.CHAINS
            for q in range(q0, min(q0 + ssd.CHAINS, bh * nc)):
                row, c = divmod(q, nc)
                acum[row, c * L:c * L + L] = chunk_cumsum(
                    dt[row, c * L:c * L + L], A[row])
            continue
        g, c, it, jt = ssd.cb_tile(blk, nc, nt)
        i0, j0 = it * T, jt * T
        ni, nj = min(T, L - i0), min(T, L - j0)
        acc = torch.zeros((T, T))                                # [j][i]
        for s0 in range(0, ds, D):
            bt = _pad(B[g, c * L + j0:c * L + j0 + nj, s0:s0 + D], T, D)
            c_t = _pad(C[g, c * L + i0:c * L + i0 + ni, s0:s0 + D], T, D)
            acc = acc + bt @ c_t.T
            if it == jt:
                ct[g, c, s0:s0 + D, i0:i0 + ni] = c_t[:ni, :ds - s0].T
        gt[g, c, j0:j0 + nj, i0:i0 + ni] = acc[:nj, :ni]

    st = torch.full((bh, nc, hp, ds), NAN)                       # (b)
    _, n_s, n_p = grid["state"]
    for rc in range(grid["state"][0]):
        row, c = divmod(rc, nc)
        t0 = c * L
        ac = acum[row, t0:t0 + L]
        w = _clip_exp(ac[-1] - ac) * dt[row, t0:t0 + L]
        for sy in range(n_s):
            for pz in range(n_p):
                s0, p0 = sy * T, pz * T
                acc = torch.zeros((T, T))                        # [s][p]
                for j0 in range(0, L, T):
                    nj = min(T, L - j0)
                    xt = _pad(x[row, t0 + j0:t0 + j0 + nj, p0:p0 + T], T, T)
                    bt = _pad(B[row // div, t0 + j0:t0 + j0 + nj, s0:s0 + T],
                              T, T)
                    bw = bt * _pad(w[j0:j0 + nj, None], T, 1)
                    acc = acc + bw.T @ xt
                np_, ns = min(T, hp - p0), min(T, ds - s0)
                st[row, c, p0:p0 + np_, s0:s0 + ns] = acc[:ns, :np_].T

    h_out = torch.empty((bh, hp, ds))                            # (c)
    for row in range(bh):
        h = torch.zeros((hp, ds))
        for c in range(nc):
            sc = st[row, c].clone()
            st[row, c] = h
            h = torch.exp(acum[row, c * L + L - 1]) * h + sc
        h_out[row] = h

    y = torch.full((bh, s, hp), NAN)                             # (d)
    for blk in range(grid["out"][0]):
        row, c, it = ssd.out_tile(blk, nc, nt)
        g, t0 = row // div, c * L
        i0 = it * T
        ni = min(T, L - i0)
        ai = _pad(acum[row, t0 + i0:t0 + i0 + ni, None], T, 1)[:, 0]
        for pz in range(grid["out"][1]):
            p0 = pz * T
            acc = torch.zeros((T, T))                            # [i][p]
            if c > 0:
                for s0 in range(0, ds, T):
                    c_t = _pad(ct[g, c, s0:s0 + T, i0:i0 + ni], T, T)
                    h_t = _pad(st[row, c, p0:p0 + T, s0:s0 + T].T, T, T)
                    acc = acc + c_t.T @ h_t
                acc = acc * _clip_exp(ai)[:, None]
            for jt in range(it + 1):
                j0 = jt * T
                nj = min(T, L - j0)
                aj = _pad(acum[row, t0 + j0:t0 + j0 + nj, None], T, 1)[:, 0]
                dj = _pad(dt[row, t0 + j0:t0 + j0 + nj, None], T, 1)[:, 0]
                g_t = torch.zeros((T, T))                        # [j][i]
                g_t[:nj, :ni] = gt[g, c, j0:j0 + nj, i0:i0 + ni]
                jj = torch.arange(T)[:, None]
                ii = torch.arange(T)[None, :]
                ok = (jj < nj) & (ii < ni) & (j0 + jj <= i0 + ii)
                m_t = torch.where(
                    ok, g_t * _clip_exp(ai[None, :] - aj[:, None])
                    * dj[:, None], torch.zeros(()))
                xt = _pad(x[row, t0 + j0:t0 + j0 + nj, p0:p0 + T], T, T)
                acc = acc + m_t.T @ xt
            np_ = min(T, hp - p0)
            y[row, t0 + i0:t0 + i0 + ni, p0:p0 + np_] = acc[:ni, :np_]
    return y, h_out


def _inputs(bh, groups, s, hp, ds, seed):
    """Inputs drawn as `tests/test_kernels.py` draws them; A per head,
    the same for every batch row (bh/groups heads a row) when B/C are
    shared, so the model's `_ssd_chunked` takes them as they are."""
    rng = np.random.default_rng(seed)
    nh = bh // groups if groups < bh else 1
    a = -rng.uniform(0.5, 2.0, size=(bh if nh == 1 else nh,))
    return (rng.normal(size=(bh, s, hp)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(bh, s)).astype(np.float32),
            np.tile(a, bh // a.shape[0]).astype(np.float32),
            (rng.normal(size=(groups, s, ds)) * 0.3).astype(np.float32),
            (rng.normal(size=(groups, s, ds)) * 0.3).astype(np.float32))


def _chunked(arrs, chunk):
    """The reference model's `_ssd_chunked` on the same rows: one call for
    shared B/C (b = groups, nh = bh/groups), one call per row otherwise."""
    x, dt, A, B, C = arrs
    bh, s, hp = x.shape
    groups, ds = B.shape[0], B.shape[-1]
    if groups == bh > 1:      # every row has its own A: one call per row
        parts = [_chunked([a[r:r + 1] for a in arrs], chunk)
                 for r in range(bh)]
        return tuple(np.concatenate(p) for p in zip(*parts))
    b, nh = groups, bh // groups
    y, h = j_ssd_chunked(
        jnp.asarray(x.reshape(b, nh, s, hp).transpose(0, 2, 1, 3)),
        jnp.asarray(dt.reshape(b, nh, s).transpose(0, 2, 1)),
        jnp.asarray(A[:nh]), jnp.asarray(B), jnp.asarray(C),
        jnp.zeros((b, nh, hp, ds), jnp.float32), chunk)
    return (np.asarray(y).transpose(0, 2, 1, 3).reshape(bh, s, hp),
            np.asarray(h).reshape(bh, hp, ds))


@pytest.fixture(scope="module")
def runs():
    """Each case's inputs and the emulated design's (y, h), made once."""
    out = {}
    for name, (bh, groups, s, hp, ds, chunk) in CASES.items():
        arrs = _inputs(bh, groups, s, hp, ds, seed=len(out) + 17)
        y, h = emulate_ssd(*map(torch.from_numpy, arrs), chunk)
        out[name] = (arrs, chunk, y.numpy(), h.numpy())
    return out


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("name", list(CASES))
def test_design_matches_sequential_recurrence(runs, name):
    arrs, _, y, h = runs[name]
    assert np.isfinite(y).all() and np.isfinite(h).all()
    wy, wh = ref.ssd_scan_ref(*map(torch.from_numpy, arrs), final_state=True)
    assert _err(y, wy) < TOL and _err(h, wh) < TOL
    x, dt, A, B, C = arrs
    rep = x.shape[0] // B.shape[0]
    jy = jref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, B.repeat(rep, 0),
                                              C.repeat(rep, 0))))
    assert _err(y, jy) < TOL


@pytest.mark.parametrize("name", list(CASES))
def test_design_matches_pallas_interpret(runs, name):
    (x, dt, A, B, C), chunk, y, _ = runs[name]
    rep = x.shape[0] // B.shape[0]
    got = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, B.repeat(rep, 0),
                                           C.repeat(rep, 0))),
                        chunk=chunk, interpret=True)
    assert _err(y, got) < TOL


@pytest.mark.parametrize("name", list(CASES))
def test_design_matches_model_chunked(runs, name):
    arrs, chunk, y, h = runs[name]
    wy, wh = _chunked(arrs, chunk)
    assert _err(y, wy) < TOL and _err(h, wh) < TOL


@pytest.mark.parametrize("L", [1, 31, 96, 256, 300, 640])
def test_chunk_cumsum_rounds_once_a_step(L):
    """Each acum entry is its neighbour plus dt·a rounded once, so the
    difference of neighbours is dt·a to within half an ulp of the entry
    (what the decays of nearby steps need), and the whole stays within
    L/2 ulps of the exact sum."""
    rng = np.random.default_rng(L)
    dt = torch.from_numpy(np.exp(rng.normal(0.5, 1.5, size=L))
                          .clip(1e-3, 40).astype(np.float32))
    a = torch.tensor(-1.6)
    acum = chunk_cumsum(dt, a).double().numpy()
    da = dt.double().numpy() * float(a)          # exact products
    ulp = np.spacing(np.abs(acum.astype(np.float32))).astype(np.float64)
    step = acum - np.concatenate([[0.0], acum[:-1]])
    assert (np.abs(step - da) <= 0.5 * ulp).all()
    assert (np.abs(acum - np.cumsum(da)) <= 0.5 * L * ulp).all()


@settings(max_examples=60, deadline=None)
@given(bh=st.integers(1, 5), nc=st.integers(1, 3), L=st.integers(1, 200),
       hp=st.integers(1, 150))
def test_out_tiles_cover_each_output_row_once(bh, nc, L, hp):
    """Kernel (d)'s blocks cover every (row, chunk, output row, hp column)
    exactly once."""
    nt = -(-L // T)
    n, n_hp = ssd.grids(bh, 1, nc * L, L, hp, 8)["out"]
    seen = np.zeros((bh, nc, L, hp), np.int64)
    for blk in range(n):
        row, c, it = ssd.out_tile(blk, nc, nt)
        assert 0 <= it < nt
        for pz in range(n_hp):
            seen[row, c, it * T:it * T + T, pz * T:pz * T + T] += 1
    assert (seen == 1).all()


@settings(max_examples=60, deadline=None)
@given(groups=st.integers(1, 3), heads=st.integers(1, 70),
       nc=st.integers(1, 3), L=st.integers(1, 400))
def test_cb_blocks_cover_causal_pairs_and_chains_once(groups, heads, nc, L):
    """Kernel (a)'s blocks cover every causal (i, j ≤ i) pair of every (B/C
    row, chunk) exactly once, and never a tile above the diagonal; the
    blocks after them every cumsum chain (row, chunk) once."""
    nt = -(-L // T)
    bh = groups * heads
    n = ssd.grids(bh, groups, nc * L, L, 1, 1)["cb"][0]
    pairs = ssd.cb_pairs(groups, nc, nt)
    assert (n - pairs) * ssd.CHAINS >= bh * nc > (n - pairs - 1) * ssd.CHAINS
    seen = np.zeros((groups, nc, L, L), np.int64)
    for blk in range(pairs):
        g, c, it, jt = ssd.cb_tile(blk, nc, nt)
        assert 0 <= jt <= it < nt
        seen[g, c, it * T:it * T + T, jt * T:jt * T + T] += 1
    causal = np.tril(np.ones((L, L), np.int64))
    assert (seen[..., causal == 1] == 1).all()
    assert (seen[..., (causal == 0)] <= 1).all()


@settings(max_examples=40, deadline=None)
@given(bh=st.integers(1, 4), nc=st.integers(1, 3), hp=st.integers(1, 150),
       ds=st.integers(1, 300))
def test_state_tiles_cover_each_state_element_once(bh, nc, hp, ds):
    """Kernel (b)'s blocks cover every (row, chunk, ds, hp) state element
    exactly once, and kernel (c)'s every (row, ds, hp)."""
    g = ssd.grids(bh, 1, nc * 64, 64, hp, ds)
    assert g["state"][0] == bh * nc and g["pass"][0] == bh
    for (_, n_s, n_p), t in ((g["state"], T), (g["pass"], ssd.PASS_TILE)):
        seen = np.zeros((n_s * t, n_p * t), np.int64)
        for sy in range(n_s):
            for pz in range(n_p):
                seen[sy * t:sy * t + t, pz * t:pz * t + t] += 1
        assert seen.shape[0] >= ds and seen.shape[1] >= hp
        assert (seen[:ds, :hp] == 1).all()
