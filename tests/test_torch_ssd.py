"""The port's SSD scan against the JAX package's on the CPU: the plain
version of the `ssd_scan` wrapper (the sequential recurrence
`kernels.ref.ssd_scan_ref`) against the Pallas kernel in interpret mode and
the reference's `ssd_scan_ref` at `tests/test_kernels.py`'s shapes, within
the reference's SSD tolerance 5e-4; the final state and the (b, S, ds) B/C
route; the port's `_ssd_chunked` (y, h_final) against the reference's; and
the wrapper's shape and device contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import _ssd_chunked as j_ssd_chunked
from repro_torch.kernels import mode, ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.ssm import _ssd_chunked

TOL = 5e-4          # tests/test_kernels.py::test_ssd_scan
SHAPES = [(2, 64, 16, 32, 16), (3, 128, 16, 32, 32), (1, 256, 64, 128, 64)]


def _inputs(bh, s, hp, ds, seed, groups=None):
    """Inputs drawn as `tests/test_kernels.py` draws them; B/C have
    ``groups`` rows (default one per row)."""
    rng = np.random.default_rng(seed)
    g = bh if groups is None else groups
    return (rng.normal(size=(bh, s, hp)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(bh, s)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(bh,)).astype(np.float32),
            (rng.normal(size=(g, s, ds)) * 0.3).astype(np.float32),
            (rng.normal(size=(g, s, ds)) * 0.3).astype(np.float32))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("bh,s,hp,ds,chunk", SHAPES)
def test_plain_version_matches_pallas_and_reference(bh, s, hp, ds, chunk):
    arrs = _inputs(bh, s, hp, ds, seed=bh * 100 + s)
    got = ssd_scan(*_t(arrs), chunk=chunk).numpy()
    pallas = np.asarray(jops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk,
                                      interpret=True))
    want = np.asarray(jref.ssd_scan_ref(*map(jnp.asarray, arrs)))
    assert got.shape == (bh, s, hp) and got.dtype == np.float32
    assert np.abs(got - pallas).max() < TOL
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("bh,s,hp,ds,chunk", SHAPES)
def test_final_state_matches_reference_chunked(bh, s, hp, ds, chunk):
    """The final state the kernel also writes is the reference model's
    `_ssd_chunked` h_final (one head per row: b = bh, nh = 1)."""
    x, dt, A, B, C = _inputs(bh, s, hp, ds, seed=7 + s)
    _, h = ssd_scan(*_t((x, dt, A, B, C)), chunk=chunk, final_state=True)
    assert h.shape == (bh, hp, ds)
    for r in range(bh):       # each row has its own A: one call per row
        _, jh = j_ssd_chunked(
            jnp.asarray(x[r:r + 1, :, None]), jnp.asarray(dt[r:r + 1, :, None]),
            jnp.asarray(A[r:r + 1]), jnp.asarray(B[r:r + 1]),
            jnp.asarray(C[r:r + 1]), jnp.zeros((1, 1, hp, ds), jnp.float32),
            chunk)
        assert np.abs(h[r].numpy() - np.asarray(jh)[0, 0]).max() < TOL


def test_shared_bc_route_equals_copied_rows():
    """B/C as (b, S, ds) shared by the nh rows of a batch row give what
    copying them once per row gives, bit for bit."""
    b, nh, s, hp, ds = 2, 3, 64, 16, 32
    x, dt, A, B, C = _t(_inputs(b * nh, s, hp, ds, seed=3, groups=b))
    y1, h1 = ssd_scan(x, dt, A, B, C, chunk=16, final_state=True)
    y2, h2 = ssd_scan(x, dt, A, B.repeat_interleave(nh, 0),
                      C.repeat_interleave(nh, 0), chunk=16, final_state=True)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("h0_scale", [0.0, 0.5])
def test_port_chunked_matches_reference(h0_scale):
    rng = np.random.default_rng(11)
    b, s, nh, hp, ds = 2, 64, 3, 16, 32
    x = rng.normal(size=(b, s, nh, hp)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, size=(b, s, nh)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=(nh,)).astype(np.float32)
    B = (rng.normal(size=(b, s, ds)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, s, ds)) * 0.3).astype(np.float32)
    h0 = (rng.normal(size=(b, nh, hp, ds)) * h0_scale).astype(np.float32)
    y, h = _ssd_chunked(*_t((x, dt, A, B, C, h0)), 16)
    jy, jh = j_ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C, h0)), 16)
    # the same formulation in f32, summed in another order
    assert np.abs(y.numpy() - np.asarray(jy)).max() < 1e-5
    assert np.abs(h.numpy() - np.asarray(jh)).max() < 1e-5
    if h0_scale == 0.0:
        # ... and the kernel's plain version from the zero state
        xk = torch.from_numpy(x).permute(0, 2, 1, 3).reshape(b * nh, s, hp)
        dtk = torch.from_numpy(dt).permute(0, 2, 1).reshape(b * nh, s)
        yk, hk = ssd_scan(xk, dtk, torch.from_numpy(A).repeat(b),
                          torch.from_numpy(B), torch.from_numpy(C), chunk=16,
                          final_state=True)
        yk = yk.reshape(b, nh, s, hp).permute(0, 2, 1, 3)
        assert (yk - y).abs().max().item() < TOL
        assert (hk.reshape(b, nh, hp, ds) - h).abs().max().item() < TOL


def test_rejects_indivisible_chunk():
    x = torch.zeros((2, 48, 4))
    dt = torch.zeros((2, 48))
    A = torch.zeros((2,))
    B = torch.zeros((2, 48, 8))
    with pytest.raises(ValueError,
                       match=r"sequence length s=48 .* chunk length chunk=32"):
        ssd_scan(x, dt, A, B, B, chunk=32)
    with pytest.raises(ValueError, match=r"chunk length chunk=32"):
        _ssd_chunked(torch.zeros((1, 48, 1, 4)), torch.zeros((1, 48, 1)),
                     torch.zeros(1), torch.zeros((1, 48, 8)),
                     torch.zeros((1, 48, 8)), torch.zeros((1, 1, 4, 8)), 32)


def test_shape_and_device_contract():
    x, dt, A, B, C = _t(_inputs(4, 32, 8, 16, seed=5))
    with pytest.raises(ValueError, match="B/C must be"):
        ssd_scan(x, dt, A, B[:3], C[:3])            # 4 rows over 3 groups
    with pytest.raises(ValueError, match="expected x"):
        ssd_scan(x, dt[:, :5], A, B, C)
    meta = [t.to("meta") for t in (x, dt, A, B, C)]
    with pytest.raises(ValueError, match="ssd_scan: no kernel for device meta"):
        ssd_scan(*meta)
    # the plain version counts no launch; S shorter than the chunk is one
    # chunk of S
    mode.reset_launches()
    y = ssd_scan(x, dt, A, B, C, chunk=256)
    assert mode.launches()["ssd_scan"] == 0
    assert torch.allclose(y, ref.ssd_scan_ref(x, dt, A, B, C))
