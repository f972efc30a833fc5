"""The port's gradient-bucket pack/unpack against the JAX package's: on the
CPU the wrappers run their plain PyTorch versions (`repro_torch.kernels.ref`),
held here bit for bit against the Pallas kernels in interpret mode
(`repro.kernels.ops`) and their jnp oracles (`repro.kernels.bucket`) on the
same numpy inputs, with the reference's contract (single-leaf passthrough,
the ValueError cases). The CUDA kernel itself is held against the same plain
versions on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.bucket import bucket_pack_ref as jpack_ref
from repro.kernels.bucket import bucket_unpack_ref as junpack_ref
from repro_torch.kernels import mode
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bucket import bucket_pack, bucket_unpack

WIDTHS = [(3,), (1, 1), (4, 2, 7), (8, 8, 8, 8), (128, 256, 64)]
DTYPES = {"f32": (np.float32, torch.float32), "i32": (np.int32, torch.int32)}


def _leaves(seed, rows, widths, dt):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, w)) * 100).astype(DTYPES[dt][0])
            for w in widths]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rows", [1, 16, 37])
@pytest.mark.parametrize("widths", WIDTHS)
def test_pack_unpack_match_pallas_and_refs(widths, rows, dt):
    arrs = _leaves(rows, rows, widths, dt)
    leaves = [torch.from_numpy(a) for a in arrs]
    flat = bucket_pack(leaves)
    pallas = np.asarray(jops.bucket_pack([jnp.asarray(a) for a in arrs],
                                         interpret=True))
    assert tuple(flat.shape) == (rows, sum(widths))
    assert flat.dtype == DTYPES[dt][1]
    assert np.array_equal(flat.numpy(), pallas)
    assert np.array_equal(flat.numpy(), np.asarray(jpack_ref(arrs)))
    assert torch.equal(flat, tref.bucket_pack_ref(leaves))

    parts = bucket_unpack(flat, widths)
    jparts = jops.bucket_unpack(jnp.asarray(pallas), widths, interpret=True)
    jrefs = junpack_ref(pallas, widths)
    assert len(parts) == len(widths)
    for p, jp, jr, a in zip(parts, jparts, jrefs, arrs):
        assert np.array_equal(p.numpy(), a)
        assert np.array_equal(p.numpy(), np.asarray(jp))
        assert np.array_equal(p.numpy(), np.asarray(jr))


def test_unpacked_parts_own_their_storage():
    flat = torch.arange(24.0).reshape(4, 6)
    parts = bucket_unpack(flat, (2, 4))
    parts[0].zero_()
    assert torch.equal(flat, torch.arange(24.0).reshape(4, 6))


def test_single_leaf_passes_through():
    x = torch.ones(8, 5)
    assert bucket_pack([x]) is x
    (y,) = bucket_unpack(x, (5,))
    assert y is x
    j = jnp.ones((8, 5))
    assert np.array_equal(np.asarray(jops.bucket_pack([j], interpret=True)),
                          np.asarray(j))


def test_validation_matches_reference():
    a = torch.zeros(8, 3)
    ja = jnp.zeros((8, 3), jnp.float32)
    cases = [
        ([a, torch.zeros(4, 3)], [ja, jnp.zeros((4, 3), jnp.float32)]),
        ([a, torch.zeros(8, 3, dtype=torch.bfloat16)],
         [ja, jnp.zeros((8, 3), jnp.bfloat16)]),
        ([torch.zeros(8)], [jnp.zeros((8,), jnp.float32)]),
    ]
    for tleaves, jleaves in cases:
        with pytest.raises(ValueError, match=r"bucket leaves must be 2-D"):
            bucket_pack(tleaves)
        with pytest.raises(ValueError, match=r"bucket leaves must be 2-D"):
            jops.bucket_pack(jleaves, interpret=True)
    with pytest.raises(ValueError, match="needs at least one leaf"):
        bucket_pack([])
    with pytest.raises(ValueError, match="needs at least one leaf"):
        jops.bucket_pack([], interpret=True)
    with pytest.raises(ValueError, match=r"widths \(2, 2\) do not sum to 3"):
        bucket_unpack(a, (2, 2))
    with pytest.raises(ValueError, match=r"widths \(2, 2\) do not sum to 3"):
        jops.bucket_unpack(ja, (2, 2), interpret=True)


def test_plain_versions_do_not_count_launches():
    mode.reset_launches()
    x = torch.ones(4, 8)
    bucket_unpack(bucket_pack([x, x, x]), (8, 8, 8))
    assert mode.launches()["bucket_pack"] == 0
    assert mode.launches()["bucket_unpack"] == 0


def test_wrappers_raise_off_cpu_and_cuda():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="bucket_pack: no kernel for device"):
        bucket_pack([x, x])
    with pytest.raises(ValueError, match="bucket_unpack: no kernel for"):
        bucket_unpack(x, (4, 4))
    with pytest.raises(ValueError, match="several devices"):
        bucket_pack([torch.zeros(4, 8), x])
