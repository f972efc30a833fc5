"""The port's CUDA kernels on the card: each built from `csrc/`, launched at
the serving path's shapes and others, and held against its plain PyTorch
version (`repro_torch.kernels.ref`) on the same inputs — f32 at 3e-5, bf16
at 2e-2 (`tests/test_kernels.py::_tol`), ssd_scan at the reference's 5e-4,
reshard_pack and the buckets bit-exact. Then small models (qwen2-7b and
mamba2-780m reduced) on the card against the same parameters on the CPU,
and small serving sessions through fail→repair against uninterrupted
ones. Every test needs a CUDA card and skips without one; run them on
the GPU with

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, mode, ref
from repro_torch.kernels.bucket import bucket_pack, bucket_unpack
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.reshard_pack import reshard_pack, reshard_pack_ranks
from repro_torch.kernels.rmsnorm import launch_config, rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    build.build_all()
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(8, 3584), (32, 3584), (7, 100), (256, 512)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_matches_plain(dev, n, d, plus_one, dtype):
    x = _randn((n, d), dtype, dev, 0)
    w = _randn((d,), dtype, dev, 1, 0.1)
    got = rmsnorm(x, w, plus_one=plus_one)
    torch.cuda.synchronize()
    want = ref.rmsnorm_ref(x, w, plus_one=plus_one)
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [
    (n, d) for n in (1, 7, 8192) for d in (100, 1536, 3072, 3584, 16384)
] + [(1, 70000), (7, 70000)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_paths_match_plain(dev, n, d, offset, dtype):
    """Every path of the kernel: 16-byte words in registers, the scalar
    path (d not a multiple of the word, or x one element past a 16-byte
    boundary), and the loop path (d 70000: too wide for registers). In bf16
    the kernel and the plain version may round one f32 product to
    neighbouring bf16 values (their sums of squares run in other orders),
    one ulp apart: 0.031 for |y| in [4, 8), past the 2e-2 tolerance, and
    among 10^8 outputs some reach there. So bf16 is held to 2e-2 or one
    bf16 ulp of the plain value, whichever is larger."""
    g = torch.Generator(device=dev).manual_seed(n + d)
    base = torch.randn((n * d + offset,), generator=g, device=dev).to(dtype)
    x = base[offset:].view(n, d)
    w = _randn((d,), dtype, dev, 13, 0.1)
    aligned = offset == 0 and d % (16 // x.element_size()) == 0
    cfg = launch_config(d, x.element_size(), aligned)
    assert (cfg.vec > 1) == aligned
    for plus_one in (False, True):
        mode.reset_launches()
        got = rmsnorm(x, w, plus_one=plus_one)
        torch.cuda.synchronize()
        assert mode.launches()["rmsnorm"] == 1
        want = ref.rmsnorm_ref(x, w, plus_one=plus_one)
        assert got.dtype == dtype and got.shape == (n, d)
        err = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            ulp = torch.ldexp(torch.ones_like(err),
                              torch.frexp(want.float()).exponent - 8)
            err = torch.where(err <= ulp, torch.zeros_like(err), err)
        assert err.max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["causal", "sliding", "chunked", "bidir"])
@pytest.mark.parametrize("b,h,kvh,s,d", [
    (1, 28, 4, 32, 128),     # the serving path's prefill
    (2, 4, 2, 200, 64),      # ragged last tile
    (1, 8, 8, 128, 32),
    (1, 2, 1, 96, 256),
    # a ragged S > 64 for each D (the last K/V tile and q tile part-filled)
    (1, 4, 2, 100, 32),
    (1, 6, 3, 77, 128),
    (1, 2, 1, 130, 256),
    (1, 14, 2, 65, 64),
    # GQA 7:1 at a long S (heads packed into a block's rows, dead tiles)
    (1, 28, 4, 4096, 128),
])
def test_flash_attention_matches_plain(dev, b, h, kvh, s, d, kind, dtype):
    q = _randn((b, h, s, d), dtype, dev, 2)
    k = _randn((b, kvh, s, d), dtype, dev, 3)
    v = _randn((b, kvh, s, d), dtype, dev, 4)
    kw = dict(kind=kind, window=40 if s < 1024 else 1024,
              chunk=64 if s < 1024 else 1536)
    mode.reset_launches()
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert mode.launches()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["causal", "sliding", "chunked", "bidir"])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_flash_attention_softcap_matches_plain(dev, d, kind, dtype):
    """Scores scaled up so that the softcap (gemma2's) bites."""
    q = _randn((1, 4, 128 + d // 32, d), dtype, dev, 5, 4.0)
    k = _randn((1, 2, 128 + d // 32, d), dtype, dev, 6, 4.0)
    v = _randn((1, 2, 128 + d // 32, d), dtype, dev, 7)
    kw = dict(kind=kind, window=50, chunk=48, softcap=5.0)
    got = flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert (got.float() - want.float()).abs().max().item() < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_second_device(dtype):
    """The kernel's shared-memory attribute belongs to a device: a launch on
    cuda:1 after one on cuda:0 must run too (D = 128 needs more than the
    default 48 KB)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    build.build_all()
    outs = []
    for dev in (torch.device("cuda:0"), torch.device("cuda:1")):
        q = _randn((1, 8, 96, 128), dtype, dev, 2)
        k = _randn((1, 2, 96, 128), dtype, dev, 3)
        v = _randn((1, 2, 96, 128), dtype, dev, 4)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize(dev)
        want = ref.flash_attention_ref(q, k, v)
        assert (got.float() - want.float()).abs().max().item() < TOL[dtype]
        outs.append(got.cpu())
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,elems,n,smax", [(4, 128 * 3, 4, 1), (33, 128, 8, 9),
                                            (10, 7, 4, 5)])
def test_reshard_pack_bit_exact(dev, u, elems, n, smax, dtype):
    src = torch.cat([_randn((u, elems), dtype, dev, 8),
                     torch.zeros((1, elems), dtype=dtype, device=dev)])
    g = torch.Generator(device=dev).manual_seed(9)
    idx = torch.randint(0, u + 1, (n, smax), generator=g, device=dev,
                        dtype=torch.int32)
    got = reshard_pack(src, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.reshard_pack_ref(src, idx))
    bad = idx.clone()
    bad[0, 0] = u + 5
    assert not reshard_pack(src, bad)[0, 0].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks,u,elems,n,smax", [
    (4, 4, 128 * 3, 4, 1),          # the kv_head table's shape
    (4, 50, 256, 4, 13),            # the training MLP table's shape
    (3, 9, 7, 3, 5),                # rows of odd bytes: narrow words
    (2, 5, 128, 4, 9000),           # n·s_max = 36,000 per rank, 72,000 rows
    (1, 33, 128, 8, 9),
])
def test_reshard_pack_ranks_bit_exact(dev, ranks, u, elems, n, smax, dtype):
    xp = _randn((ranks, u + 1, elems), dtype, dev, 14)
    xp[:, -1] = 0
    g = torch.Generator(device=dev).manual_seed(15)
    idx = torch.randint(0, u + 1, (ranks, n, smax), generator=g, device=dev,
                        dtype=torch.int32)
    mode.reset_launches()
    got = reshard_pack_ranks(xp, idx)
    torch.cuda.synchronize()
    assert mode.launches()["reshard_pack"] == 1
    assert got.shape == (ranks, n, smax, elems)
    assert torch.equal(got, ref.reshard_pack_ranks_ref(xp, idx))
    assert torch.equal(got, xp[torch.arange(ranks, device=dev)[:, None, None],
                                idx.long()])
    for r in range(ranks):
        assert torch.equal(got[r], reshard_pack(xp[r], idx[r]))
    # out-of-range indices, below and above [0, U], give zero rows
    bad = idx.clone()
    bad[0, 0, 0], bad[-1, -1, -1] = -3, u + 7
    out = reshard_pack_ranks(xp, bad)
    assert not out[0, 0, 0].any() and not out[-1, -1, -1].any()
    keep = torch.ones_like(bad, dtype=torch.bool)
    keep[0, 0, 0] = keep[-1, -1, -1] = False
    assert torch.equal(out[keep], got[keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reshard_pack_unaligned_pointers(dev, dtype):
    """xp one element past a 16-byte boundary: the kernel takes narrower
    words and stays bit-exact."""
    ranks, u, elems = 3, 6, 128
    g = torch.Generator(device=dev).manual_seed(16)
    base = torch.randn((ranks * (u + 1) * elems + 1,), generator=g,
                       device=dev).to(dtype)
    xp = base[1:].view(ranks, u + 1, elems)
    xp[:, -1] = 0
    idx = torch.randint(0, u + 1, (ranks, ranks, 4), generator=g, device=dev,
                        dtype=torch.int32)
    got = reshard_pack_ranks(xp, idx)
    assert torch.equal(got, ref.reshard_pack_ranks_ref(xp, idx))
    assert torch.equal(reshard_pack(xp[1], idx[1]), got[1])


def test_reshard_route_one_launch_per_call(dev):
    """`reshard_ranks` gathers every rank's send buckets in one launch, and
    gives the plain route's result."""
    from repro_torch.core import shard_mapping as sm
    from repro_torch.reshard import engine

    _, _, pre, _ = sm.plan(28, 4, 3)
    x = _randn((4, pre.buf, 2, 64), torch.float32, dev, 17)
    mode.reset_launches()
    got = engine.reshard_ranks(x, pre)
    torch.cuda.synchronize()
    assert mode.launches()["reshard_pack"] == 1
    assert torch.equal(got.cpu(), engine.reshard_ranks(x.cpu(), pre))


def test_launches_are_counted(dev):
    mode.reset_launches()
    x = _randn((8, 64), torch.float32, dev, 10)
    rmsnorm(x, x[0])
    q = _randn((1, 2, 64, 64), torch.float32, dev, 11)
    flash_attention(q, q, q)
    reshard_pack(x, torch.zeros((2, 1), dtype=torch.int32, device=dev))
    bucket_unpack(bucket_pack([x, x]), (64, 64))
    ssd_scan(x[None], x[:1, :8], x[0, :1].abs().neg(), x[None], x[None])
    assert mode.launches() == dict.fromkeys(mode.KERNELS, 1)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# each kernel's wrapper on meta tensors at its main path's shape (PERF.md's
# kernel table): (call, output shape, output dtype)
META_CALLS = {
    "rmsnorm": (lambda: rmsnorm(_meta(8, 3584), _meta(3584)), (8, 3584),
                torch.float32),
    "flash_attention": (lambda: flash_attention(
        _meta(1, 28, 32, 128, dtype=torch.bfloat16),
        _meta(1, 4, 32, 128, dtype=torch.bfloat16),
        _meta(1, 4, 32, 128, dtype=torch.bfloat16)), (1, 28, 32, 128),
        torch.bfloat16),
    "reshard_pack": (lambda: reshard_pack_ranks(
        _meta(4, 5, 4096), _meta(4, 4, 1, dtype=torch.int32)),
        (4, 4, 1, 4096), torch.float32),
    "bucket_pack": (lambda: bucket_pack([_meta(400, 4096)] * 2), (400, 8192),
                    torch.float32),
    "bucket_unpack": (lambda: bucket_unpack(_meta(400, 8192),
                                            (4096, 4096))[1], (400, 4096),
                      torch.float32),
    "ssd_scan": (lambda: ssd_scan(_meta(192, 2048, 64), _meta(192, 2048),
                                  _meta(192), _meta(4, 2048, 128),
                                  _meta(4, 2048, 128)), (192, 2048, 64),
                 torch.float32),
}


@pytest.mark.parametrize("name", sorted(META_CALLS))
def test_meta_call_launches_nothing(dev, name):
    """With the kernels built and a card present, a meta call computes
    nothing: no launch is counted, the output is a meta tensor of the
    kernel's shape and dtype, and the call is counted as a dry launch."""
    call, shape, dtype = META_CALLS[name]
    mode.reset_launches()
    mode.reset_dry_launches()
    out = call()
    torch.cuda.synchronize()
    assert mode.launches() == dict.fromkeys(mode.KERNELS, 0)
    assert out.is_meta and tuple(out.shape) == shape and out.dtype == dtype
    assert mode.dry_launches()[name]["calls"] == 1


def test_model_on_card_matches_cpu(dev):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import build_model

    cfg = reduced(get_arch("qwen2-7b"))
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=dev)
    gparams = _to(params, dev)
    toks = torch.randint(1, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    cl, cc = cpu.prefill(params, toks, cpu.init_cache(2, 24, torch.float32))
    gl, gc = gpu.prefill(gparams, toks.to(dev), gpu.init_cache(2, 24, torch.float32))
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), atol=1e-4)
    cur, pos = torch.tensor([3, 5]), torch.tensor([16, 16])
    cl, _ = cpu.decode_slots(params, cc, cur, pos)
    gl, _ = gpu.decode_slots(gparams, gc, cur.to(dev), pos.to(dev))
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), atol=1e-4)


def test_serving_on_card_through_fail_repair(dev):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.runtime import FailureEvent, RecoveryEvent
    from repro_torch.serve import Request, Router, ServeSession

    cfg = ArchConfig(arch_id="cuda-serve", family="dense", citation="test",
                     n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=256, vocab_size=256, attn_bias=True)
    kw = dict(n1=4, slots=8, max_len=48, prefill_len=16, policy="ntp_pw")

    def run(session, events):
        router = Router(session)
        rng = np.random.default_rng(0)
        for i in range(16):
            router.submit(Request(rid=i, prompt=rng.integers(
                1, 256, size=10).astype(np.int32), max_new=8))
        for tick in range(400):
            if tick in events:
                router.apply(events[tick])
            router.step()
            if not router.queue and session.engines[0].n_active == 0:
                break
        return {r.rid: r.generated for r in router.completed}

    mode.reset_launches()
    s = ServeSession.create(cfg, device=dev, **kw)
    events = {2: FailureEvent(domain=0), 4: FailureEvent(domain=0),
              9: RecoveryEvent(domain=0), 11: RecoveryEvent(domain=0)}
    got = run(s, events)
    serving = ("rmsnorm", "flash_attention", "reshard_pack")
    assert all(mode.launches()[k] > 0 for k in serving), mode.launches()
    want = run(ServeSession.create(cfg, device=dev, params=s.params, **kw), {})
    assert len(got) == 16 and got == want


def _unaligned(rows, w, dtype, dev, seed):
    """A contiguous (rows, w) tensor whose data pointer is one element past
    a 16-byte boundary, so the kernel must take narrower words."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn((rows * w + 1,), generator=g, device=dev).to(dtype)
    return base[1:].view(rows, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
@pytest.mark.parametrize("rows,widths", [
    (8, (3584 * 896, 3584 * 128, 3584 * 128, 896 * 3584)),  # attn bucket
    (296, (3584 * 128, 128 * 3584)),                         # MLP bucket
    (16, (128, 256, 384)),
    (7, (1, 3, 5)),                                          # ragged
    (33, (129, 7, 64, 1)),
    (70000, (3, 5)),                                         # rows > 65535
    (4, (3,) * 130),                                         # > 128 leaves
])
def test_bucket_pack_unpack_bit_exact(dev, rows, widths, dtype):
    g = torch.Generator(device=dev).manual_seed(rows)
    leaves = [torch.randint(0, 120, (rows, w), generator=g, device=dev)
              .to(dtype) if not dtype.is_floating_point else
              torch.randn((rows, w), generator=g, device=dev).to(dtype)
              for w in widths]
    mode.reset_launches()
    flat = bucket_pack(leaves)
    parts = bucket_unpack(flat, widths)
    torch.cuda.synchronize()
    groups = -(-len(widths) // 128)
    assert mode.launches()["bucket_pack"] == groups
    assert mode.launches()["bucket_unpack"] == groups
    assert flat.dtype == dtype and flat.shape == (rows, sum(widths))
    assert torch.equal(flat, ref.bucket_pack_ref(leaves))
    for p, want, leaf in zip(parts, ref.bucket_unpack_ref(flat, widths),
                             leaves):
        assert torch.equal(p, want) and torch.equal(p, leaf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_unaligned_pointers(dev, dtype):
    leaves = [_unaligned(5, w, dtype, dev, w) for w in (128, 64, 200)]
    flat = bucket_pack(leaves)
    assert torch.equal(flat, ref.bucket_pack_ref(leaves))
    outs = [_unaligned(5, w, dtype, dev, 0) for w in (128, 64, 200)]
    from repro_torch.kernels import bucket as bk

    bk._launch(False, outs, flat, "bucket_unpack")
    torch.cuda.synchronize()
    for o, leaf in zip(outs, leaves):
        assert torch.equal(o, leaf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_layouts_alternate_bit_exact(dev, dtype):
    """Layouts that change between calls — four leaves, two leaves, four
    leaves of other widths, the first again, and the first in another
    dtype — each stay bit-exact with one launch per call, so state carried
    from one call's layout into the next would show."""
    layouts = [(8, (3584, 512, 512, 3584)), (16, (512, 3584)),
               (8, (640, 128, 128, 640)), (8, (3584, 512, 512, 3584)),
               (4, (136, 8)), (4, (8, 136, 1))]
    for i, (rows, widths) in enumerate(layouts + layouts[:1]):
        dt = torch.float32 if i == len(layouts) else dtype
        leaves = [_randn((rows, w), dt, dev, 100 * i + w) for w in widths]
        mode.reset_launches()
        flat = bucket_pack(leaves)
        parts = bucket_unpack(flat, widths)
        torch.cuda.synchronize()
        assert mode.launches()["bucket_pack"] == 1
        assert mode.launches()["bucket_unpack"] == 1
        assert torch.equal(flat, ref.bucket_pack_ref(leaves)), (rows, widths)
        for p, leaf in zip(parts, leaves):
            assert torch.equal(p, leaf), (rows, widths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_on_side_stream_and_in_graph(dev, dtype):
    """bucket_pack / bucket_unpack issued on a side stream (as the
    overlapped gradient sync does) and captured in a CUDA graph, then
    replayed on new leaf values: both bit-exact, so the launcher passes
    the current stream's handle intact."""
    widths = (3584, 512, 512, 3584)
    leaves = [_randn((8, w), dtype, dev, 40 + w) for w in widths]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flat = bucket_pack(leaves)
        parts = bucket_unpack(flat, widths)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(flat, ref.bucket_pack_ref(leaves))
    for p, leaf in zip(parts, leaves):
        assert torch.equal(p, leaf)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        flat = bucket_pack(leaves)
        parts = bucket_unpack(flat, widths)
    for i, leaf in enumerate(leaves):
        leaf.copy_(_randn(tuple(leaf.shape), dtype, dev, 90 + i))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(flat, ref.bucket_pack_ref(leaves))
    for p, leaf in zip(parts, leaves):
        assert torch.equal(p, leaf)


def test_bucket_single_leaf_passes_through(dev):
    x = _randn((8, 128), torch.float32, dev, 12)
    mode.reset_launches()
    assert bucket_pack([x]) is x
    assert bucket_unpack(x, (128,))[0] is x
    assert mode.launches()["bucket_pack"] == 0
    assert mode.launches()["bucket_unpack"] == 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _ssd_inputs(bh, s, hp, ds, dev, seed, groups=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    u = lambda shape: torch.rand(shape, generator=g, device=dev)  # noqa: E731
    n = lambda shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    grp = bh if groups is None else groups
    return (n((bh, s, hp)), 0.01 + 0.19 * u((bh, s)), -(0.5 + 1.5 * u((bh,))),
            0.3 * n((grp, s, ds)), 0.3 * n((grp, s, ds)))


@pytest.mark.parametrize("bh,s,hp,ds,chunk,groups", [
    (2, 64, 16, 32, 16, None),       # tests/test_kernels.py's shapes
    (3, 128, 16, 32, 32, None),
    (1, 256, 64, 128, 64, None),
    (16, 64, 64, 32, 32, 2),         # reduced mamba2, B/C shared by 8 heads
    (8, 256, 64, 128, 256, 2),       # S == chunk, full widths
    (4, 1024, 64, 128, 256, 1),      # several chunks of 256
    (300, 128, 64, 128, 64, 3),      # more rows than the 132 SMs
    (6, 96, 64, 128, 96, 2),         # chunk not a multiple of the 64-row tile
    (2, 1, 64, 128, 256, None),      # a one-token call
    (4, 192, 64, 128, 96, 1),        # L = 96 over two chunks, shared B/C
    (4, 128, 6, 12, 32, 2),          # hp, ds off the float4 words
    (2, 128, 72, 80, 64, None),      # two hp tiles, two ds tiles
    (2, 640, 8, 16, 320, 1),         # L > 256: two cumsum segments
])
def test_ssd_scan_matches_plain(dev, bh, s, hp, ds, chunk, groups):
    x, dt, A, B, C = _ssd_inputs(bh, s, hp, ds, dev, bh + s, groups)
    mode.reset_launches()
    y, h = ssd_scan(x, dt, A, B, C, chunk=chunk, final_state=True)
    torch.cuda.synchronize()
    assert mode.launches()["ssd_scan"] == 1
    want_y, want_h = ref.ssd_scan_ref(x, dt, A, B, C, final_state=True)
    assert y.shape == (bh, s, hp) and h.shape == (bh, hp, ds)
    assert (y - want_y).abs().max().item() < 5e-4
    assert (h - want_h).abs().max().item() < 5e-4


@pytest.mark.parametrize("bh,s,hp,ds,chunk,groups", [
    (4, 512, 64, 256, 256, 2),       # d_state 256 at chunk 256
    (2, 256, 3, 256, 256, 1),        # hp % 4 != 0
    (2, 256, 64, 20, 128, 1),        # ds % 8 != 0
    (2, 1024, 64, 128, 1024, 1),     # one chunk of 1024
])
def test_ssd_scan_takes_shapes_the_old_kernel_refused(dev, bh, s, hp, ds,
                                                      chunk, groups):
    """Shapes the one-block-per-row kernel refused (hp % 4, ds % 8, or
    more than 227 KB of shared memory) run, one counted launch each, and
    hold the plain version with the final state."""
    x, dt, A, B, C = _ssd_inputs(bh, s, hp, ds, dev, bh * s + ds, groups)
    mode.reset_launches()
    y, h = ssd_scan(x, dt, A, B, C, chunk=chunk, final_state=True)
    torch.cuda.synchronize()
    assert mode.launches()["ssd_scan"] == 1
    want_y, want_h = ref.ssd_scan_ref(x, dt, A, B, C, final_state=True)
    assert (y - want_y).abs().max().item() < 5e-4
    assert (h - want_h).abs().max().item() < 5e-4


def test_ssd_scan_final_state_matches_model_chunked(dev):
    """The final state against the model's plain `_ssd_chunked` on the same
    card tensors (B/C shared by the heads of a batch row)."""
    from repro_torch.models.ssm import _ssd_chunked

    b, nh, s, hp, ds = 2, 6, 512, 64, 128
    x, dt, A, B, C = _ssd_inputs(b * nh, s, hp, ds, dev, 21, groups=b)
    A = A[:nh]
    y, h = ssd_scan(x, dt, A.repeat(b), B, C, chunk=256, final_state=True)
    wy, wh = _ssd_chunked(x.reshape(b, nh, s, hp).permute(0, 2, 1, 3),
                          dt.reshape(b, nh, s).permute(0, 2, 1), A, B, C,
                          torch.zeros((b, nh, hp, ds), device=dev), 256)
    assert (y.reshape(b, nh, s, hp).permute(0, 2, 1, 3) - wy).abs().max() < 5e-4
    assert (h.reshape(b, nh, hp, ds) - wh).abs().max().item() < 5e-4


def test_mamba2_on_card_matches_cpu(dev):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.transformer import build_model

    cfg = reduced(get_arch("mamba2-780m"))
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device=dev)
    gparams = _to(params, dev)
    toks = torch.randint(1, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(1))
    mode.reset_launches()
    cl, cc = cpu.prefill(params, toks, cpu.init_cache(2, 8, torch.float32))
    gl, gc = gpu.prefill(gparams, toks.to(dev), gpu.init_cache(2, 8, torch.float32))
    assert mode.launches()["ssd_scan"] == cfg.n_layers
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), atol=1e-4)
    for name in ("h", "conv"):
        np.testing.assert_allclose(gc[name].cpu().numpy(), cc[name].numpy(),
                                   atol=1e-4)
    cur, pos = torch.tensor([3, 5]), torch.tensor([64, 64])
    cl, _ = cpu.decode_slots(params, cc, cur, pos)
    gl, _ = gpu.decode_slots(gparams, gc, cur.to(dev), pos.to(dev))
    np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), atol=1e-4)


def test_mamba2_serving_on_card_through_fail_repair(dev):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.runtime import FailureEvent, RecoveryEvent
    from repro_torch.serve import Request, Router, ServeSession

    cfg = reduced(get_arch("mamba2-780m"))
    kw = dict(n1=4, slots=8, max_len=48, prefill_len=16, policy="ntp_pw")

    def run(session, events):
        router = Router(session)
        rng = np.random.default_rng(0)
        for i in range(16):
            router.submit(Request(rid=i, prompt=rng.integers(
                1, cfg.vocab_size, size=10).astype(np.int32), max_new=8))
        for tick in range(400):
            if tick in events:
                router.apply(events[tick])
            router.step()
            if not router.queue and session.engines[0].n_active == 0:
                break
        return {r.rid: r.generated for r in router.completed}

    mode.reset_launches()
    s = ServeSession.create(cfg, device=dev, **kw)
    events = {2: FailureEvent(domain=0), 4: FailureEvent(domain=0),
              9: RecoveryEvent(domain=0), 11: RecoveryEvent(domain=0)}
    got = run(s, events)
    assert mode.launches()["reshard_pack"] > 0
    assert mode.launches()["rmsnorm"] > 0
    want = run(ServeSession.create(cfg, device=dev, params=s.params, **kw), {})
    assert len(got) == 16 and got == want


def test_trace_run_on_card_matches_cpu(dev):
    """A small trace run (2 layers, d_model 64) through the mixed schedule
    `chip_smoke.py` replays — failure, link degrade, repair, SDC quarantine
    with rollback, straggler — under NTP-PW with the overlapped sync, on the
    card and on the CPU from the same canonical params: the same plans,
    local batches and policy verdicts, losses within 1e-4, canonical params
    within 1e-4 at the end, and the card's run through the path's kernels."""
    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.core.failure_model import FailureTraceConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.optim import sgd
    from repro_torch.runtime import (
        NTPSession, TraceRunner, power_policy, schedule_from_trace,
    )

    cfg = nt.NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=2,
                            head_dim=16, d_ff=256, unit_rows=64, vocab=128,
                            n_layers=2)
    canon = nt.init_canonical(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    trace = FailureTraceConfig(n_gpus=8, domain_size=4, days=16 / 24.0,
                               rate_multiplier=200.0, seed=136,
                               straggler_rate_mult=2.0, link_rate_mult=2.0,
                               sdc_rate_mult=1.0)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, 32, 8, seed=0))
    runs = {}
    for where in ("cpu", dev):
        s = NTPSession.create(cfg, (2, 4), local_batch=4, optimizer=sgd(0.05),
                              params=_to(canon, where), overlap=True,
                              device=where,
                              power_policy=power_policy("ntp_pw"))
        runner = TraceRunner(s, schedule_from_trace(trace, steps=16),
                             verify=True, atol=1e-4)
        mode.reset_launches()
        hist = runner.run(pipe._batch_np, 16)
        runs[str(where)] = (hist, runner.summary(), mode.launches(),
                            tr.leaves(s.canonical_params()))
    (ch, cs, _, cp), (gh, gs, launches, gp) = runs["cpu"], runs[str(dev)]
    for a, b in zip(ch, gh):
        for k in ("replica_tp", "local_batches", "policy", "power_boost",
                  "rel_iter_time", "events_applied"):
            assert a[k] == b[k], (k, a, b)
        assert abs(a["loss"] - b["loss"]) < 1e-4
    assert cs == gs and cs["rollbacks"] == 1
    for a, b in zip(cp, gp):
        assert float((a - b.cpu()).abs().max()) < 1e-4
    assert all(launches[k] > 0 for k in
               ("reshard_pack", "bucket_pack", "bucket_unpack")), launches


@pytest.mark.parametrize("overlap,microbatches", [(False, 1), (True, 2)])
def test_pp2_session_on_card_matches_cpu(dev, overlap, microbatches):
    """A small pp=2 session (4 layers, d_model 64) through the stage-
    addressed chain of tests/dist/session_pp_lifecycle.py, on the card and
    on the CPU from the same canonical params: the same stage plans, local
    batches, stage_rel_iter_time and ledgers, losses within 1e-4,
    canonical params within 1e-4 at the end, and the card's run through
    the path's kernels (the bucket kernels with overlap on)."""
    from repro_torch import tree as tr
    from repro_torch.core import ntp_train as nt
    from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
    from repro_torch.optim import sgd
    from repro_torch.runtime import FailureEvent, NTPSession, RecoveryEvent

    cfg = nt.NTPModelConfig(d_model=64, n_kv_groups=4, q_per_kv=2,
                            head_dim=16, d_ff=256, unit_rows=64, vocab=128,
                            n_layers=4)
    canon = nt.init_canonical(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    chain = {2: FailureEvent(stage=1, domain=0),
             5: FailureEvent(stage=0, domain=0),
             8: RecoveryEvent(stage=1, domain=0),
             11: RecoveryEvent(stage=0, domain=0)}
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab, 32, 8, seed=0))
    runs = {}
    for where in ("cpu", dev):
        s = NTPSession.create(cfg, (2, 4), local_batch=4, optimizer=sgd(0.05),
                              params=_to(canon, where), overlap=overlap,
                              microbatches=microbatches, pp=2, device=where)
        mode.reset_launches()
        recs = []
        for i in range(14):
            if i in chain:
                s.apply(chain[i])
                recs.append(s.last_transition.as_dict())
            m = s.step(pipe._batch_np(i))
            recs.append((float(m["loss"]), s.plan.stage_tp,
                         tuple(s.local_batches), m["stage_rel_iter_time"]))
        runs[str(where)] = (recs, mode.launches(),
                            tr.leaves(s.canonical_params()))
    (cr, _, cp), (gr, launches, gp) = runs["cpu"], runs[str(dev)]
    for a, b in zip(cr, gr):
        if isinstance(a, dict):
            assert a == b
        else:
            assert a[1:] == b[1:] and abs(a[0] - b[0]) < 1e-4, (a, b)
    for a, b in zip(cp, gp):
        assert float((a - b.cpu()).abs().max()) < 1e-4
    kernels = ("reshard_pack", "bucket_pack", "bucket_unpack") if overlap \
        else ("reshard_pack",)
    assert all(launches[k] > 0 for k in kernels), launches
