"""`launch.op_analysis`, the port's counterpart of
`repro/launch/hlo_analysis.py`, on the CPU: FLOPs exact for a matrix
product and for a loop counted once an iteration (the twins of
tests/test_substrate.py's HLO-analyzer tests), the ring formulas equal to
the reference's `_coll_moved`, the collectives table from
`core.collectives` counts, the per-op rows, and each kernel's cost
function (the one `chip_smoke.py`'s bound column reads) equal to
PERF.md's bound at the kernel table's main shape."""
import pytest
import torch

from repro_torch.core import shard_mapping as sm
from repro_torch.kernels import mode
from repro_torch.kernels.bucket import bucket_cost
from repro_torch.kernels.flash_attention import (allowed_pairs,
                                                 flash_attention_cost)
from repro_torch.kernels.reshard_pack import reshard_pack_cost
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_cost
from repro_torch.kernels.ssd_scan import ssd_scan_cost
from repro_torch.launch import op_analysis as oa

# the card's peaks (NVIDIA H100 SXM 80GB, 700 W, data sheet), as
# chip_smoke.py's MEM_BW and PEAK
HBM = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12}


def bound_ms(cost, dtype):
    return max(cost.bytes / HBM, cost.flops / PEAK[dtype]) * 1e3


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_exact_matmul(device):
    a = torch.zeros((256, 512), device=device)
    b = torch.zeros((512, 128), device=device)
    r = oa.analyze_step(lambda a, b: a @ b, a, b)
    assert r["flops"] == 2 * 256 * 512 * 128
    # one product: both inputs read, the output written
    assert r["bytes"] == 4 * (256 * 512 + 512 * 128 + 256 * 128)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_counted_every_iteration(device):
    """A Python loop runs every iteration: seven 128² products count seven
    times (the reference's scan needs the HLO's known trip count)."""
    b0 = torch.eye(128, device=device)

    def g(a):
        for _ in range(7):
            a = a @ b0
        return a

    r = oa.analyze_step(g, torch.zeros((128, 128), device=device))
    assert r["flops"] == 2 * 128 ** 3 * 7
    rows = oa.top_contributors(r)
    assert [(row["key"].split(":")[0], row["count"]) for row in rows] == \
        [("mm", 7)]
    assert "unknown_trip_count_loops" not in r


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_ring_formulas_equal_the_reference(op):
    from repro.launch.hlo_analysis import _coll_moved

    for n in range(1, 17):
        for rbytes in (0, 1, 4096, 3_126_947_848):
            assert oa._coll_moved(op, rbytes, n) == _coll_moved(op, rbytes, n)


def test_collectives_table_from_counts():
    """Each port op under its HLO opcode: an all-gather's counted input is
    one peer's part of its result; a receive moves nothing of its own."""
    counts = {("all_reduce", "data"): (2, 800), ("all_reduce_max", "model"):
              (1, 8), ("all_gather", "data"): (1, 100),
              ("all_to_all", "model"): (1, 400),
              ("send_next", "stage"): (1, 50), ("recv_prev", "stage"): (1, 50)}
    got = oa.collectives_from_counts(counts, {"data": 4, "model": 2,
                                              "stage": 2})
    assert got == {
        "all-reduce": {"count": 3, "result_bytes": 808,
                       "moved_bytes": 2 * 800 * 3 / 4 + 2 * 8 / 2},
        "all-gather": {"count": 1, "result_bytes": 400,
                       "moved_bytes": 400 * 3 / 4},
        "all-to-all": {"count": 1, "result_bytes": 400,
                       "moved_bytes": 400 / 2},
        "collective-permute": {"count": 1, "result_bytes": 50,
                               "moved_bytes": 50.0}}


def test_views_move_nothing_and_rows_name_the_function():
    """A view (reshape, transpose) adds no bytes; a kernel's meta call adds
    its cost function's FLOPs and bytes under ``kernel`` and launches
    nothing."""
    x = torch.empty((8, 3584), device="meta")
    w = torch.empty((3584,), device="meta")

    def step(x, w):
        y = rmsnorm(x, w)
        return y.reshape(4, 2, 3584).transpose(0, 1)

    before = mode.launches()
    r = oa.analyze_step(step, x, w)
    cost = rmsnorm_cost(8, 3584, 4)
    assert mode.launches() == before
    assert r["kernels"] == {"rmsnorm": {"calls": 1, "flops": cost.flops,
                                        "bytes": cost.bytes}}
    assert (r["flops"], r["bytes"]) == (cost.flops, cost.bytes)
    assert [row["key"] for row in oa.top_contributors(r)] == \
        ["rmsnorm:kernel"]


def test_saved_bytes_count_what_the_backward_keeps():
    """``saved_bytes``: tensors the forward saves for the backward, the
    step's own arguments left out."""
    w = torch.empty((64, 64), device="meta", requires_grad=True)

    def step(w):
        h = torch.empty((16, 64), device="meta") @ w     # saves the input
        (h.tanh().sum()).backward()                      # saves tanh's out

    r = oa.analyze_step(step, w)
    assert r["saved_bytes"] == 2 * 16 * 64 * 4


def test_flash_pairs_equal_the_masks():
    for s in (1, 7, 64, 100, 257):
        q = torch.arange(s)[:, None]
        k = torch.arange(s)[None, :]
        causal = k <= q
        for kind, window, chunk, mask in (
                ("causal", 4096, 8192, causal),
                ("bidir", 4096, 8192, torch.ones(s, s, dtype=torch.bool)),
                ("sliding", 16, 8192, causal & (k > q - 16)),
                ("chunked", 4096, 32, causal & (k // 32 == q // 32))):
            assert allowed_pairs(kind, s, window, chunk) == \
                int(mask.sum()), (kind, s)


def _kv_head_reshard():
    """Phase 3's main reshard_pack row: qwen2-7b's KV-head reshard at TP
    4 -> 3, all 4 ranks in one launch."""
    t = sm.reshard_tables(sm.sync_layout(4, 4, 4), sm.sync_layout(4, 4, 3), 4)
    n_read = sum(len({int(u) for u in t.send_idx[r].flatten()
                      if u != t.pad}) for r in range(t.n))
    return reshard_pack_cost(t.send_idx.size, 2 * 28 * 8 * 96 * 128, 4,
                             n_read)


# (the kernel table's row, its cost, its dtype, PERF.md's bound ms, by)
TABLE = [
    ("rmsnorm (8, 3584) f32", rmsnorm_cost(8, 3584, 4), "float32",
     0.0000727, "bytes"),
    ("flash q (1, 28, 32, 128) kv 4 f32", flash_attention_cost(
        1, 28, 4, 32, 128, 4), "float32", 0.000313, "bytes"),
    ("flash bf16 S=4096 causal", flash_attention_cost(
        1, 28, 4, 4096, 128, 2), "bfloat16", 0.121626, "operations"),
    ("flash whisper encoder bidir", flash_attention_cost(
        1, 12, 12, 1500, 64, 4, "bidir"), "float32", 0.103164, "operations"),
    ("reshard_pack kv_head all 4 ranks", _kv_head_reshard(), "float32",
     0.12489, "bytes"),
    ("buckets 400 x 2 x 458,752", bucket_cost(400, 2 * 458_752, 4),
     "float32", 0.876422, "bytes"),
    ("ssd_scan x (192, 2048, 64)", ssd_scan_cost(192, 4, 2048, 256, 64, 128),
     "float32", 0.292866, "operations"),
]


@pytest.mark.parametrize("row", TABLE, ids=[r[0] for r in TABLE])
def test_cost_functions_give_the_kernel_tables_bound(row):
    _, cost, dtype, want, by = row
    got = bound_ms(cost, dtype)
    digits = len(f"{want:.10f}".rstrip("0").split(".")[1])
    assert round(got, digits) == want
    t_bytes, t_ops = cost.bytes / HBM, cost.flops / PEAK[dtype]
    assert ("bytes" if t_bytes >= t_ops else "operations") == by


def test_rmsnorm_cost_at_the_main_shape():
    assert rmsnorm_cost(8, 3584, 4) == mode.Cost(4 * 8 * 3584, 243_712)
