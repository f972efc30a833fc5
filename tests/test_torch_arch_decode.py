"""The uniform arch stack's plain route against the served model and the
JAX package, on the CPU (the helpers are tests/test_torch_arch_train.py's):

* ``microbatches=2`` against the reference's accumulated step, and the
  port's m=2 step against its own m=1 step from the same state; one bf16
  train step with ``master`` against the reference's within 2e-2; the
  blockwise attention route (the threshold and blocks
  monkeypatched small in both packages) against the reference's step and
  the port's naive forward;
* decode matches the full forward for every arch (and `make_setup`'s
  prefill step gives the forward's last logits), and attention decode
  through the cache matches the plain route's full-sequence attention,
  naive and blockwise — the oracles of tests/test_archs_smoke.py and
  tests/test_decode_path.py."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch import tree as tr
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import steps

from test_torch_arch_train import (
    B, LR, TOL, batch_np, cfgs, const_schedule, step_parity,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_microbatched_step_matches_reference_and_full_batch():
    start = []
    p2, o2, m2 = step_parity("qwen2-7b", b=4, microbatches=2, start=start)
    assert int(m2["microbatches"]) == 2
    su = steps.make_setup(cfgs("qwen2-7b")[1], ShapeSpec("t", 16, 4, "train"),
                          param_dtype=torch.float32,
                          opt_cfg=AdamWConfig(lr=LR),
                          lr_schedule=const_schedule, device="cpu")
    p1, o1, m1 = su.step_fn(*start)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < TOL["f32"]
    for a, b in zip(tr.leaves((p2, o2["m"], o2["v"])),
                    tr.leaves((p1, o1["m"], o1["v"]))):
        torch.testing.assert_close(a, b, atol=TOL["f32"], rtol=0)


def test_bf16_step_with_master_matches_reference():
    _, to, _ = step_parity("qwen2-7b", param_dtype="bf16", tol=TOL["bf16"])
    assert "master" in to
    assert all(t.dtype == torch.float32 for t in tr.leaves(to["master"]))


@pytest.mark.parametrize("aid", ("qwen2-7b", "gemma2-9b"))
def test_blockwise_route_matches_reference(aid, monkeypatch):
    """The blockwise attention of the plain route (threshold 8, blocks of 4
    queries and 8 keys, in both packages) in a 16-token step: against the
    reference's step, and the port's forward against its naive one
    (gemma2: sliding window 6, attention softcap)."""
    kw = {"window": 6} if aid == "gemma2-9b" else {}
    _, tcfg = cfgs(aid, **kw)
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(batch_np(tcfg)["tokens"])
    naive, _ = model.forward(params, toks)
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "FLASH_SEQ_THRESHOLD", 8)
        monkeypatch.setattr(mod, "FLASH_BLOCK_Q", 4)
        monkeypatch.setattr(mod, "FLASH_BLOCK_K", 8)
    blockwise, _ = model.forward(params, toks)
    torch.testing.assert_close(blockwise, naive, atol=1e-5, rtol=0)
    step_parity(aid, **kw)


# --------------------------------------------- decode against the forward

def _decode_cfg(aid):
    """The arch at reduced size, MoE capacity raised so that no dispatch
    drops (the forward's and a decode step's capacities differ)."""
    cfg = reduced(get_arch(aid))
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@pytest.mark.parametrize("aid", sorted(ARCH_IDS))
def test_decode_matches_full_forward(aid):
    """tests/test_archs_smoke.py's oracle on the port: prefill of S-1
    tokens then one decode step equals the plain forward's last logits
    within 2e-3; the prefill step of `make_setup` gives the forward's
    last logits too."""
    cfg = _decode_cfg(aid)
    s = 32
    model = build_model(cfg, remat=False, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    data = batch_np(cfg, s=s, seed=1)
    toks = torch.from_numpy(data["tokens"])
    kw = {}
    if "enc_input" in data:
        kw["enc_input"] = torch.from_numpy(data["enc_input"])
    full, _ = model.forward(params, toks, **kw)
    cache = model.init_cache(B, s, torch.float32)
    model.prefill(params, toks[:, :s - 1], cache, **kw)
    last, _ = model.decode_step(params, cache, toks[:, s - 1:], s - 1)
    assert float((full[:, -1] - last[:, 0]).abs().max()) < 2e-3
    su = steps.make_setup(cfg, ShapeSpec("p", s, B, "prefill"),
                          param_dtype=torch.float32, device="cpu")
    pre, _ = su.step_fn(params, {"tokens": toks, **kw})
    assert float((full[:, -1] - pre).abs().max()) < 2e-3


def _attn_cfg(kvh, **kw):
    base = dict(arch_id=f"decode-test-kv{kvh}", family="dense",
                citation="test", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=kvh, head_dim=8, d_ff=64, vocab_size=64,
                window=16, chunk_size=16)
    base.update(kw)
    return ArchConfig(**base)


ATTN_CASES = [
    ("attn", _attn_cfg(2)), ("attn", _attn_cfg(4)), ("attn", _attn_cfg(1)),
    ("attn", _attn_cfg(2, qk_norm=True, attn_softcap=30.0)),
    ("attn_sw", _attn_cfg(2)), ("attn_chunked", _attn_cfg(2)),
]


@pytest.mark.parametrize("blockwise", (False, True))
@pytest.mark.parametrize("kind,cfg", ATTN_CASES,
                         ids=lambda c: getattr(c, "arch_id", c))
def test_incremental_decode_matches_plain_attention(kind, cfg, blockwise,
                                                    monkeypatch):
    """tests/test_decode_path.py's oracle on the port: a 16-token prefill
    then 16 one-token steps through the cache equal the plain route's
    full-sequence attention within 2e-5 (blockwise: threshold 8, blocks of
    4 queries and 8 keys)."""
    if blockwise:
        monkeypatch.setattr(tattn, "FLASH_SEQ_THRESHOLD", 8)
        monkeypatch.setattr(tattn, "FLASH_BLOCK_Q", 4)
        monkeypatch.setattr(tattn, "FLASH_BLOCK_K", 8)
    s, pre = 32, 16
    p = tattn.attn_init(cfg, torch.Generator().manual_seed(1), torch.float32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, s, cfg.d_model))
                         .astype(np.float32))
    full, _ = tattn.attn_apply(cfg, p, x, kind=kind, plain=True)
    cache = tattn.init_kv_cache(cfg, 1, B, s, torch.float32, "cpu",
                                kind=kind)
    layer = {"k": cache["k"][0], "v": cache["v"][0]}
    outs = [tattn.attn_apply(cfg, p, x[:, :pre], kind=kind, cache=layer,
                             cache_pos=0)[0]]
    for t in range(pre, s):
        outs.append(tattn.attn_apply(cfg, p, x[:, t:t + 1], kind=kind,
                                     cache=layer, cache_pos=t)[0])
    torch.testing.assert_close(torch.cat(outs, 1), full, atol=2e-5, rtol=0)


