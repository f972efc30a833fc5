"""Training of the uniform arch stack in the port (`train.steps.make_setup`,
`Model.forward`'s plain route) on the CPU, against the JAX package:

* one train step of each registered arch at ``reduced`` size (B 2 × S 16,
  f32) against the reference's ``jax.jit(make_setup(...).step_fn)``, both
  started from the reference's ``init`` (norms and biases nudged off their
  init) and `adamw_init` state, converted: loss, total loss (the MoE aux
  loss), grad norm, the updated first moment (the gradients) and the
  updated params within 3e-5 (`step_parity`). `PARITY` names the file
  that holds each arch's, so that every file stays well inside one
  worker's share;
* the microbatch refusals with the reference's messages (the MoE one
  naming the aux loss) and the mesh refusal naming its ROADMAP row;
  remat on equals remat off; `cross_entropy` on a padded vocab, value and
  gradient;
* the forward-only guard of the kernel wrappers.

The learning rate of the parity steps is 1e-5 with a constant schedule:
a first AdamW step moves each weight by about ±lr whatever its gradient's
size, and some gradients are rounding noise (a key bias's is zero in exact
arithmetic: a shift of every key leaves the softmax unchanged), so a
larger rate would only measure how the two packages round that noise. The
first moment holds each gradient itself at 3e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.train import steps as jsteps
from repro_torch import tree as tr
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.kernels import mode
from repro_torch.optim import AdamWConfig
from repro_torch.train import steps

B, S = 2, 16
TOL = {"f32": 3e-5, "bf16": 2e-2}
LR = 1e-5
NUDGED = ("w", "b", "bq", "bk", "bv", "conv_b", "bias_a", "bias_i",
          "dt_bias", "q_norm", "k_norm")
# the test file that holds each arch's step parity
PARITY = {
    "test_torch_arch_train": ("qwen2-7b", "granite-3-2b", "minitron-4b",
                              "chameleon-34b"),
    "test_torch_sharding_specs": ("mamba2-780m", "gemma2-9b"),
    "test_torch_arch_session": ("recurrentgemma-9b", "whisper-small"),
    "test_torch_arch_moe": ("arctic-480b", "llama4-scout-17b-a16e"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def const_schedule(step):
    return 1.0


def reference_state(jsu):
    """The reference model's params from ``init`` (key 0) with every norm
    weight and bias moved off its init (so that the (1 + w) and bias paths
    count), and their `adamw_init` state; one compiled program."""
    def init(key):
        flat, treedef = jax.tree_util.tree_flatten_with_path(
            jsu.model.init(key))
        keys = jax.random.split(jax.random.PRNGKey(1), len(flat))
        params = treedef.unflatten([
            a + (jax.random.normal(k, a.shape) * 0.05).astype(a.dtype)
            if getattr(path[-1], "key", "") in NUDGED else a
            for (path, a), k in zip(flat, keys)])
        return params, jadamw_init(params, jsu.opt_cfg)

    return jax.jit(init)(jax.random.PRNGKey(0))


def batch_np(cfg, b=B, s=S, seed=0):
    """Seeded tokens and targets (and frame embeddings for an enc-dec
    config) as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.encoder is not None:
        out["enc_input"] = (rng.normal(
            size=(b, cfg.encoder.enc_seq, cfg.d_model)) * 0.1
        ).astype(np.float32)
    return out


def to_numpy(tree):
    """A JAX tree as numpy, bf16 leaves widened to f32 (numpy has no
    bf16)."""
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                             else a), tree)


def cfgs(aid, **kw):
    return (dataclasses.replace(jreduced(jget_arch(aid)), **kw),
            dataclasses.replace(reduced(get_arch(aid)), **kw))


def step_parity(aid, *, b=B, s=S, microbatches=1, param_dtype="f32",
                tol=TOL["f32"], remat=True, start=None, **cfg_kw):
    """One train step of both packages from `reference_state`; asserts the
    metrics, the first moment and the params agree within ``tol``. Returns
    the port's (params, opt, metrics); a ``start`` list receives copies of
    the port's step inputs (params, opt, batch)."""
    jcfg, tcfg = cfgs(aid, **cfg_kw)
    jdt, tdt = ((jnp.float32, torch.float32) if param_dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jsu = jsteps.make_setup(
        jcfg, JShapeSpec("t", s, b, "train"), None, param_dtype=jdt,
        opt_cfg=JAdamWConfig(lr=LR), lr_schedule=const_schedule,
        microbatches=microbatches, remat=remat)
    jp, jo = reference_state(jsu)
    tp = params_from_jax(to_numpy(jp), device="cpu")
    if tdt is not torch.float32:
        tp = tr.tree_map(lambda t: t.to(tdt), tp)
    to = opt_state_from_jax(to_numpy(jo), device="cpu")
    data = batch_np(tcfg, b, s)
    if start is not None:
        start.extend(tr.tree_map(torch.clone, (tp, to)))
        start.append({k: torch.from_numpy(v) for k, v in data.items()})
    jp2, jo2, jm = jax.jit(jsu.step_fn)(
        jp, jo, {k: jnp.asarray(v) for k, v in data.items()})

    su = steps.make_setup(
        tcfg, ShapeSpec("t", s, b, "train"), param_dtype=tdt,
        opt_cfg=AdamWConfig(lr=LR), lr_schedule=const_schedule,
        microbatches=microbatches, remat=remat, device="cpu")
    tp2, to2, tm = su.step_fn(
        tp, to, {k: torch.from_numpy(v) for k, v in data.items()})
    for key in ("loss", "total_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=tol,
                                   rtol=0, err_msg=key)
    assert int(to2["step"]) == int(jo2["step"]) == 1
    for name, got, want in (("params", tp2, jp2), ("m", to2["m"], jo2["m"])):
        want = params_from_jax(to_numpy(want), device="cpu")
        for (path, g), w in zip(tr.leaves_with_path(got), tr.leaves(want)):
            np.testing.assert_allclose(
                g.float().numpy(), w.numpy(), atol=tol, rtol=0,
                err_msg=f"{aid} {name} {tr.path_key(path)}")
    return tp2, to2, tm


@pytest.mark.parametrize("aid", PARITY["test_torch_arch_train"])
def test_train_step_matches_reference(aid):
    step_parity(aid)


def test_every_arch_is_held_somewhere():
    assert sorted(sum(PARITY.values(), ())) == sorted(ARCH_IDS)


def test_microbatch_refusals_match_reference():
    for aid, shape, m in (("llama4-scout-17b-a16e", (S, 4, "train"), 2),
                          ("qwen2-7b", (S, 4, "train"), 3),
                          ("qwen2-7b", (S, 4, "train"), 5),
                          ("qwen2-7b", (S, 4, "prefill"), 2)):
        jcfg, tcfg = cfgs(aid)
        with pytest.raises(ValueError) as want:
            jsteps.make_setup(jcfg, JShapeSpec("t", *shape), None,
                              microbatches=m)
        with pytest.raises(ValueError) as got:
            steps.make_setup(tcfg, ShapeSpec("t", *shape), microbatches=m,
                             device="cpu")
        assert str(got.value) == str(want.value)


def test_moe_refusal_names_the_aux_loss():
    _, tcfg = cfgs("arctic-480b")
    with pytest.raises(ValueError, match="aux loss is not additive"):
        steps.make_setup(tcfg, ShapeSpec("t", S, 4, "train"), microbatches=2,
                         device="cpu")


def test_mesh_is_refused_naming_its_row():
    _, tcfg = cfgs("qwen2-7b")
    with pytest.raises(NotImplementedError,
                       match="sharded arch-stack execution"):
        steps.make_setup(tcfg, ShapeSpec("t", S, B, "train"),
                         {"data": 2, "model": 4}, device="cpu")


@pytest.mark.parametrize("aid", ("qwen2-7b", "recurrentgemma-9b"))
def test_remat_equals_no_remat(aid):
    """The same step with and without per-cycle recomputation: equal
    losses and params (recurrentgemma's pattern is a 3-block cycle)."""
    _, tcfg = cfgs(aid)
    data = {k: torch.from_numpy(v) for k, v in batch_np(tcfg).items()}
    out = []
    for remat in (True, False):
        su = steps.make_setup(tcfg, ShapeSpec("t", S, B, "train"),
                              param_dtype=torch.float32,
                              opt_cfg=AdamWConfig(lr=1e-3),
                              lr_schedule=const_schedule, remat=remat,
                              device="cpu")
        assert su.model.remat is remat
        p = su.model.init(torch.Generator().manual_seed(0))
        from repro_torch.optim import adamw_init

        out.append(su.step_fn(p, adamw_init(p, su.opt_cfg), data))
    assert float(out[0][2]["loss"]) == float(out[1][2]["loss"])
    for a, b in zip(tr.leaves(out[0][0]), tr.leaves(out[1][0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_cross_entropy_on_padded_vocab_matches_reference():
    """Logits over a vocab padded from 500 to 512 (the pad at -1e30),
    value and gradient against the reference's f32 CE."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 5, 512)) * 4).astype(np.float32)
    targets = rng.integers(0, 500, (2, 5)).astype(np.int32)
    jv, jg = jax.value_and_grad(jsteps.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(targets), 500)
    t = torch.from_numpy(logits).requires_grad_()
    tv = steps.cross_entropy(t, torch.from_numpy(targets), 500)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=3e-6,
                               rtol=0)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-7,
                               rtol=0)
    assert float(t.grad[..., 500:].abs().max()) == 0.0


# ---------------------------------------------- the forward-only guard

def test_kernel_wrappers_refuse_grad(monkeypatch):
    """On the CUDA path (here forced by making the device check say CUDA)
    `rmsnorm`, `flash_attention` and `ssd_scan` raise, naming the kernel,
    when grad mode is on and an input requires grad — before any launch."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan

    monkeypatch.setattr(mode, "on_cpu", lambda *t, kernel: False)
    x = torch.ones(4, 8, requires_grad=True)
    q = torch.ones(1, 2, 16, 32, requires_grad=True)
    xs, dt, a = torch.ones(2, 8, 4), torch.ones(2, 8), -torch.ones(2)
    bc = torch.ones(1, 8, 4, requires_grad=True)
    for name, call in (
            ("rmsnorm", lambda: rmsnorm(x, torch.ones(8))),
            ("flash_attention", lambda: flash_attention(q, q.detach(),
                                                        q.detach())),
            ("ssd_scan", lambda: ssd_scan(xs, dt, a, bc, bc, chunk=8))):
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel is "
                                               "forward-only"):
            call()


def test_forward_only_predicate():
    t, g = torch.ones(2), torch.ones(2, requires_grad=True)
    mode.check_forward_only(t, t, kernel="k")
    with torch.no_grad():
        mode.check_forward_only(t, g, kernel="k")
    with pytest.raises(RuntimeError, match="k: the CUDA kernel"):
        mode.check_forward_only(t, g, kernel="k")
    # the plain versions on the CPU stay differentiable
    from repro_torch.kernels.rmsnorm import rmsnorm

    rmsnorm(g[None], torch.ones(2)).sum().backward()
    assert g.grad is not None
