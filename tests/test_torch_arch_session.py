"""`NTPSession.from_arch` and ``launch.train --arch`` of the port on the
CPU:

* the arch session builds the reference's uniform backend (``"arch"``,
  `Mode.UNIFORM`, no plan) and its steps equal `make_setup`'s step driven
  by hand; started from the reference's params (numpy), its first step
  equals the reference's `make_setup` step;
* every lifecycle call raises `NotImplementedError` in the reference's
  wording;
* the launcher's losses equal `from_arch` driven by hand; its ``--ckpt``
  restores into the session's trees; every registered arch trains through
  it at ``reduced`` size (whisper with its zero ``enc_input``); its
  ``--dry-run`` and ``--devices`` are refused naming their ROADMAP rows;
* one train step of recurrentgemma-9b and whisper-small against the
  reference's (tests/test_torch_arch_train.py's `step_parity`)."""
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.train import steps as jsteps
from repro_torch import tree as tr
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.launch.train import main as train_main
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FailureEvent, Mode, NTPSession
from repro_torch.train import steps

from test_torch_arch_train import (
    LR, PARITY, batch_np, const_schedule, reference_state, step_parity,
)

S, B = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shape(b=B, s=S):
    return ShapeSpec("t", s, b, "train")


def test_from_arch_builds_the_uniform_backend():
    cfg = reduced(get_arch("qwen2-7b"))
    s = NTPSession.from_arch(cfg, _shape(), device="cpu",
                             opt_cfg=AdamWConfig(lr=1e-3))
    assert s.backend == "arch" and s.mode is Mode.UNIFORM
    assert s.plan is None and s.health is None and s.events == []
    assert s.pp == 1 and not s.overlap and s.device.type == "cpu"
    assert s.setup.model.remat and s.setup.opt_cfg.lr == 1e-3
    assert s.opt_step == 0 and s.cfg is cfg
    # the default weights are the model's init from seed 0
    want = s.setup.model.init(torch.Generator().manual_seed(0))
    for a, b in zip(tr.leaves(s.params), tr.leaves(want)):
        assert torch.equal(a, b)
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab_size, S, B), device="cpu")
    m = s.step(pipe.batch(0))
    assert s.opt_step == 1
    assert {"loss", "total_loss", "grad_norm", "lr"} <= set(m)
    # the same steps through make_setup by hand
    su = steps.make_setup(cfg, _shape(), param_dtype=torch.float32,
                          opt_cfg=AdamWConfig(lr=1e-3), device="cpu")
    p = su.model.init(torch.Generator().manual_seed(0))
    o = adamw_init(p, su.opt_cfg)
    p, o, hm = su.step_fn(p, o, pipe.batch(0))
    assert float(hm["loss"]) == float(m["loss"])
    m, (p, o, hm) = s.step(pipe.batch(1)), su.step_fn(p, o, pipe.batch(1))
    assert float(hm["loss"]) == float(m["loss"])
    for a, b in zip(tr.leaves(s.params), tr.leaves(p)):
        assert torch.equal(a, b)


def test_from_arch_with_reference_params_matches_reference_step():
    """``params=`` the reference's init as numpy: the session's first step
    equals the reference's `make_setup` step (3e-5)."""
    import jax
    import jax.numpy as jnp

    from repro.optim import AdamWConfig as JAdamWConfig

    aid = "granite-3-2b"
    jcfg, tcfg = jreduced(jget_arch(aid)), reduced(get_arch(aid))
    jsu = jsteps.make_setup(jcfg, JShapeSpec("t", S, B, "train"), None,
                            param_dtype=jnp.float32,
                            opt_cfg=JAdamWConfig(lr=LR),
                            lr_schedule=const_schedule)
    jp, jo = reference_state(jsu)
    data = batch_np(tcfg)
    jp2, _, jm = jax.jit(jsu.step_fn)(
        jp, jo, {k: jnp.asarray(v) for k, v in data.items()})
    np_params = jax.tree.map(np.asarray, jp)
    s = NTPSession.from_arch(
        tcfg, _shape(), device="cpu", opt_cfg=AdamWConfig(lr=LR),
        lr_schedule=const_schedule,
        params=tr.tree_map(lambda t: t.numpy(),
                           params_from_jax(np_params, device="cpu")))
    m = s.step({k: torch.from_numpy(v) for k, v in data.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=3e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jp2), device="cpu")
    for a, b in zip(tr.leaves(s.params), tr.leaves(want)):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)


def test_arch_session_refuses_lifecycle_calls(tmp_path):
    s = NTPSession.from_arch(reduced(get_arch("qwen2-7b")), _shape(),
                             device="cpu")
    calls = {
        "apply": lambda: s.apply(FailureEvent(step=0, replica=0)),
        "save": lambda: s.save(str(tmp_path / "c.npz")),
        "restore": lambda: s.restore(str(tmp_path / "c.npz")),
        "snapshot": s.snapshot, "rollback": s.rollback,
        "measure_sync": lambda: s.measure_sync(None),
        "canonical_params": s.canonical_params,
        "local_batches": lambda: s.local_batches,
        "optimizer": lambda: s.optimizer,
    }
    for name, call in calls.items():
        with pytest.raises(NotImplementedError) as e:
            call()
        msg = str(e.value)
        assert msg.startswith(f"NTPSession.{name}() needs ")
        assert "only the NTP prototype backend implements" in msg
        assert "NTPSession.from_arch()" in msg and "--ntp instead of --arch" \
            in msg and "power policies" in msg


def test_launcher_matches_from_arch_by_hand(tmp_path, capsys):
    """``--arch qwen2-7b --reduced --device cpu --steps 2 --seq-len 16``:
    the losses of `from_arch` driven by hand, the reference's log lines,
    and a ``--ckpt`` that restores into the session's trees."""
    ckpt = str(tmp_path / "arch.npz")
    out = train_main(["--arch", "qwen2-7b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--seq-len", "16", "--log-every", "1",
                      "--ckpt", ckpt])
    log = capsys.readouterr().out
    assert "arch=qwen2-7b-smoke params=" in log and "M device=cpu" in log
    assert log.count("  loss ") == 2 and "gnorm" in log
    assert "final checkpoint -> " + ckpt in log
    cfg = reduced(get_arch("qwen2-7b"))
    s = NTPSession.from_arch(
        cfg, ShapeSpec("cli", 16, 8, "train"),
        opt_cfg=AdamWConfig(lr=3e-4), device="cpu",
        generator=torch.Generator().manual_seed(0))
    pipe = SyntheticLMPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=0),
                               device="cpu")
    losses = [float(s.step(pipe.batch(i))["loss"]) for i in range(2)]
    assert out["losses"] == losses
    like = {"params": s.params, "opt": s.opt_state}
    tree, step = load_checkpoint(ckpt, like)
    assert step == 2
    for a, b in zip(tr.leaves(tree), tr.leaves(like)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("aid", sorted(ARCH_IDS))
def test_launcher_trains_every_arch(aid):
    out = train_main(["--arch", aid, "--reduced", "--device", "cpu",
                      "--steps", "2", "--seq-len", "16", "--batch", "2"])
    assert len(out["losses"]) == 2
    assert all(np.isfinite(loss) for loss in out["losses"])
    assert all(bool(torch.isfinite(t).all()) for t in tr.leaves(out["params"]))


@pytest.mark.parametrize("argv,row", [
    (["--arch", "qwen2-7b", "--dry-run"], "item 8"),
    (["--arch", "qwen2-7b", "--devices", "8"], "sharded arch-stack execution"),
    (["--arch", "qwen2-7b", "--fail-at", "2"], "--fail-at needs --ntp"),
    (["--steps", "2"], "--arch is required unless --ntp"),
])
def test_launcher_refusals(argv, row, capsys):
    with pytest.raises(SystemExit):
        train_main(argv + ["--device", "cpu"])
    assert row in capsys.readouterr().err


@pytest.mark.parametrize("aid", PARITY["test_torch_arch_session"])
def test_train_step_matches_reference(aid):
    step_parity(aid)
