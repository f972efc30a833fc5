"""`launch.profile` of the port on the CPU: ``--measure`` on a pp=2 × (1, 2)
staged mesh of 4 gloo processes beside the emulated session — both
sessions' steps printed, their losses within 1e-5 of each other (the
check `chip_smoke.py` phase 11 makes), the bubble factor against the
analytic one, the sync probes, ticks and hand-off table; ``--telemetry``
holds the parent's ``session.step`` spans with ``pp`` 2; the dry-run
mode prints the totals and the top contributors. The reference's
16-process ``--measure`` (pp=2 × (2, 4)) is the slow tier, as
tests/test_telemetry_runtime.py's twin."""
import functools
import json

import pytest

from repro_torch.launch import profile


def _losses_agree(r):
    emu = [st["loss"] for st in r["emulated"]["steps"]]
    for rank in r["staged"]:
        got = [st["loss"] for st in rank["steps"]]
        assert len(got) == len(emu)
        assert max(abs(a - b) for a, b in zip(got, emu)) <= 1e-5, \
            rank["rank"]


def test_measure_on_a_small_staged_mesh(capsys):
    r = profile.measure(steps=2, n_data=1, n_model=2, pp=2, device="cpu")
    out = capsys.readouterr().out
    assert out.count("emu step") == out.count("sub step") == 4
    assert "(warm-up)" in out and "bubble factor: measured" in out
    assert "sync probe" in out and "fwd_bytes" in out
    _losses_agree(r)
    assert len(r["staged"]) == 4
    assert r["analytic"] == (4 + 2 - 1) / 4
    assert r["bubble"] == r["t_sub"] / r["t_emu"] > 0
    assert [st["timed"] for st in r["emulated"]["steps"]] == \
        [False, False, True, True]


def test_measure_telemetry_holds_session_steps(tmp_path, monkeypatch,
                                               capsys):
    out = tmp_path / "run.jsonl"
    monkeypatch.setattr(profile, "measure", functools.partial(
        profile.measure, device="cpu", n_data=1, n_model=2))
    profile.main(["--measure", "--steps", "1", "--telemetry", str(out)])
    assert "telemetry stream written" in capsys.readouterr().out
    spans = [json.loads(line) for line in out.read_text().splitlines()]
    steps = [s for s in spans if s["name"] == "session.step"]
    assert len(steps) == 3 and all(s["labels"]["pp"] == 2 for s in steps)


def test_dry_run_prints_the_top_contributors(capsys):
    profile.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                  "--top", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("total: ")
    assert lines[1].split()[0] == "aten_op:function"
    assert len(lines) == 2 + 5
    assert any(":" in line.split()[0] for line in lines[2:])


def test_measure_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile.measure(steps=1, n_data=1, n_model=2)


@pytest.mark.slow
def test_measure_the_reference_mesh():
    """The reference's default: pp=2 on (2, 4), 16 processes."""
    _losses_agree(profile.measure(steps=1, device="cpu"))
