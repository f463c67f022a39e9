"""rgp_tpu_torch.bench.all against rgp_tpu.bench.all on the CPU.

* the entries have the JAX sweep's names, order, flags and timeouts, for the
  quick and the full budgets alike, each pointed at the port's entry point;
* ``run_all`` with ``subprocess.run`` stubbed writes rows with the JAX row's
  keys plus ``card`` to ``--out`` (never to the JAX sweep's files) and
  never sleeps; a failing entry keeps its stderr tail and the sweep goes on.
"""

import json
import subprocess
import sys

import pytest

from rgp_tpu.bench import all as jall
from rgp_tpu_torch.bench import all as tall

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _ported(argv):
    """A JAX entry's command line as the port's entry point runs it."""
    exe, *rest = argv
    if rest[0].endswith("bench.py"):
        return [exe, "-m", "rgp_tpu_torch.bench.config1", *rest[1:]]
    assert rest[0] == "-m" and rest[1].startswith("rgp_tpu.bench")
    return [exe, "-m", rest[1].replace("rgp_tpu.bench", "rgp_tpu_torch.bench", 1), *rest[2:]]


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_entries_are_the_jax_sweeps(quick):
    ref, ours = jall._entries(quick), tall._entries(quick)
    assert [e[0] for e in ours] == [e[0] for e in ref]
    for (name, argv, timeout), (_, jargv, jtimeout) in zip(ours, ref):
        assert argv == _ported(jargv), name
        assert timeout == jtimeout, name
        assert argv[0] == sys.executable


def _fake_run(calls, fail=()):
    def run(argv, **kw):
        calls.append(list(argv))
        if argv[0] == "nvidia-smi":
            return subprocess.CompletedProcess(argv, 0, stdout=CARD + "\n", stderr="")
        if argv[0] == "git":
            return subprocess.CompletedProcess(argv, 0, stdout="abc1234\n", stderr="")
        rc = 1 if any(f in argv for f in fail) else 0
        return subprocess.CompletedProcess(argv, rc, stdout=b'{"metric": "m", "value": 1.5}\n', stderr=b"boom")
    return run


def test_run_all_rows(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_run(calls))
    monkeypatch.setattr(jall, "_REPO", tmp_path)  # the JAX sweep writes under its repo's artifacts/
    ref = jall.run_all(1, quick=True, only={"serving"})
    assert len(ref) == 1

    def no_sleep(s):
        raise AssertionError(f"slept {s} s")

    monkeypatch.setattr(tall.time, "sleep", no_sleep)
    out = tmp_path / "rows.jsonl"
    rows = tall.run_all(9, quick=True, only={"config5", "serving"}, out=str(out))
    assert [r["name"] for r in rows] == ["config5_nuts", "config5_smc", "serving"]
    written = [json.loads(line) for line in out.read_text().splitlines()]
    assert written == json.loads(json.dumps(rows))
    for r in rows:
        assert set(r) == set(ref[0]) | {"card"}
        assert r["card"] == CARD and r["git_sha"] == "abc1234" and r["returncode"] == 0
        assert r["result"] == {"metric": "m", "value": 1.5} and r["quick"] is True
    bench_calls = [c for c in calls if c[0] == sys.executable]
    assert bench_calls[-1] == [sys.executable, "-m", "rgp_tpu_torch.bench.serving"]
    assert not (tall._REPO / "artifacts" / "torch_bench_all_r9.jsonl").exists()


def test_run_all_keeps_going_past_a_failure(monkeypatch, tmp_path):
    monkeypatch.setattr(subprocess, "run", _fake_run([], fail=("smc",)))
    rows = tall.run_all(9, quick=True, only={"config5"}, out=str(tmp_path / "rows.jsonl"))
    assert [r["returncode"] for r in rows] == [0, 1]
    assert rows[1]["stderr_tail"] == "boom" and "stderr_tail" not in rows[0]
