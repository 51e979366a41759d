"""Wedge-proofing: the bench orchestrator runs the headline and every leg
in killable child processes with per-unit timeouts and one retry — a
wedged compile costs one child's budget, not the whole record. These
tests drive the
REAL subprocess path on tiny CPU shapes, including an artificially
wedged leg whose in-process watchdog is also suppressed (simulating a
blocked C call that only the orchestrator's kill can recover from)."""

import json
import sys


def _bench():
    sys.path.insert(0, "/root/repo")
    try:
        import bench
    finally:
        sys.path.pop(0)
    return bench


# --platform cpu: children are fresh processes; the flag makes every child
# force the CPU itself
BASE = ["--voices", "2", "--num-irs", "2", "--ir-seconds", "0.05",
        "--block", "256", "--engine-blocks", "4", "--chunks", "4",
        "--chunk", "3", "--reps", "1", "--no-backend-probe",
        "--record-dir", "", "--platform", "cpu",
        "--isolate", "subprocess"]


def _last_json(capsys):
    """The FULL record (stderr) — and assert the driver-facing stdout
    digest stays inside the 2,000-char tail window with 2x headroom and
    agrees on the headline value (BENCH_r04 was parsed:null because the
    full record outgrew the tail)."""
    cap = capsys.readouterr()
    full = None
    for line in cap.err.strip().splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                full = json.loads(line)
            except ValueError:
                continue
    last = cap.out.strip().splitlines()[-1]
    assert len(last) < 1200
    digest = json.loads(last)
    assert full is not None and digest["value"] == full["value"]
    return full


def test_subprocess_headline_completes(capsys, tmp_path):
    bench = _bench()
    assert bench.main([*BASE, "--legs", "none",
                       "--pack-cache", str(tmp_path)]) == 0
    rec = _last_json(capsys)
    assert rec["value"] > 0
    assert "partial" not in rec
    assert rec["engine_steady_ms"] > 0
    assert rec["p99_ms"] > 0


def test_orchestrator_writes_merged_store(capsys, tmp_path):
    """A completed orchestrated run persists the merged best-known-
    evidence record to the record dir (same contract as in-process)."""
    import json as _json

    bench = _bench()
    # appended flags win in argparse: BASE's --record-dir '' is overridden
    assert bench.main([*BASE, "--record-dir", str(tmp_path / "rec"),
                       "--legs", "none",
                       "--pack-cache", str(tmp_path / "cache")]) == 0
    rec = _last_json(capsys)
    stored = _json.loads(
        (tmp_path / "rec" / f"last_good_{rec['metric']}.json").read_text())
    assert stored["value"] == rec["value"]
    assert "measured_at" in stored


def test_wedged_leg_cannot_zero_the_run(capsys, tmp_path, monkeypatch):
    """The offline leg wedges hard on BOTH attempts (watchdog suppressed —
    a blocked C call): the orchestrator kills it twice, records the
    failure as that leg's row, and the run still completes with the
    headline and the other leg's this-run numbers. This is the round-3
    postmortem scenario with the fix in place."""
    bench = _bench()
    monkeypatch.setenv("TPU_AUDIO_BENCH_WEDGE", "offline:600")
    monkeypatch.setenv("TPU_AUDIO_BENCH_WEDGE_HARD", "1")
    assert bench.main([*BASE, "--legs", "all",
                       "--only-legs", "offline,mono_ref",
                       "--child-timeout", "20",
                       "--offline-seconds", "0.5",
                       "--pack-cache", str(tmp_path)]) == 0
    rec = _last_json(capsys)
    assert rec["value"] > 0                       # headline survived
    assert "partial" not in rec                   # the record completed
    assert rec["legs"]["mono_ref"]["steady_ms"] > 0
    err = rec["legs"]["offline"]["error"]
    assert "killed" in err or "wedged" in err
    # both attempts were made before giving up
    assert "(x2)" in err


def test_wedged_headline_still_captures_legs(capsys, tmp_path, monkeypatch):
    """Round 3's actual failure: the headline's first compile wedges. The
    child's own watchdog emits a partial line, the orchestrator retries
    (still wedged), gives up — and the LEGS still run and the final line
    still carries their this-run numbers (r03 carried nothing)."""
    bench = _bench()
    monkeypatch.setenv("TPU_AUDIO_BENCH_WEDGE", "headline:600")
    assert bench.main([*BASE, "--legs", "all", "--only-legs", "mono_ref",
                       "--child-timeout", "20",
                       "--pack-cache", str(tmp_path)]) == 0
    rec = _last_json(capsys)
    assert rec["partial"] is True
    assert "headline" in rec["error"]
    assert rec["legs"]["mono_ref"]["steady_ms"] > 0
