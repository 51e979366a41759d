"""Best-known-evidence store merge (bench._merge_store): newest wins only
when PLAUSIBLE. A newest-wins merge lets one globally slowed run
overwrite a healthy reading; the policy under test
keeps implausible readings out of the store (tagged suspect_congestion
with the rejected reading) while accepting a twice-confirmed regression
(tagged regressed_from) so the store can never lie forever."""

import sys

import pytest


def _bench():
    sys.path.insert(0, "/root/repo")
    try:
        import bench
    finally:
        sys.path.pop(0)
    return bench


def mk(value=4.5, legs=None, partial=False, at=None):
    rec = {"metric": "m", "value": value, "vs_baseline": value,
           "unit": "x_realtime", "engine_steady_ms": 0.85,
           "p99_ms": 1.9, "legs": legs}
    if partial:
        rec["partial"] = True
        rec["error"] = "headline: wedged"
    if at:
        rec["measured_at"] = at
    return rec


def test_suspect_leg_kept_out_of_store():
    bench = _bench()
    prior = mk(legs={"ws": {"steady_ms": 1.144, "rtf": 5.07}}, at="T1")
    new = mk(legs={"ws": {"steady_ms": 37.056, "rtf": 0.157}})
    row = bench._merge_store(new, prior)["legs"]["ws"]
    assert row["steady_ms"] == 1.144
    assert row["stale_from"] == "T1"
    assert row["suspect_congestion"]["steady_ms"] == 37.056


def test_confirmed_leg_regression_accepted():
    bench = _bench()
    prior = mk(legs={"ws": {"steady_ms": 1.144,
                            "suspect_congestion": {"steady_ms": 37.056,
                                                   "measured_at": "T2"}}},
               at="T1")
    new = mk(legs={"ws": {"steady_ms": 30.0}})
    row = bench._merge_store(new, prior)["legs"]["ws"]
    assert row["steady_ms"] == 30.0
    assert row["regressed_from"]["steady_ms"] == 1.144


def test_good_reading_clears_suspect_tag():
    bench = _bench()
    prior = mk(legs={"ws": {"steady_ms": 1.144, "stale_from": "T0",
                            "suspect_congestion": {"steady_ms": 37.056,
                                                   "measured_at": "T2"}}},
               at="T1")
    new = mk(legs={"ws": {"steady_ms": 1.2}})
    row = bench._merge_store(new, prior)["legs"]["ws"]
    assert row["steady_ms"] == 1.2
    assert "suspect_congestion" not in row
    assert "stale_from" not in row


def test_within_band_newest_wins():
    bench = _bench()
    prior = mk(value=4.5, legs={"ws": {"steady_ms": 1.144}}, at="T1")
    new = mk(value=3.4, legs={"ws": {"steady_ms": 1.5}})
    store = bench._merge_store(new, prior)
    assert store["value"] == 3.4
    assert store["legs"]["ws"]["steady_ms"] == 1.5
    assert "suspect_congestion" not in store["legs"]["ws"]
    assert "suspect_congestion" not in store


def test_partial_headline_substituted_from_prior():
    bench = _bench()
    prior = mk(value=4.5, at="T1")
    new = mk(value=0.0, partial=True, legs={"ws": {"steady_ms": 1.2}})
    store = bench._merge_store(new, prior)
    assert store["value"] == 4.5
    assert store["engine_steady_ms"] == 0.85
    assert store["headline_stale_from"] == "T1"
    assert "partial" not in store and "error" not in store
    # this run's good legs still merged in
    assert store["legs"]["ws"]["steady_ms"] == 1.2


def test_suspect_headline_then_confirmed_regression():
    bench = _bench()
    prior = mk(value=4.5, at="T1")
    store = bench._merge_store(mk(value=1.0), prior)
    assert store["value"] == 4.5
    assert store["suspect_congestion"]["value"] == 1.0
    assert store["headline_stale_from"] == "T1"
    store2 = bench._merge_store(mk(value=1.1), store)
    assert store2["value"] == 1.1
    assert store2["regressed_from"]["value"] == 4.5


def test_skipped_leg_backfilled_with_provenance():
    bench = _bench()
    prior = mk(legs={"sel152": {"steady_ms": 2.05, "rtf": 2.83}}, at="T1")
    new = mk(legs={"sel152": {"skipped": "slow host link"}})
    row = bench._merge_store(new, prior)["legs"]["sel152"]
    assert row["steady_ms"] == 2.05
    assert row["stale_from"] == "T1"


def test_perblock_keys_survive_partial_runs():
    """A targeted/partial run that didn't measure p99_block must not drop
    the store's per-block evidence: the headline keys re-hoist from the
    merged (backfilled) leg row."""
    bench = _bench()
    prior = mk(value=4.5, at="T1",
               legs={"p99_block": {"p99_ms": 0.477, "blocks": 100,
                                   "basis": "on-device XLA trace"}})
    prior["p99_per_block_ms"] = 0.477
    new = mk(value=0.0, partial=True, legs=None)
    store = bench._merge_store(new, prior)
    assert store["legs"]["p99_block"]["p99_ms"] == 0.477
    assert store["p99_per_block_ms"] == 0.477
    assert "on-device" in store["p99_per_block_basis"]


def test_flag_suspects_annotates_printed_record_only():
    bench = _bench()
    rec = mk(value=1.0, legs={"ws": {"steady_ms": 37.0}})
    prior = mk(value=4.5, legs={"ws": {"steady_ms": 1.144}}, at="T1")
    bench._flag_suspects(rec, prior)
    # this-run readings stay in the printed record; annotation rides along
    assert rec["value"] == 1.0
    assert rec["suspect"]["value"] == 4.5
    assert rec["legs"]["ws"]["steady_ms"] == 37.0
    assert rec["legs"]["ws"]["suspect"]["steady_ms"] == 1.144
    # and the store merge strips the printed-record annotations
    store = bench._merge_store(rec, prior)
    assert "suspect" not in store
    assert "suspect" not in store["legs"]["ws"]


def test_covariate_blocks_confirmation_when_run_is_globally_congested():
    """Cross-leg covariate: a SECOND bad reading for a leg is only
    accepted as a real regression when the OTHER comparable legs of the
    same run are within their plausibility bands — otherwise two globally
    slowed runs would make the plain two-strike rule confirm an artifact."""
    bench = _bench()
    prior = mk(legs={
        "mono_ref": {"steady_ms": 0.414,
                     "suspect_congestion": {"steady_ms": 1.0,
                                            "measured_at": "T2"}},
        "ws": {"steady_ms": 1.1}}, at="T1")
    # second bad mono_ref reading, but ws is ALSO 3x its band: global
    # congestion -> keep the prior row, refresh the suspect tag
    new = mk(legs={"mono_ref": {"steady_ms": 1.082},
                   "ws": {"steady_ms": 3.5}})
    row = bench._merge_store(new, prior)["legs"]["mono_ref"]
    assert row["steady_ms"] == 0.414
    assert row["suspect_congestion"]["steady_ms"] == 1.082


def test_covariate_allows_confirmation_when_other_legs_healthy():
    bench = _bench()
    prior = mk(legs={
        "mono_ref": {"steady_ms": 0.414,
                     "suspect_congestion": {"steady_ms": 1.0,
                                            "measured_at": "T2"}},
        "ws": {"steady_ms": 1.1}}, at="T1")
    # second bad mono_ref reading on an otherwise-healthy run: a REAL
    # regression, accepted with provenance
    new = mk(legs={"mono_ref": {"steady_ms": 1.082},
                   "ws": {"steady_ms": 1.15}})
    row = bench._merge_store(new, prior)["legs"]["mono_ref"]
    assert row["steady_ms"] == 1.082
    assert row["regressed_from"]["steady_ms"] == 0.414


def test_covariate_absent_falls_back_to_two_strike():
    """Targeted single-leg reruns have no covariate — the plain
    two-strike rule applies (the pre-covariate behavior)."""
    bench = _bench()
    prior = mk(legs={"ws": {"steady_ms": 1.144,
                            "suspect_congestion": {"steady_ms": 37.0,
                                                   "measured_at": "T2"}}},
               at="T1")
    new = mk(legs={"ws": {"steady_ms": 30.0}})
    row = bench._merge_store(new, prior)["legs"]["ws"]
    assert row["steady_ms"] == 30.0
    assert row["regressed_from"]["steady_ms"] == 1.144


def test_covariate_gates_headline_confirmation_too():
    bench = _bench()
    prior = mk(value=4.5, legs={"ws": {"steady_ms": 1.1}}, at="T1")
    prior["suspect_congestion"] = {"value": 1.0, "measured_at": "T2"}
    # second bad headline on a run whose ws leg is also 3x its band
    new = mk(value=1.1, legs={"ws": {"steady_ms": 3.5}})
    store = bench._merge_store(new, prior)
    assert store["value"] == 4.5          # kept prior, not confirmed
    assert store["suspect_congestion"]["value"] == 1.1


@pytest.mark.parametrize("layout", ["no_dirs", "empty_dirs", "auto_repo_dir"])
def test_last_good_lookup_tolerates_missing_records(tmp_path, layout):
    """The TPU-era records are gone from the tree: a partial record must
    still print, with no last_good attached, when neither store holds one."""
    import os

    bench = _bench()
    old = bench._LAST_GOOD_DIR, bench._REPO_RECORD_DIR
    try:
        cache, repo = tmp_path / "cache", tmp_path / "bench_records"
        if layout == "empty_dirs":
            cache.mkdir()
            repo.mkdir()
        bench._LAST_GOOD_DIR = str(cache)
        bench._REPO_RECORD_DIR = (
            os.path.join(os.path.dirname(os.path.abspath(bench.__file__)),
                         "bench_records")
            if layout == "auto_repo_dir" else str(repo))
        if layout == "auto_repo_dir":
            bench._LAST_GOOD_DIR = None
        assert bench._load_last_good("rtf_64voices_4sIR_44k256") is None
    finally:
        bench._LAST_GOOD_DIR, bench._REPO_RECORD_DIR = old
