"""Best-known-evidence record store + compact driver digest (split
out of bench.py, round 5). Pure functions — no globals, no I/O."""

import json
import time


_HEADLINE_KEYS = ("value", "vs_baseline", "wire", "e2e_f32_rtf",
                  "e2e_fade_rtf", "engine_steady_ms",
                  "engine_fade_indexed_ms", "engine_fade_general_ms",
                  "engine_steady_rtf", "p99_ms", "p99_basis",
                  "transport_bound")

# per-leg figure of merit for the plausibility guard (lower is better);
# 'equiv' is deliberately unguarded: it measures accuracy, not weather
_LEG_FOM = {"ws": "steady_ms", "sel152": "steady_ms",
            "cascade_hv": "steady_ms", "cascade_2048": "steady_ms",
            "mono_ref": "steady_ms", "offline": "wall_s",
            "p99_block": "p99_ms", "groups": "combined_ms"}
# a reading this many times worse than the stored one is held out as a
# suspected host-side artifact until a second run confirms it
_SUSPECT_RATIO = 1.8


def _flag_suspects(rec: dict, prior: dict) -> None:
    """Annotate the PRINTED record (this-run readings are kept — the
    printed line is always what THIS run measured) when a row is
    implausibly worse than the prior completed record: congestion
    evidence for the reader. The store merge separately keeps the prior
    row (_merge_store)."""
    pv, nv = prior.get("value") or 0, rec.get("value") or 0
    if pv > 0 and nv > 0 and nv * _SUSPECT_RATIO < pv:
        rec["suspect"] = {"value": pv,
                          "measured_at": prior.get("measured_at")}
    prior_legs = prior.get("legs") or {}
    for name, row in (rec.get("legs") or {}).items():
        key = _LEG_FOM.get(name)
        old = prior_legs.get(name)
        if (key and isinstance(row, dict) and isinstance(old, dict)
                and isinstance(row.get(key), (int, float))
                and isinstance(old.get(key), (int, float)) and old[key] > 0
                and row[key] > _SUSPECT_RATIO * old[key]):
            row["suspect"] = {key: old[key],
                             "measured_at": old.get(
                                 "stale_from", prior.get("measured_at"))}


def _merge_leg_row(name, new, old, new_at, old_at, others_healthy=None):
    """Best-known-evidence merge for ONE leg row. Newest wins ONLY when
    plausible: a reading > _SUSPECT_RATIO x worse than the stored one is
    kept OUT of the store (tagged suspect_congestion with the rejected
    reading) unless the stored row is itself already suspect-tagged — a
    second consecutive bad reading is accepted as a real regression
    (tagged regressed_from) so the store can never lie forever.

    others_healthy: cross-leg covariate (a run-wide slowdown would
    otherwise let the two-strike rule confirm an artifact).
    True = every OTHER comparable leg of this run is within its
    plausibility band, so a second strike measures a REAL regression;
    False = the rest of the run is also elevated (a run-wide slowdown),
    so the second strike re-tags instead of confirming;
    None = no other comparable legs exist (targeted rerun) — fall back
    to the plain two-strike rule."""
    def stale(row):
        # provenance must not drift forward across consecutive bad runs
        return dict(row, stale_from=row.get(
            "stale_from", row.get("measured_at", old_at)))

    good_new = (isinstance(new, dict) and "error" not in new
                and "skipped" not in new)
    good_old = (isinstance(old, dict) and "error" not in old
                and "skipped" not in old)
    if not good_new:
        if good_old:
            return stale(old)
        return new if new is not None else old
    new = {k: v for k, v in new.items() if k != "suspect"}
    if not good_old:
        return new
    key = _LEG_FOM.get(name)
    nv, ov = (new.get(key), old.get(key)) if key else (None, None)
    if (isinstance(nv, (int, float)) and isinstance(ov, (int, float))
            and ov > 0 and nv > _SUSPECT_RATIO * ov):
        if "suspect_congestion" in old and others_healthy is not False:
            # second strike on a healthy-looking run (or no covariate
            # available): accept as a real regression
            row = dict(new)
            row["regressed_from"] = {key: ov,
                                     "measured_at": old.get("stale_from",
                                                            old_at)}
            return row
        row = stale(old)
        row["suspect_congestion"] = {key: nv, "measured_at": new_at}
        return row
    return new


def _merge_store(rec: dict, prior) -> dict:
    """The store record a completed (or even partial) run leaves behind:
    per-row best-known evidence with explicit provenance, replacing the
    newest-wins merge that let one globally slowed run overwrite every
    healthy row."""
    store = {k: v for k, v in rec.items()
             if k not in ("last_good", "suspect")}
    store["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime())
    new_at = store["measured_at"]
    old_at = (prior or {}).get("measured_at")

    # cross-leg weather covariate: per-leg new/old figure-of-merit ratios
    # for every leg measured in BOTH records (errors/skips excluded)
    prior_legs0 = (prior or {}).get("legs") or {}
    ratios = {}
    for nm, row in (store.get("legs") or {}).items():
        key = _LEG_FOM.get(nm)
        old = prior_legs0.get(nm)
        if (key and isinstance(row, dict) and isinstance(old, dict)
                and "error" not in row and "skipped" not in row
                and isinstance(row.get(key), (int, float))
                and isinstance(old.get(key), (int, float)) and old[key] > 0):
            ratios[nm] = row[key] / old[key]

    def _others_healthy(exclude):
        rs = [r for n, r in ratios.items() if n != exclude]
        if not rs:
            return None
        return all(r <= _SUSPECT_RATIO for r in rs)

    if prior:
        pv = prior.get("value") or 0
        nv = store.get("value") or 0
        good_new = nv > 0 and not rec.get("partial")
        good_old = pv > 0

        def keep_prior_headline(suspect=None):
            for k in _HEADLINE_KEYS:
                if k in prior:
                    store[k] = prior[k]
            store["value"] = pv
            store["vs_baseline"] = pv
            store["headline_stale_from"] = prior.get("headline_stale_from",
                                                     old_at)
            store.pop("partial", None)
            store.pop("error", None)
            if suspect is not None:
                store["suspect_congestion"] = suspect
            elif "suspect_congestion" in prior:
                store["suspect_congestion"] = prior["suspect_congestion"]

        if good_old and not good_new:
            # headline failed/partial this run: the store keeps the prior
            # measured headline (tagged), this run's legs still merge in
            keep_prior_headline()
        elif good_old and good_new and nv * _SUSPECT_RATIO < pv:
            if ("suspect_congestion" in prior
                    and _others_healthy(None) is not False):
                store["regressed_from"] = {
                    "value": pv,
                    "measured_at": prior.get("headline_stale_from", old_at)}
            else:
                keep_prior_headline(suspect={"value": nv,
                                             "measured_at": new_at})

    prior_legs = (prior or {}).get("legs") or {}
    legs = dict(store.get("legs") or {})
    for name in set(legs) | set(prior_legs):
        merged = _merge_leg_row(name, legs.get(name), prior_legs.get(name),
                                new_at, old_at,
                                others_healthy=_others_healthy(name))
        if merged is not None:
            legs[name] = merged
    store["legs"] = legs or None
    # the per-block p99 headline keys mirror the MERGED p99_block row
    # (a run that didn't measure the leg must not drop the store's
    # best-known per-block evidence)
    pb = (legs or {}).get("p99_block")
    if isinstance(pb, dict) and isinstance(pb.get("p99_ms"), (int, float)):
        store["p99_per_block_ms"] = pb["p99_ms"]
        store["p99_per_block_basis"] = (f"{pb.get('basis')}; "
                                        f"{pb.get('blocks')} chained steps")
    return store




_COMPACT_BUDGET = 1100


def _compact_summary(rec: dict) -> str:
    """The digest printed as the LAST stdout line: headline keys, one
    figure-of-merit per leg, provenance flags — never the full record."""
    out = {"metric": rec.get("metric"), "value": rec.get("value"),
           "unit": rec.get("unit", "x_realtime"),
           "vs_baseline": rec.get("vs_baseline")}
    for k in ("engine_steady_ms", "p99_per_block_ms"):
        v = rec.get(k)
        if isinstance(v, (int, float)):
            out[k] = round(v, 3)
    if rec.get("partial"):
        out["partial"] = True
    if rec.get("error"):
        out["error"] = str(rec["error"])[:140]
    lg = rec.get("last_good")
    if isinstance(lg, dict) and isinstance(lg.get("value"), (int, float)):
        out["last_good_value"] = lg["value"]
    legs, stale = {}, []
    for name, row in (rec.get("legs") or {}).items():
        if not isinstance(row, dict):
            continue
        if "error" in row:
            legs[name] = "error"
            continue
        if "skipped" in row:
            legs[name] = "skipped"
            continue
        key = _LEG_FOM.get(name)
        v = row.get(key) if key else None
        if isinstance(v, (int, float)):
            legs[name] = round(v, 3)
        elif name == "equiv":
            legs[name] = "pass" if row.get("pass") else "FAIL"
        else:
            legs[name] = "ok"
        if "stale_from" in row:
            stale.append(name)
    if legs:
        out["legs"] = legs
    if stale:
        out["stale_legs"] = stale
    if rec.get("legs_skipped"):
        out["legs_skipped"] = str(rec["legs_skipped"])[:100]
    line = json.dumps(out)
    # belt-and-braces: the digest must NEVER outgrow the tail window
    for drop in ("legs_skipped", "error", "stale_legs", "legs"):
        if len(line) <= _COMPACT_BUDGET:
            break
        out.pop(drop, None)
        line = json.dumps(out)
    return line


