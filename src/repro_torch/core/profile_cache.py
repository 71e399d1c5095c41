"""Persistent offline-profiling cache (``artifacts/profiles_torch/*.json``).

Hercules' provisioning pipeline keeps re-deriving the same efficiency
tuples: every ``build_table`` call, cluster benchmark and example re-runs
the gradient search for each (workload, server) cell, and the baseline
sweeps re-run their grid scans.  This module caches one record per
profiled cell, keyed by everything that determines the result:

- profiling kind (``hercules`` search, ``deeprecsys``/``baymax`` baseline),
- workload fingerprint (name + operator profile + footprints + SLA),
- server fingerprint (the full device profile),
- search seed, o-grid, batch grid, power budget,
- the query-size sample (hashed bytes), and
- ``ENGINE_VERSION`` — bump it when simulator semantics change to
  invalidate every cached profile at once.

Cache files are ``<workload>__<server>__<kind>__<key12>.json`` so stale
entries for a cell are overwritten in place and ``invalidate()`` can
target a workload/server subset.  A record whose stored key does not
match (hash collision on the truncated filename, hand-edited file) is
recomputed, never trusted.
"""
from __future__ import annotations

import hashlib
import json
import pathlib

import numpy as np

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts"
# The port's records live apart from the reference's ``artifacts/profiles/``:
# both packages compute the same keys, so a shared directory would let one
# package answer from the other's records.
PROFILE_DIR = ARTIFACTS / "profiles_torch"

# Bump to invalidate all cached profiles when the simulator/search changes
# in a result-affecting way.
ENGINE_VERSION = 2


def _fingerprint(obj) -> str:
    return hashlib.sha1(repr(obj).encode()).hexdigest()


def pair_key(
    kind: str,
    profile,
    device,
    query_sizes: np.ndarray,
    seed: int = 0,
    o_grid=None,
    batch_grid=None,
    power_budget_w: float | None = None,
    qps_tol: float = 0.0,
    engine: str = "fast",
    coloc: tuple | None = None,
) -> str:
    """Deterministic key for one profiled (workload, server) cell."""
    h = hashlib.sha1()
    payload = {
        "v": ENGINE_VERSION,
        "kind": kind,
        "workload": _fingerprint((profile.name, profile.ops, profile.table_gb,
                                  profile.weight_gb, profile.sla_ms,
                                  profile.zipf_alpha)),
        "server": _fingerprint(device),
        "seed": int(seed),
        "o_grid": list(o_grid) if o_grid else None,
        "batch_grid": list(batch_grid) if batch_grid else None,
        "power_budget_w": power_budget_w,
    }
    if qps_tol:  # keep bit-exact (tol=0) keys unchanged across this addition
        payload["qps_tol"] = float(qps_tol)
    if engine != "fast":  # reference-engine records must never satisfy a
        payload["engine"] = engine  # fast lookup or vice versa
    if coloc:  # co-located records key on the co-tenant set; solo (coloc
        payload["coloc"] = list(coloc)  # empty/None) keys stay unchanged

    h.update(json.dumps(payload, sort_keys=True).encode())
    h.update(np.ascontiguousarray(np.asarray(query_sizes, np.int64)).tobytes())
    return h.hexdigest()


def _path(kind: str, workload: str, server: str, key: str,
          root: pathlib.Path | None = None) -> pathlib.Path:
    root = root or PROFILE_DIR
    safe = "".join(c if c.isalnum() or c in "-._" else "_" for c in f"{workload}__{server}")
    return root / f"{safe}__{kind}__{key[:12]}.json"


def load(kind: str, workload: str, server: str, key: str,
         root: pathlib.Path | None = None) -> dict | None:
    """Cached record for this key, or None (missing / stale / corrupt)."""
    p = _path(kind, workload, server, key, root)
    if not p.exists():
        return None
    try:
        blob = json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if blob.get("key") != key:
        return None
    return blob.get("record")


def store(kind: str, workload: str, server: str, key: str, record: dict,
          root: pathlib.Path | None = None) -> pathlib.Path:
    p = _path(kind, workload, server, key, root)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        {"key": key, "kind": kind, "workload": workload, "server": server,
         "engine_version": ENGINE_VERSION, "record": record}, indent=1))
    return p


def invalidate(workload: str | None = None, server: str | None = None,
               root: pathlib.Path | None = None) -> int:
    """Delete cached profiles (all, or a workload/server subset); returns
    the number of files removed."""
    root = root or PROFILE_DIR
    if not root.exists():
        return 0
    removed = 0
    for p in root.glob("*.json"):
        try:
            blob = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError):
            blob = {}
        if workload is not None and blob.get("workload") != workload:
            continue
        if server is not None and blob.get("server") != server:
            continue
        p.unlink()
        removed += 1
    return removed
