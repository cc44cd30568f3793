"""``tuneconf.v1`` artifacts: the persisted, verifiable output of one
tuner search. The counterpart of ``lux_tpu/tune/artifact.py``: the same
key string, file-name hash, content-derived id and JSON layout, so an
artifact written by either package loads in the other.

A tune artifact is *evidence*, exactly like a saved partition plan: it
names the workload it was searched for (graph fingerprint, program,
engine kind, mesh shape, device kind), the winning knob assignment, and
the full score table with the run-ledger record ids of every probe that
produced it — so ``luxlint --tune`` can verify the selection offline
and PERF.md claims can cite it. Files are one JSON object each,
written atomically (tmp + rename) under ``LUX_TUNE_DIR`` with a name
derived from the key, so re-tuning the same workload replaces its
artifact in place.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

SCHEMA = "tuneconf.v1"

# Key fields, in key_string order. device_kind joins the run-ledger key
# quartet because a config searched on one chip is not evidence for
# another (the accelerator survey's reproducibility complaint).
KEY_FIELDS = ("graph_fingerprint", "program", "engine_kind",
              "mesh_shape", "device_kind")

__all__ = ["SCHEMA", "KEY_FIELDS", "make_key", "key_string",
           "artifact_path", "build", "save", "load_path", "load",
           "list_artifacts"]


def make_key(graph_fingerprint: str, program: str, engine_kind: str,
             mesh_shape: str, device_kind: str) -> Dict[str, str]:
    return {
        "graph_fingerprint": str(graph_fingerprint),
        "program": str(program),
        "engine_kind": str(engine_kind),
        "mesh_shape": str(mesh_shape),
        "device_kind": str(device_kind),
    }


def key_string(key: Dict[str, str]) -> str:
    return "|".join(str(key[f]) for f in KEY_FIELDS)


def _key_hash(key: Dict[str, str]) -> str:
    return hashlib.sha1(key_string(key).encode("utf-8")).hexdigest()[:12]


def artifact_path(root: str, key: Dict[str, str]) -> str:
    return os.path.join(root, f"tuneconf-{_key_hash(key)}.json")


def build(key: Dict[str, str], config: Dict[str, str], score: float,
          score_table: List[dict], graph_meta: Dict[str, int],
          tuner: Dict[str, object],
          select_record_id: Optional[str] = None,
          created_at: Optional[float] = None) -> dict:
    """Assemble one artifact dict. The id is content-derived (key +
    winning config + per-row scores), so identical searches mint
    identical ids — determinism is testable end to end."""
    blob = key_string(key) + "\x00" + json.dumps(config, sort_keys=True) \
        + "\x00" + json.dumps(
            [[r["score"], r["iters"], r["rung"]] for r in score_table])
    art = {
        "schema": SCHEMA,
        "id": "tune-" + hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12],
        "created_at": float(time.time() if created_at is None
                            else created_at),
        "key": dict(key),
        "key_string": key_string(key),
        "config": dict(config),
        "score": float(score),
        "score_table": score_table,
        "probe_ledger_ids": [r["probe_record_id"] for r in score_table
                             if r.get("probe_record_id")],
        "graph_meta": dict(graph_meta),
        "tuner": dict(tuner),
    }
    if select_record_id:
        art["select_record_id"] = select_record_id
    return art


def save(root: str, art: dict) -> str:
    """Atomic write; returns the artifact path."""
    os.makedirs(root, exist_ok=True)
    path = artifact_path(root, art["key"])
    fd, tmp = tempfile.mkstemp(dir=root, prefix=".tuneconf-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_path(path: str) -> dict:
    with open(path) as f:
        art = json.load(f)
    if art.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: schema {art.get('schema')!r}, want {SCHEMA!r}")
    return art


def load(root: str, key: Dict[str, str]) -> Optional[dict]:
    """The persisted artifact for ``key``, or None. A file that exists
    but fails to parse raises — a corrupt artifact must never silently
    become a fallback-to-default."""
    path = artifact_path(root, key)
    if not os.path.exists(path):
        return None
    art = load_path(path)
    if art.get("key_string") != key_string(key):
        raise ValueError(
            f"{path}: key_string {art.get('key_string')!r} does not match "
            f"requested key {key_string(key)!r} (hash collision or "
            "hand-edited artifact)")
    return art


def list_artifacts(root: str) -> List[str]:
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    return [os.path.join(root, e) for e in entries
            if e.startswith("tuneconf-") and e.endswith(".json")]
