"""Seeded LUX701 violation: a memcap.v1 artifact whose only entry is
structurally rotten — the model is missing coefficients, the recorded
peak is negative, and the probe dims are absent. Admission math over
this entry would be garbage-in, so the structure rule fails it before
any formula is evaluated.

The port's counterpart of ``tests/mem_fixtures/lux701_malformed_artifact.py``.
Loaded by ``python -m lux_tpu_torch.tools.luxlint --memory <this file>``;
the CLI must exit 1 with exactly LUX701.
"""

# expect: LUX701
MEMCAP = {
    "schema": "memcap.v1",
    "id": "memcap-000000000000",
    "probe": {"nv": 96, "ne": 400},
    "targets": {
        "sssp@push": {
            "kind": "push",
            "model": {"per_vertex_bytes": 4.0},   # missing two fields
            "peak_bytes": -3,                      # not a positive int
            "probe": {},                           # no dims
        },
    },
}
