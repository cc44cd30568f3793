"""Port parity: the run ledger (``obs/ledger.py``, ``runrec.v1``).

The port keeps ``lux_tpu``'s bytes on disk: the ``LUXRR1 <crc32> <json>``
frame, ``runrec-NNNNNN.jsonl`` segments, the ``latest.json`` index,
torn-tail repair and rotation. These tests hold the durability contract
of ``tests/test_ledger.py`` on the port, its ``config_hash`` rules (path
flags ignored, the port's own behaviour flags tracked), the bytes of a
record against ``lux_tpu``'s, and a ledger directory written by either
package read by the other through ``read_all(strict=True)`` and
``validate_dir``. An engine run of the port lands one ``engine_run``
record.
"""

import threading

import numpy as np
import pytest

from lux_tpu.obs import ledger as jledger
from lux_tpu.utils import flags as jflags
from lux_tpu_torch import models as tmodels
from lux_tpu_torch.engine.push import PushExecutor
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.obs import ledger
from lux_tpu_torch.utils import flags


@pytest.fixture
def armed(tmp_path, monkeypatch):
    """Arm both packages' ledgers at one fresh directory; disarm
    afterwards."""
    root = str(tmp_path / "ledger")
    monkeypatch.setenv("LUX_LEDGER_DIR", root)
    for mod in (ledger, jledger):
        mod.reset()
    yield root
    for mod in (ledger, jledger):
        mod.reset()


# -- framing + durability (tests/test_ledger.py's cases) -----------------------


def test_record_run_roundtrip_and_frame(armed):
    rid = ledger.record_run(
        "engine_run", {"gteps": 1.5, "nv": 100, "ne": 700},
        program="PageRank", engine_kind="pull",
    )
    assert rid
    segs = ledger.RunLedger(armed).segments()
    assert len(segs) == 1
    raw = open(segs[0], "rb").read()
    assert raw.startswith(b"LUXRR1 ") and raw.endswith(b"\n")
    (rec,) = ledger.read_all(armed, strict=True)
    assert rec["schema"] == ledger.SCHEMA == jledger.SCHEMA
    assert rec["id"] == rid
    assert rec["kind"] == "engine_run"
    assert rec["metrics"]["gteps"] == 1.5
    key = rec["key"]
    assert key["graph_fingerprint"] == "nv100-ne700"
    assert key["program"] == "PageRank"
    assert key["config_hash"] == flags.config_hash()
    assert rec["key_string"] == ledger.key_string(**key)
    assert rec["config"].get("LUX_LEDGER_ROTATE_BYTES") is not None
    assert set(rec["config"]) == set(flags.names())


def test_unarmed_record_run_is_none(monkeypatch):
    monkeypatch.delenv("LUX_LEDGER_DIR", raising=False)
    ledger.reset()
    assert not ledger.enabled()
    assert ledger.record_run("engine_run", {"gteps": 1.0}) is None
    assert ledger.read_all() == []


def test_torn_tail_is_truncated_on_reopen(armed):
    led = ledger.RunLedger(armed)
    ledger.record_run("engine_run", {"gteps": 1.0}, program="A")
    seg = led.segments()[0]
    with open(seg, "ab") as f:
        f.write(b"LUXRR1 0000dead {\"half\": ")       # crash mid-append
    ledger.record_run("engine_run", {"gteps": 2.0}, program="B")
    recs = ledger.read_all(armed, strict=True)
    assert [r["key"]["program"] for r in recs] == ["A", "B"]
    v = ledger.validate_dir(armed)
    assert v["ok"] == 2 and v["interior_bad"] == 0 and v["torn_segments"] == 0


def test_crc_bad_final_line_is_torn_not_corrupt(armed):
    led = ledger.RunLedger(armed)
    ledger.record_run("engine_run", {"gteps": 1.0}, program="A")
    with open(led.segments()[0], "ab") as f:
        f.write(b"LUXRR1 00000000 {\"bad\": \"crc\"}\n")
    assert ledger.validate_dir(armed)["torn_segments"] == 1
    assert ledger.validate_dir(armed)["interior_bad"] == 0
    ledger.record_run("engine_run", {"gteps": 2.0}, program="B")
    recs = ledger.read_all(armed, strict=True)
    assert [r["key"]["program"] for r in recs] == ["A", "B"]


def test_interior_corruption_raises_strict_skips_lenient(armed):
    led = ledger.RunLedger(armed)
    led.append({"schema": ledger.SCHEMA, "n": 1})
    led.append({"schema": ledger.SCHEMA, "n": 2})
    seg = led.segments()[0]
    buf = bytearray(open(seg, "rb").read())
    first_nl = buf.index(b"\n")
    buf[first_nl - 2] ^= 0xFF                # flip a byte mid-record
    open(seg, "wb").write(bytes(buf))
    with pytest.raises(ledger.LedgerCorruptError):
        ledger.read_all(armed, strict=True)
    with pytest.raises(jledger.LedgerCorruptError):
        jledger.read_all(armed, strict=True)
    assert [r["n"] for r in ledger.read_all(armed)] == [2]
    assert ledger.validate_dir(armed)["interior_bad"] == 1
    led.append({"schema": ledger.SCHEMA, "n": 3})
    assert [r["n"] for r in ledger.read_all(armed)] == [2, 3]
    assert ledger.validate_dir(armed)["interior_bad"] == 1


def test_rotation_and_latest_index(armed, monkeypatch):
    monkeypatch.setenv("LUX_LEDGER_ROTATE_BYTES", "1")   # rotate every append
    for i in range(4):
        ledger.record_run("engine_run", {"i": i, "nv": 8, "ne": 8},
                          program="PageRank", engine_kind="pull")
    led = ledger.RunLedger(armed)
    assert [s[-19:] for s in led.segments()] == [
        f"runrec-{i:06d}.jsonl" for i in range(4)]
    recs = led.read(strict=True)
    assert [r["metrics"]["i"] for r in recs] == [0, 1, 2, 3]
    key = recs[-1]["key_string"]
    assert led.latest(key)["metrics"]["i"] == 3
    idx = led.read_index()
    assert idx[key] == {"record_id": recs[-1]["id"],
                        "segment": "runrec-000003.jsonl"}
    assert jledger.RunLedger(armed).latest(key)["metrics"]["i"] == 3


def test_concurrent_writers_all_land(armed):
    led = ledger.RunLedger(armed)

    def spin(w):
        for i in range(25):
            led.append({"schema": ledger.SCHEMA, "w": w, "i": i})

    threads = [threading.Thread(target=spin, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = led.read(strict=True)
    assert len(recs) == 200
    assert len({r["id"] for r in recs}) == 200


# -- config_hash ---------------------------------------------------------------


def test_config_hash_ignores_path_flags(monkeypatch):
    base = flags.config_hash()
    monkeypatch.setenv("LUX_LEDGER_DIR", "/some/other/place")
    assert flags.config_hash() == base
    monkeypatch.setenv("LUX_METRICS", "/tmp/m.json")
    monkeypatch.setenv("LUX_TRACE", "/tmp/t.json")
    monkeypatch.setenv("LUX_WAL_DIR", "/tmp/wal")
    assert flags.config_hash() == base


def test_config_hash_tracks_behavior_flags(monkeypatch):
    base = flags.config_hash()
    monkeypatch.setenv("LUX_LEDGER_ROTATE_BYTES", "12345")
    changed = flags.config_hash()
    assert changed != base
    assert flags.config_hash() == changed   # deterministic
    assert flags.snapshot()["LUX_LEDGER_ROTATE_BYTES"] == "12345"
    monkeypatch.setenv("LUX_GAS", "pull")
    assert flags.config_hash() not in (base, changed)
    with flags.overrides({"LUX_GAS": None, "LUX_LEDGER_ROTATE_BYTES": None}):
        assert flags.config_hash() == base


# -- across the packages ---------------------------------------------------------


def test_record_bytes_equal_lux_tpus(tmp_path):
    """One record with its id set appends the same bytes in both
    packages."""
    rec = {"schema": "runrec.v1", "id": "rr-1", "kind": "engine_run",
           "key_string": "g|PageRank|pull|1|abc", "metrics": {"gteps": 2.5,
                                                            "nv": 3}}
    ledger.RunLedger(str(tmp_path / "t")).append(dict(rec))
    jledger.RunLedger(str(tmp_path / "j")).append(dict(rec))
    for name in ("runrec-000000.jsonl", "latest.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_each_package_reads_the_others(armed, monkeypatch, writer):
    monkeypatch.setenv("LUX_LEDGER_ROTATE_BYTES", "600")
    first, second = (ledger, jledger) if writer == "torch" else (
        jledger, ledger)
    for i in range(6):
        first.record_run("engine_run", {"i": i, "nv": 5, "ne": 9},
                         program="SSSP", engine_kind="push",
                         mesh_shape=str(i % 2 + 1))
    assert len(second.RunLedger(armed).segments()) > 1
    got = second.read_all(armed, strict=True)
    want = first.read_all(armed, strict=True)
    assert got == want and [r["metrics"]["i"] for r in got] == list(range(6))
    assert second.validate_dir(armed) == first.validate_dir(armed)
    assert second.validate_dir(armed)["ok"] == 6
    # The other package appends to the open segment after a torn tail,
    # which it repairs first.
    monkeypatch.delenv("LUX_LEDGER_ROTATE_BYTES")
    seg = second.RunLedger(armed).segments()[-1]
    with open(seg, "ab") as f:
        f.write(b"LUXRR1 0000dead {")
    second.record_run("engine_run", {"i": 6}, program="SSSP")
    got = first.read_all(armed, strict=True)
    assert [r["metrics"]["i"] for r in got] == list(range(7))
    assert first.validate_dir(armed)["torn_segments"] == 0


def test_config_hash_is_the_ports_own():
    """Both packages hash their own behaviour flags; the port's table is
    a subset of lux_tpu's."""
    assert set(flags.names()) < set(jflags.names())
    assert len(flags.config_hash()) == len(jflags.config_hash()) == 12


def test_engine_run_lands_one_record(armed):
    g = tgen.rmat(8, 8, seed=5)
    ex = PushExecutor(g, tmodels.get_program("sssp"), device="cpu")
    st, iters = ex.run(start=0)
    (rec,) = jledger.read_all(armed, strict=True)
    assert rec["kind"] == "engine_run"
    assert rec["key"]["engine_kind"] == "push"
    assert rec["key"]["program"] == "SSSP"
    assert rec["key"]["mesh_shape"] == "1"
    assert rec["key"]["graph_fingerprint"] == f"nv{g.nv}-ne{g.ne}"
    assert rec["metrics"]["num_iters"] == iters
    assert "iterations" not in rec["metrics"]
    assert rec["metrics"]["roofline"]["device_kind"] == "cpu"
    np.testing.assert_array_equal(
        ex.values(st), ex.values(ex.run(start=0)[0]))
    assert len(ledger.read_all(armed)) == 2
