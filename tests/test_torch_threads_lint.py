"""Port parity: the concurrency tier (LUX301-305) of
``lux_tpu_torch.analysis.threads`` against ``lux_tpu.analysis.threads``,
the port's own serving tree under it, and ``luxlint --threads``.

``lux_tpu``'s fixtures (tests/lint_fixtures/threads/) are read and never
edited: on each, both packages' ``run_threads`` must give the same
(rule, line, col) findings and suppressed counts.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from lux_tpu.analysis import threads as jthreads
from lux_tpu_torch.analysis.core import FileContext, run_source
from lux_tpu_torch.analysis.threads import (_ClassAnalysis,
                                            all_thread_rules,
                                            build_lock_graph, run_threads)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "lint_fixtures", "threads")
JLUXLINT = os.path.join(REPO, "tools", "luxlint.py")
_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9_,\s]+?)\s*$")

THREAD_FIXTURES = sorted(f for f in os.listdir(FIXTURES)
                         if f.endswith(".py"))
RULE_OF = {
    "bad_shared_state.py": "LUX301",
    "bad_lock_order.py": "LUX302",
    "bad_blocking_under_lock.py": "LUX303",
    "bad_unjoined_thread.py": "LUX304",
    "bad_publish.py": "LUX305",
}


def _expected(path):
    want = {}
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            m = _EXPECT_RE.search(line)
            if m:
                want[i] = sorted(s.strip() for s in m.group(1).split(",")
                                 if s.strip())
    return want


def _by_line(findings):
    out = {}
    for f in findings:
        out.setdefault(f.line, []).append(f.rule)
    return {k: sorted(v) for k, v in out.items()}


def _keys(findings):
    return sorted((f.rule, f.line, f.col) for f in findings)


def _luxlint(*args):
    return subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", *args],
        capture_output=True, text=True, cwd=REPO)


def _summary(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("LUXLINT ")]
    assert lines, stdout
    return json.loads(lines[-1][len("LUXLINT "):])


def _lint(src):
    return run_source(textwrap.dedent(src), "t.py", all_thread_rules())


# -- lux_tpu's fixtures ---------------------------------------------------


@pytest.mark.parametrize("rel", THREAD_FIXTURES)
def test_fixture_findings_equal_lux_tpu(rel):
    path = os.path.join(FIXTURES, rel)
    (mine,) = run_threads([path], graph_paths=[path]).results
    (theirs,) = jthreads.run_threads([path], graph_paths=[path]).results
    assert mine.error is None and theirs.error is None
    assert _keys(mine.findings) == _keys(theirs.findings)
    assert [f.message for f in mine.findings] == \
        [f.message for f in theirs.findings]
    assert _keys(mine.suppressed) == _keys(theirs.suppressed)
    if rel in RULE_OF:
        assert _by_line(mine.findings) == _expected(path)
        assert {f.rule for f in mine.findings} == {RULE_OF[rel]}
    else:
        assert mine.findings == []


def test_fixture_tree_lock_graph_equals_lux_tpu():
    assert build_lock_graph([FIXTURES]) == \
        jthreads.build_lock_graph([FIXTURES])


def test_rule_table_mirrors_lux_tpu():
    mine, theirs = all_thread_rules(), jthreads.all_thread_rules()
    assert [(r.id, r.title) for r in mine] == \
        [(r.id, r.title) for r in theirs]


# -- the port's own tree ----------------------------------------------------


def test_session_declares_lux_tpu_publish_pointers():
    import ast

    path = os.path.join(REPO, "lux_tpu_torch", "serve", "session.py")
    with open(path) as fh:
        src = fh.read()
    ctx = FileContext(path, src)
    (cls,) = [n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.ClassDef) and n.name == "Session"]
    ca = _ClassAnalysis(cls, ctx)
    assert ca.publish == {"_serving": "_swap_lock",
                          "_degraded": "_swap_lock"}
    assert ca.is_concurrent()


def test_tree_suppressions_match_lux_tpus_reasons():
    report = run_threads([os.path.join(REPO, "lux_tpu_torch")])
    assert report.ok, report.format_human()
    by_rule = {}
    for f in report.suppressed:
        by_rule.setdefault(f.rule, []).append(os.path.basename(f.path))
    # session: _served_keys on the batcher thread (4 reads and writes);
    # breaker: the stale fast-path probe; pool: warmup under the lock.
    assert sorted(by_rule["LUX301"]) == ["breaker.py"] + ["session.py"] * 4
    assert by_rule["LUX303"] == ["pool.py"]


def test_torn_publish_read_fires():
    res = _lint("""
        import threading


        class S:
            def __init__(self, batcher_cls):
                self._serving = None  # luxlint: publish=_swap_lock
                self._swap_lock = threading.Lock()
                self.batcher = batcher_cls(self._execute)

            def _execute(self, batch):
                snap = self._serving
                return snap

            def torn(self):
                a = self._serving.graph
                b = self._serving.version
                return a, b

            def swap(self, snap):
                with self._swap_lock:
                    self._serving = snap
    """)
    assert [(f.rule, f.line) for f in res.findings] == [("LUX305", 17)]


def test_device_sync_under_lock_is_blocking():
    res = _lint("""
        import threading

        import torch

        _lock = threading.Lock()


        def publish(dev, ev):
            with _lock:
                torch.cuda.synchronize(dev)
                ev.synchronize()
            torch.cuda.synchronize(dev)
    """)
    assert [(f.rule, f.line) for f in res.findings] == [
        ("LUX303", 11), ("LUX303", 12)]


def test_suppression_counts_not_silent():
    res = _lint("""
        import threading


        class W:
            def __init__(self):
                self.n = 0
                self._t = threading.Thread(target=self._run)
                self._t.start()

            def _run(self):
                # luxlint: disable=LUX301 -- single-writer by construction
                self.n += 1

            def read(self):
                return self.n  # luxlint: disable=LUX301 -- approximate read

            def close(self):
                self._t.join(1.0)
    """)
    assert res.findings == [] and len(res.suppressed) == 2


def test_lock_order_cycle_across_files(tmp_path):
    (tmp_path / "m1.py").write_text(
        "import threading\n"
        "a_lock = threading.Lock()\n"
        "b_lock = threading.Lock()\n\n\n"
        "def fwd():\n"
        "    with a_lock:\n"
        "        with b_lock:\n"
        "            pass\n")
    m2 = tmp_path / "m2.py"
    m2.write_text(
        "import m1\n\n\n"
        "def bwd():\n"
        "    with m1.b_lock:\n"
        "        with m1.a_lock:\n"
        "            pass\n")
    (res,) = run_threads([str(m2)], graph_paths=[str(tmp_path)]).results
    assert [f.rule for f in res.findings] == ["LUX302"]
    assert "m1.a_lock" in res.findings[0].message


# -- the CLI ------------------------------------------------------------------


def test_cli_threads_tree_is_green():
    proc = _luxlint("--threads")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = _summary(proc.stdout)
    assert s["schema"] == "luxlint-threads.v1"
    assert s["ok"] is True and s["findings"] == 0 and s["errors"] == 0
    assert s["files"] > 90 and s["suppressed"] == 6


@pytest.mark.parametrize("rel", sorted(RULE_OF))
def test_cli_threads_rc1_equals_tools_luxlint(rel):
    path = os.path.join("tests", "lint_fixtures", "threads", rel)
    mine = _luxlint("--threads", "--json", path)
    theirs = subprocess.run(
        [sys.executable, JLUXLINT, "--threads", "--json", path],
        capture_output=True, text=True, cwd=REPO)
    assert mine.returncode == theirs.returncode == 1, mine.stderr
    a = json.loads(mine.stdout[:mine.stdout.rfind("LUXLINT ")])
    b = json.loads(theirs.stdout[:theirs.stdout.rfind("LUXLINT ")])
    a["summary"].pop("elapsed_s")
    b["summary"].pop("elapsed_s")
    assert a == b
    assert set(a["summary"]["by_rule"]) == {RULE_OF[rel]}


def test_cli_threads_select_and_baseline(tmp_path):
    fix = os.path.join("tests", "lint_fixtures", "threads", "bad_publish.py")
    other = os.path.join("tests", "lint_fixtures", "threads",
                         "bad_shared_state.py")
    sel = _luxlint("--threads", "--select", "LUX301", fix, other)
    assert sel.returncode == 1
    assert set(_summary(sel.stdout)["by_rule"]) == {"LUX301"}
    assert _luxlint("--threads", "--select", "LUX399").returncode == 2
    base = str(tmp_path / "threads_baseline.json")
    p1 = _luxlint("--threads", fix, "--baseline", base)
    assert p1.returncode == 0 and "baseline written" in p1.stdout
    keys = json.load(open(base))["keys"]
    assert keys and all(k.startswith("LUX305\t") for k in keys)
    assert _luxlint("--threads", fix, "--baseline", base).returncode == 0
    p3 = _luxlint("--threads", fix, other, "--baseline", base)
    assert p3.returncode == 1 and "[new]" in p3.stdout
