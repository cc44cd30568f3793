"""Port parity: the AST tier (LUX001-010) of ``lux_tpu_torch.analysis``
against ``lux_tpu.analysis``, the torch forms of LUX001-003 and LUX009,
the rule engine, the ``python -m lux_tpu_torch.tools.luxlint`` CLI, and
``HostTransferGuard`` (LUX001 at run time) on the CPU.

``lux_tpu``'s fixtures (tests/lint_fixtures/) are read and never edited;
a rule scoped to ``lux_tpu/`` reads them under a ``lux_tpu_torch/`` copy
in ``tmp_path``. The torch fixtures are inline strings with ``# expect:``
markers on exactly the lines a finding must anchor to.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lux_tpu.analysis import core as jcore
from lux_tpu.analysis import rules as jrules
from lux_tpu_torch.analysis import core, rules
from lux_tpu_torch.analysis.sentinel import HostTransferError, HostTransferGuard
from lux_tpu_torch.engine import push as tpush
from lux_tpu_torch.engine import telemetry
from lux_tpu_torch.engine.pull import PullExecutor
from lux_tpu_torch.graph import generate as tgen
from lux_tpu_torch.models import PageRank
from lux_tpu_torch.utils import flags as tflags

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
FIXTURES = os.path.join(TESTS, "lint_fixtures")
JLUXLINT = os.path.join(REPO, "tools", "luxlint.py")

_EXPECT_RE = re.compile(r"#\s*expect:\s*([A-Z0-9_,\s]+?)\s*$")
PARITY_RULES = ("LUX004", "LUX005", "LUX006", "LUX007", "LUX008",
                "LUX009", "LUX010")

AST_FIXTURES = sorted(
    os.path.relpath(os.path.join(root, f), FIXTURES)
    for root, _, files in os.walk(FIXTURES)
    if os.path.relpath(root, FIXTURES).split(os.sep)[0] != "threads"
    for f in files if f.endswith(".py"))


def _expected(source):
    want = {}
    for i, line in enumerate(source.splitlines(), 1):
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


def _ported_path(tmp_path, rel):
    """``rel`` under tmp_path, its ``lux_tpu/`` directory read as
    ``lux_tpu_torch/`` (LUX005's scope in the port)."""
    parts = rel.split(os.sep)
    parts = ["lux_tpu_torch" if p == "lux_tpu" else p for p in parts]
    dst = tmp_path.joinpath(*parts)
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(os.path.join(FIXTURES, rel), dst)
    return str(dst)


def _keys(findings):
    return sorted((f.rule, f.line, f.col) for f in findings
                  if f.rule in PARITY_RULES)


def _luxlint(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "lux_tpu_torch.tools.luxlint", *args],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, **(env or {})))


def _summary(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("LUXLINT ")]
    assert lines, stdout
    return json.loads(lines[-1][len("LUXLINT "):])


def _lint_src(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    src = textwrap.dedent(src)
    path.write_text(src)
    return core.run_source(src, str(path), rules.all_rules(),
                           core.load_declared_flags()), src


# -- lux_tpu's fixtures: LUX004-010 give the same findings ----------------


@pytest.mark.parametrize("rel", AST_FIXTURES)
def test_fixture_findings_equal_lux_tpu(tmp_path, rel):
    declared = jcore.load_declared_flags()
    src_path = os.path.join(FIXTURES, rel)
    with open(src_path) as fh:
        src = fh.read()
    theirs = jcore.run_source(src, src_path, jrules.all_rules(), declared)
    mine = core.run_source(src, _ported_path(tmp_path, rel),
                           rules.all_rules(), declared)
    assert mine.error is None and theirs.error is None
    assert _keys(mine.findings) == _keys(theirs.findings)
    assert _keys(mine.suppressed) == _keys(theirs.suppressed)
    if os.path.basename(rel).startswith("good_"):
        assert not _keys(mine.findings)


def test_fixture_run_paths_totals_equal_lux_tpu(tmp_path):
    """The fixture tree through both ``run_paths``: the same LUX004-010
    findings per file, and both summaries carry luxlint.v1."""
    declared = jcore.load_declared_flags()
    for rel in AST_FIXTURES:
        _ported_path(tmp_path, rel)
    sel = [r for r in rules.all_rules() if r.id in PARITY_RULES]
    jsel = [r for r in jrules.all_rules() if r.id in PARITY_RULES]
    mine = core.run_paths([str(tmp_path)], sel, declared)
    theirs = jcore.run_paths([FIXTURES], jsel, declared)
    theirs.results = [r for r in theirs.results
                      if "/threads/" not in r.path.replace(os.sep, "/")]
    assert mine.summary()["by_rule"] == theirs.summary()["by_rule"]
    assert mine.summary()["schema"] == theirs.summary()["schema"]
    assert len(mine.suppressed) == len(theirs.suppressed)


def test_rule_table_mirrors_lux_tpu():
    mine, theirs = rules.all_rules(), jrules.all_rules()
    assert [r.id for r in mine] == [r.id for r in theirs]
    assert [r.title for r in mine] == [r.title for r in theirs]


def test_suppression_grammar_equals_lux_tpu():
    lines = [
        "x = 1  # luxlint: disable=LUX001,LUX002 -- reason text",
        "# luxlint: disable=all",
        "y = 2",
        "z = 3  # luxlint: disable = LUX006",
        "w = 4  # luxlint:disable=LUX007 --",
    ]
    assert core.suppressions_for(lines) == jcore.suppressions_for(lines)
    assert core.suppressions_for(lines)[3] == {"all"}


def test_port_registry_drives_lux004(tmp_path):
    """Without a declared set, LUX004 reads the port's own registry."""
    res, _ = _lint_src(tmp_path, "x.py", """
        from lux_tpu_torch.utils import flags
        A = flags.get("LUX_PLANCK_INFLATION")
        B = flags.get("LUX_NOT_DECLARED_ANYWHERE")
    """)
    assert [(f.rule, f.line) for f in res.findings] == [("LUX004", 4)]
    assert "lux_tpu_torch/utils/flags.py" in res.findings[0].message


def test_syntax_error_is_reported_not_crashed():
    res = core.run_source("def broken(:\n", "engine/x.py",
                          rules.all_rules(), set())
    assert res.error and "x.py" in res.error


# -- the torch forms ------------------------------------------------------


HOST_SYNC = """
    import numpy as np
    import torch

    from lux_tpu_torch.engine.telemetry import sync


    def run(step, vals, n, dev, ev, stream):
        for _ in range(n):
            vals = step(vals)
            a = vals.item()                  # expect: LUX001
            b = vals.tolist()                # expect: LUX001
            c = vals.cpu()                   # expect: LUX001
            d = vals.numpy()                 # expect: LUX001
            e = float(vals.sum())            # expect: LUX001
            f = int(vals[0])                 # expect: LUX001
            g = np.asarray(vals)             # expect: LUX001
            torch.cuda.synchronize(dev)      # expect: LUX001
            ev.synchronize()                 # expect: LUX001
            stream.synchronize()             # expect: LUX001
            sync(dev)                        # expect: LUX001
            h = int(a) + float(b[0])         # host values: free
            k = np.asarray(c.numpy())        # one read, flagged once
        return vals


    def run_tainted(step, vals, n):
        for _ in range(n):
            got = vals.tolist()              # expect: LUX001
            cnt = int(got[0])                # already on the host
            vals = step(vals)
        return cnt


    def warmup(step, vals, n):
        for _ in range(n):
            vals.item()                      # not a hot function
        return vals


    class Loop:
        def _iterate(self, state):
            new, cnt = self._update(state)
            frontier = self._frontier(new)
            # the helper's own reads, once per iteration of _run:
            return new, self._read(frontier), int(cnt)  # expect: LUX001, LUX001

        def _update(self, state):
            return state, state.sum()

        def _read(self, stats):
            return stats.tolist()            # the funnel itself

        def _run(self, state, n):
            stats = self._read(state)        # before the loop: fine
            for _ in range(n):
                state, stats, cnt = self._iterate(state)
                if stats[0] == 0:
                    break
            return state
"""


def test_lux001_torch_forms(tmp_path):
    res, src = _lint_src(tmp_path, "engine/hot.py", HOST_SYNC)
    assert res.error is None
    assert _by_line(res.findings) == _expected(src)
    assert {f.rule for f in res.findings} == {"LUX001"}


def test_lux001_scoped_to_engine(tmp_path):
    res, _ = _lint_src(tmp_path, "serve/hot.py", HOST_SYNC)
    assert not [f for f in res.findings if f.rule == "LUX001"]


def test_lux001_suppression_with_reason_is_counted(tmp_path):
    res, _ = _lint_src(tmp_path, "engine/flush.py", """
        def run(step, vals, n, sync, dev):
            for i in range(n):
                vals = step(vals)
                # luxlint: disable=LUX001 -- designed flush point
                sync(dev)
                got = vals.tolist()  # luxlint: disable=LUX001 -- one read a chunk
            return vals
    """)
    assert res.findings == []
    assert [f.rule for f in res.suppressed] == ["LUX001", "LUX001"]


def test_lux002_torch_compile_scalars(tmp_path):
    res, src = _lint_src(tmp_path, "tc.py", """
        import torch


        def body(x, k):
            return x * k


        step = torch.compile(body)
        dyn = torch.compile(body, dynamic=True)


        @torch.compile
        def deco(x, k):
            return x + k


        @torch.compile(dynamic=True)
        def deco_dyn(x, k):
            return x + k


        def drive(x, t):
            step(x, 3)                       # expect: LUX002
            step(x, k=0.5)                   # expect: LUX002
            step(x, t)                       # a tensor: fine
            step(x, True)                    # a bool: fine
            dyn(x, 3)                        # dynamic: fine
            deco(x, 2)                       # expect: LUX002
            deco_dyn(x, 2)                   # dynamic: fine
            body(x, 3)                       # not compiled: fine
    """)
    assert _by_line(res.findings) == _expected(src)


def test_lux003_kernel_dtypes(tmp_path):
    res, src = _lint_src(tmp_path, "ops/merge_kernel.py", """
        import numpy as np
        import torch


        def wrap(plan, dev, rows, n):
            c8 = plan.codes.to(torch.int8)              # contract: fine
            c32 = torch.as_tensor(plan.codes, dtype=torch.int32)
            c16 = plan.codes.to(torch.int16)            # expect: LUX003
            cf = plan.codes.astype(np.float32)          # expect: LUX003
            r32 = plan.arow.to(dev, torch.int32)        # fine
            r64 = torch.as_tensor(rows, dtype=torch.int64)  # expect: LUX003
            rl = plan.brow.to(dtype=torch.long)         # expect: LUX003
            moved = plan.codes.to(dev)                  # no dtype: fine
            z = torch.zeros(n, dtype=torch.int64)       # not a plane: fine
            return c8, c32, c16, cf, r32, r64, rl, moved, z
    """)
    assert _by_line(res.findings) == _expected(src)
    # Outside a kernel wrapper file the contract is not the rule's.
    res2, _ = _lint_src(tmp_path, "ops/segment.py", src)
    assert not [f for f in res2.findings if f.rule == "LUX003"]


def test_lux009_torch_regions(tmp_path):
    res, src = _lint_src(tmp_path, "obs/regions.py", """
        import torch
        from lux_tpu_torch.obs import prof


        def regions(fn):
            with torch.profiler.record_function("Step 1"):  # expect: LUX009
                fn()
            with torch.profiler.record_function("lux.pull.compute"):
                fn()
            torch.cuda.nvtx.range_push("exchange")  # expect: LUX009
            torch.cuda.nvtx.range_pop()
            with torch.cuda.nvtx.range("lux.tiled.k1"):
                fn()
            with torch.cuda.nvtx.range("K1"):  # expect: LUX009
                fn()
            with prof.region("lux.serve.execute"):
                fn()
            for i in range(3):
                fn(i)
    """)
    assert _by_line(res.findings) == _expected(src)


# -- the CLI ----------------------------------------------------------------


def test_cli_tree_is_green():
    proc = _luxlint()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    s = _summary(proc.stdout)
    assert s["schema"] == "luxlint.v1"
    assert s["ok"] is True and s["findings"] == 0 and s["errors"] == 0
    assert s["files"] > 90
    # The per-iteration counter reads (ROADMAP A20), the flush point,
    # the tune block's wall clock and the advisory program audit.
    assert s["suppressed"] >= 6
    doc = json.loads(_luxlint("--json").stdout.rsplit("LUXLINT ", 1)[0])
    assert {f["rule"] for f in doc["suppressed"]} == {
        "LUX001", "LUX006", "LUX007"}


def test_every_suppression_in_the_port_carries_a_reason():
    bare = []
    for root, _, files in os.walk(os.path.join(REPO, "lux_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    if "luxlint: disable=" in line and " -- " not in line:
                        bare.append(f"{path}:{i}")
    assert bare == []


def test_cli_nonzero_on_seeded_violation(tmp_path):
    bad = tmp_path / "engine" / "run_bad.py"
    bad.parent.mkdir()
    bad.write_text(
        "def run(step, vals, n):\n"
        "    for _ in range(n):\n"
        "        vals = step(vals)\n"
        "        done = vals.item()\n"
        "    return vals, done\n"
    )
    proc = _luxlint(str(tmp_path))
    assert proc.returncode == 1
    assert _summary(proc.stdout)["by_rule"] == {"LUX001": 1}
    assert f"{bad}:4" in proc.stdout


def test_cli_json_select_and_unknown_id(tmp_path):
    d = os.path.dirname(_ported_path(tmp_path,
                                     os.path.join("lux_tpu",
                                                  "bad_envflag.py")))
    proc = _luxlint("--json", d)
    assert proc.returncode == 1
    doc = json.loads(proc.stdout.rsplit("LUXLINT ", 1)[0])
    assert {f["rule"] for f in doc["findings"]} == {"LUX004", "LUX005"}
    for f in doc["findings"]:
        assert set(f) == {"rule", "path", "line", "col", "message"}
    sel = _luxlint("--select", "LUX005", d)
    assert sel.returncode == 1
    assert _summary(sel.stdout)["by_rule"] == {"LUX005": 2}
    bad = _luxlint("--select", "LUX999")
    assert bad.returncode == 2 and "LUX999" in bad.stderr


def test_cli_output_equals_tools_luxlint_on_fixtures(tmp_path):
    """Same fixture tree, same LUX004-010 lines and summary counts."""
    for rel in AST_FIXTURES:
        if not rel.startswith("lux_tpu" + os.sep):
            _ported_path(tmp_path, rel)
    sel = ",".join(PARITY_RULES)
    mine = _luxlint("--select", sel, str(tmp_path))
    theirs = subprocess.run(
        [sys.executable, JLUXLINT, "--select", sel,
         *[os.path.join(FIXTURES, d) for d in ("engine", "obs", "ops",
                                               "serve")],
         os.path.join(FIXTURES, "bad_recompile.py"),
         os.path.join(FIXTURES, "good_recompile.py")],
        capture_output=True, text=True, cwd=REPO)
    assert mine.returncode == theirs.returncode == 1
    a, b = _summary(mine.stdout), _summary(theirs.stdout)
    for k in ("by_rule", "findings", "suppressed", "files", "schema"):
        assert a[k] == b[k], k

    def keys(out, root):
        got = []
        for ln in out.splitlines():
            if ": LUX" not in ln:
                continue
            path, line, col, rest = ln.split(":", 3)
            got.append((os.path.relpath(path, root), int(line), int(col),
                        rest.split()[0]))
        return sorted(got)

    assert keys(mine.stdout, str(tmp_path)) == keys(theirs.stdout, FIXTURES)


def test_cli_baseline_ratchet(tmp_path):
    bad = tmp_path / "engine" / "run_bad.py"
    bad.parent.mkdir()
    bad.write_text("def run(step, vals, n):\n"
                   "    for _ in range(n):\n"
                   "        done = vals.cpu()\n"
                   "    return done\n")
    base = str(tmp_path / "baseline.json")
    p1 = _luxlint(str(tmp_path / "engine"), "--baseline", base)
    assert p1.returncode == 0 and "baseline written" in p1.stdout
    bad.write_text("# shifted\n" + bad.read_text())
    p2 = _luxlint(str(tmp_path / "engine"), "--baseline", base)
    assert p2.returncode == 0 and "0 new" in p2.stdout
    bad.write_text(bad.read_text().replace("done = vals.cpu()",
                                           "done2 = vals.cpu()"))
    p3 = _luxlint(str(tmp_path / "engine"), "--baseline", base)
    assert p3.returncode == 1 and "[new]" in p3.stdout


# -- HostTransferGuard on the CPU -------------------------------------------


def test_guard_blocks_and_restores_entry_points():
    real = (torch.cuda.synchronize, torch.cuda.Event.synchronize,
            torch.cuda.Stream.synchronize, telemetry.sync, tpush.sync)
    cpu = torch.device("cpu")
    with HostTransferGuard("unit") as g:
        for call in (torch.cuda.synchronize,
                     lambda: telemetry.sync(cpu), lambda: tpush.sync(cpu)):
            with pytest.raises(HostTransferError, match=r"\[unit\]"):
                call()
        with pytest.raises(HostTransferError, match="Event.synchronize"):
            torch.cuda.Event.synchronize(object())
        with pytest.raises(HostTransferError, match="Stream.synchronize"):
            torch.cuda.Stream.synchronize(object())
        with g.allow():
            telemetry.sync(cpu)
            tpush.sync(cpu)
        # A CPU tensor crosses no device boundary.
        assert torch.ones(3).sum().item() == 3.0
    assert (torch.cuda.synchronize, torch.cuda.Event.synchronize,
            torch.cuda.Stream.synchronize, telemetry.sync,
            tpush.sync) == real


def test_guard_restores_entry_points_on_error():
    real = telemetry.sync
    with pytest.raises(HostTransferError):
        with HostTransferGuard():
            telemetry.sync(torch.device("cpu"))
    assert telemetry.sync is real


def test_guard_allow_is_reentrant():
    cpu = torch.device("cpu")
    with HostTransferGuard() as g:
        with g.allow():
            with g.allow():
                telemetry.sync(cpu)
            telemetry.sync(cpu)       # still inside the outer window
        with pytest.raises(HostTransferError):
            telemetry.sync(cpu)


def test_guard_reads_of_cuda_tensors():
    """The dispatch mode's decisions, on stand-ins for CUDA tensors (a
    CPU build has none; tests/test_torch_cuda.py drives the card)."""
    import types

    aten = torch.ops.aten
    gpu = types.SimpleNamespace(is_cuda=True)
    host = torch.zeros(2)
    reads = HostTransferGuard._reads
    assert "scalar read" in reads(aten._local_scalar_dense.default,
                                  (gpu,), {}, aten)
    assert "to the CPU" in reads(aten._to_copy.default, (gpu,),
                                 {"device": torch.device("cpu")}, aten)
    assert "into a CPU tensor" in reads(aten.copy_.default, (host, gpu),
                                        {}, aten)
    assert reads(aten._to_copy.default, (gpu,),
                 {"dtype": torch.float64}, aten) is None
    assert reads(aten._local_scalar_dense.default, (host,), {},
                 aten) is None
    assert reads(aten.add.Tensor, (gpu, gpu), {}, aten) is None


def test_pull_step_loop_passes_under_the_guard():
    g = tgen.rmat(8, 8, seed=1)
    ex = PullExecutor(g, PageRank(), device="cpu")
    want = ex.run(5)
    v = ex.init_values()
    with HostTransferGuard("pull") as guard:
        for _ in range(5):
            v = ex.step(v)
        with guard.allow():
            telemetry.sync(ex.device)
    np.testing.assert_array_equal(v.numpy(), want.numpy())
    # run() flushes through telemetry.sync only with a live recorder;
    # under the guard a live run's flush is refused.


def test_planck_flag_default_equals_lux_tpu():
    from lux_tpu.utils import flags as jflags

    assert tflags.default("LUX_PLANCK_INFLATION") == \
        jflags.default("LUX_PLANCK_INFLATION")
