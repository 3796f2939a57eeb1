"""The port's trace contracts (`repro_torch.analysis`) on the CPU.

Two layers, as `tests/test_trace_analysis.py` holds them for `repro`:

- the AST linter against the fixture corpus (`tests/fixtures/torch_lint`)
  and against small sources written per case: each known-bad snippet
  fires exactly its rule, the clean fixture and `src/repro_torch` fire
  nothing;
- the step audit: the gate logic (`compare_report`) on synthetic
  reports, the live CPU audit of all ten grids against the committed
  pin, the grids and their groups against `repro`'s (its grids and its
  committed `benchmarks/trace_audit.json`, read only), and a step that
  bypasses `ops` failing the gate.
"""

import contextlib
import copy
import io
import json
import pathlib
import sys

import pytest
import torch

from repro.analysis import traceaudit as ref_audit
from repro_torch.analysis import RULES, lint_paths
from repro_torch.analysis import traceaudit
from repro_torch.kernels import ref as t_ref

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_lint"

sys.path.insert(0, str(ROOT / "tools"))

import torch_trace_lint  # noqa: E402


# --------------------------------------------------------------------------
# AST linter: fixture corpus
# --------------------------------------------------------------------------

FIXTURE_RULES = {
    "host_rng_in_step.py": "host-rng-in-device-code",
    "torch_in_prepare.py": "device-tensor-in-host-prepare",
    "host_sync_in_step.py": "host-sync-in-step",
    "unfrozen_spec.py": "spec-dataclass-not-frozen",
    "missing_statics_key.py": "statics-key-not-in-signature",
}


@pytest.mark.parametrize("fname,rule", sorted(FIXTURE_RULES.items()))
def test_fixture_fires_exactly_its_rule(fname, rule):
    findings = lint_paths([FIXTURES / fname])
    assert findings, f"{fname} produced no findings"
    assert {f.rule for f in findings} == {rule}


def test_every_rule_has_a_fixture():
    assert set(FIXTURE_RULES.values()) == set(RULES)
    assert len(RULES) == 5


def test_clean_fixture_has_zero_findings():
    assert lint_paths([FIXTURES / "clean.py"]) == []


def test_port_tree_is_clean():
    assert lint_paths([ROOT / "src" / "repro_torch"], root=ROOT) == []


def test_findings_are_located_and_printable():
    findings = lint_paths([FIXTURES / "host_sync_in_step.py"], root=ROOT)
    (f,) = findings
    assert f.path == "tests/fixtures/torch_lint/host_sync_in_step.py"
    assert f.line == 19
    assert str(f) == f"{f.path}:19: [host-sync-in-step] {f.message}"


def test_linted_corpus_as_a_whole_fires_all_rules():
    """The cross-file statics-key union must not hide the missing key:
    `ghost_gain` is produced nowhere in the corpus."""
    assert {f.rule for f in lint_paths([FIXTURES])} == set(RULES)


# --------------------------------------------------------------------------
# AST linter: each form of a rule, one small kernel a case
# --------------------------------------------------------------------------

_KERNEL = '''
import numpy as np
import random
import torch


class CaseKernel(MethodKernel):
    def prepare(self, problem, net, cfg, iters):
        {prepare}
        return Prepared(consts=(), steps=(),
                        statics=dict(iters=iters, K=3, damped=True))

    def step(self, state, inp, aux, statics):
        x = state["x"]
        {step}
        return state, (x, x, x)
'''


def _lint_kernel(tmp_path, step):
    path = tmp_path / "case_kernel.py"
    path.write_text(_KERNEL.format(step=step, prepare="pass"))
    return {f.rule for f in lint_paths([path])}


@pytest.mark.parametrize("step", [
    "if x.sum() > 0: x = -x",
    "if torch.any(x > 0): x = -x",
    "while x.max() > 1: x = x / 2",
    "assert torch.isfinite(x).all()",
    "x = x if x.mean() > 0 else -x",
    "s = float(x.sum())",
    "n = int(inp[0][0])",
    "ok = bool(x.norm() < 1)",
    "v = x.sum().item()",
    "v = x.tolist()",
    "v = x.cpu()",
    "v = x.detach().numpy()",
    "idx = torch.nonzero(x)",
    "idx = x.nonzero()",
    "u = torch.unique(x)",
    "u = x.unique()",
    "torch.cuda.synchronize()",
    "print(x.shape)",
])
def test_each_host_sync_form_fires(tmp_path, step):
    assert _lint_kernel(tmp_path, step=step) == {"host-sync-in-step"}


@pytest.mark.parametrize("step", [
    "if statics['damped']: x = x * 0.5",
    "if x.shape[0] > 1 and x.ndim == 4: x = x * 2",
    "if x.dtype == torch.float64: x = x * 2",
    "if x.device.type == 'cuda': x = x.contiguous()",
    "if x.size(0) > int(statics['K']): x = x[:1]",
    "n = len(x) + x.numel() + x.dim()",
    "x = torch.where(x > 0, x, -x)",
    "k = statics.get('K', 1) if statics['iters'] else 0",
])
def test_python_level_branches_do_not_fire(tmp_path, step):
    assert _lint_kernel(tmp_path, step=step) == set()


@pytest.mark.parametrize("step", [
    "x = x + torch.rand(x.shape)",
    "x = x + torch.randn_like(x)",
    "x = x + torch.randint(0, 2, x.shape)",
    "x = x + torch.normal(0.0, 1.0, x.shape)",
    "x = torch.bernoulli(x)",
    "i = torch.multinomial(x, 1)",
    "torch.manual_seed(0)",
    "x.uniform_()",
    "x.normal_()",
    "x.random_(0, 2)",
    "x.bernoulli_(0.5)",
    "x.exponential_()",
    "x = x + np.random.normal(size=3)",
    "x = x + random.random()",
])
def test_each_rng_form_fires(tmp_path, step):
    assert _lint_kernel(tmp_path, step=step) == {"host-rng-in-device-code"}


def test_rng_in_a_kernels_module_function_fires(tmp_path):
    path = tmp_path / "kernels" / "noisy.py"
    path.parent.mkdir()
    path.write_text("import torch\n\ndef f(x):\n    return x + torch.rand_like(x)\n")
    assert [(f.rule, f.line) for f in lint_paths([path])] == [
        ("host-rng-in-device-code", 4)
    ]


def test_torch_in_a_host_helper_fires(tmp_path):
    """A helper the host side calls is host side too (the self.-call
    fixpoint), so torch there fires."""
    src = _KERNEL.replace(
        "        {prepare}",
        "        self._table()\n\n    def _table(self):\n"
        "        return torch.zeros(3)",
    )
    path = tmp_path / "helper.py"
    path.write_text(src.format(step="pass"))
    assert {f.rule for f in lint_paths([path])} == {
        "device-tensor-in-host-prepare"
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fname", sorted(FIXTURE_RULES))
def test_cli_nonzero_on_each_fixture(capsys, fname):
    rc = torch_trace_lint.main([str(FIXTURES / fname)])
    out = capsys.readouterr().out
    assert rc == 1
    assert FIXTURE_RULES[fname] in out


@pytest.fixture(scope="module")
def cli_on_the_tree():
    """One real run of the CLI on the tree on the CPU: its exit code, its
    output and the audit report it gated (the live tests below read it,
    so the suite audits the ten grids once)."""
    real = traceaudit.audit_report
    reports = []

    def spy(*args, **kwargs):
        reports.append(real(*args, **kwargs))
        return reports[-1]

    traceaudit.audit_report = spy
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = torch_trace_lint.main(["--device", "cpu"])
    finally:
        traceaudit.audit_report = real
    (report,) = reports
    return rc, out.getvalue(), report


def test_cli_zero_on_the_tree_on_the_cpu(cli_on_the_tree):
    rc, out, _ = cli_on_the_tree
    assert rc == 0
    assert "[ast]: clean" in out
    assert "10 grids / 15 static groups clean on cpu" in out


@pytest.mark.parametrize("flags", [
    ["--ast-only", "--audit-only"],
    ["--ast-only", "--update-audit"],
])
def test_cli_flag_contradiction(flags):
    with pytest.raises(SystemExit):
        torch_trace_lint.main(flags)


def test_cli_audit_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the audit runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_trace_lint.main(["--audit-only"])


# --------------------------------------------------------------------------
# Step audit: gate logic on synthetic reports
# --------------------------------------------------------------------------


def _entry(groups=1, calls=12, launches=None, syncs=None, demotions=0,
           f64=True, expect=True):
    return {
        "groups": groups,
        "expect_kernel": expect,
        "signatures": {
            "('admm', 5)": {
                "iters": 12,
                "k1_calls": calls,
                "k1_launches": launches,
                "host_syncs": syncs,
                "demotions": demotions,
                "f64_outputs": f64,
                "out_dtypes": ["float64"] if f64 else ["float32"],
            }
        },
    }


def test_gate_passes_on_identical_reports():
    fresh = {"admm_coded": _entry(launches=12, syncs=0)}
    fails, _ = traceaudit.compare_report(fresh, copy.deepcopy(fresh))
    assert fails == []


def test_gate_fails_on_a_host_sync_naming_grid_and_signature():
    entry = _entry(launches=1, calls=1, syncs=1)
    entry["signatures"]["('admm', 5)"]["sync_error"] = "called a synchronizing CUDA operation"
    fails, _ = traceaudit.compare_report({"admm_async": entry}, None)
    assert any(
        f.startswith("admm_async ('admm', 5): host sync")
        and "synchronizing" in f for f in fails
    )


def test_gate_fails_on_lost_k1_path():
    fails, _ = traceaudit.compare_report({"admm_coded": _entry(calls=11)}, None)
    assert any("lost the fused" in f for f in fails)


def test_gate_fails_on_k1_on_a_non_coded_grid():
    fails, _ = traceaudit.compare_report(
        {"admm_exact": _entry(calls=12, expect=False)}, None
    )
    assert any("non-coded" in f for f in fails)


def test_gate_fails_when_launches_differ_from_entries():
    fails, _ = traceaudit.compare_report(
        {"admm_coded": _entry(launches=0, syncs=0)}, None
    )
    assert any("0 K1 launches for 12 entries" in f for f in fails)


def test_gate_records_but_does_not_assert_walkman():
    fails, _ = traceaudit.compare_report(
        {"walkman": _entry(calls=5, expect=None)}, None
    )
    assert fails == []


def test_gate_fails_on_f32_outputs():
    fails, _ = traceaudit.compare_report({"admm_coded": _entry(f64=False)}, None)
    assert any("demoted" in f for f in fails)


def test_gate_fails_on_group_growth():
    base = {"admm_coded": _entry()}
    fails, _ = traceaudit.compare_report({"admm_coded": _entry(groups=3)}, base)
    assert any("grew 1 -> 3" in f for f in fails)
    assert any("declares 1" in f for f in fails)


def test_gate_fails_on_demotion_growth_but_notes_shrinkage():
    fails, _ = traceaudit.compare_report(
        {"admm_coded": _entry(demotions=1)}, {"admm_coded": _entry()}
    )
    assert any("demotions grew 0 -> 1" in f for f in fails)
    fails, notes = traceaudit.compare_report(
        {"admm_coded": _entry(demotions=1)}, {"admm_coded": _entry(demotions=2)}
    )
    assert fails == [] and any("shrank" in n for n in notes)


def test_gate_fails_on_grid_missing_from_fresh():
    base = {"admm_coded": _entry(), "walkman": _entry(calls=0, expect=None)}
    fails, _ = traceaudit.compare_report({"admm_coded": _entry()}, base)
    assert any("walkman" in f and "absent" in f for f in fails)


def test_gate_notes_new_grid_without_failing():
    fresh = {"admm_coded": _entry(), "walkman": _entry(calls=0, expect=None)}
    fails, notes = traceaudit.compare_report(fresh, {"admm_coded": _entry()})
    assert fails == []
    assert any("walkman" in n and "NEW" in n for n in notes)


def test_baseline_roundtrip(tmp_path):
    path = tmp_path / "audit.json"
    assert traceaudit.load_baseline(path) is None
    traceaudit.write_baseline({"admm_coded": _entry()}, path)
    assert traceaudit.load_baseline(path) == {"admm_coded": _entry()}


# --------------------------------------------------------------------------
# Step audit: live runs on the CPU
# --------------------------------------------------------------------------

CODED = ("admm_coded", "admm_async", "admm_adaptive", "pi_admm", "cq_admm")
NON_CODED = ("admm_exact", "gossip_dadmm", "gossip_dgd", "gossip_extra")


@pytest.fixture(scope="module")
def cpu_report(cli_on_the_tree):
    return cli_on_the_tree[2]


def test_live_cpu_audit_equals_the_committed_pin(cpu_report):
    assert cpu_report == traceaudit.load_baseline()
    assert traceaudit.compare_report(cpu_report, traceaudit.load_baseline())[0] == []


def test_live_cpu_audit_counts(cpu_report):
    assert set(cpu_report) == set(CODED + NON_CODED + ("walkman",))
    for name, entry in cpu_report.items():
        for counts in entry["signatures"].values():
            assert counts["iters"] == 12
            want = 12 if name in CODED else 0
            if name != "walkman":
                assert counts["k1_calls"] == want, name
            assert counts["k1_launches"] is None and counts["host_syncs"] is None
            assert counts["demotions"] == 0
            assert counts["out_dtypes"] == ["float64"]


def test_grids_equal_the_reference_grids():
    ref = {g.name: g for g in ref_audit._default_grids()}
    port = traceaudit.AUDIT_GRIDS
    assert list(port) == list(ref)
    for name, grid in port.items():
        assert grid.expect_groups == ref[name].expect_groups
        assert grid.expect_kernel is ref[name].expect_pallas
        assert [c.__dict__ for c in grid.cases] == [
            c.__dict__ for c in ref[name].cases
        ]


def test_groups_and_signatures_equal_the_reference_pin(cpu_report):
    ref = json.loads((ROOT / "benchmarks" / "trace_audit.json").read_text())
    assert set(cpu_report) == set(ref)
    for name, entry in cpu_report.items():
        assert entry["groups"] == ref[name]["groups"]
        assert set(entry["signatures"]) == set(ref[name]["signatures"])
        for sig, counts in entry["signatures"].items():
            entered = counts["k1_calls"] > 0
            assert entered == (ref[name]["signatures"][sig]["pallas_calls"] > 0)


def test_a_step_that_bypasses_ops_fails_the_gate(monkeypatch):
    import repro_torch.methods.admm as admm

    monkeypatch.setattr(admm, "coded_admm_update", t_ref.coded_admm_update_ref)
    fresh = traceaudit.audit_report(["admm_coded"], device="cpu")
    assert fresh["admm_coded"]["signatures"][
        "('admm', 5, 198, 64, 10, 100, 3, 66, False, 12)"
    ]["k1_calls"] == 0
    fails, _ = traceaudit.compare_report(fresh, traceaudit.load_baseline())
    assert any("lost the fused decode-combine kernel" in f for f in fails)


def test_profile_hook_is_restored_when_a_step_raises(monkeypatch):
    from repro_torch.methods.walkman import WalkmanADMM

    def boom(self, state, inp, aux, statics):
        raise ValueError("step failed")

    def sentinel(frame, event, arg):
        return None

    monkeypatch.setattr(WalkmanADMM, "step", boom)
    previous = sys.getprofile()
    sys.setprofile(sentinel)
    try:
        with pytest.raises(ValueError, match="step failed"):
            traceaudit.audit_report(["walkman"], device="cpu")
        assert sys.getprofile() is sentinel
    finally:
        sys.setprofile(previous)


def test_demotion_counter_sees_an_f64_to_f32_op():
    x = torch.ones(3, dtype=torch.float64)
    with torch.inference_mode(), traceaudit._Demotions() as mode:
        x + 1
        x.to(torch.int64)
        x.float()
        torch.ones(3, dtype=torch.float32) * 2
    assert mode.count == 1
