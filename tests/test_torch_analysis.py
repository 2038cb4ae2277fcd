"""chiplint on the port (``repro_torch.analysis``) on the CPU.

* The port's parity-drift, units and determinism rules give the
  reference's findings (rule, path, line, symbol) on the reference's
  fixtures (``tests/fixtures/chiplint/``, read-only);
* a one-token drift seeded into each of the port's seven registered
  pairs is a finding at that file:line;
* torch-hygiene (the port's counterpart of jax-hygiene): a clean fixture
  full of metadata branches and a firing one that hits every sub-check
  at known lines (``tests/fixtures/chiplint_torch/``); on the real tree
  it reports none of the reference taint model's metadata findings and
  does report the gmm's dw ``.tolist()``;
* determinism with torch's global generator;
* baseline semantics (reasons kept), the repo-wide gate against
  ``chiplint_torch_baseline.json`` and ``cli lint``'s exit codes.

Every file a test writes lies under its ``tmp_path``.
"""
import ast
import json
import shutil
from pathlib import Path

import pytest

from repro.analysis import LintConfig as RefLintConfig
from repro.analysis import run_lint as ref_run_lint
from repro.analysis.astutil import ModuleCache as RefModuleCache
from repro.analysis.jax_hygiene import JaxEntry, check_jax_hygiene
from repro_torch.analysis import (DEFAULT_CONFIG, DEFAULT_PARITY_PAIRS,
                                  DEFAULT_TORCH_ENTRIES, Finding, LintConfig,
                                  TorchEntry, diff_baseline, load_baseline,
                                  load_baseline_reasons, run_lint,
                                  save_baseline)
from repro_torch.analysis.astutil import load_module
from repro_torch.cli import main as cli_main

REPO_ROOT = Path(__file__).resolve().parents[1]
REF_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "chiplint"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "chiplint_torch"
BASELINE = REPO_ROOT / "chiplint_torch_baseline.json"
OPS = "src/repro_torch/kernels/ops.py"
GMM = "src/repro_torch/kernels/moe_gmm.py"

# configs that disable every family; tests switch on one at a time
_OFF = dict(parity_pairs=(), torch_entries=(), units_paths=(),
            scan_glob="no_such_dir/**/*.py",
            metrics_decl_path="no_such_file.py")
_REF_OFF = {**_OFF, "jax_entries": ()}
del _REF_OFF["torch_entries"]


def _tree(root, mapping):
    """Materialize {relpath: fixture-name-or-text} under ``root``."""
    for rel, src in mapping.items():
        dst = root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        for fixtures in (FIXTURES, REF_FIXTURES):
            if "\n" not in src and (fixtures / src).is_file():
                shutil.copy(fixtures / src, dst)
                break
        else:
            dst.write_text(src)
    return root


def _keys(findings):
    return sorted((f.rule, f.path, f.line, f.symbol) for f in findings)


# ---------------------------------------------------------------------------
# the port against the reference on the reference's fixtures
# ---------------------------------------------------------------------------
def _fixture_pair(a_file):
    from repro.analysis import ParityPair as RP
    from repro.analysis import ParitySide as RS
    from repro_torch.analysis import ParityPair, ParitySide
    roles = (("w", "workload"), ("hw", "hw"))
    ref = RP(name="fixture",
             a=RS(path=a_file, functions=("cost",), roles=roles),
             b=RS(path="b.py", functions=("cost_batch",), roles=roles))
    port = ParityPair(
        name="fixture",
        a=ParitySide(path=a_file, functions=("cost",), roles=roles),
        b=ParitySide(path="b.py", functions=("cost_batch",), roles=roles))
    return {"parity_pairs": (ref,)}, {"parity_pairs": (port,)}


_DET = {"scan_glob": "src/repro/**/*.py",
        "metrics_decl_path": "src/repro/obs/metrics.py"}
_SUPPRESSED = ("def mix(total_bytes, lat_s):\n"
               "    a = total_bytes + lat_s  # chiplint: ignore[units]\n"
               "    b = total_bytes - lat_s  # chiplint: ignore\n"
               "    c = total_bytes + lat_s"
               "  # chiplint: ignore[parity-drift]\n"
               "    return a, b, c\n")
_PROPAGATED = ("def f(n_bytes, lat_s):\n"
               "    total = n_bytes\n"
               "    return total + lat_s\n")

REF_CASES = {
    "parity_clean": ({"a.py": "parity_a_clean.py", "b.py": "parity_b.py"},
                     _fixture_pair("a.py")),
    "parity_drift": ({"a.py": "parity_a_drift.py", "b.py": "parity_b.py"},
                     _fixture_pair("a.py")),
    "parity_missing": ({"a.py": "def other():\n    pass\n",
                        "b.py": "parity_b.py"}, _fixture_pair("a.py")),
    "units_clean": ({"u.py": "units_clean.py"},
                    ({"units_paths": ("u.py",)},) * 2),
    "units_firing": ({"u.py": "units_firing.py"},
                     ({"units_paths": ("u.py",)},) * 2),
    "units_propagated": ({"u.py": _PROPAGATED},
                         ({"units_paths": ("u.py",)},) * 2),
    "units_suppressed": ({"u.py": _SUPPRESSED},
                         ({"units_paths": ("u.py",)},) * 2),
    "determinism_clean": ({"src/repro/obs/metrics.py": "metrics_decl.py",
                           "src/repro/mod.py": "determinism_clean.py"},
                          (_DET,) * 2),
    "determinism_firing": ({"src/repro/obs/metrics.py": "metrics_decl.py",
                            "src/repro/mod.py": "determinism_firing.py"},
                           (_DET,) * 2),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_port_rules_match_reference_on_its_fixtures(tmp_path, case):
    mapping, (ref_kw, port_kw) = REF_CASES[case]
    root = _tree(tmp_path, mapping)
    want = ref_run_lint(root, RefLintConfig(**{**_REF_OFF, **ref_kw}))
    got = run_lint(root, LintConfig(**{**_OFF, **port_kw}))
    assert _keys(got.findings) == _keys(want.findings)
    assert got.n_suppressed == want.n_suppressed
    assert got.n_files == want.n_files
    if case.endswith(("_firing", "_drift", "_propagated", "_missing")):
        assert got.findings            # the comparison has teeth


# ---------------------------------------------------------------------------
# a drift seeded into each of the port's registered pairs
# ---------------------------------------------------------------------------
def _seed_line(path: Path, qualname: str, stmt: str) -> int:
    """Insert ``stmt`` as the first statement of ``qualname`` (after its
    docstring) in ``path`` -> the inserted line's number."""
    mod = load_module(path, path.parent)
    body = mod.functions[qualname].body
    first = body[0]
    if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant) \
            and isinstance(first.value.value, str) and len(body) > 1:
        first = body[1]                  # after the docstring
    lines = path.read_text().splitlines(keepends=True)
    indent = lines[first.lineno - 1][:first.col_offset]
    lines.insert(first.lineno - 1, f"{indent}{stmt}\n")
    path.write_text("".join(lines))
    return first.lineno


@pytest.mark.parametrize("pair", DEFAULT_PARITY_PAIRS,
                         ids=[p.name for p in DEFAULT_PARITY_PAIRS])
def test_seeded_drift_in_each_registered_pair(tmp_path, pair):
    for rel in {pair.a.path, pair.b.path}:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO_ROOT / rel, dst)
    cfg = LintConfig(**{**_OFF, "parity_pairs": (pair,)})
    assert run_lint(tmp_path, cfg).findings == []      # the tree's pair
    if pair.check_consts:        # a constant the mirrored side lacks
        stmt, needle = "_seeded = 4242.5", "constant `4242.5`"
    else:                        # a model term the mirrored side lacks
        role = next(n for n, r in pair.a.roles if r == "hw")
        stmt, needle = f"_seeded = {role}.seeded_drift", \
            "attribute `hw.seeded_drift`"
    line = _seed_line(tmp_path / pair.a.path, pair.a.functions[0], stmt)
    got = run_lint(tmp_path, cfg).findings
    assert [(f.path, f.line) for f in got if needle in f.message] \
        == [(pair.a.path, line)], [f.render() for f in got]
    assert all(f.rule == "parity-drift" and f.symbol == pair.name
               for f in got)


# ---------------------------------------------------------------------------
# torch-hygiene
# ---------------------------------------------------------------------------
def _torch_cfg(*entries):
    return LintConfig(**{**_OFF, "torch_entries": entries})


_FIXTURE_ENTRY = TorchEntry(path="k.py", qualname="entry",
                            tensor_params=("x", "ids"))


def test_torch_hygiene_clean(tmp_path):
    root = _tree(tmp_path, {"k.py": "torch_clean.py"})
    report = run_lint(root, _torch_cfg(_FIXTURE_ENTRY))
    assert report.findings == []


FIRING = {   # line -> (symbol, the message's start)
    9: ("entry", "host-sync: `.item()`"),
    10: ("entry", "host-sync: `.tolist()`"),
    11: ("entry", "host-sync: `.cpu()`"),
    12: ("entry", "host-sync: `.numpy()`"),
    13: ("entry", "host-sync: `.to(\"cpu\")`"),
    14: ("entry", "host-sync: `float()`"),
    15: ("entry", "branch-on-tensor: `if`"),
    17: ("entry", "branch-on-tensor: `while`"),
    19: ("entry", "branch-on-tensor: `assert`"),
    20: ("entry", "branch-on-tensor: `conditional expression`"),
    21: ("entry", "branch-on-tensor: comprehension `if`"),
    23: ("entry", "data-dependent-shape: boolean-mask indexing"),
    24: ("entry", "data-dependent-shape: boolean-mask indexing"),
    25: ("entry", "data-dependent-shape: `nonzero`"),
    26: ("entry", "data-dependent-shape: `unique`"),
    27: ("entry", "data-dependent-shape: `repeat_interleave`"),
    28: ("entry", "data-dependent-shape: `where`"),
    29: ("entry", "host-sync: `torch.tensor(..., device=)`"),
    35: ("total", "host-sync: `int()`"),
    38: ("helper", "unhashable-default"),
}


def test_torch_hygiene_firing_all_subchecks_at_lines(tmp_path):
    root = _tree(tmp_path, {"k.py": "torch_firing.py"})
    got = run_lint(root, _torch_cfg(_FIXTURE_ENTRY)).findings
    assert {f.rule for f in got} == {"torch-hygiene"}
    assert sorted(f.line for f in got) == sorted(FIRING)
    for f in got:
        symbol, start = FIRING[f.line]
        assert f.symbol == symbol and f.message.startswith(start), f.render()


def test_torch_hygiene_is_context_sensitive(tmp_path):
    """A callee is checked under the data its call gives it: the same
    helper fires when handed a tensor and not when handed its length."""
    src = ("def entry(x):\n"
           "    return half(x.shape[0]), half(len(x))\n"
           "\n"
           "\n"
           "def other(x):\n"
           "    return half(x)\n"
           "\n"
           "\n"
           "def half(n):\n"
           "    return n // 2 if n > 1 else n\n")
    root = _tree(tmp_path, {"k.py": src})
    entry = TorchEntry(path="k.py", qualname="entry", tensor_params=("x",))
    assert run_lint(root, _torch_cfg(entry)).findings == []
    other = TorchEntry(path="k.py", qualname="other", tensor_params=("x",))
    got = run_lint(root, _torch_cfg(other)).findings
    assert [(f.line, f.symbol) for f in got] == [(10, "half")]


def test_torch_hygiene_missing_entry_is_reported(tmp_path):
    root = _tree(tmp_path, {"k.py": "def other(x):\n    return x\n"})
    got = run_lint(root, _torch_cfg(_FIXTURE_ENTRY)).findings
    assert [f.message for f in got] == [
        "registered device entry point not found"]


def test_torch_hygiene_drops_the_reference_models_metadata_findings():
    """The reference's taint model (every callee parameter a tracer, every
    assignment from one tainted) pointed at the gmm's backward on the
    port's tree flags metadata branches, ctypes return codes, build paths
    and Python ints; torch-hygiene flags, of those lines, only the two
    ``.tolist()``s."""
    ref = check_jax_hygiene(RefModuleCache(REPO_ROOT), (
        JaxEntry(path=OPS, qualname="_MoEGMM.backward"),))
    ref_lines = {(f.path, f.line) for f in ref}
    entry = next(e for e in DEFAULT_TORCH_ENTRIES
                 if e.qualname == "_MoEGMM.backward")
    got = run_lint(REPO_ROOT, _torch_cfg(entry)).findings
    ours = {(f.path, f.line) for f in got}
    tolist = {(p, n) for p, n in ours
              if ".tolist()" in (REPO_ROOT / p).read_text()
              .splitlines()[n - 1]}
    assert {p for p, _ in tolist} == {OPS, GMM}
    assert ours & ref_lines == tolist
    assert len(ref_lines - ours) >= 28
    assert {f.rule for f in got} == {"torch-hygiene"}


def test_every_registered_torch_entry_exists():
    for e in DEFAULT_TORCH_ENTRIES:
        mod = load_module(REPO_ROOT / e.path, REPO_ROOT)
        fn = mod.functions[e.qualname]
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        assert set(e.tensor_params) <= params, e


# ---------------------------------------------------------------------------
# determinism: torch's global generator
# ---------------------------------------------------------------------------
_TORCH_RNG = '''\
import torch
import torch as th


def draws(gen, shape, kw):
    a = torch.randn(shape)
    b = torch.randn(shape,
                    generator=gen)
    c = th.randint(0, 5, shape)
    d = torch.rand(shape, **kw)
    torch.manual_seed(0)
    torch.cuda.manual_seed_all(0)
    e = torch.empty(shape).normal_(0.0, 1.0)
    f = torch.empty(shape).normal_(
        0.0, 1.0, generator=gen)
    g = torch.multinomial(a.abs(), 2)
    h = torch.randperm(4, generator=gen)
    return a, b, c, d, e, f, g, h
'''
TORCH_RNG_LINES = {6: "torch.randn", 9: "torch.randint", 11: "manual_seed",
                   12: "torch.cuda.manual_seed_all", 13: ".normal_",
                   16: "torch.multinomial"}


def test_determinism_flags_torch_global_generator(tmp_path):
    root = _tree(tmp_path, {
        "src/repro_torch/obs/metrics.py": "metrics_decl.py",
        "src/repro_torch/mod.py": _TORCH_RNG})
    got = run_lint(root, LintConfig(**{
        **_OFF, "scan_glob": "src/repro_torch/**/*.py",
        "metrics_decl_path": "src/repro_torch/obs/metrics.py"})).findings
    assert sorted(f.line for f in got) == sorted(TORCH_RNG_LINES)
    for f in got:
        assert f.rule == "determinism" and f.symbol == "draws"
        assert "global-rng" in f.message
        assert TORCH_RNG_LINES[f.line] in f.message, f.render()


@pytest.mark.parametrize("rel", ["src/repro_torch/models/api.py",
                                 "src/repro_torch/data/pipeline.py"])
def test_port_draws_pass_their_generator(tmp_path, rel):
    """The port's seeded draws stay clean, the generator keyword on a
    continuation line included."""
    src = (REPO_ROOT / rel).read_text()
    lines = src.splitlines()
    draws = [i for i, ln in enumerate(lines, 1)
             if "torch.randn(" in ln and "generator=" not in ln]
    assert draws, "a draw whose generator= is on a later line"
    root = _tree(tmp_path, {rel: src,
                            "src/repro_torch/obs/metrics.py":
                                (REPO_ROOT / "src/repro_torch/obs/metrics.py"
                                 ).read_text()})
    got = run_lint(root, LintConfig(**{
        **_OFF, "scan_glob": "src/repro_torch/**/*.py",
        "metrics_decl_path": "src/repro_torch/obs/metrics.py"}))
    assert got.findings == [] and got.n_files == 2


# ---------------------------------------------------------------------------
# baseline semantics
# ---------------------------------------------------------------------------
def _f(path="x.py", line=3, rule="units", message="m", symbol="f"):
    return Finding(path=path, line=line, rule=rule, message=message,
                   symbol=symbol)


def test_baseline_roundtrip_reasons_and_multiset_diff(tmp_path):
    f1, f2 = _f(line=3), _f(line=9)      # same fingerprint, two sites
    g = _f(rule="determinism", message="other")
    p = save_baseline(tmp_path / "b.json", [f1, g],
                      {g.fingerprint: "why g stays"})
    base = load_baseline(p)
    assert load_baseline_reasons(p) == {f1.fingerprint: "",
                                        g.fingerprint: "why g stays"}
    new, stale = diff_baseline([f1, f2, g], base)
    assert new == [f2] and stale == []
    new, stale = diff_baseline([], base)
    assert new == [] and sorted(stale) == sorted(
        [f1.fingerprint, g.fingerprint])
    new, stale = diff_baseline([_f(line=77), g], base)   # lines move
    assert new == [] and stale == []


def test_baseline_reads_bare_fingerprints_missing_and_bad_schema(tmp_path):
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"schema": 1, "tool": "chiplint",
                                "findings": [_f().fingerprint] * 2}))
    assert load_baseline(bare) == {_f().fingerprint: 2}
    assert load_baseline_reasons(bare) == {_f().fingerprint: ""}
    assert load_baseline(tmp_path / "absent.json") == {}
    bad = tmp_path / "bad.json"
    bad.write_text('{"schema": 99, "findings": []}')
    with pytest.raises(ValueError):
        load_baseline(bad)


# ---------------------------------------------------------------------------
# the repo-wide gate (tier-1): the port's tree must be baseline-exact
# ---------------------------------------------------------------------------
def test_repo_is_baseline_exact():
    report = run_lint(REPO_ROOT)
    new, stale = diff_baseline(report.findings, load_baseline(BASELINE))
    assert new == [], "chiplint found NEW findings:\n" + "\n".join(
        f.render() for f in new)
    assert stale == [], ("baseline entries with no matching finding "
                         "(fix shipped? update the baseline):\n"
                         + "\n".join(stale))
    assert report.n_files > 80     # the scan actually covered the tree
    reasons = load_baseline_reasons(BASELINE)
    assert all(r.strip() for r in reasons.values()), reasons
    gmm_dw = [f for f in report.findings
              if f.path == OPS and f.symbol == "_MoEGMM.backward"
              and ".tolist()" in f.message]
    assert len(gmm_dw) == 1


def test_cli_lint_exit_codes(tmp_path, capsys):
    assert cli_main(["lint", "--root", str(REPO_ROOT),
                     "--json", str(tmp_path / "r.json")]) == 0
    assert "chiplint:" in capsys.readouterr().out
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["n_new"] == 0 and report["n_files"] > 80
    # a tree with findings and no baseline exits 1 (the default config
    # scans src/repro_torch/**, so the firing determinism fixture is
    # covered; the registered-but-absent pairs and entries also report)
    root = _tree(tmp_path / "t", {
        "src/repro_torch/obs/metrics.py": "metrics_decl.py",
        "src/repro_torch/mod.py": "determinism_firing.py",
    })
    assert cli_main(["lint", "--root", str(root)]) == 1
    capsys.readouterr()
    # ...--update-baseline grandfathers them, then lint exits 0
    assert cli_main(["lint", "--root", str(root),
                     "--update-baseline"]) == 0
    assert (root / "chiplint_torch_baseline.json").is_file()
    assert cli_main(["lint", "--root", str(root)]) == 0
    # fixing the findings makes the baseline stale -> exit 1 again
    (root / "src/repro_torch/mod.py").write_text("def ok():\n    return 0\n")
    assert cli_main(["lint", "--root", str(root)]) == 1
    # a missing root is a usage error
    with pytest.raises(SystemExit) as e:
        cli_main(["lint", "--root", str(tmp_path / "absent")])
    assert e.value.code == 2
    capsys.readouterr()


def test_default_config_covers_the_port():
    assert all(p.a.path.startswith("src/repro_torch/")
               and p.b.path.startswith("src/repro_torch/")
               for p in DEFAULT_CONFIG.parity_pairs)
    assert len(DEFAULT_CONFIG.parity_pairs) == 7
    assert all(p.startswith("src/repro_torch/")
               for p in DEFAULT_CONFIG.units_paths)
    assert DEFAULT_CONFIG.scan_glob == "src/repro_torch/**/*.py"
