#!/usr/bin/env python3
"""Static analysis over the port's registry, plus the port's repo lint.

The PyTorch port's counterpart of ``tools/speclint.py``; it imports
nothing of JAX or of the JAX package.  Three modes:

  * default — sweep every registry row that publishes its ``traversal``
    through the static verifier (``repro_torch.analysis``): the
    config-independent rules once, then every config the row faces —
    the conformance points and the planner's ranked candidates (the
    card's stream model, unfiltered, the autotuner's block rows
    included) — at its default, aliased and bench sizes, in f32 and
    bf16.  Nothing is launched; no card is needed.

        python tools/torch_speclint.py
        python tools/torch_speclint.py --kernel mxv_gen --json report.json

  * ``--fixture NAME`` — run one fixture of ``repro_torch.analysis.
    fixtures`` (race, redsplit, halo, smem, reassoc) and check the
    checker flags its defect.  The fixture IS a violation, so finding
    the expected rule exits 1; missing it exits 2.

  * ``--repo-lint`` — the port's AST rules:

      1. no module under ``src/repro_torch/``, and neither
         ``chip_smoke.py`` nor ``tools/torch_*.py``, imports ``jax`` or
         ``repro``;
      2. every kernel family package of the port has a ``specs.py``,
         and every ``*_gen`` registry row publishes a ``traversal``;
      3. every obs event, counter or span name emitted under
         ``src/repro_torch/`` appears in the README's port observability
         table (the one headed ``| port name | layer | payload |``).

Exit codes (``tools/speclint.py``'s): 0 = clean; 1 = findings or
problems; 2 = missing or malformed input, or a fixture whose expected
rule did not fire.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import sys
from typing import Any, Optional

__all__ = ["SpeclintError", "candidate_configs", "sweep", "run_fixture",
           "repo_lint", "collect_emitted_names", "documented_names",
           "main"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(REPO, "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

_PORT = os.path.join("src", "repro_torch")
_FORBIDDEN = ("jax", "repro")       # top-level packages the port may not
_TABLE_HEADER = ("port name", "layer")


class SpeclintError(Exception):
    """Missing/malformed input (CLI exit code 2)."""


# ------------------------------------------------------- registry sweep

def candidate_configs(traffic) -> list:
    """The configs a row faces: the conformance points plus the planner's
    own ranked candidates (unfiltered — ``spec=None`` — to see what the
    gate would reject), the autotuner's block rows included."""
    from repro_torch.core.planner import rank_configs
    from repro_torch.registry.base import CONFORMANCE_CONFIGS

    cands = [cfg for _label, cfg in CONFORMANCE_CONFIGS]
    if traffic is not None:
        try:
            cands += [c for c, _bw, _cols in rank_configs(
                traffic, block_rows_candidates=(0, 4, 16))]
        except ValueError:
            pass
    seen, out = set(), []
    for c in cands:
        key = (c.stride_unroll, c.portion_unroll, c.block_rows,
               c.lookahead, c.arrangement)
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def sweep(kernels: Optional[list[str]] = None) -> dict[str, Any]:
    """Static-verify every registered traversal at its default, aliased
    and bench sizes in f32 and bf16, against every candidate config."""
    import torch

    from repro_torch import registry
    from repro_torch.analysis import checker

    report: dict[str, Any] = {"kernels": {}, "skipped": [],
                              "findings": 0, "errors": 0, "configs": 0}
    for row in registry.all_specs():
        if kernels and row.name not in kernels:
            continue
        if row.traversal is None:
            report["skipped"].append(row.name)
            continue
        rows = []
        for which in ("default", "aliased", "bench"):
            sizes = dict({"default": row.default_sizes,
                          "aliased": row.aliased_sizes,
                          "bench": row.bench_problem}[which])
            for dtype in (torch.float32, torch.bfloat16):
                trav = row.traversal(sizes, dtype)
                traffic = (row.traffic(sizes, dtype)
                           if row.traffic is not None else None)
                found = list(checker.check(trav))
                cfgs = candidate_configs(traffic)
                for cfg in cfgs:
                    found += checker.check(trav, cfg, dtype=dtype,
                                           static=False)
                rows.append({"sizes": sizes, "which": which,
                             "dtype": str(dtype).removeprefix("torch."),
                             "configs": len(cfgs),
                             "findings": [f.as_dict() for f in found]})
                report["configs"] += len(cfgs)
                report["findings"] += len(found)
                report["errors"] += sum(f.severity == "error"
                                        for f in found)
        report["kernels"][row.name] = rows
    if kernels:
        missing = set(kernels) - set(report["kernels"])
        if missing:
            raise SpeclintError(
                f"no traversal-publishing kernel named {sorted(missing)}")
    return report


def format_sweep(report: dict[str, Any]) -> str:
    lines = ["# torch_speclint: registry sweep"]
    for name, rows in report["kernels"].items():
        for row in rows:
            flagged = row["findings"]
            mark = ("clean" if not flagged else
                    ", ".join(f"{f['rule']}({f['severity']})"
                              for f in flagged))
            lines.append(f"{name:22s} {row['which']:8s} {row['dtype']:9s}"
                         f"{str(row['sizes']):40s} "
                         f"configs={row['configs']:<3d} {mark}")
    if report["skipped"]:
        lines.append("no traversal (skipped): "
                     + ", ".join(report["skipped"]))
    lines.append(f"findings: {report['findings']} ({report['errors']} "
                 f"errors) over {report['configs']} configs")
    return "\n".join(lines)


# ------------------------------------------------------------ fixtures

def run_fixture(name: str) -> dict[str, Any]:
    from repro_torch.analysis import checker, fixtures

    try:
        fx = fixtures.build(name)
    except ValueError as e:
        raise SpeclintError(str(e))
    found = checker.check(fx.spec, fx.config, **fx.check_kwargs)
    return {
        "fixture": name,
        "expected_rule": fx.rule,
        "findings": [f.as_dict() for f in found],
        "flagged": any(f.rule == fx.rule for f in found),
    }


# ----------------------------------------------------------- repo lint

def _parse(path: str) -> ast.AST:
    try:
        with open(path, encoding="utf-8") as f:
            return ast.parse(f.read(), filename=path)
    except (OSError, SyntaxError) as e:
        raise SpeclintError(f"{path}: cannot parse ({e})")


def _port_files(root: str) -> list[str]:
    """Every Python file of the port: the package, chip_smoke.py and the
    port's tools."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(os.path.join(root, _PORT)):
        out += [os.path.join(dirpath, fn) for fn in filenames
                if fn.endswith(".py")]
    smoke = os.path.join(root, "chip_smoke.py")
    if os.path.exists(smoke):
        out.append(smoke)
    tools = os.path.join(root, "tools")
    if os.path.isdir(tools):
        out += [os.path.join(tools, fn) for fn in os.listdir(tools)
                if fn.startswith("torch_") and fn.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".", 1)[0]
    return top in _FORBIDDEN


def _lint_imports(root: str) -> list[str]:
    """Rule 1: the port imports neither jax nor repro."""
    problems = []
    for path in _port_files(root):
        rel = os.path.relpath(path, root)
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if _forbidden(name):
                    problems.append(
                        f"{rel}:{node.lineno}: imports {name!r} — the port "
                        "imports neither jax nor the JAX package")
    return problems


def _lint_specs_layout(root: str) -> list[str]:
    """Rule 2: one specs.py per family; every *_gen row publishes its
    traversal."""
    problems = []
    kdir = os.path.join(root, _PORT, "kernels")
    for entry in sorted(os.listdir(kdir)):
        fam = os.path.join(kdir, entry)
        if (not os.path.isdir(fam) or entry == "gen"
                or not os.path.exists(os.path.join(fam, "__init__.py"))):
            continue
        if not os.path.exists(os.path.join(fam, "specs.py")):
            problems.append(
                f"{_PORT}/kernels/{entry}/: family package without a "
                "specs.py — every variant must be reachable from a "
                "TraversalSpec builder")
    from repro_torch import registry
    for row in registry.all_specs():
        if row.name.endswith("_gen") and row.traversal is None:
            problems.append(
                f"registry: {row.name} publishes no traversal — the "
                "static verifier cannot screen it")
    return problems


def collect_emitted_names(root: str) -> dict[str, str]:
    """{name: file:line} for every literal obs emission of the package."""
    names: dict[str, str] = {}
    for path in _port_files(root):
        rel = os.path.relpath(path, root)
        if not rel.startswith(_PORT):
            continue
        for node in ast.walk(_parse(path)):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("event", "counter", "span")
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            base = node.func.value
            if isinstance(base, ast.Name) and base.id in ("obs", "_obs"):
                names.setdefault(node.args[0].value, f"{rel}:{node.lineno}")
    return names


def _expand_braces(token: str) -> list[str]:
    """``a.{x,y}`` -> [a.x, a.y] (single brace group)."""
    if "{" not in token:
        return [token]
    head, rest = token.split("{", 1)
    body, tail = rest.split("}", 1)
    return [head + alt + tail for alt in body.split(",")]


def documented_names(readme_path: str) -> set[str]:
    """Names in the README's port observability table (the backticked
    tokens of its first column)."""
    try:
        with open(readme_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError as e:
        raise SpeclintError(f"{readme_path}: cannot read ({e})")
    names: set[str] = set()
    in_table = False
    for line in lines:
        cells = [c.strip() for c in line.strip().split("|")]
        if len(cells) >= 4 and tuple(cells[1:3]) == _TABLE_HEADER:
            in_table = True
            continue
        if not in_table:
            continue
        if not line.strip().startswith("|"):
            break
        for tok in cells[1].split("`")[1::2]:
            names.update(_expand_braces(tok))
    if not names:
        raise SpeclintError(
            f"{readme_path}: no port observability table "
            "(| port name | layer | payload |) found")
    return names


def _lint_obs_names(root: str) -> list[str]:
    """Rule 3: every emitted name is in the README's port table."""
    emitted = collect_emitted_names(root)
    documented = documented_names(os.path.join(root, "README.md"))
    return [f"{emitted[name]}: obs name {name!r} is not in the README's "
            "port observability table"
            for name in sorted(set(emitted) - documented)]


def repo_lint(root: str = REPO) -> dict[str, Any]:
    imports = _lint_imports(root)
    problems = imports + _lint_specs_layout(root) + _lint_obs_names(root)
    return {"repo": root, "problems": problems,
            "files": len(_port_files(root)), "import_problems": imports}


# ---------------------------------------------------------------- CLI

def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="static analysis over the port's registry + the "
                    "port's repo lint (repro_torch.analysis front end)")
    ap.add_argument("--kernel", action="append", default=None,
                    metavar="NAME",
                    help="restrict the sweep to named rows")
    ap.add_argument("--fixture", default=None, metavar="NAME",
                    help="run one fixture (race, redsplit, halo, smem, "
                         "reassoc); the expected rule firing exits 1, "
                         "missing it 2")
    ap.add_argument("--repo-lint", action="store_true",
                    help="AST lint: no jax/repro import in the port, "
                         "specs.py layout, README-documented obs names")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the structured report")
    args = ap.parse_args(argv)

    try:
        if args.repo_lint:
            report = repo_lint()
            for p in report["problems"]:
                print(p)
            print(f"# repo-lint: {report['files']} port files, "
                  f"{len(report['import_problems'])} jax/repro imports, "
                  f"{len(report['problems'])} problem(s)")
            rc = 1 if report["problems"] else 0
        elif args.fixture:
            report = run_fixture(args.fixture)
            for f in report["findings"]:
                print(f"{f['rule']}({f['severity']}) @{f['locus']}: "
                      f"{f['message']}")
            if not report["flagged"]:
                print(f"torch_speclint: fixture {args.fixture!r} expected "
                      f"{report['expected_rule']} but it did not fire",
                      file=sys.stderr)
                rc = 2
            else:
                print(f"# fixture {args.fixture}: "
                      f"{report['expected_rule']} flagged as expected")
                rc = 1
        else:
            report = sweep(args.kernel)
            print(format_sweep(report))
            rc = 1 if report["errors"] else 0
    except SpeclintError as e:
        print(f"torch_speclint: {e}", file=sys.stderr)
        return 2
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote {args.json}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
