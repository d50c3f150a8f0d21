#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's kernel instances in two
checkouts.

    python3 tools/sass_compare.py ROOT_A ROOT_B STEM [STEM ...]

Each ROOT is a checkout of the repository.  For each STEM, in each ROOT,
``csrc/<STEM>.cu`` is built as ``kernels/cuda.py`` builds it (in the
ROOT's own build directory) and disassembled with ``cuobjdump -sass``.
Every kernel instance of ROOT_A is paired with the instance of ROOT_B of
the same demangled name, after :data:`RENAMES`; two instances are the
same where their instruction sequences are equal with addresses and
encodings left out.  Where two instances run the same instructions at
the same launch geometry, a time difference between them is the card's
spread.

Prints one JSON line per STEM: ``same`` (names), ``differ`` (name:
instructions in A and in B, and the index of the first that differs),
``only_a`` and ``only_b``.  Needs ``nvcc`` and ``cuobjdump`` (the CUDA
toolkit) and ``c++filt``; no card.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

# ROOT_B's name → ROOT_A's, for instances that gained a template
# parameter: rmsnorm's vector width, whose 16-byte instances are the
# kernels of rows of whole 16-byte vectors.  A rename applies only where
# ROOT_A has no instance of B's own name.
RENAMES = [(re.compile(r"rmsnorm_ms<([^,<>]+), 16, "), r"rmsnorm_ms<\1, ")]

_BUILD = ("import sys; sys.path.insert(0, 'src');"
          "from repro_torch.kernels import cuda;"
          "cuda.build([{stem!r}]);"
          "print(cuda._lib_path(cuda.CSRC / {src!r}))")
_CUDA_BIN = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin")


def _tool(name: str) -> str:
    path = shutil.which(name) or os.path.join(_CUDA_BIN, name)
    if not os.path.exists(path):
        raise SystemExit(f"sass_compare: {name} not found")
    return path


def library(root: str, stem: str) -> str:
    """Build ``csrc/<stem>.cu`` in ``root``; its library's path."""
    proc = subprocess.run(
        [sys.executable, "-c", _BUILD.format(stem=stem, src=f"{stem}.cu")],
        cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"sass_compare: build of {stem} in {root} "
                         f"failed:\n{proc.stdout}{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


def functions(lib: str) -> dict[str, list[str]]:
    """``{demangled kernel instance: [instruction, ...]}`` of ``lib``."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", lib],
                          capture_output=True, text=True, check=True).stdout
    found: dict[str, list[str]] = {}
    code = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            code = found.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and code is not None:
            code.append(re.sub(r"\s+", " ", m.group(1)))
    names = list(found)
    plain = subprocess.run([_tool("c++filt")], input="\n".join(names),
                           capture_output=True, text=True,
                           check=True).stdout.split("\n")
    out = {}
    for mangled, name in zip(names, plain):
        name = re.sub(r"\(anonymous namespace\)::", "", name)
        out[name.split("(")[0].removeprefix("void ")] = found[mangled]
    return out


def compare(a: dict, b: dict) -> dict:
    renamed = {}
    for name, code in b.items():
        if name not in a:
            for pattern, repl in RENAMES:
                name = pattern.sub(repl, name)
        renamed[name] = code
    same, differ = [], {}
    for name, code in sorted(a.items()):
        other = renamed.get(name)
        if other is None:
            continue
        if other == code:
            same.append(name)
        else:
            first = next((i for i, (x, y) in enumerate(zip(code, other))
                          if x != y), min(len(code), len(other)))
            differ[name] = [len(code), len(other), first]
    return {"same": same, "differ": differ,
            "only_a": sorted(set(a) - set(renamed)),
            "only_b": sorted(set(renamed) - set(a))}


def main(argv: list[str]) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    root_a, root_b = map(os.path.abspath, argv[:2])
    for stem in argv[2:]:
        result = compare(functions(library(root_a, stem)),
                         functions(library(root_b, stem)))
        print(json.dumps({"stem": stem, **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
