"""The runner shared by the A/B tools (``torch_kernel_ab.py``,
``torch_decode_step_ab.py``): one child process per checkout, in the
order given (parent, change, change, parent), each in its checkout's
root, then the card's name and power limit.

A tool calls :func:`main` with its ``one(root, n, first)``, which times
one checkout and returns a JSON-able dict; ``n`` is the tool's count
option and ``first`` is true in the first checkout's process only.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable


def main(script: str, doc: str, one: Callable[[str, int, bool], dict],
         option: str, default: int) -> int:
    """``script ROOT [ROOT ...] [option N]``: print one JSON line per
    ROOT, then the ``nvidia-smi`` card line.  A child that fails passes
    its output on and its exit code out."""
    args = sys.argv[1:]
    n = default
    if option in args:
        i = args.index(option)
        n = int(args[i + 1])
        del args[i:i + 2]
    if args and args[0] == "--one":
        print(json.dumps(one(args[1], n, args[2] == "1")), flush=True)
        return 0
    if not args:
        print(doc, file=sys.stderr)
        return 2
    for i, root in enumerate(map(os.path.abspath, args)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--one", root,
             "1" if i == 0 else "0", option, str(n)],
            cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    return 0
