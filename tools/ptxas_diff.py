#!/usr/bin/env python3
"""Compare the kernels' ptxas report (registers, stack frame and spills a
thread, from nvcc's ``-Xptxas -v``) of this checkout with another's:

    python3 tools/ptxas_diff.py --parent DIR

builds both checkouts' kernel libraries (``rbdtpu_torch.kernels._lib.build``,
each in a process of its own, both at once), summarises each build's report
with ``chip_smoke.ptxas_summary`` (one line a kernel instantiation) and
prints how many of the parent's lines this checkout keeps unchanged, every
line that changed or is gone, and every new line.  Exits 1 when a line of
the parent changed or is gone: a change to code that several kernels share
must leave the others' registers and stacks as they were.  Needs nvcc (the
card's machine); DIR is a parent commit unpacked into an ignored directory
(``git archive``).
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(root: str) -> subprocess.Popen:
    """A process that builds ``root``'s kernels and prints the library's
    path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from rbdtpu_torch.kernels import _lib; print(_lib.build())")
    return subprocess.Popen([sys.executable, "-c", code, root],
                            stdout=subprocess.PIPE, text=True)


def summary(so: str) -> dict:
    """Kernel instantiation -> its ptxas line, from the report beside
    ``so``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    with open(so[:-3] + ".ptxas.log") as f:
        lines = cs.ptxas_summary(f.read())
    out, seen = {}, collections.Counter()
    for line in lines:
        name = line.split(":")[0]
        seen[name] += 1  # a name compiled twice keeps both lines apart
        out[f"{name} #{seen[name]}"] = line
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the checkout to compare with")
    a = ap.parse_args()
    procs = {"parent": build(os.path.abspath(a.parent)), "this": build(REPO)}
    libs = {}
    for key, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            print(f"ptxas_diff: the {key} checkout's build failed",
                  file=sys.stderr)
            return 2
        libs[key] = out.strip().splitlines()[-1]
    old, new = summary(libs["parent"]), summary(libs["this"])
    kept = [k for k in old if new.get(k) == old[k]]
    changed = [k for k in old if k in new and new[k] != old[k]]
    gone = [k for k in old if k not in new]
    added = [k for k in new if k not in old]
    for k in changed:
        print(f"changed: {old[k]}\n     -> {new[k]}")
    for k in gone:
        print(f"gone: {old[k]}")
    for k in added:
        print(f"new: {new[k]}")
    print(f"ptxas_diff: {len(kept)} of the parent's {len(old)} lines "
          f"unchanged, {len(changed)} changed, {len(gone)} gone, "
          f"{len(added)} new")
    return 1 if changed or gone else 0


if __name__ == "__main__":
    sys.exit(main())
