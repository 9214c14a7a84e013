#!/usr/bin/env python3
"""Compare the kernel times of two checkouts of this repository on one card,
in turns (old, new, new, old), each in a process of its own.

    python3 chip_ab.py OLD_TREE NEW_TREE [PHASE ...]

Each tree is a directory holding ``chip_smoke.py`` and ``src/repro_torch``
(for instance the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists).  Both trees' kernels are built first,
in parallel.  Each run calls the named ``chip_smoke.py`` phases of its tree
(default: ``phase_k1 phase_k1_int8 phase_k2 phase_k1_grouped
phase_k2_grouped phase_k3``; a phase the old tree lacks is left out
there, one the new tree lacks fails the run) and reports their
per-decode-step kernel times.  A phase named ``serve:LABEL`` serves the
new tree's ``chip_smoke.SERVE_PATHS[LABEL]`` (or ``NO_FUSE_PATHS[LABEL]``)
path through each tree's ``phase_serve`` and reports the median decode
step on the host clock and one two-row decode step's time (host and
device); ``serve:LABEL+fused`` serves the same path with its MLPs fused,
for an A/B of ``--no-fuse`` at the same depth.  The last lines print
one row per result
(marked ``new only`` or ``old only`` where one tree lacks it), its four
times in run order and the change of the new tree's mean against the old
one's.  Needs the card: single launches are timed with
CUDA events on a cold L2, as in ``chip_smoke.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

DEFAULT_PHASES = ("phase_k1", "phase_k1_int8", "phase_k2",
                  "phase_k1_grouped", "phase_k2_grouped", "phase_k3")

# One run: the tree's chip_smoke phases, their step rows as one JSON line.
RUN = r"""
import json, os, sys
tree, phases = sys.argv[1], sys.argv[2:]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
timer = cs.Timer(torch)
serve = json.loads(os.environ.get("AB_SERVE", "{}"))
out = {}
for name in phases:
    if name.startswith("serve:"):
        label, _, fused = name[6:].partition("+")
        kw = dict(serve[label], **({"fused": True} if fused else {}))
        r = cs.phase_serve(torch, label=name[6:], **kw)
        out[name] = {"median decode step": r["decode_step_ms"],
                     "two-row decode step": r["step_ms"]}
        continue
    if not hasattr(cs, name):
        print(f"AB-MISSING {name}")
        continue
    rows = getattr(cs, name)(torch, timer)
    if isinstance(rows, tuple):
        rows = rows[0]
    out[name] = {str(k): v["ms"] for k, v in rows.items()}
print("AB " + json.dumps(out))
"""

BUILD = ("import sys; sys.path.insert(0, sys.argv[1] + '/src'); "
         "from repro_torch.kernels import _build; _build.build_all()")


def main(argv):
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (str(Path(t).resolve()) for t in argv[:2])
    phases = argv[2:] or list(DEFAULT_PHASES)
    builds = [subprocess.Popen([sys.executable, "-c", BUILD, t])
              for t in (old, new)]
    if any(p.wait() != 0 for p in builds):
        print("chip_ab: a build failed", file=sys.stderr)
        return 1
    sys.path.insert(0, new)
    import chip_smoke
    env = dict(os.environ, AB_SERVE=json.dumps(
        {**getattr(chip_smoke, "SERVE_PATHS", {}),
         **getattr(chip_smoke, "NO_FUSE_PATHS", {})}))
    order = (old, new, new, old)
    results = []
    for tree in order:
        run = subprocess.run([sys.executable, "-c", RUN, tree, *phases],
                             capture_output=True, text=True, env=env)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            return 1
        lines = run.stdout.splitlines()
        missing = [ln.split()[1] for ln in lines if ln.startswith("AB-MISSING")]
        if missing and tree == new:
            print(f"chip_ab: the new tree lacks {missing}", file=sys.stderr)
            return 1
        line = [ln for ln in lines if ln.startswith("AB ")]
        results.append(json.loads(line[-1][3:]))
    print(f"[ab] old {old}, new {new}; ms per decode step, runs old, new, "
          f"new, old")
    for phase in dict.fromkeys([*results[1], *results[0]]):
        keys = dict.fromkeys([*results[1].get(phase, {}),
                              *results[0].get(phase, {})])
        for key in keys:
            ms = [r.get(phase, {}).get(key) for r in results]
            if ms[0] is None:
                print(f"[ab] {phase} {key}: new only, {ms[1]:.3f} "
                      f"{ms[2]:.3f}")
                continue
            if ms[1] is None:
                print(f"[ab] {phase} {key}: old only, {ms[0]:.3f} "
                      f"{ms[3]:.3f}")
                continue
            change = (ms[1] + ms[2]) / (ms[0] + ms[3]) - 1.0
            print(f"[ab] {phase} {key}: " + " ".join(f"{x:.3f}" for x in ms)
                  + f"  new vs old {100 * change:+.1f} %")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
