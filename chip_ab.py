#!/usr/bin/env python3
"""Compare the kernel times of two checkouts of this repository on one card,
in turns (old, new, new, old), each in a process of its own.

    python3 chip_ab.py [--turns N] [--harness new] OLD_TREE NEW_TREE [PHASE ...]

Each tree is a directory holding ``chip_smoke.py`` and ``src/repro_torch``
(for instance the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists).  Both trees' kernels are built first,
in parallel.  Each run calls the named ``chip_smoke.py`` phases of its tree
(default: ``phase_k1 phase_k1_int8 phase_k2 phase_k1_grouped
phase_k2_grouped phase_k3 phase_k4``; a phase the old tree lacks is left
out there, one the new tree lacks fails the run) and reports their
per-decode-step kernel times.  A phase named ``serve:LABEL`` serves the
new tree's ``chip_smoke.SERVE_PATHS[LABEL]`` (or ``NO_FUSE_PATHS[LABEL]``)
path through each tree's ``phase_serve`` and reports the median decode
step on the host clock, one two-row decode step's time until the device
is done, and the host's time to enqueue that step (the wrappers' host
cost); ``serve:LABEL+fused`` serves the same path with its MLPs fused,
for an A/B of ``--no-fuse`` at the same depth.  ``--turns N`` repeats
the four runs N times (old, new, new, old, old, new, ...).  ``--harness
new`` runs the new tree's ``chip_smoke.py`` kernel phases in every run,
each on its own tree's kernels and wrappers: the same cases and timing on
both sides, and rows the old tree's script did not report (``serve:``
rows always run each tree's own script, whose checks hold its own
kernels).  The last lines
print one row per result (marked ``new only`` or ``old only`` where one
tree lacks it): its times in run order, the change of the new tree's mean
against the old one's, and the verdict against the spread: ``faster``
when every new run beats every old one, ``slower`` when every old run
beats every new one, else ``within the spread``.  Needs the card: single
launches are timed with CUDA events on a cold L2, as in
``chip_smoke.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

DEFAULT_PHASES = ("phase_k1", "phase_k1_int8", "phase_k2",
                  "phase_k1_grouped", "phase_k2_grouped", "phase_k3",
                  "phase_k4")

# One run: the tree's chip_smoke phases, their step rows as one JSON line.
RUN = r"""
import importlib.util, json, os, sys
tree, harness, phases = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path[:0] = [tree + "/src"]
import torch


def script(root, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  root + "/chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = script(harness, "chip_smoke")
own = cs if harness == tree else script(tree, "own_chip_smoke")
torch.backends.cuda.matmul.allow_tf32 = False
timer = cs.Timer(torch)
serve = json.loads(os.environ.get("AB_SERVE", "{}"))
out = {}
for name in phases:
    if name.startswith("serve:"):
        label, _, fused = name[6:].partition("+")
        kw = dict(serve[label], **({"fused": True} if fused else {}))
        r = own.phase_serve(torch, label=name[6:], **kw)
        out[name] = {"median decode step": r["decode_step_ms"],
                     "two-row decode step": r["step_ms"],
                     "two-row step, host enqueue": r["enqueue_ms"]}
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
    turns, same_harness = 1, False
    while argv[:1] in (["--turns"], ["--harness"]) and len(argv) > 1:
        if argv[0] == "--turns":
            turns = int(argv[1])
        elif argv[1] == "new":
            same_harness = True
        else:
            print(__doc__, file=sys.stderr)
            return 2
        argv = argv[2:]
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
    order = (old, new, new, old) * turns
    results = []
    for tree in order:
        harness = new if same_harness else tree
        run = subprocess.run([sys.executable, "-c", RUN, tree, harness,
                              *phases],
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
    print(f"[ab] old {old}, new {new}; ms per decode step, runs "
          + ", ".join("old" if t == old else "new" for t in order))
    for phase in dict.fromkeys([*results[1], *results[0]]):
        keys = dict.fromkeys([*results[1].get(phase, {}),
                              *results[0].get(phase, {})])
        for key in keys:
            ms = [r.get(phase, {}).get(key) for r in results]
            olds = [x for t, x in zip(order, ms) if t == old]
            news = [x for t, x in zip(order, ms) if t == new]
            if None in olds or None in news:
                which = "new" if None in olds else "old"
                times = news if which == "new" else olds
                print(f"[ab] {phase} {key}: {which} only, "
                      + " ".join(f"{x:.3f}" for x in times if x is not None))
                continue
            change = sum(news) / sum(olds) - 1.0
            verdict = ("faster" if max(news) < min(olds) else "slower"
                       if min(news) > max(olds) else "within the spread")
            print(f"[ab] {phase} {key}: " + " ".join(f"{x:.3f}" for x in ms)
                  + f"  new vs old {100 * change:+.1f} %, {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
