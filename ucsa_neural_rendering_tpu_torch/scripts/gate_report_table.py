"""Assemble the quality-gate table from exp_synthetic_cl arm reports (the
port's counterpart of scripts/gate_report_table.py; it reads the same
files, written by either package, and runs nothing on a device).

For each arm under <root>/experiments/report_<arm>.json, prints one row of
the metrics the gate decides on:
  * seg-level (what the protocol consumes): new-scene mIoU mean, old-scene
    final mIoU mean, and the same excluding scenes whose PRETRAIN transfer
    is ~0 (no adaptation signal to preserve: the pseudo-label loop never
    engages, so they only add noise to the mean);
  * nerf-level (what feeds replay/finetune data): per-stage rendered-label
    test mIoU from each stage's metrics.jsonl.

Usage:
  python -m ucsa_neural_rendering_tpu_torch.scripts.gate_report_table \\
      [root[,root2,...] [dead_scene[,scene...]]]

(the roots default to scripts/quality_gate.py's: build/quality_gate/seed123,
seed7 and seed21 under the repository).

Multiple comma-separated roots = seed replicates of the same arms; rows
report the across-seed mean plus the per-seed values so the paired spread
is visible.
"""

import glob
import json
import os
import re
import sys

# pretrain transfer ~0 on the synthetic protocol. Importers
# (gate_decision) get this default; the command line's override is parsed
# in main(), never at import time
DEAD = frozenset(["scene0001_00"])
# where scripts/quality_gate.py puts its seeds' roots by default
GATE_BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "quality_gate")
GATE_SEEDS = (123, 7, 21)
DEFAULT_ROOTS = ",".join(os.path.join(GATE_BASE, f"seed{s}")
                         for s in GATE_SEEDS)


def last_metric(path, key):
    if not os.path.exists(path):
        return None
    val = None
    pat = re.compile('"' + re.escape(key) + '": ([0-9.eE+-]+)')
    with open(path) as f:
        for line in f:
            m = pat.search(line)
            if m:
                val = float(m.group(1))
    return val


def arm_row(root, rp, dead=DEAD):
    with open(rp) as f:
        rep = json.load(f)
    arm = rep["arm"]
    scenes = rep["scenes"]
    mat = rep["val_mIoU"]
    n = len(scenes)
    live = [s for s in scenes if s not in dead]
    news_live = [mat[f"stage_{i}"][scenes[i]] for i in range(n)
                 if scenes[i] in live and f"stage_{i}" in mat]
    last = mat.get(f"stage_{n - 1}", {})
    # old scenes = every live scene except the NEWEST (scenes[n-1]); the
    # newest is excluded by name, not by slicing live[:-1], which would
    # wrongly drop the last live OLD scene whenever scenes[n-1] is dead
    olds_live = [last[s] for s in live
                 if s != scenes[n - 1] and s in last]
    nerf = []
    for i in range(n):
        mj = os.path.join(root, "experiments", arm, f"stage_{i}",
                          "metrics.jsonl")
        v = last_metric(mj, "test/nerf_mean_IoU")
        nerf.append(round(v, 4) if v is not None else None)
    return {
        "arm": arm,
        "new_scene_mIoU_mean": rep["new_scene_mIoU_mean"],
        "new_scene_mIoU_live": (sum(news_live) / len(news_live)
                                if news_live else None),
        "old_scene_final_live": (sum(olds_live) / len(olds_live)
                                 if olds_live else None),
        "nerf_test_mIoU_per_stage": nerf,
    }


def table(roots, dead=DEAD):
    """The table's rows, one an arm over the seed roots."""
    by_arm = {}
    for root in roots:
        for rp in sorted(glob.glob(os.path.join(root, "experiments",
                                                "report_*.json"))):
            row = arm_row(root, rp, dead)
            by_arm.setdefault(row["arm"], []).append(row)
    rows = []
    for arm, reps in by_arm.items():
        def mean_of(key):
            vals = [r[key] for r in reps if r[key] is not None]
            return round(sum(vals) / len(vals), 4) if vals else None
        out = {"arm": arm, "seeds": len(reps),
               "new_scene_mIoU_mean": mean_of("new_scene_mIoU_mean"),
               "new_scene_mIoU_live": mean_of("new_scene_mIoU_live"),
               "old_scene_final_live": mean_of("old_scene_final_live")}
        if len(reps) > 1:
            out["new_live_per_seed"] = [round(r["new_scene_mIoU_live"], 4)
                                        for r in reps]
            out["old_live_per_seed"] = [round(r["old_scene_final_live"], 4)
                                        for r in reps]
        else:
            out["nerf_test_mIoU_per_stage"] = reps[0][
                "nerf_test_mIoU_per_stage"]
        rows.append(out)
    return rows


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("-h", "--help"):
        print(__doc__)
        return None
    roots = (argv[0] if argv else DEFAULT_ROOTS).split(",")
    dead = frozenset(argv[1].split(",")) if len(argv) > 1 else DEAD
    rows = table(roots, dead)
    print(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
