"""Quality-gate decision: paired per-seed deltas against the incumbent (the
port's counterpart of scripts/gate_decision.py; it reads the same report
files, written by either package, and runs nothing on a device).

The gate criterion: the FASTEST arm whose live new-scene and old-scene seg
mIoU are within --threshold (0.5) points of the incumbent (accel16x2,
`cl_replay_on`) is promoted. Single-seed inter-arm spreads on this protocol
are over a point, so the comparison is PAIRED: each seed root holds every
arm run on identical data from an identical pretrain checkpoint, and the
decision statistic is the mean over seeds of the within-seed delta.

One departure from the JAX script: it carries no throughput of its own.
The JAX script's THROUGHPUT constants and its default --throughput-json
list are rays/s measured on a TPU, so they are left out. Throughput comes
only from the files the caller names ({tag: {"rays_per_sec": x}}, the
result tags mapped to arms by _BENCH_TAG_TO_ARM). Without one, every
candidate's rays_per_sec is null and promote is null; passes_gate is
computed all the same.

Usage:
  python -m ucsa_neural_rendering_tpu_torch.scripts.gate_decision \\
      root1[,root2,...] [--threshold 0.5] [--throughput-json a.json,...]
"""

import argparse
import glob
import json
import os

from .gate_report_table import arm_row

INCUMBENT = "cl_replay_on"

# benchmark result tag -> gate arm name
_BENCH_TAG_TO_ARM = {
    "enc_16x2": "cl_replay_on",
    "enc_8x4": "cl_replay_on_enc8x4",
    "enc_4x8_sfwd": "cl_replay_on_ladder_enc4x8",
    "enc_4x8_sfwd_full": "cl_replay_on_ladder_enc4x8",
    "enc_16x2_sfwd": "cl_replay_on_ladder",
    "enc_16x2_sfwd_full": "cl_replay_on_ladder",
    "enc_16x2_sfwd_face": "cl_replay_on_face",
    "enc_4x8_sfwd_face": "cl_replay_on_face_enc4x8",
    "enc_8x4_sfwd_face": "cl_replay_on_face_enc8x4",
    "enc_8x4_occ24": "cl_replay_on_enc8x4_occ24",
    "enc_8x4_prop32": "cl_replay_on_proposal_enc8x4",
}


def read_throughput(paths):
    """{arm: rays/s} from the named {tag: {rays_per_sec}} files that exist
    (a later file's tag wins)."""
    tp = {}
    for path in paths:
        if not path or not os.path.exists(path):
            continue
        with open(path) as f:
            extra = json.load(f)
        for tag, arm in _BENCH_TAG_TO_ARM.items():
            if tag in extra:
                tp[arm] = extra[tag]["rays_per_sec"]
    return tp


def decide(roots, threshold=0.5, tp=None):
    """The decision over the seed roots, as the JAX script prints it; tp:
    {arm: rays/s} (read_throughput), or None."""
    tp = tp or {}
    per_seed = []  # [{arm: row}]
    for root in roots:
        rows = {}
        for rp in sorted(glob.glob(os.path.join(root, "experiments",
                                                "report_*.json"))):
            row = arm_row(root, rp)
            rows[row["arm"]] = row
        per_seed.append(rows)

    arms = sorted({arm for rows in per_seed for arm in rows})
    out = []
    for arm in arms:
        if arm == INCUMBENT:
            continue
        dn, do = [], []
        for rows in per_seed:
            if arm in rows and INCUMBENT in rows:
                dn.append(rows[arm]["new_scene_mIoU_live"]
                          - rows[INCUMBENT]["new_scene_mIoU_live"])
                do.append(rows[arm]["old_scene_final_live"]
                          - rows[INCUMBENT]["old_scene_final_live"])
        if not dn:
            continue
        mean_dn = 100 * sum(dn) / len(dn)  # in mIoU points
        mean_do = 100 * sum(do) / len(do)
        passes = mean_dn >= -threshold and mean_do >= -threshold
        out.append({
            "arm": arm, "seeds": len(dn),
            "delta_new_live_pts": round(mean_dn, 2),
            "delta_old_live_pts": round(mean_do, 2),
            "per_seed_new_pts": [round(100 * d, 2) for d in dn],
            "per_seed_old_pts": [round(100 * d, 2) for d in do],
            "rays_per_sec": tp.get(arm),
            "passes_gate": passes,
        })
    out.sort(key=lambda r: -(r["rays_per_sec"] or 0))
    # promotion also requires being FASTER than the incumbent: a
    # quality-passing but slower (or unmeasured) arm never replaces it
    incumbent_tp = tp.get(INCUMBENT)
    passing = [r for r in out if r["passes_gate"] and r["rays_per_sec"]
               and incumbent_tp and r["rays_per_sec"] > incumbent_tp]
    return {
        "incumbent": INCUMBENT,
        "incumbent_rays_per_sec": incumbent_tp,
        "threshold_pts": threshold,
        "candidates": out,
        "promote": passing[0]["arm"] if passing else None,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="max allowed mean paired regression, in mIoU points")
    ap.add_argument("--throughput-json", default="",
                    help="comma-separated measured throughputs "
                         "{tag: {rays_per_sec}}; none by default")
    a = ap.parse_args(argv)
    decision = decide(a.roots.split(","), a.threshold,
                      read_throughput(a.throughput_json.split(",")))
    print(json.dumps(decision, indent=2))
    return decision


if __name__ == "__main__":
    main()
