"""The synthetic continual-learning quality gate as one resumable chain (the
port's counterpart of scripts/run_gate_r5.sh and scripts/run_gate_annex.sh),
on the card unless --device cpu:

  python -m ucsa_neural_rendering_tpu_torch.scripts.quality_gate \\
      [--base build/quality_gate] [--seeds 123,7,21] \\
      [--arms accel16x2,prop32e8x4] [--device cpu]

Per seed it runs exp_synthetic_cl's data phase and pretrain into
<base>/seed<s>, then the arms ARM-MAJOR across the seeds (every seed of an
arm before the next arm, so a chain cut short still gives a paired decision
for the arms it finished): for each, its three stages and its report, one
subprocess a phase, each phase's output in <base>/logs/<tag>.log. After
each arm-seed gate_decision runs over the seeds' roots into
<base>/decision.json, and at the end the table goes into <base>/table.json.

A phase that finished leaves <base>/logs/<tag>.ok, and a rerun of the same
command skips it, so the chain resumes where it stopped. A file
<base>/gate.stop halts the chain between phases (exit code 3); remove it
and rerun to continue. <base>/phases.jsonl records each phase's seconds;
a phase that outlasts PHASE_TIMEOUT fails with rc 124.

The gate's settings are the defaults: --scenes 3 --hw 120x160 --frames 8
--seg-tiny --nerf-epochs 10 --joint-epochs 5, pretrain 30 epochs; the
NeRF runs at full size (bound 4, 2^19 table, 4096 rays) on the device's
packing defaults. Arms (JAX's names):
  accel16x2    the incumbent, cl_replay_on (16 x 2, occupancy 32 + 32)
  enc8x4       --enc 8x4
  face8x4      --enc 8x4 --render-arm face
  enc8x4occ24  --enc 8x4 --occ-steps 24
  face16x2     --render-arm face
  prop32e8x4   --enc 8x4 --render-arm proposal --occ-steps 32 (the
               configuration the gate promoted: 8 x 4, 24 + 8)
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

from ..utils.device import resolve_device
from .gate_report_table import GATE_BASE, GATE_SEEDS
from .train_joint import ROOT_DIR

ARMS = {
    "accel16x2": [],
    "enc8x4": ["--enc", "8x4"],
    "face8x4": ["--enc", "8x4", "--render-arm", "face"],
    "enc8x4occ24": ["--enc", "8x4", "--occ-steps", "24"],
    "face16x2": ["--render-arm", "face"],
    "prop32e8x4": ["--enc", "8x4", "--render-arm", "proposal",
                   "--occ-steps", "32"],
}
MODULE = "ucsa_neural_rendering_tpu_torch.scripts."
STOPPED = 3  # the exit code after the stop file halted the chain
PHASE_TIMEOUT = 3600  # seconds a phase may take


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", default=GATE_BASE,
                    help="where the seeds' roots, logs and the decision go")
    ap.add_argument("--seeds", default=",".join(map(str, GATE_SEEDS)))
    ap.add_argument("--arms", default="accel16x2,prop32e8x4",
                    help="comma-separated, from: " + ", ".join(ARMS))
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--hw", default="120x160")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--pretrain-epochs", type=int, default=30)
    ap.add_argument("--nerf-epochs", type=int, default=10)
    ap.add_argument("--joint-epochs", type=int, default=5)
    ap.add_argument("--throughput-json", default="",
                    help="passed to gate_decision")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    unknown = [arm for arm in a.arms.split(",") if arm not in ARMS]
    if unknown:
        ap.error(f"unknown arms {unknown}; known: {', '.join(ARMS)}")
    return a


class Chain:
    """Runs tagged phases as subprocesses, each once (its .ok file)."""

    def __init__(self, base):
        self.base = base
        self.logs = os.path.join(base, "logs")
        os.makedirs(self.logs, exist_ok=True)

    def run(self, tag, argv, stdout_to=None, once=True):
        """Run `python -m MODULE<argv>` unless `once` and <tag>.ok exists.
        Returns True when the phase finished (now or before); exits STOPPED
        on the stop file. The phase's stdout goes to `stdout_to` when given,
        its log otherwise."""
        ok = os.path.join(self.logs, f"{tag}.ok")
        if once and os.path.exists(ok):
            print(f"[gate] skip {tag} (done)", flush=True)
            return True
        if os.path.exists(os.path.join(self.base, "gate.stop")):
            print("[gate] stop file - exiting", flush=True)
            sys.exit(STOPPED)
        print(f"[gate] {time.strftime('%H:%M:%S')} start {tag}", flush=True)
        log = os.path.join(self.logs, f"{tag}.log")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (ROOT_DIR, os.environ.get("PYTHONPATH")) if p))
        t0 = time.time()
        with contextlib.ExitStack() as files:
            out = files.enter_context(open(stdout_to or log, "w"))
            err = files.enter_context(open(log, "w")) if stdout_to \
                else subprocess.STDOUT
            try:
                rc = subprocess.run([sys.executable, "-m", MODULE + argv[0],
                                     *argv[1:]], stdout=out, stderr=err,
                                    cwd=ROOT_DIR, env=env,
                                    timeout=PHASE_TIMEOUT).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        seconds = time.time() - t0
        with open(os.path.join(self.base, "phases.jsonl"), "a") as f:
            f.write(json.dumps({"tag": tag, "rc": rc,
                                "seconds": round(seconds, 3)}) + "\n")
        if rc:
            print(f"[gate] {time.strftime('%H:%M:%S')} FAIL  {tag} "
                  f"(rc={rc}) - see {log}", flush=True)
            return False
        if once:
            with open(ok, "w") as f:
                f.write(f"{seconds:.3f}\n")
        print(f"[gate] {time.strftime('%H:%M:%S')} done  {tag} "
              f"({seconds:.1f} s)", flush=True)
        return True


def common_for(a, seed):
    return ["--root", os.path.join(a.base, f"seed{seed}"),
            "--scenes", str(a.scenes), "--hw", a.hw,
            "--frames", str(a.frames), "--seg-tiny",
            "--pretrain-epochs", str(a.pretrain_epochs),
            "--nerf-epochs", str(a.nerf_epochs),
            "--joint-epochs", str(a.joint_epochs), "--seed", str(seed),
            "--device", a.device]


def roots_of(a, seeds):
    return ",".join(os.path.join(a.base, f"seed{s}") for s in seeds)


def decide(chain, a, seeds):
    """gate_decision over the seeds' roots, in its own process, into
    <base>/decision.json; rerun each time, never skipped."""
    return chain.run("decision", ["gate_decision", roots_of(a, seeds),
                                  "--throughput-json", a.throughput_json],
                     stdout_to=os.path.join(a.base, "decision.json"),
                     once=False)


def main(argv=None):
    """Returns 0 when the chain ran to its end (STOPPED after the stop
    file, 1 after a failed phase)."""
    a = parse_args(argv)
    resolve_device(a.device)
    seeds = [int(s) for s in a.seeds.split(",")]
    arms = a.arms.split(",")
    a.base = os.path.abspath(a.base)
    chain = Chain(a.base)
    exp = "exp_synthetic_cl"
    for s in seeds:
        for phase in ("data", "pretrain"):
            if not chain.run(f"{phase}_s{s}",
                             [exp, *common_for(a, s), "--phase", phase]):
                return 1
    # arm-major: every seed of an arm before the next arm; the decision
    # after each arm-seed covers the arm-seeds done so far
    for arm in arms:
        for s in seeds:
            base_argv = [exp, *common_for(a, s), *ARMS[arm]]
            for i in range(a.scenes):
                if not chain.run(f"{arm}_seed{s}_s{i}",
                                 [*base_argv, "--phase", "stage",
                                  "--stage-idx", str(i)]):
                    return 1
            if not chain.run(f"{arm}_seed{s}_report",
                             [*base_argv, "--phase", "report"]):
                return 1
            if not decide(chain, a, seeds):
                return 1
    if not chain.run("table", ["gate_report_table", roots_of(a, seeds)],
                     stdout_to=os.path.join(a.base, "table.json"),
                     once=False):
        return 1
    print(f"[gate] chain complete; decision in "
          f"{os.path.join(a.base, 'decision.json')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
