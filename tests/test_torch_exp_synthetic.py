"""The synthetic continual-learning quality gate in the port
(scripts/exp_synthetic_cl.py, gate_report_table.py, gate_decision.py,
fit_synthetic.py and quality_gate.py under ucsa_neural_rendering_tpu_torch)
held to the JAX package's scripts, which are loaded by path and not edited:
the same flags, arm names, experiment dicts, render configs, parameter
shapes, data, reports, tables and decisions; the decision the gate took on
its TPU (gate_r5/decision.json) reproduced from its reports; a tiny
continual-learning run and a short fit on the CPU."""

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import shutil
import sys
import weakref
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucsa_neural_rendering_tpu_torch import kernels
from ucsa_neural_rendering_tpu_torch.data.image_io import read_png, read_rgb
from ucsa_neural_rendering_tpu_torch.data.splits import load_split
from ucsa_neural_rendering_tpu_torch.models import (deeplab_state_from_jax,
                                                    params_from_jax)
from ucsa_neural_rendering_tpu_torch.scripts import (exp_synthetic_cl,
                                                     fit_synthetic,
                                                     gate_decision,
                                                     gate_report_table,
                                                     quality_gate)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
GATE_R5 = REPO / "gate_r5"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU runs here are thousands of small ops: with one intra-op
    thread they do not spin against the other test processes' threads
    (with all of them each op waits on descheduled threads, and the file
    took 1236 s among six workers instead of 25 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_script(name):
    """A root script as a module, by path (scripts/ on sys.path only while
    it loads, for gate_decision's own import of gate_report_table)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


jexp = _load_script("exp_synthetic_cl")
jtable = _load_script("gate_report_table")
jdecision = _load_script("gate_decision")
jfit = _load_script("fit_synthetic")


def _jax_args(argv):
    """JAX's parse_args over argv (it reads sys.argv)."""
    saved = sys.argv
    sys.argv = ["exp_synthetic_cl.py", *argv]
    try:
        return jexp.parse_args()
    finally:
        sys.argv = saved


def _run_main(main, argv):
    """A JAX script's main over argv; its printed JSON."""
    saved = sys.argv
    sys.argv = ["script.py", *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            main()
    finally:
        sys.argv = saved
    return json.loads(buf.getvalue())


def _both_args(argv, device="cpu"):
    """(JAX's namespace, the port's) over the same flags."""
    return _jax_args(argv), exp_synthetic_cl.parse_args(
        [*argv, "--device", device])


def test_flags_and_defaults_match_jax():
    """Every flag of the JAX script with its default, plus --device (cuda
    by default); --root defaults under the repository's build/ where the
    JAX script's defaults to /tmp."""
    j = vars(_jax_args([]))
    p = vars(exp_synthetic_cl.parse_args([]))
    assert p.pop("device") == "cuda"
    assert p.pop("root") == str(REPO / "build" / "ucsa_cl_exp")
    assert j.pop("root") == "/tmp/ucsa_cl_exp"
    assert p == j
    argv = ["--root", "r", "--phase", "stage", "--stage-idx", "2",
            "--scenes", "4", "--hw", "48x64", "--frames", "6", "--tiny",
            "--seg-tiny", "--replay", "off", "--enc", "4x8",
            "--render-arm", "ladder", "--occ-steps", "16",
            "--pretrain-epochs", "3", "--pretrain-lr", "2e-3",
            "--nerf-epochs", "4", "--joint-epochs", "2",
            "--frame-gain", "0.1", "--pixel-noise", "0.02",
            "--lr-seg", "2e-5", "--lr-nerf", "3e-3", "--seed", "9"]
    j, p = _both_args(argv)
    assert vars(p) == dict(vars(j), device="cpu")


ARM_GRID = [(arm, occ, size)
            for arm in ("accel", "dense", "ladder", "face", "proposal")
            for occ in (24, 32) for size in ("tiny", "seg_tiny", "full")]


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arm,occ,size", ARM_GRID,
                         ids=[f"{a}-occ{o}-{s}" for a, o, s in ARM_GRID])
def test_arm_exps_and_render_cfg_match_jax(arm, occ, size, tmp_path):
    """arm_name, env_dict, pretrain_exp, joint_exp at each stage and
    render_cfg_for (field by field; the JAX RenderConfig's remat, which
    changes only memory, is the one field the port's lacks) equal JAX's,
    with replay on and off; the 8 x 4 encoding at occ-steps 24."""
    argv = ["--root", str(tmp_path), "--render-arm", arm,
            "--occ-steps", str(occ), "--hw", "120x160", "--seed", "7",
            "--enc", "8x4" if occ == 24 else "16x2"]
    if size != "full":
        argv.append(f"--{size.replace('_', '-')}")
    for replay in ("on", "off"):
        j, p = _both_args([*argv, "--replay", replay])
        assert exp_synthetic_cl.arm_name(p) == jexp.arm_name(j)
        assert exp_synthetic_cl.env_dict(p) == jexp.env_dict(j)
        assert exp_synthetic_cl.pretrain_exp(p) == jexp.pretrain_exp(j)
        for stage in range(3):
            assert exp_synthetic_cl.joint_exp(p, stage) == \
                jexp.joint_exp(j, stage)
    jc, pc = _fields(jexp.render_cfg_for(j)), \
        _fields(exp_synthetic_cl.render_cfg_for(p))
    assert set(jc) - set(pc) == {"remat"} and set(pc) <= set(jc)
    assert pc == {k: jc[k] for k in pc}


@pytest.mark.parametrize("arm", ["accel", "ladder", "face"])
def test_models_for_tiny_matches_jax_shapes(arm):
    """models_for --tiny: the port's models take JAX's parameters (numpy
    at the shapes jax.eval_shape gives JAX's init) through
    params_from_jax / deeplab_state_from_jax with strict loads, at equal
    shapes; the training encoder (stochastic_fwd), n_rays and the NeRF's
    geometry are JAX's."""
    j, p = _both_args(["--tiny", "--render-arm", arm])
    jseg, jkw = jexp.models_for(j)
    pseg, pkw = exp_synthetic_cl.models_for(p)
    assert pkw["seg_model"] is pseg and pkw["n_rays"] == jkw["n_rays"]
    jn, pn = jkw["nerf_model"], pkw["nerf_model"]
    for name in ("bound", "num_semantic_classes", "n_levels", "n_features",
                 "log2_hashmap_size", "stochastic_fwd"):
        assert getattr(pn, name) == getattr(jn, name), name
    zeros = lambda tree: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), tree)
    x = jnp.zeros((4, 3))
    nerf = zeros(jax.eval_shape(jn.init, jax.random.key(0), x, x))
    state = params_from_jax(nerf["params"])
    assert {k: v.shape for k, v in state.items()} == \
        {k: v.shape for k, v in pn.state_dict().items()}
    pn.load_state_dict(state)
    seg = zeros(jax.eval_shape(
        partial(jseg.init, use_running_average=False, deterministic=True),
        jax.random.key(0), jnp.zeros((1, 24, 32, 3))))
    state = deeplab_state_from_jax(seg["params"], seg["batch_stats"])
    assert {k: v.shape for k, v in state.items()} == \
        {k: v.shape for k, v in pseg.state_dict().items()}
    pseg.load_state_dict(state)


def _scene_files(root, scene):
    meta = json.loads((Path(root) / scene / "transforms_train.json")
                      .read_text())
    out = {"meta": {k: v for k, v in meta.items() if k != "frames"},
           "frames": meta["frames"]}
    for k, fr in enumerate(meta["frames"]):
        s = Path(root) / scene
        out[f"rgb{k}"] = read_rgb(str(s / fr["file_path"]))
        for sub in ("label_40_scaled", "label_scaled", "mapping_label",
                    "depth"):
            out[f"{sub}{k}"] = read_png(str(s / sub / f"{k}.png"))
    return out


def test_phase_data_matches_jax(tmp_path):
    """phase_data at 24 x 32, 2 scenes, 2 frames: the scenes' decoded
    colour, labels, depth and poses, the 25k corpus's decoded colour,
    labels and tsv, and both split files (paths relative to each root)
    equal JAX's."""
    roots = {}
    for name, mod in (("jax", jexp), ("port", exp_synthetic_cl)):
        roots[name] = tmp_path / name
        j, p = _both_args(["--root", str(roots[name]), "--hw", "24x32",
                           "--scenes", "2", "--frames", "2", "--seed", "5"])
        mod.phase_data(j if mod is jexp else p)
    scenes = exp_synthetic_cl.scene_names(2)
    for scene in scenes:
        a = _scene_files(roots["jax"] / "scans", scene)
        b = _scene_files(roots["port"] / "scans", scene)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            else:
                assert b[k] == a[k], k
    f25 = {n: r / "frames25k" for n, r in roots.items()}
    assert (f25["port"] / "scannetv2-labels.combined.tsv").read_bytes() == \
        (f25["jax"] / "scannetv2-labels.combined.tsv").read_bytes()
    files = sorted(p.relative_to(f25["jax"])
                   for p in f25["jax"].rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(f25["port"])
                           for p in f25["port"].rglob("*") if p.is_file())
    for rel in files:
        a, b = f25["jax"] / rel, f25["port"] / rel
        if rel.suffix == ".jpg":
            np.testing.assert_array_equal(read_rgb(str(b)), read_rgb(str(a)))
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(read_png(str(b)), read_png(str(a)))
    for name in ("split.npz", "split_cl.npz"):
        a, b = (load_split(str(f25[n] / name)) for n in ("jax", "port"))
        assert a.keys() == b.keys() == {"train", "val", "test", "train_cl"}
        for k in a:
            rel = lambda arr, r: [os.path.relpath(str(x), str(r))
                                  for x in arr]
            assert rel(b[k], f25["port"]) == rel(a[k], f25["jax"]), k
        assert len(a["val"]) == int(0.25 * 2 * 2 * 2)


SCENES = ("scene0000_00", "scene0001_00", "scene0002_00")
FIXTURE_ARMS = {"accel": [], "prop": ["--enc", "8x4", "--render-arm",
                                      "proposal"],
                "occ24": ["--enc", "8x4", "--occ-steps", "24"]}


def _write_stages(root, arm, rng, nerf=True, missing=()):
    """final_val.json a stage (random mIoU on every scene) and, with
    `nerf`, metrics.jsonl lines holding test/nerf_mean_IoU, the last
    wins; stages in `missing` are left out."""
    for i in range(len(SCENES)):
        if i in missing:
            continue
        d = root / "experiments" / arm / f"stage_{i}"
        d.mkdir(parents=True)
        (d / "final_val.json").write_text(json.dumps(
            {s: {"mIoU": float(rng.uniform()), "total_acc": 0.5,
                 "mean_acc": 0.5} for s in SCENES}))
        if nerf:
            with open(d / "metrics.jsonl", "w") as f:
                for v in rng.uniform(size=3):
                    f.write(json.dumps({"test/nerf_mean_IoU": float(v),
                                        "step": 1}) + "\n")


def _report_roots(tmp_path, seeds=(1, 2)):
    """Seed roots whose reports the JAX script's phase_report wrote, each
    arm over the same three scenes (in seed 2 the proposal arm lacks its
    stage 1 and carries no metrics.jsonl)."""
    roots = []
    for seed in seeds:
        root = tmp_path / f"seed{seed}"
        rng = np.random.default_rng(seed)
        for tag, extra in FIXTURE_ARMS.items():
            j = _jax_args(["--root", str(root), *extra])
            missing = (1,) if seed == 2 and tag == "prop" else ()
            _write_stages(root, jexp.arm_name(j), rng,
                          nerf=missing == (), missing=missing)
            with contextlib.redirect_stdout(io.StringIO()):
                jexp.phase_report(j)
        roots.append(root)
    return roots


def test_phase_report_and_table_match_jax(tmp_path):
    """phase_report writes JAX's report file byte for byte from the same
    stage files (one stage missing included); arm_row and the table over
    seed roots (with the default and another dead-scene set, the newest
    scene dead) equal JAX's."""
    roots = _report_roots(tmp_path)
    for root in roots:
        for tag, extra in FIXTURE_ARMS.items():
            j, p = _both_args(["--root", str(root), *extra])
            path = root / "experiments" / f"report_{jexp.arm_name(j)}.json"
            ref = path.read_bytes()
            with contextlib.redirect_stdout(io.StringIO()):
                out = exp_synthetic_cl.phase_report(p)
            assert path.read_bytes() == ref
            assert out == json.loads(ref)
            for dead in (gate_report_table.DEAD,
                         frozenset(["scene0002_00"])):
                assert gate_report_table.arm_row(str(root), str(path),
                                                 dead) == \
                    jtable.arm_row(str(root), str(path), dead)
    joined = ",".join(map(str, roots))
    for extra in ([], ["scene0002_00"]):
        ref = _run_main(jtable.main, [joined, *extra])
        with contextlib.redirect_stdout(io.StringIO()):
            assert gate_report_table.main([joined, *extra]) == ref
        with contextlib.redirect_stdout(io.StringIO()):
            assert gate_report_table.main([str(roots[0]), *extra]) == \
                _run_main(jtable.main, [str(roots[0]), *extra])


def test_decision_matches_jax(tmp_path):
    """With a throughput file that names every arm, gate_decision equals
    JAX's whole decision (promote included) at two thresholds; without one
    (JAX then falls back on its TPU constants) the deltas, per-seed lists,
    seeds and passes_gate equal JAX's, and rays_per_sec and promote are
    null."""
    roots = ",".join(map(str, _report_roots(tmp_path)))
    tp = tmp_path / "tp.json"
    tp.write_text(json.dumps({
        "enc_16x2": {"rays_per_sec": 1000.0},
        "enc_8x4_prop32": {"rays_per_sec": 3000.0},
        "enc_8x4_occ24": {"rays_per_sec": 2000.0}}))
    for threshold in ("0.5", "40"):
        argv = [roots, "--threshold", threshold, "--throughput-json",
                str(tp)]
        with contextlib.redirect_stdout(io.StringIO()):
            assert gate_decision.main(argv) == _run_main(jdecision.main,
                                                         argv)
    ref = _run_main(jdecision.main, [roots, "--throughput-json", ""])
    with contextlib.redirect_stdout(io.StringIO()):
        got = gate_decision.main([roots])
    assert got["incumbent_rays_per_sec"] is None and got["promote"] is None
    assert ref["incumbent_rays_per_sec"] is not None
    by_arm = {c["arm"]: c for c in ref["candidates"]}
    assert sorted(by_arm) == [c["arm"] for c in got["candidates"]]
    for c in got["candidates"]:
        assert c.pop("rays_per_sec") is None
        assert c == {k: v for k, v in by_arm[c["arm"]].items()
                     if k != "rays_per_sec"}
    assert not hasattr(gate_decision, "THROUGHPUT")


def test_decision_reproduces_the_tpu_gate():
    """From gate_r5's three seed roots (the reports the gate wrote on its
    TPU), the port's decision gives gate_r5/decision.json's deltas,
    per-seed lists, seeds and passes_gate for every candidate, exactly.
    Reads those files, writes nothing."""
    ref = json.loads((GATE_R5 / "decision.json").read_text())
    roots = [str(GATE_R5 / f"seed{s}") for s in (123, 7, 21)]
    got = gate_decision.decide(roots, ref["threshold_pts"])
    keys = ("seeds", "delta_new_live_pts", "delta_old_live_pts",
            "per_seed_new_pts", "per_seed_old_pts", "passes_gate")
    want = {c["arm"]: {k: c[k] for k in keys} for c in ref["candidates"]}
    assert {c["arm"]: {k: c[k] for k in keys}
            for c in got["candidates"]} == want
    assert want["cl_replay_on_proposal_enc8x4"]["per_seed_new_pts"] == \
        [1.06, 3.07, -0.37]


def test_phase_all_tiny_on_the_cpu(tmp_path, monkeypatch):
    """--phase all --tiny --device cpu (2 scenes of 5 frames at 24 x 32,
    1 epoch each; 5 frames give each scene one val frame, where 3 give
    none): the 2 x 2 report is finite and in [0, 1], each stage's
    metrics.jsonl holds test/nerf_mean_IoU, the table reads it, and each
    stage's JointTrainer is gone before the next stage starts and after
    the last."""
    from ucsa_neural_rendering_tpu_torch.train import joint_loop
    train = joint_loop.train
    trainers = []

    def recording(*args, **kw):
        gc.collect()
        assert all(r() is None for r in trainers), "a stage is still held"
        trainer, grid = train(*args, **kw)
        trainers.append(weakref.ref(trainer))
        return trainer, grid

    monkeypatch.setattr(joint_loop, "train", recording)
    root = tmp_path / "cl"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        exp_synthetic_cl.main(["--root", str(root), "--tiny", "--device",
                               "cpu", "--scenes", "2", "--frames", "5",
                               "--hw", "24x32", "--pretrain-epochs", "1",
                               "--nerf-epochs", "1", "--joint-epochs", "1"])
    gc.collect()
    assert len(trainers) == 2 and all(r() is None for r in trainers)
    assert out.getvalue().count("kernel launches: {}") == 2
    rep = json.loads((root / "experiments" / "report_cl_replay_on.json")
                     .read_text())
    mat = rep["val_mIoU"]
    assert sorted(mat) == ["stage_0", "stage_1"]
    for row in mat.values():
        assert sorted(row) == list(exp_synthetic_cl.scene_names(2))
        assert all(math.isfinite(v) and 0 <= v <= 1 for v in row.values())
    for i in range(2):
        stage = root / "experiments" / "cl_replay_on" / f"stage_{i}"
        assert '"test/nerf_mean_IoU": ' in (stage / "metrics.jsonl") \
            .read_text()
        assert (stage / "deeplab_ckpt").exists()
    row = gate_report_table.arm_row(
        str(root), str(root / "experiments" / "report_cl_replay_on.json"))
    assert len(row["nerf_test_mIoU_per_stage"]) == 2
    assert all(0 <= v <= 1 for v in row["nerf_test_mIoU_per_stage"])


class _Built(Exception):
    pass


def test_fit_synthetic_matches_jax_and_runs(monkeypatch):
    """fit_synthetic's model, render config (field by field) and trainer
    (lr, n_rays, image size) are the JAX script's, as its main builds them
    (stopped at the trainer); its defaults are the same; two steps on the
    CPU give a finite PSNR, an accuracy in [0, 1] and each step's losses
    (step 0's as printed), and the same inside kernels.plain_versions()."""
    import ucsa_neural_rendering_tpu.train as jtrain
    seen = {}

    def trainer(model, cfg, lr, n_rays, image_hw):
        seen.update(model=model, cfg=cfg, lr=lr, n_rays=n_rays,
                    image_hw=tuple(image_hw))
        raise _Built

    monkeypatch.setattr(jtrain, "NeRFTrainer", trainer)
    monkeypatch.setattr(sys, "argv", ["fit_synthetic.py"])
    with pytest.raises(_Built):
        jfit.main()
    args = fit_synthetic.parse_args([])
    assert (args.steps, tuple(args.hw), args.device) == (
        120, (32, 40), "cuda")
    model, cfg, tr = fit_synthetic.build(tuple(args.hw), "cpu")
    for name in ("bound", "num_semantic_classes", "n_levels", "n_features",
                 "log2_hashmap_size", "base_resolution", "stochastic_fwd"):
        assert getattr(model, name) == getattr(seen["model"], name), name
    jc, pc = _fields(seen["cfg"]), _fields(cfg)
    assert pc == {k: jc[k] for k in pc}
    assert (tr.lr, tr.n_rays, (tr.H, tr.W)) == (
        seen["lr"], seen["n_rays"], seen["image_hw"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fit_synthetic.main(["--device", "cpu", "--steps", "2"])
        with kernels.plain_versions():
            plain = fit_synthetic.main(["--device", "cpu", "--steps", "2"])
    assert math.isfinite(res["psnr"]) and 0 <= res["acc"] <= 1
    assert "PSNR" in out.getvalue() and "step    1" in out.getvalue()
    losses = res["losses"]
    assert sorted(losses) == ["loss_depth", "loss_nerf_rgb",
                              "loss_nerf_semantics", "loss_nerf_total"]
    assert all(len(v) == 2 and all(map(math.isfinite, v))
               for v in losses.values())
    assert (f"step    0  rgb {losses['loss_nerf_rgb'][0]:.4f}  sem "
            f"{losses['loss_nerf_semantics'][0]:.4f}  depth "
            f"{losses['loss_depth'][0]:.4f}") in out.getvalue()
    # on CPU tensors the wrappers take the plain versions anyway
    assert plain == dict(res, seconds=plain["seconds"])


def _fake_chain(monkeypatch):
    """quality_gate's subprocess.run replaced: records each command's
    arguments (calls) and fails those `fail` picks (rc 5)."""
    calls, fail = [], [lambda cmd: False]

    def fake_run(cmd, **kw):
        calls.append(cmd[3:])
        return type("Done", (), {"returncode": 5 if fail[0](cmd) else 0})

    monkeypatch.setattr(quality_gate.subprocess, "run", fake_run)
    return calls, fail


def _phase(c):
    return (c[c.index("--seed") + 1], c[c.index("--phase") + 1],
            c[c.index("--enc") + 1] if "--enc" in c else "16x2",
            c[c.index("--stage-idx") + 1] if "--stage-idx" in c else None)


GATE_ORDER = [
    ("7", "data", "16x2", None), ("7", "pretrain", "16x2", None),
    ("21", "data", "16x2", None), ("21", "pretrain", "16x2", None),
    ("7", "stage", "16x2", "0"), ("7", "stage", "16x2", "1"),
    ("7", "report", "16x2", None),
    ("21", "stage", "16x2", "0"), ("21", "stage", "16x2", "1"),
    ("21", "report", "16x2", None),
    ("7", "stage", "8x4", "0"), ("7", "stage", "8x4", "1"),
    ("7", "report", "8x4", None),
    ("21", "stage", "8x4", "0"), ("21", "stage", "8x4", "1"),
    ("21", "report", "8x4", None)]


def test_quality_gate_chain_order_resume_and_stop(tmp_path, monkeypatch):
    """quality_gate runs data and pretrain per seed, then each arm's stages
    and report arm-major over the seeds with JAX's arm flags, one
    subprocess a phase with --device passed on, the decision after every
    arm-seed and the table at the end; a rerun skips every phase that left
    its .ok (only the decisions and the table run again); the stop file
    halts it with exit code 3 before the next phase; a failed phase stops
    it with 1 and nothing after it runs."""
    calls, fail = _fake_chain(monkeypatch)
    base = tmp_path / "gate"
    argv = ["--base", str(base), "--seeds", "7,21", "--arms",
            "accel16x2,prop32e8x4", "--device", "cpu", "--scenes", "2"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert quality_gate.main(argv) == 0
    runs = [c for c in calls if "--phase" in c]
    assert [_phase(c) for c in runs] == GATE_ORDER
    prop = runs[-1]
    assert prop[prop.index("--render-arm") + 1] == "proposal"
    assert prop[prop.index("--occ-steps") + 1] == "32"
    for c in runs:
        assert c[c.index("--device") + 1] == "cpu" and "--seg-tiny" in c
        assert c[c.index("--hw") + 1] == "120x160"
        assert c[c.index("--nerf-epochs") + 1] == "10"
        assert c[c.index("--joint-epochs") + 1] == "5"
        assert c[c.index("--pretrain-epochs") + 1] == "30"
        assert c[c.index("--frames") + 1] == "8"
    roots = f"{base}/seed7,{base}/seed21"
    decisions = [c for c in calls if c[0] == roots]
    assert len(decisions) == 4 + 1  # every arm-seed's, the table
    assert calls[-1] == [roots] and calls[-2][0] == roots
    assert len((base / "phases.jsonl").read_text().splitlines()) == \
        len(calls)
    calls.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        assert quality_gate.main(argv) == 0
    assert all("--phase" not in c for c in calls) and len(calls) == 5
    calls.clear()
    shutil.rmtree(base / "logs")
    (base / "gate.stop").write_text("")
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(SystemExit) as stop:
        quality_gate.main(argv)
    assert stop.value.code == quality_gate.STOPPED and not calls
    (base / "gate.stop").unlink()
    fail[0] = lambda cmd: "--stage-idx" in cmd and "--enc" not in cmd \
        and cmd[cmd.index("--seed") + 1] == "21"
    with contextlib.redirect_stdout(io.StringIO()):
        assert quality_gate.main(argv) == 1
    assert [_phase(c) for c in calls if "--phase" in c] == GATE_ORDER[:8]


def test_quality_gate_stops_at_a_phase_past_its_time(tmp_path,
                                                     monkeypatch):
    """A phase that outlasts PHASE_TIMEOUT is recorded with rc 124, leaves
    no .ok and stops the chain with 1: the first pretrain here, so no
    stage runs."""
    calls = []

    def fake_run(cmd, timeout, **kw):
        calls.append(cmd[3:])
        assert timeout == quality_gate.PHASE_TIMEOUT
        if "pretrain" in cmd:
            raise quality_gate.subprocess.TimeoutExpired(cmd, timeout)
        return type("Done", (), {"returncode": 0})

    monkeypatch.setattr(quality_gate.subprocess, "run", fake_run)
    base = tmp_path / "gate"
    with contextlib.redirect_stdout(io.StringIO()):
        assert quality_gate.main(["--base", str(base), "--seeds", "7,21",
                                  "--device", "cpu"]) == 1
    assert [_phase(c) for c in calls] == GATE_ORDER[:2]
    lines = [json.loads(line) for line in
             (base / "phases.jsonl").read_text().splitlines()]
    assert [(p["tag"], p["rc"]) for p in lines] == [("data_s7", 0),
                                                    ("pretrain_s7", 124)]
    assert sorted(os.listdir(base / "logs")) == [
        "data_s7.log", "data_s7.ok", "pretrain_s7.log"]


def test_quality_gate_passes_its_throughput_file_to_each_decision(
        tmp_path, monkeypatch):
    """--throughput-json reaches every gate_decision run, after every
    arm-seed, and each decision's stdout lands in <base>/decision.json."""
    calls, _ = _fake_chain(monkeypatch)
    base = tmp_path / "gate"
    with contextlib.redirect_stdout(io.StringIO()):
        assert quality_gate.main(["--base", str(base), "--seeds", "7",
                                  "--arms", "accel16x2,prop32e8x4",
                                  "--scenes", "2", "--device", "cpu",
                                  "--throughput-json", "bench.json"]) == 0
    decisions = [c for c in calls if "--throughput-json" in c]
    assert decisions == [[f"{base}/seed7", "--throughput-json",
                          "bench.json"]] * 2
    assert (base / "decision.json").exists()


def test_quality_gate_knows_jax_arm_names():
    """The chain's arm flags are the JAX chains' (run_gate_r5.sh,
    run_gate_annex.sh): each arm gives the arm_name the JAX script
    derives; unknown arms are refused."""
    names = {
        "accel16x2": "cl_replay_on", "enc8x4": "cl_replay_on_enc8x4",
        "face8x4": "cl_replay_on_face_enc8x4",
        "enc8x4occ24": "cl_replay_on_enc8x4_occ24",
        "face16x2": "cl_replay_on_face",
        "prop32e8x4": "cl_replay_on_proposal_enc8x4"}
    for arm, flags in quality_gate.ARMS.items():
        assert jexp.arm_name(_jax_args(flags)) == names[arm]
    assert sorted(quality_gate.ARMS) == sorted(names)
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit):
        quality_gate.parse_args(["--arms", "accel16x2,nope"])
