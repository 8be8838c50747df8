"""The port stands alone: it imports neither jax nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ucsa_neural_rendering_tpu_torch as port

PKG = Path(port.__file__).resolve().parent
MODULES = sorted(p for p in PKG.rglob("*.py"))
# the port's smoke run on the card, at the repository's root
CHIP_SMOKE = PKG.parent / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "ucsa_neural_rendering_tpu")


def _module_name(path: Path) -> str:
    rel = path.relative_to(PKG.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def test_port_imports_without_jax():
    """Import every port module in a fresh interpreter where jax (and the
    JAX package) cannot be imported at all."""
    names = [_module_name(p) for p in MODULES]
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{m!r}] = None" for m in FORBIDDEN),
        "import importlib",
        f"for name in {names!r}:",
        "    importlib.import_module(name)",
        "print('ok', len(sys.modules))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_never_uses_the_repository_native_loader(tmp_path):
    """The port's native loader is its own (data/native_loader.py builds
    its copy of the source into build/torch_native/): in a fresh
    interpreter where the repository's `native` package cannot be
    imported, every port module imports, the loader builds and loads, and
    a PNG reads through it, while an audit hook sees no open, run or
    dlopen of anything under the repository's native/ (build.py,
    libucsa_loader.so, ucsa_loader.cpp); no port module's source imports
    `native`."""
    for path in MODULES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] == "native" for n in names), path
    names = [_module_name(p) for p in MODULES]
    native = str(PKG.parent / "native")
    code = "\n".join([
        "import sys",
        f"NATIVE = {native!r}",
        "seen = []",
        "def hook(event, args):",
        "    if event in ('open', 'subprocess.Popen', 'ctypes.dlopen'):",
        "        flat = args[1] if event == 'subprocess.Popen' else args[:1]",
        "        if any(str(a).startswith(NATIVE) for a in flat):",
        "            seen.append((event, str(args[0])))",
        "sys.addaudithook(hook)",
        "sys.modules['native'] = None",
        "sys.modules['native.build'] = None",
        "import importlib",
        f"for name in {names!r}:",
        "    importlib.import_module(name)",
        "from ucsa_neural_rendering_tpu_torch.data import native_loader",
        "from ucsa_neural_rendering_tpu_torch.data.image_io import write_png",
        "import numpy as np",
        "assert native_loader.status()['available']",
        f"p = {str(tmp_path / 'l.png')!r}",
        "write_png(p, np.arange(12, dtype=np.uint8).reshape(3, 4))",
        "assert (native_loader.load_label(p, 4, 3) ==",
        "        np.arange(12).reshape(3, 4)).all()",
        "assert not seen, seen",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# libraries the JAX package's data layer and loop import (cv2, imageio,
# PyYAML, wandb) or that a JPEG read may use, none of which the card's
# machine is known to have: the port must not need them to import, to read
# its configs or to read and write PNGs, and its logger never tries wandb
THIRD_PARTY = ("cv2", "yaml", "imageio", "PIL", "torchvision", "pandas",
               "wandb")
_BLOCK_IMPORTS = "\n".join([
    "import sys",
    "class _Refuse:",
    "    seen = []",
    "    def find_spec(self, name, path=None, target=None):",
    f"        if name.split('.')[0] in {THIRD_PARTY!r}:",
    "            _Refuse.seen.append(name)",
    "            raise ImportError(name)",
    "sys.meta_path.insert(0, _Refuse())",
    *(f"sys.modules.pop({m!r}, None)" for m in THIRD_PARTY),
])


def test_port_imports_no_image_or_yaml_library():
    """Importing every port module (the CLI included) attempts none of
    cv2, PyYAML, imageio, PIL, torchvision or pandas: a JPEG decoder is
    imported only inside the JPEG read."""
    names = [_module_name(p) for p in MODULES]
    code = "\n".join([
        _BLOCK_IMPORTS,
        "import importlib",
        f"for name in {names!r}:",
        "    importlib.import_module(name)",
        "assert not _Refuse.seen, _Refuse.seen",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_configs_and_pngs_need_no_third_party_library(tmp_path):
    """In a fresh interpreter where cv2, PyYAML, imageio, PIL, torchvision
    and pandas cannot be imported, the port loads cfg/ experiments and the
    environment, writes the synthetic scene with PNG colour and reads its
    frames through ScanNetNGPJoint, attempting none of them."""
    code = "\n".join([
        _BLOCK_IMPORTS,
        "from ucsa_neural_rendering_tpu_torch.config import "
        "load_exp_and_env",
        "from ucsa_neural_rendering_tpu_torch.data import ScanNetNGPJoint",
        "from ucsa_neural_rendering_tpu_torch.data.synthetic import "
        "write_synthetic_scene_dir",
        "exp, env, _, _ = load_exp_and_env("
        f"{str(PKG.parent)!r}, 'cfg/exp/one_step_joint/s00_lr1e-5.yml')",
        "assert exp['optimizer']['lr_seg'] == 1e-5 and env['results']",
        f"write_synthetic_scene_dir({str(tmp_path)!r}, n_frames=5, H=8, "
        "W=10, color_ext='.png')",
        f"ds = ScanNetNGPJoint({str(tmp_path)!r}, ['scene0000_00'], "
        "output_size=(8, 10))",
        "item = ds[0]",
        "assert item['img'].shape == (8, 10, 3) and item['depth'].max() > 0",
        "assert not _Refuse.seen, _Refuse.seen",
        f"assert not [m for m in sys.modules if m.split('.')[0] in "
        f"{THIRD_PARTY!r}]",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# the continual-learning data layer, its test set, cl_driver and its CLIs
CL_MODULES = ("ucsa_neural_rendering_tpu_torch.data.label_loader",
              "ucsa_neural_rendering_tpu_torch.data.scannet",
              "ucsa_neural_rendering_tpu_torch.data.cl_mixers",
              "ucsa_neural_rendering_tpu_torch.data.synthetic",
              "ucsa_neural_rendering_tpu_torch.train.seg_eval",
              "ucsa_neural_rendering_tpu_torch.train.cl_driver",
              "ucsa_neural_rendering_tpu_torch.scripts.cl_deeplab",
              "ucsa_neural_rendering_tpu_torch.scripts.create_split")


def test_cl_modules_need_no_jax_or_image_library(tmp_path):
    """In a fresh interpreter where jax, the JAX package, cv2, PIL,
    imageio, pandas, PyYAML, torchvision and wandb cannot be imported, the
    continual-learning modules import, LabelLoaderAuto reads the label tsv
    (csv) and decodes a MAPPED and a FAST label PNG, rescale_to_canonical
    shrinks a ScanNet-25k-sized frame, and a stage's MetricsLogger logs a
    record and an image, attempting none of them."""
    code = "\n".join([
        _BLOCK_IMPORTS,
        *(f"sys.modules[{m!r}] = None" for m in FORBIDDEN),
        "import importlib",
        f"mods = [importlib.import_module(m) for m in {CL_MODULES!r}]",
        "import numpy as np",
        "from ucsa_neural_rendering_tpu_torch.data import LabelLoaderAuto",
        "from ucsa_neural_rendering_tpu_torch.data import "
        "rescale_to_canonical",
        "from ucsa_neural_rendering_tpu_torch.data.image_io import "
        "write_png",
        f"root = {str(tmp_path)!r}",
        "open(root + '/scannetv2-labels.combined.tsv', 'w').write("
        "'id\\tnyu40id\\n3\\t7\\n9\\t40\\n')",
        "write_png(root + '/m.png', np.array([[3, 9], [0, 3]], np.uint16))",
        "write_png(root + '/f.png', np.array([[1, 2]], np.uint8))",
        "loader = LabelLoaderAuto(root)",
        "lab, how = loader.get(root + '/m.png')",
        "assert how == 'MAPPED' and lab.tolist() == [[7, 40], [0, 7]]",
        "assert loader.get(root + '/f.png')[1] == 'FAST'",
        "img, (lab,) = rescale_to_canonical(np.zeros((968, 1296, 3), "
        "np.float32), [np.zeros((968, 1296), np.float32)])",
        "assert img.shape == (288, 385, 3) and lab.shape == (288, 385)",
        "from ucsa_neural_rendering_tpu_torch.utils import MetricsLogger",
        "log = MetricsLogger(root + '/run', project_name='p')",
        "log.log({'a': 1.0})",
        "log.log_image('v/x', np.zeros((2, 3, 3), np.uint8))",
        "log.close()",
        "assert not _Refuse.seen, _Refuse.seen",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_cl_cli_defaults_to_the_card(monkeypatch):
    """The protocol's CLI defaults --device to cuda, and without a card it
    raises before reading anything."""
    from ucsa_neural_rendering_tpu_torch.scripts import cl_deeplab
    assert cl_deeplab.parse_args([]).device == "cuda"
    assert cl_deeplab.parse_args(["--device", "cpu"]).device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cl_deeplab.main(["--exp", "does/not/exist.yml"])


# the pretrain and finetune loops, their dataset and their CLIs
LOOP_MODULES = ("ucsa_neural_rendering_tpu_torch.data.scannet_ngp",
                "ucsa_neural_rendering_tpu_torch.train.pretrain_loop",
                "ucsa_neural_rendering_tpu_torch.train.finetune_loop",
                "ucsa_neural_rendering_tpu_torch.scripts.pretrain",
                "ucsa_neural_rendering_tpu_torch.scripts.train_finetune")


def test_loop_modules_need_no_jax_or_image_library(tmp_path):
    """In a fresh interpreter where jax, the JAX package, cv2, PIL,
    imageio, pandas, PyYAML, torchvision and wandb cannot be imported, the
    loop modules and CLIs import, the pretrain experiment loads, and
    ScanNetNGP reads a training item from a NeRF-only stage's PNG dumps,
    attempting none of them (the scene's JPEG frames are written here,
    outside that interpreter)."""
    from ucsa_neural_rendering_tpu_torch.data.synthetic import \
        write_synthetic_scene_dir
    from ucsa_neural_rendering_tpu_torch.train import joint_loop
    scene = write_synthetic_scene_dir(str(tmp_path), n_frames=5, H=8, W=10)
    folder = f"{scene}/one_step_nerf_only"
    joint_loop.make_predict_dirs(folder)
    for k in range(5):
        joint_loop.write_predict_outputs(
            folder, {"viewpoint_is_novel": False, "current_index": str(k)},
            {"nerf_rgb": np.full((8, 10, 3), 0.5, np.float32),
             "nerf_semantics": np.full((8, 10), k), "seg_semantics":
             np.zeros((8, 10), np.int64)})
    code = "\n".join([
        _BLOCK_IMPORTS,
        *(f"sys.modules[{m!r}] = None" for m in FORBIDDEN),
        "import importlib",
        f"mods = [importlib.import_module(m) for m in {LOOP_MODULES!r}]",
        "from ucsa_neural_rendering_tpu_torch.config import "
        "load_exp_and_env",
        "exp, env, _, _ = load_exp_and_env("
        f"{str(PKG.parent)!r}, 'cfg/exp/pretrain_scannet_25k_deeplabv3.yml')",
        "assert exp['trainer']['max_epochs'] == 150",
        "from ucsa_neural_rendering_tpu_torch.data import ScanNetNGP",
        f"ds = ScanNetNGP({str(tmp_path)!r}, ['scene0000_00'], "
        "output_size=(8, 10), seed=0)",
        "img, label, _ = ds[3]",
        "assert len(ds) == 4 and img.shape == (8, 10, 3)",
        "assert ((label == 3) | (label == -1)).all() and (label == 3).any()",
        "assert not _Refuse.seen, _Refuse.seen",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("cli", ["pretrain", "train_finetune"])
def test_loop_clis_default_to_the_card(cli, monkeypatch, capsys):
    """The pretrain and finetune CLIs take the JAX package's flags with its
    defaults and --device cuda by default; without a card they raise
    before reading anything, and so do their loops called with args that
    name no device; --help names TF32."""
    import argparse
    import importlib
    mod = importlib.import_module(f"ucsa_neural_rendering_tpu_torch.scripts."
                                  f"{cli}")
    args = mod.parse_args([])
    assert (args.device, args.seed) == ("cuda", 123)
    if cli == "pretrain":
        assert (args.exp, args.project_name) == (
            "cfg/exp/pretrain_scannet_25k_deeplabv3.yml", "pretrain")
    else:
        assert (args.exp, args.project_name, args.prev_exp_name) == (
            "cfg/exp/one_step_finetune_nerf/s00_lr1e-5.yml", "finetune",
            "one_step_nerf_only")
    assert mod.parse_args(["--device", "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        mod.parse_args(["--help"])
    assert "TF32" in " ".join(capsys.readouterr().out.split())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--exp", "does/not/exist.yml"])
    from ucsa_neural_rendering_tpu_torch.train import (finetune_loop,
                                                       pretrain_loop)
    loop = pretrain_loop if cli == "pretrain" else finetune_loop
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train({"general": {"name": "never"}, "model": {
            "num_classes": 3}}, {}, argparse.Namespace(seed=0))


@pytest.mark.parametrize("loop", ["pretrain_loop", "finetune_loop"])
def test_loops_refuse_seg_bf16(loop, monkeypatch):
    """model.compute_dtype: bfloat16 raised NotImplementedError until seg
    bf16 compute was ported. The same config now passes the dtype and the
    loop goes on to set the run up (stopped there: the config names no
    data; tests/test_torch_loops.py runs both loops at bf16); a name that
    is not a floating dtype raises ValueError before anything is read."""
    import argparse
    import importlib
    mod = importlib.import_module(f"ucsa_neural_rendering_tpu_torch.train."
                                  f"{loop}")

    class Reached(Exception):
        pass

    def stop(*a, **kw):
        raise Reached

    monkeypatch.setattr(mod, "setup_experiment", stop)
    exp = {"general": {"name": "never"},
           "model": {"num_classes": 3, "compute_dtype": "bfloat16"}}
    args = argparse.Namespace(seed=0, device="cpu")
    with pytest.raises(Reached):
        mod.train(exp, {}, args)
    exp["model"]["compute_dtype"] = "int8"
    with pytest.raises(ValueError, match="compute_dtype"):
        mod.train(exp, {}, args)


# the synthetic continual-learning quality gate's CLIs
GATE_MODULES = tuple(f"ucsa_neural_rendering_tpu_torch.scripts.{m}" for m in (
    "exp_synthetic_cl", "gate_report_table", "gate_decision",
    "fit_synthetic", "quality_gate"))


def test_gate_modules_need_no_jax_or_image_library():
    """In a fresh interpreter where jax, the JAX package, cv2, PIL,
    imageio, pandas, PyYAML, torchvision and wandb cannot be imported, the
    gate's five CLIs import and the decision reads reports (none here)
    without a throughput of its own, attempting none of them."""
    code = "\n".join([
        _BLOCK_IMPORTS,
        *(f"sys.modules[{m!r}] = None" for m in FORBIDDEN),
        "import importlib",
        f"mods = [importlib.import_module(m) for m in {GATE_MODULES!r}]",
        "d = mods[2].decide(['no/such/root'])",
        "assert d['candidates'] == [] and d['promote'] is None",
        "assert d['incumbent_rays_per_sec'] is None",
        "assert not hasattr(mods[2], 'THROUGHPUT')",
        "assert not _Refuse.seen, _Refuse.seen",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("cli", ["exp_synthetic_cl", "fit_synthetic",
                                 "quality_gate"])
def test_gate_clis_default_to_the_card(cli, monkeypatch, tmp_path):
    """The gate's CLIs that run a model default --device to cuda, and
    without a card they raise before writing anything."""
    import importlib
    mod = importlib.import_module(f"ucsa_neural_rendering_tpu_torch.scripts."
                                  f"{cli}")
    assert mod.parse_args([]).device == "cuda"
    assert mod.parse_args(["--device", "cpu"]).device == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    argv = {"exp_synthetic_cl": ["--root", str(out)],
            "quality_gate": ["--base", str(out)]}.get(cli, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
    assert not out.exists()


@pytest.mark.parametrize("path", MODULES + [CHIP_SMOKE],
                         ids=lambda p: _module_name(p))
def test_module_names_no_jax(path):
    """No import statement of a port module or of chip_smoke.py names jax,
    its libraries or the JAX package (the name
    `ucsa_neural_rendering_tpu_torch` itself is allowed)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.name} imports {name}"


def _entry_points():
    from ucsa_neural_rendering_tpu_torch.data.rays import get_rays
    from ucsa_neural_rendering_tpu_torch.models import SemanticNeRF
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.models.semantic_nerf import (
        _FusedStyleMLP)
    from ucsa_neural_rendering_tpu_torch.models import (TINY_LAYOUT,
                                                        DeepLabV3)
    from ucsa_neural_rendering_tpu_torch.ops.occupancy import init_grid
    from ucsa_neural_rendering_tpu_torch.train import (JointTrainer,
                                                       NeRFTrainer,
                                                       SegTrainer)
    from ucsa_neural_rendering_tpu_torch.data.augmentation import (
        draw_augment_params)
    import numpy as np
    small = dict(bound=1.0, num_semantic_classes=3, n_levels=2,
                 log2_hashmap_size=10)
    seg = dict(num_classes=3, backbone_layout=TINY_LAYOUT, aspp_channels=4,
               head_channels=4)
    return {
        "DeepLabV3": lambda **kw: DeepLabV3(**seg, **kw),
        "SegTrainer": lambda **kw: SegTrainer(
            DeepLabV3(**seg, device="cpu"), {"name": "Adam", "lr": 1e-3},
            **kw),
        "SemanticNeRF": lambda **kw: SemanticNeRF(**small, **kw),
        "HashGridEncoding": lambda **kw: he.HashGridEncoding(
            he.make_spec(2, 2, 10, 16, 1.5), **kw),
        "_FusedStyleMLP": lambda **kw: _FusedStyleMLP(15, 64, 1, 3, **kw),
        "NeRFTrainer": lambda **kw: NeRFTrainer(
            SemanticNeRF(**small, device="cpu"), image_hw=(2, 2), **kw),
        "init_grid": lambda **kw: init_grid(**kw),
        "get_rays": lambda **kw: get_rays(
            np.eye(4, dtype=np.float32), [2.0, 2.0, 1.0, 1.0], 2, 2, **kw),
        "JointTrainer": lambda **kw: JointTrainer(
            {"optimizer": {"lr_seg": 1e-5}}, image_hw=(2, 2), num_classes=3,
            nerf_model=SemanticNeRF(**small, device="cpu"),
            seg_model=DeepLabV3(**seg, device="cpu"), **kw),
        "draw_augment_params": lambda **kw: draw_augment_params(
            torch.Generator(), 2, (4, 4), (3, 3), **kw),
    }


@pytest.mark.parametrize("name", ["SemanticNeRF", "NeRFTrainer", "init_grid",
                                  "get_rays", "HashGridEncoding",
                                  "_FusedStyleMLP", "DeepLabV3",
                                  "SegTrainer", "JointTrainer",
                                  "draw_augment_params"])
def test_entry_points_default_to_cuda(name, monkeypatch):
    """Without a card, an entry point (or a module the model is built of)
    called with its default device raises; with device="cpu" it runs on the
    CPU."""
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(device="cuda")
    out = make(device="cpu")
    tensors = {"init_grid": lambda o: [o],
               "get_rays": lambda o: list(o.values()),
               "SemanticNeRF": lambda o: list(o.parameters()),
               "HashGridEncoding": lambda o: list(o.parameters()),
               "_FusedStyleMLP": lambda o: list(o.parameters()),
               "NeRFTrainer": lambda o: list(o.model.parameters()),
               "DeepLabV3": lambda o: list(o.state_dict().values()),
               "SegTrainer": lambda o: list(o.model.state_dict().values()),
               "JointTrainer": lambda o: [
                   *o.nerf.model.parameters(),
                   *o.seg.model.state_dict().values()],
               "draw_augment_params": lambda o: list(o.values())
               }[name](out)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("option", ["use_occupancy", "compute_dtype", "mesh",
                                    "no_grid"])
def test_joint_trainer_raises_for_unported_options(option, tmp_path):
    """JointTrainer refused the dense program (nerf.use_occupancy: false,
    or a render without a grid) and seg bf16 compute, naming ROADMAP queue
    1 item 5, and mesh= sharding, naming item 7, until they were ported;
    all four now run: the trainer builds, under use_occupancy: false
    without a grid and with its test and predict configs the train config,
    under compute_dtype: bfloat16 with its default seg net at bf16
    compute, and renders a frame without a grid (tests/test_torch_opt_in.py
    holds them to JAX). mesh= over a one-rank gloo group renders and takes
    a joint step bit-equal to mesh=None (tests/test_torch_parallel.py holds
    two ranks to one)."""
    from ucsa_neural_rendering_tpu_torch.models import (TINY_LAYOUT,
                                                        DeepLabV3,
                                                        SemanticNeRF)
    from ucsa_neural_rendering_tpu_torch.ops.renderer import RenderConfig
    from ucsa_neural_rendering_tpu_torch.train import JointTrainer
    exp = {"optimizer": {"lr_seg": 1e-5},
           "nerf": {"use_occupancy": option != "use_occupancy"},
           "model": {"compute_dtype": "bfloat16"
                     if option == "compute_dtype" else None}}
    make = lambda mesh=None: JointTrainer(
        exp, image_hw=(2, 2), num_classes=3, device="cpu",
        render_cfg=RenderConfig(num_steps=8, upsample_steps=8),
        nerf_model=SemanticNeRF(bound=1.0, num_semantic_classes=3,
                                n_levels=2, log2_hashmap_size=10,
                                device="cpu"),
        seg_model=None if option == "compute_dtype" else DeepLabV3(
            num_classes=3, backbone_layout=TINY_LAYOUT, aspp_channels=4,
            head_channels=4, device="cpu"),
        mesh=mesh)
    if option == "mesh":
        _one_rank_mesh_equals_none(make, tmp_path)
        return
    trainer = make()
    if option == "use_occupancy":
        assert trainer.init_occupancy() is None
        assert trainer.test_cfg == trainer.predict_cfg == trainer.cfg
    if option == "compute_dtype":
        assert trainer.seg.model.compute_dtype == torch.bfloat16
    out = trainer.render_frames(np.eye(4, dtype=np.float32)[None],
                                [2.0, 2.0, 1.0, 1.0], occ_grid=None)
    assert out["nerf_rgb"].shape == (1, 2, 2, 3)
    assert all(torch.isfinite(v.float()).all() for v in out.values())


def _one_rank_mesh_equals_none(make, tmp_path):
    """A frame and a joint step of trainers built alike, one with mesh=
    over a one-rank gloo group, one without: the same bits."""
    import torch.distributed as dist
    from ucsa_neural_rendering_tpu_torch.parallel import get_mesh, shutdown
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        outs = []
        for mesh in (get_mesh("cpu"), None):
            trainer = make(mesh)
            trainer.init()
            frame = trainer.render_frames(
                np.eye(4, dtype=np.float32)[None], [2.0, 2.0, 1.0, 1.0],
                occ_grid=None)
            rng = np.random.default_rng(0)
            new = {"img": rng.uniform(0, 1, (2, 2, 2, 3)).astype(np.float32),
                   "depth": np.full((2, 2, 2), 0.5, np.float32),
                   "pose": np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
                   "intrinsics": np.tile(np.array([2.0, 2.0, 1.0, 1.0],
                                                  np.float32), (2, 1)),
                   "one_m_to_scene_uom": np.ones(2, np.float32)}
            logs = trainer.joint_step(None, new, None,
                                      torch.Generator().manual_seed(1))
            outs.append((frame, logs, trainer.nerf.model.state_dict(),
                         trainer.seg.model.state_dict()))
    finally:
        shutdown()
    for a, b in zip(*outs):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_kernel_wrappers_take_plain_path_on_cpu():
    """On CPU tensors the wrappers never build or launch a kernel."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.bench.dma_gather import dma_gather
    from ucsa_neural_rendering_tpu_torch.models import (hash_encode_bwd,
                                                        hash_encode_sampled,
                                                        make_spec, mlp_bwd,
                                                        mlp_fwd)
    from ucsa_neural_rendering_tpu_torch.ops import (composite_bwd,
                                                     composite_fwd,
                                                     importance_resample,
                                                     occ_grid_update,
                                                     occ_placement,
                                                     stratified_placement)
    kernels.reset_launches()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    assert stratified_placement(o, d, 1.0, 8, 0.2,
                                torch.rand(4, 8)).shape == (4, 8)
    z = occ_placement(o, d, torch.ones((8, 8, 8)), 1.0, 8, 16)
    new_z, z_all, order = importance_resample(z, torch.ones_like(z), 4)
    sigma = torch.ones_like(z_all)
    image, sem, depth = composite_fwd(z_all, sigma,
                                      torch.rand(4, 12, 3),
                                      torch.rand(4, 12, 5), torch.ones(4))
    assert image.shape == (4, 3) and sem.shape == (4, 5)
    d_sigma, _, _ = composite_bwd(z_all, sigma, torch.rand(4, 12, 3),
                                  torch.rand(4, 12, 5), torch.ones(4),
                                  torch.ones(4, 3), torch.ones(4, 5),
                                  torch.ones(4))
    assert d_sigma.shape == (4, 12)
    spec = make_spec(2, 2, 10, 16, 1.5)
    x01 = torch.rand(6, 3)
    assert hash_encode_bwd(x01, torch.ones(6, 4, dtype=torch.bfloat16), spec,
                           True).shape == (spec.table_size, 2)
    assert hash_encode_sampled(torch.ones(spec.table_size, 2,
                                          dtype=torch.bfloat16),
                               x01, spec).shape == (6, 4)
    assert occ_grid_update(torch.ones((8, 8, 8)), torch.zeros(128), 128,
                           0.5).shape == (8, 8, 8)
    from ucsa_neural_rendering_tpu_torch.models.packed_table import (
        build_packed_table, hash_encode_packed)
    packed = build_packed_table(torch.rand(spec.table_size, 2), spec, 1,
                                "fp8")
    assert packed.data.shape == (16 ** 3, 16)
    for mode in ("exact", "probe", "face"):
        assert hash_encode_packed(torch.ones(spec.table_size, 2,
                                             dtype=torch.bfloat16),
                                  packed, x01, spec, mode).shape == (6, 4)
    weights = [torch.rand(64, 15), torch.rand(5, 64)]
    x = torch.rand(6, 15, dtype=torch.bfloat16)
    assert mlp_fwd(x, weights).shape == (6, 5)
    dx, dws = mlp_bwd(x, weights, torch.ones(6, 5, dtype=torch.bfloat16))
    assert dx.shape == (6, 15) and [w.shape for w in dws] == [(64, 15),
                                                                (5, 64)]
    table = torch.rand(10, 2)
    assert torch.equal(dma_gather(table, torch.tensor([3, 0, 9],
                                                      dtype=torch.int32)),
                       table[[3, 0, 9]])
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    assert not kernels._LIBS


def test_plain_versions_swaps_every_call_site_and_restores():
    """kernels.plain_versions() points each call site of the render and
    training paths at its kernel's plain version, one site per kernel of
    those paths (every kernel but the gather benchmark's), and puts the
    wrappers back on leaving, on an error too; plain_versions(*names)
    swaps only the sites named."""
    from ucsa_neural_rendering_tpu_torch import kernels
    from ucsa_neural_rendering_tpu_torch.models import hash_encoding as he
    from ucsa_neural_rendering_tpu_torch.models import packed_table as pt
    from ucsa_neural_rendering_tpu_torch.models import semantic_nerf as sn
    from ucsa_neural_rendering_tpu_torch.ops import compositing as cp
    from ucsa_neural_rendering_tpu_torch.ops import occupancy as oc
    from ucsa_neural_rendering_tpu_torch.ops import placement as pl
    from ucsa_neural_rendering_tpu_torch.ops import renderer as rr
    sites = {(he, "hash_encode"): he.hash_encode_plain,
             (he, "hash_encode_bwd"): he.hash_encode_bwd_plain,
             (he, "hash_encode_sampled"): he.hash_encode_sampled_plain,
             (he, "hash_encode_face"): he.hash_encode_face_plain,
             (pt, "hash_encode_packed"): pt.hash_encode_packed_plain,
             (sn, "build_packed_table"): pt.build_packed_table_plain,
             (sn, "mlp_fwd"): sn.mlp_fwd_plain,
             (sn, "mlp_bwd"): sn.mlp_bwd_plain,
             (rr, "occ_placement"): pl.occ_placement_plain,
             (rr, "stratified_placement"): pl.stratified_placement_plain,
             (rr, "importance_resample"): pl.importance_resample_plain,
             (cp, "composite_fwd"): cp.composite_fwd_plain,
             (cp, "composite_bwd"): cp.composite_bwd_plain,
             (oc, "occ_grid_update"): oc.occ_grid_update_plain}
    # one site per kernel but dma_gather (only its benchmark calls it)
    assert len(sites) == len(kernels._CALL_SITES) == \
        len(kernels.SIGNATURES) - 1
    wrappers = {site: getattr(*site) for site in sites}
    with pytest.raises(KeyError):
        with kernels.plain_versions():
            for site, plain in sites.items():
                assert getattr(*site) is plain
            raise KeyError("leave the block")
    for site, fn in wrappers.items():
        assert getattr(*site) is fn
    with kernels.plain_versions("mlp_fwd", "mlp_bwd"):
        for site, plain in sites.items():
            swapped = site[1] in ("mlp_fwd", "mlp_bwd")
            assert (getattr(*site) is plain) == swapped
    for site, fn in wrappers.items():
        assert getattr(*site) is fn
    with pytest.raises(ValueError, match="dma_gather"):
        with kernels.plain_versions("dma_gather"):
            pass


@pytest.mark.parametrize("lost", ["no_device_events", "the_counted_call",
                                  "some_timed_events", "the_window",
                                  "the_count_range", "every_try",
                                  "nothing_but_the_device_clock",
                                  "the_first_calls",
                                  "nothing_but_the_host_clock",
                                  "nothing_but_a_shared_id"])
def test_device_ms_retakes_a_profile_that_lost_device_events(monkeypatch,
                                                             lost):
    """device_ms counts the device operations of one call (k) and times
    those of `iters` calls, each operation placed by its correlation id
    between the ids of three marks (the host calls that record a CUDA
    event, in call order: before the counted call, between it and the
    timed calls, after them), not by any timestamp. A profile that lost a
    mark (the window's closing one, the counted call's opening one), the
    counted call or some of the timed calls' operations (here 7 of 4 calls
    × 2) is taken again, and when every try comes back short it raises;
    so is one that lost the device operations of its first calls while
    their launches are all there, as an H100's profiler did (the first
    call's, the counted call's and the first timed call's). A device clock
    mapped milliseconds off the host's, host events stamped anywhere, and
    an earlier host event that shares an operation's id all place nothing
    wrong; each try pads its profile twice as long as the one before and
    makes SETTLE_CALLS calls after the pad, before its first mark."""
    import time
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from ucsa_neural_rendering_tpu_torch import bench

    def event(us, start, device=DeviceType.CUDA, name="kernel", id=0):
        return SimpleNamespace(name=name, device_type=device, id=id,
                               is_user_annotation=False,
                               time_range=SimpleNamespace(
                                   start=start, end=start + us,
                                   elapsed_us=lambda: us))

    ids = iter(range(100, 1000))
    # host timestamps (µs); "nothing_but_the_host_clock" stamps them all 0
    host_t = (lambda t: 0.0) if lost == "nothing_but_the_host_clock" \
        else (lambda t: t)

    def launch(us, host_start, device_start, name="kernel"):
        """A device operation of `us` and the host call that launched it,
        with the next correlation id."""
        i = next(ids)
        return [event(0.0, host_t(host_start), DeviceType.CPU,
                      "cudaLaunchKernel", i),
                event(us, device_start, name=name, id=i)]

    def mark(host_start):
        # the name the card's profiler gives Event.record's host call
        return event(0.0, host_t(host_start), DeviceType.CPU,
                     "cudaEventRecordWithFlags", next(ids))

    # device timestamps as the profiler maps them, here up to 1.5 ms before
    # their own launch, as one card's profiler did
    off = {"nothing_but_the_device_clock": -5000.0}.get(lost, -1500.0)
    first = launch(9.0, 10.0, 10.0 + off)             # may be lost
    opened = mark(1002.0)
    counted = launch(7.0, 1005.0, 1005.0 + off) \
        + launch(7.0, 1020.0, 1080.0 + off)
    between = mark(1030.0)
    timed = [e for c in range(4) for j in range(2)
             for e in launch(3.0, 2005.0 + 10 * c + j, 2900.0 + 5 * c + j)]
    closed = mark(2090.0)
    good = first + [opened] + counted + [between] + timed + [closed]
    if lost == "nothing_but_a_shared_id":
        # an earlier host event carries the counted call's first id
        good = [event(0.0, 5.0, DeviceType.CPU, "cudaStreamIsCapturing",
                      counted[0].id)] + good
    short = {"no_device_events": [e for e in good
                                  if e.device_type == DeviceType.CPU],
             "the_counted_call": first + [opened, between] + timed
             + [closed],
             "some_timed_events": good[:-2] + good[-1:],
             "the_window": good[:-1],
             "the_count_range": [e for e in good if e is not opened],
             "every_try": good[:-2] + good[-1:],
             # the launches all there, the device operations of the first
             # call, the counted call and the first timed call lost
             "the_first_calls": [e for e in good if e not in (
                 first[1], counted[1], counted[3], timed[1], timed[3])]
             }.get(lost, good)

    profiles = []

    class FakeProfile:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def events(self):
            return profiles.pop(0)

    class FakeEvent:
        def record(self):
            pass

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    monkeypatch.setattr(bench, "PROFILES", {"taken": 0, "short": 0})
    calls = []
    if lost == "every_try":
        profiles[:] = [short] * bench.PROFILE_TRIES
        with pytest.raises(RuntimeError, match=r"k = 2, 7 in the window "
                           r"\(2 and 8 host calls into CUDA\)"):
            bench.device_ms(lambda: calls.append(1), iters=4, warmup=0)
        assert len(calls) == bench.PROFILE_TRIES * (
            2 + bench.SETTLE_CALLS + 4) and not profiles
        assert sleeps == [bench.PAD_S * 2 ** i
                          for i in range(bench.PROFILE_TRIES) for _ in "ab"]
        assert bench.PROFILES == {"taken": bench.PROFILE_TRIES,
                                  "short": bench.PROFILE_TRIES}
        return
    profiles[:] = [short, good]
    assert bench.device_ms(lambda: calls.append(1), iters=4,
                           warmup=1) == pytest.approx(6e-3)
    taken = 1 if short is good else 2
    assert len(calls) == 1 + taken * (2 + bench.SETTLE_CALLS + 4) \
        and len(profiles) == 2 - taken
    assert bench.PROFILES == {"taken": taken, "short": taken - 1}
    # by name: the timed calls' operations of each name, per call
    split = good[:good.index(between) + 1] + [
        e for c in range(4) for e in launch(3.0, 2005.0 + c, 1900.0 + c)
        + launch(1.0, 2050.0 + c, 1950.0 + c, "reduce")] + [mark(2095.0)]
    profiles[:] = [split]
    assert bench.device_ms(lambda: None, iters=4, warmup=0, by_name=True) \
        == pytest.approx({"kernel": 3e-3, "reduce": 1e-3})


def test_gather_benchmark_needs_the_card(monkeypatch):
    """The gather benchmark measures the card: without one it raises, and
    it refuses the CPU."""
    from ucsa_neural_rendering_tpu_torch.bench import dma_gather as bg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bg.measure(m=8, t=4)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bg.measure(m=8, t=4, device="cpu")
