"""Write the scannet_frames_25k split files (the port's counterpart of
scripts/create_split.py; ref: nr4seg/dataset/create_split.py):
`split_file` (train / val / test / train_cl) and `split_file_cl`
(train_cl alone) under the environment's scannet_frames_25k folder, from
the frames the experiment's data_module.root and image_regex glob:

  python -m ucsa_neural_rendering_tpu_torch.scripts.create_split \\
      [--config cfg/exp/pretrain_scannet_25k_deeplabv3.yml] [--seed N]

A continual-learning run (cl.active: true) cannot start without
split_file_cl.
"""

import argparse
import os

from ..config import load_exp_and_env
from ..data import create_split, save_split
from .train_joint import ROOT_DIR


def main(argv=None):
    """Returns (the split path, the continual-learning split path)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config",
                    default="cfg/exp/pretrain_scannet_25k_deeplabv3.yml")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    exp, env, _, _ = load_exp_and_env(ROOT_DIR, args.config)
    cfg = exp["data_module"]
    pre = cfg["data_preprocessing"]
    split = create_split(cfg["root"], pre["image_regex"], pre["val_ratio"],
                         seed=args.seed)
    out = os.path.join(env["scannet_frames_25k"], pre["split_file"])
    save_split(split, out)
    out_cl = os.path.join(env["scannet_frames_25k"],
                          pre.get("split_file_cl", "split_cl.npz"))
    save_split({"train_cl": split["train_cl"]}, out_cl)
    print(f"wrote {out} ({len(split['train'])} train / {len(split['val'])} "
          f"val) and {out_cl}")
    return out, out_cl


if __name__ == "__main__":
    main()
