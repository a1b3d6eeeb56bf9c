"""python -m deepsee_torch.train: the training entry point of the port (the
flags of the root train.py that this slice serves).

    python -m deepsee_torch.train --name 8x_independent_256x256 \
        --image_dir /data/CelebAMask-HQ/train_img --label_dir /data/CelebAMask-HQ/train_label
    python -m deepsee_torch.train --name 8x_independent_256x256 --synthetic --max_steps 20

Runs on the card unless --device cpu is given, and raises without one.  The
flags of slices not ported yet are refused with a message naming the slice:
mesh and multi-host flags (multi-GPU), remat.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from deepsee_torch.config import get_preset

# flag -> the slice it waits for
_LATER = {
    "data_axis": "the multi-GPU slice", "model_axis": "the multi-GPU slice",
    "dcn_axis": "the multi-GPU slice", "multihost": "the multi-GPU slice",
    "partition": "the multi-GPU slice",
    "remat": "a later PR (a recompute would advance the batch statistics twice)",
    "remat_policy": "a later PR (a recompute would advance the batch statistics twice)",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--name", default="8x_independent_256x256", help="preset name")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--niter", type=int, default=None)
    p.add_argument("--niter_decay", type=int, default=None)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--image_dir", default="")
    p.add_argument("--label_dir", default="")
    p.add_argument("--image_dir_val", default="")
    p.add_argument("--label_dir_val", default="")
    p.add_argument("--identities_file", default="",
                   help="CelebAMask-HQ identities CSV or CelebA identity_CelebA.txt (guided)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic samples instead of the preset's dataset")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--compute_dtype", default=None, choices=("bfloat16", "float32"))
    p.add_argument("--vgg_weights", default="",
                   help="torchvision vgg19 state dict (.pth/.npz) for the perceptual loss; "
                        "random features and a warning without it")
    p.add_argument("--evaluation_freq", type=int, default=None,
                   help="samples between in-training evaluations (FID, LPIPS, PSNR, SSIM, "
                        "MS-SSIM, RMSE on a shuffled copy of the training set); 0 disables "
                        "them")
    p.add_argument("--evaluate_val_set", action="store_true",
                   help="also evaluate --image_dir_val / --label_dir_val at each evaluation")
    p.add_argument("--num_evaluation_samples", type=int, default=None,
                   help="samples per in-training evaluation")
    p.add_argument("--inception_weights", default="",
                   help="pt_inception-2015-12-05 state dict (.pth) for the FID; random "
                        "Inception weights without it (FIDs comparable only with each other)")
    p.add_argument("--alexnet_weights", default="",
                   help="torchvision AlexNet state dict (.pth) for LPIPS; random weights "
                        "without it")
    p.add_argument("--reuse_fake", action="store_true",
                   help="train D on the G step's fake instead of regenerating it with the "
                        "updated G (an opt-in deviation from the reference's schedule)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag in ("partition", "remat_policy"):
        p.add_argument(f"--{flag}", default=None, help=f"not ported: {_LATER[flag]}")
    for flag in ("data_axis", "model_axis", "dcn_axis"):
        p.add_argument(f"--{flag}", type=int, default=None, help=f"not ported: {_LATER[flag]}")
    for flag in ("multihost", "remat"):
        p.add_argument(f"--{flag}", action="store_true", default=None,
                       help=f"not ported: {_LATER[flag]}")
    args = p.parse_args(argv)
    for flag, slice_name in _LATER.items():
        if getattr(args, flag) is not None:
            p.error(f"--{flag} belongs to {slice_name} of the port, which this package "
                    "does not have yet")
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from deepsee_torch.train.loop import Trainer

    exp = get_preset(args.name)
    data = dataclasses.replace(
        exp.data, dataset="synthetic" if args.synthetic else exp.data.dataset,
        image_dir=args.image_dir, label_dir=args.label_dir, image_dir_val=args.image_dir_val,
        label_dir_val=args.label_dir_val, identities_file=args.identities_file)
    train = exp.train
    for field, value in (("batch_size", args.batch_size), ("lr", args.lr),
                         ("niter", args.niter), ("niter_decay", args.niter_decay),
                         ("evaluation_freq", args.evaluation_freq),
                         ("num_evaluation_samples", args.num_evaluation_samples)):
        if value is not None:
            train = dataclasses.replace(train, **{field: value})
    train = dataclasses.replace(train, vgg_weights=args.vgg_weights,
                                inception_weights=args.inception_weights,
                                alexnet_weights=args.alexnet_weights,
                                evaluate_val_set=args.evaluate_val_set or train.evaluate_val_set,
                                reuse_fake=args.reuse_fake or train.reuse_fake)
    model = exp.model
    if args.compute_dtype:
        model = dataclasses.replace(model, compute_dtype=args.compute_dtype)
    exp = exp.replace(data=data, train=train, model=model, checkpoints_dir=args.checkpoints_dir)
    trainer = Trainer(exp, device=args.device, continue_train=args.continue_train)
    state = trainer.run(max_steps=args.max_steps)
    print(f"trained {state.step} steps on {trainer.system.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
