"""python -m deepsee_torch.train: the training entry point of the port (the
flags of the root train.py that this slice serves).

    python -m deepsee_torch.train --name 8x_independent_256x256 \
        --image_dir /data/CelebAMask-HQ/train_img --label_dir /data/CelebAMask-HQ/train_label
    python -m deepsee_torch.train --name 8x_independent_256x256 --synthetic --max_steps 20

Runs on the card unless --device cpu is given, and raises without one.

Data parallelism over N cards, one process each (--batch_size stays the
global batch; each rank reads its stripe, batch_size / N samples a step):

    torchrun --nproc_per_node N -m deepsee_torch.train --multihost --data_axis N ...

--multihost joins the process group torchrun's environment describes (NCCL
on the card, gloo with --device cpu); --data_axis x --dcn_axis x
--model_axis must equal the world size (the first two count data-parallel
ranks here).  Tensor parallelism over M ranks per data index, each holding
column/row shards of the wide convs (the JAX package's --model_axis):

    torchrun --nproc_per_node D*M -m deepsee_torch.train --multihost --data_axis D --model_axis M ...

Spatial sharding over M ranks per data index, each holding a horizontal
stripe of every map and the whole networks (M must divide start_size and
crop_size / 16; the JAX package's --partition spatial):

    torchrun --nproc_per_node D*M -m deepsee_torch.train --multihost --data_axis D \
        --model_axis M --partition spatial ...

--remat rematerializes the generator's blocks in the backward
(--remat_policy full: each block recomputed whole; convs: the conv outputs
kept, the rest recomputed), as the 32x 512^2 preset trains:

    python -m deepsee_torch.train --name 32x_guided_512x512 --synthetic --batch_size 8 --remat
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional

from deepsee_torch.config import MeshConfig, get_preset

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
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK with --multihost) or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of torchrun's environment (NCCL on the card, "
                        "gloo on the CPU); one process per card, batch_size stays global")
    p.add_argument("--data_axis", type=int, default=1,
                   help="data-parallel ranks (with --dcn_axis: their product is the world)")
    p.add_argument("--dcn_axis", type=int, default=1,
                   help="data-parallel ranks across hosts; here the same as --data_axis")
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel ranks per data index (column/row shards of the convs)")
    p.add_argument("--partition", default="tensor", choices=("tensor", "spatial"),
                   help="how --model_axis is used: tensor (column/row shards of the convs) "
                        "or spatial (horizontal stripes of every map)")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing of the generator's blocks (the reference's "
                        "--efficient)")
    p.add_argument("--remat_policy", default="full", choices=("full", "convs"),
                   help="full: recompute whole blocks (least memory); convs: keep the conv "
                        "outputs, recompute the norms, activations and modulation convs")
    args = p.parse_args(argv)
    mesh = mesh_config(args)
    try:
        mesh.check_ported(get_preset(args.name).model if mesh.spatial else None)
    except ValueError as e:
        p.error(f"--{e}")
    return args


def mesh_config(args: argparse.Namespace) -> MeshConfig:
    return MeshConfig(data_axis=args.data_axis, model_axis=args.model_axis,
                      partition=args.partition, dcn_axis=args.dcn_axis)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from deepsee_torch.parallel import distributed

    with distributed.joined(args.multihost, args.device) as device:
        return _train(args, device)


def _train(args: argparse.Namespace, device) -> int:
    from deepsee_torch.parallel import distributed
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
                                reuse_fake=args.reuse_fake or train.reuse_fake,
                                remat=args.remat or train.remat,
                                remat_policy=args.remat_policy)
    model = exp.model
    if args.compute_dtype:
        model = dataclasses.replace(model, compute_dtype=args.compute_dtype)
    exp = exp.replace(data=data, train=train, model=model, mesh=mesh_config(args),
                      checkpoints_dir=args.checkpoints_dir)
    trainer = Trainer(exp, device=device, continue_train=args.continue_train)
    state = trainer.run(max_steps=args.max_steps)
    if distributed.is_main_process():
        print(f"trained {state.step} steps on {trainer.system.device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
