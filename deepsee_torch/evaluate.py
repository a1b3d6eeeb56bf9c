"""python -m deepsee_torch.evaluate: the evaluation entry point of the port,
counterpart of the repository's evaluate.py (reference:
managers/inference_manager.py:61-147).  Runs the metric harness (PSNR,
SSIM, MS-SSIM, RMSE, LPIPS, FID) over samples with a trained checkpoint and
prints the result as JSON.

    python -m deepsee_torch.evaluate --name 8x_independent_256x256 \\
        --image_dir .../test_img --label_dir .../test_label \\
        --checkpoints_dir ./checkpoints --num_samples 1000 --out results/eval

The samples are the preset's dataset read from --image_dir / --label_dir in
file order (phase "test"; samples without a guiding image are skipped, the
last partial batch dropped), or synthetic ones with --synthetic.  The CSV's
ID column holds each sample's file name without its extension.

Weights: by default the port trainer's `<checkpoints_dir>/<name>/<epoch>_net_
{SR,E}.pth` files; --torch_checkpoint reads the same files of a reference
release (or of scripts/export_torch.py) from another directory;
--no_checkpoint evaluates the seeded init.  Without --inception_weights and
--alexnet_weights the FID and LPIPS networks are seeded random ones
(`exact` false): their absolute values are comparable only with each other.

Runs on the card unless --device cpu is given, and raises without one.
--multihost (under torchrun, one process per card: `torchrun --nproc_per_node
N -m deepsee_torch.evaluate --multihost ...`) gives each rank a stripe of the
samples in file order (--batch_size per rank) and gathers every rank's rows
before the means and the FID; rank 0 prints and writes.  --int8 runs the
evaluation under `int8_inference()`: the generator and encoder take the W8A8
convs, the metric networks stay in float32 (evaluate.py:102-108); under
--multihost each rank's activation scales are its own batch's.
--save_images writes PNGs and needs Pillow.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
from typing import Dict, List, Optional

import torch

from deepsee_torch.config import get_preset


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--name", default="8x_independent_256x256")
    p.add_argument("--image_dir", default="")
    p.add_argument("--label_dir", default="")
    p.add_argument("--identities_file", default="")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_samples", type=int, default=1000)
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on synthetic samples instead of the preset's dataset")
    p.add_argument("--no_fid", action="store_true")
    p.add_argument("--no_lpips", action="store_true")
    p.add_argument("--no_checkpoint", action="store_true",
                   help="evaluate the seeded init (smoke)")
    p.add_argument("--torch_checkpoint", default="",
                   help="directory holding reference-format <epoch>_net_{SR,E}.pth files")
    p.add_argument("--epoch", default="latest")
    p.add_argument("--inception_weights", default="")
    p.add_argument("--alexnet_weights", default="")
    p.add_argument("--out", default="")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:LOCAL_RANK with --multihost) or cpu")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group (NCCL on the card, gloo on the CPU); "
                        "each rank evaluates its stripe, the rows are gathered")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 quantized generator and encoder (the int8 conv kernels)")
    return p.parse_args(argv)


def load_weights(system, args: argparse.Namespace) -> None:
    """The networks' weights as the flags ask (module docstring)."""
    from deepsee_torch.weights import load_reference_checkpoint

    system.init(torch.Generator().manual_seed(0))
    if args.no_checkpoint:
        return
    directory = args.torch_checkpoint or os.path.join(args.checkpoints_dir, args.name)
    if not os.path.exists(os.path.join(directory, f"{args.epoch}_net_SR.pth")):
        raise FileNotFoundError(
            f"no {args.epoch}_net_SR.pth in {directory}: deepsee_torch reads the .pth files its "
            "trainer writes; convert an Orbax checkpoint of the JAX trainer with "
            "scripts/export_torch.py (on a machine with flax and orbax) and pass its output "
            "directory as --torch_checkpoint")
    load_reference_checkpoint(system, directory, epoch=args.epoch)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    from deepsee_torch.parallel import distributed

    with distributed.joined(args.multihost, args.device) as device:
        return _evaluate(args, device)


def _evaluate(args: argparse.Namespace, device) -> Dict[str, float]:
    from deepsee_torch.data import DataLoader, create_dataset
    from deepsee_torch.eval.evaluator import InferenceEvaluator
    from deepsee_torch.models.layers import int8_inference
    from deepsee_torch.parallel import distributed
    from deepsee_torch.system import SRSystem

    exp = get_preset(args.name).replace(is_train=False, checkpoints_dir=args.checkpoints_dir)
    exp = exp.replace(
        data=dataclasses.replace(
            exp.data, dataset="synthetic" if args.synthetic else exp.data.dataset,
            image_dir=args.image_dir, label_dir=args.label_dir,
            identities_file=args.identities_file, phase="test"),
        train=dataclasses.replace(exp.train, batch_size=args.batch_size))
    system = SRSystem(exp, device=device)
    load_weights(system, args)
    # each rank a disjoint stripe (evaluate.py:88-94): the evaluator caps a
    # rank at num_samples / world and gathers
    loader = DataLoader(create_dataset(exp, phase="test"), args.batch_size, shuffle=False,
                        drop_last=True, shard_index=distributed.data_rank(),
                        num_shards=distributed.data_world())
    ev = InferenceEvaluator(
        system, num_samples=args.num_samples, write_details=bool(args.out),
        folder_out=args.out or None, compute_fid=not args.no_fid,
        compute_lpips=not args.no_lpips, inception_weights=args.inception_weights or None,
        alexnet_weights=args.alexnet_weights or None)
    with int8_inference() if args.int8 else contextlib.nullcontext():
        result = ev.run(loader)
    if ev.writer is not None:
        ev.writer.close()
    if not distributed.is_main_process():
        return result
    print(json.dumps(result, indent=2, sort_keys=True))

    if args.save_images and args.out:
        from deepsee_torch.utils.visualizer import save_images_only

        batch = next(iter(loader))
        fake, real = ev.run_batch(batch)
        visuals = {"fake_image": fake.cpu().numpy(), "image_hr": real.cpu().numpy(),
                   "input_label": batch["label"]}
        save_images_only(visuals, batch["path"], os.path.join(args.out, "visuals"),
                         exp.model.label_nc)
    return result


if __name__ == "__main__":
    main()
