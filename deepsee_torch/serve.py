"""Serving export: port of deepsee_tpu/serve.py with `torch.export`.

The whole inference computation -- preprocessing (label one-hot), style
encode, generator -- is exported once with `torch.export.export` as a
self-contained program with the weights stored in the artifact.  A serving
process loads it with `load_serving` and calls it without SRSystem or the
configuration; it needs torch and this package's `modnorm` and `int8_conv`
ops, which `load_serving` registers by importing deepsee_torch.ops.modnorm
and deepsee_torch.ops.int8conv.

Two programs per model, as in the JAX package:
  * end_to_end: (image_lr, label[, guiding_image, guiding_label]) ->
    (fake, style), the standard serving path; the style is returned so
    callers can save or perturb it.
  * styled: (image_lr, label, style) -> fake, the manipulation path.

Both run with no style noise, at a fixed trace batch.  Arguments and
results are NHWC: image_lr (B, s, s, 3) float32 in [-1, 1], label
(B, crop, crop) int32, style (B, label_nc, style_size) float32, fake
(B, crop, crop, 3) float32.  A program is exported on the system's device
and runs there: one exported on CUDA is a CUDA program (its kernels are
the port's, built at first use); the manifest records which.

quantize="int8" exports under `int8_inference()`: every eval-mode conv with
cin and cout >= 64 is one `deepsee::int8_conv` node (W8A8, SmoothQuant);
"int8_nosmooth" drops the equalization.  The manifest records the mode.
A daemon serves such an artifact next to a bf16 one under two aliases.

  python -m deepsee_torch.serve --name 8x_independent_256x256 \\
      --batch_size 8 --out serving/run1/ [--torch_checkpoint ckpts/ \\
      --epoch latest] [--device cuda] [--quantize int8]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deepsee_torch.config import Experiment
from deepsee_torch.models.layers import int8_inference
from deepsee_torch.system import SRSystem

PROGRAMS = ("end_to_end", "styled")
QUANTIZE = ("", "int8", "int8_nosmooth")


class EndToEnd(nn.Module):
    """(image_lr, label[, guiding_image, guiding_label]) -> (fake, style):
    preprocess -> encode (the mini trunk; the guided model's full trunk on
    the guiding image) -> generate, with no style noise."""

    def __init__(self, system: SRSystem):
        super().__init__()
        self.system = system
        self.generator = system.generator
        self.encoder = system.encoder

    def forward(self, image_lr: torch.Tensor, label: torch.Tensor,
                guiding_image: Optional[torch.Tensor] = None,
                guiding_label: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        batch = {"image_lr": image_lr, "label": label}
        guided = self.system.cfg.guiding_style_image
        if guided:
            batch.update(guiding_image=guiding_image, guiding_label=guiding_label)
        pre = self.system.preprocess(batch)
        return self.system.generate(pre, use_full=guided, no_noise=True)


class Styled(nn.Module):
    """(image_lr, label, style) -> fake: preprocess -> generate on the given
    style matrix."""

    def __init__(self, system: SRSystem):
        super().__init__()
        self.system = system
        self.generator = system.generator

    def forward(self, image_lr: torch.Tensor, label: torch.Tensor,
                style: torch.Tensor) -> torch.Tensor:
        pre = self.system.preprocess({"image_lr": image_lr, "label": label})
        fake, _ = self.system.generate(pre, style=style, no_noise=True)
        return fake


def make_serving_fns(system: SRSystem) -> Tuple[nn.Module, nn.Module]:
    """The two serving programs as modules over `system`'s networks."""
    return EndToEnd(system).eval(), Styled(system).eval()


def serving_arg_specs(exp: Experiment, batch_size: int = 1,
                      device: str | torch.device = "cpu"
                      ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Example arguments of the two programs at the trace batch, on
    `device`: (end_to_end args, styled args)."""
    cfg = exp.model
    b, s, crop = batch_size, cfg.start_size, cfg.crop_size

    # a new tensor for every argument: torch.export treats one tensor passed
    # twice as one input, so guiding_label would become label
    def lr():
        return torch.zeros((b, s, s, 3), dtype=torch.float32, device=device)

    def lab():
        return torch.zeros((b, crop, crop), dtype=torch.int32, device=device)

    sty = torch.zeros((b, cfg.label_nc, cfg.regional_style_size), dtype=torch.float32,
                      device=device)
    if cfg.guiding_style_image:
        hr = torch.zeros((b, crop, crop, 3), dtype=torch.float32, device=device)
        return (lr(), lab(), hr, lab()), (lr(), lab(), sty)
    return (lr(), lab()), (lr(), lab(), sty)


def export_serving(system: SRSystem, batch_size: int = 1,
                   quantize: str = "") -> Dict[str, torch.export.ExportedProgram]:
    """Export both serving programs on the system's device:
    {"end_to_end": program, "styled": program}.  quantize: "" (the
    system's own dtype), "int8" or "int8_nosmooth" (module docstring)."""
    if quantize not in QUANTIZE:
        raise ValueError(f"unknown quantize mode {quantize!r}; one of {QUANTIZE}")
    e2e_args, styled_args = serving_arg_specs(system.exp, batch_size, system.device)
    end_to_end, styled = make_serving_fns(system)
    ctx = (int8_inference(smooth=quantize == "int8") if quantize
           else contextlib.nullcontext())
    with torch.no_grad(), ctx:
        return {"end_to_end": torch.export.export(end_to_end, e2e_args),
                "styled": torch.export.export(styled, styled_args)}


def save_serving(out_dir: str, exp: Experiment,
                 programs: Dict[str, torch.export.ExportedProgram], batch_size: int,
                 device: str | torch.device, quantize: str = "") -> None:
    """Write `<name>.pt2` for each program and `manifest.json`."""
    os.makedirs(out_dir, exist_ok=True)
    for name, program in programs.items():
        torch.export.save(program, os.path.join(out_dir, f"{name}.pt2"))
    cfg = exp.model
    manifest = {
        "name": exp.name, "batch_size": batch_size,
        "device": torch.device(device).type,
        "quantize": quantize,
        "start_size": cfg.start_size, "crop_size": cfg.crop_size,
        "label_nc": cfg.label_nc,
        "regional_style_size": cfg.regional_style_size,
        "guiding_style_image": cfg.guiding_style_image,
        "programs": {
            "end_to_end": "(image_lr, label"
                          + (", guiding_image, guiding_label"
                             if cfg.guiding_style_image else "")
                          + ") -> (fake, style)",
            "styled": "(image_lr, label, style) -> fake",
        },
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_serving(path_or_dir: str, name: str = "end_to_end") -> nn.Module:
    """Load an exported program; returns a module to call with tensors on
    the device it was exported for."""
    import deepsee_torch.ops.int8conv  # noqa: F401  (registers deepsee::int8_conv)
    import deepsee_torch.ops.modnorm  # noqa: F401  (registers deepsee::modnorm)

    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, f"{name}.pt2")
    return torch.export.load(path).module()


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="Export the two serving programs of a "
                                            "model as torch.export artifacts")
    p.add_argument("--name", required=True, help="preset, e.g. 8x_independent_256x256")
    p.add_argument("--torch_checkpoint", default="",
                   help="directory of reference-format <epoch>_net_{SR,E}.pth files")
    p.add_argument("--epoch", default="latest",
                   help="epoch tag of the --torch_checkpoint files")
    p.add_argument("--batch_size", type=int, default=1, help="the trace batch")
    p.add_argument("--device", default="cuda",
                   help="device the programs are exported for and run on")
    p.add_argument("--quantize", default="", choices=QUANTIZE,
                   help="int8: W8A8 quantized convs (SmoothQuant); int8_nosmooth drops the "
                        "equalization")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    from deepsee_torch.config import get_preset
    from deepsee_torch.weights import load_reference_checkpoint

    exp = get_preset(args.name).replace(is_train=False)
    system = SRSystem(exp, device=args.device)
    system.init(torch.Generator().manual_seed(0))
    if args.torch_checkpoint:
        load_reference_checkpoint(system, args.torch_checkpoint, epoch=args.epoch)
    else:
        print("WARNING: exporting seeded random-init weights (no --torch_checkpoint)")
    programs = export_serving(system, args.batch_size, quantize=args.quantize)
    save_serving(args.out, exp, programs, args.batch_size, system.device,
                 quantize=args.quantize)
    for name in programs:
        path = os.path.join(args.out, f"{name}.pt2")
        print(f"wrote {path} ({os.path.getsize(path) / 2 ** 20:.1f} MiB)")


if __name__ == "__main__":
    main()
