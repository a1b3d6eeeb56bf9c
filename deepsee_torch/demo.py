"""Demo entry point of the port: port of the repository's demo.py
(reference: demo.py + managers/demo_manager.py).

Upscales one LR face given an HR semantic mask and a style source:

  python -m deepsee_torch.demo --name 8x_independent_256x256 \\
      --image_lr face_32.png --semantics mask_256.png \\
      [--style_csv style.csv | --hr_image face.jpg:11,12 ...] \\
      [--torch_checkpoint <dir of <epoch>_net_{SR,E}.pth>] \\
      [--device cuda] --out results/

Style sources (demo.py:97-118):
  * --style_csv: a saved (19, S) style matrix
  * --hr_image path[:r1,r2,...]: encode HR image(s); the first provides the
    base style, later ones overwrite the listed region rows
    (demo_manager.py:21-27)
  * neither: encode from the LR input (independent model only)

Writes the upscaled PNG and the applied style matrix as CSV
(demo.py:62-73).  Runs on CUDA unless --device cpu; images are read through
the native codec where it builds (data/codec.py), through Pillow otherwise,
and writing the PNG needs Pillow.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deepsee_torch.config import Experiment
from deepsee_torch.inference.modes import encode_only, generate_with_style
from deepsee_torch.system import SRSystem
from deepsee_torch.utils.images import (image_file_to_array, label_file_to_array,
                                        load_style_matrix, save_image,
                                        save_style_matrix, tensor2im)


class Demo:
    """One system and the demo's style sources.  Weights: seeded init
    (seed 0) until the caller loads others into `self.system`."""

    def __init__(self, exp: Experiment, device: Optional[str | torch.device] = None):
        self.exp = exp
        self.system = SRSystem(exp.replace(is_train=False), device=device)
        self.system.init(torch.Generator().manual_seed(0))

    # -- IO -------------------------------------------------------------

    def load_image(self, path: str, size: Optional[int] = None) -> np.ndarray:
        return image_file_to_array(path, size)

    def load_label(self, path: str) -> np.ndarray:
        cfg = self.exp.model
        return label_file_to_array(path, cfg.crop_size, cfg.label_nc)

    # -- style sources ----------------------------------------------------

    def compute_style_from_hr(self, inputs_hr: List[Dict]) -> torch.Tensor:
        """inputs_hr: [{'image_hr': (1,H,W,3), 'label': (1,H,W),
        'regions': [int] or 'all'}]; the first gives the base style, later
        entries overwrite their listed region rows (demo_manager.py:12-29)."""
        styles = []
        for inp in inputs_hr:
            batch = self.system.preprocess(
                {"image_hr": inp["image_hr"], "label": inp["label"]})
            styles.append(encode_only(self.system, batch, encode_full=True))
        style = styles[0].clone()
        for inp, other in zip(inputs_hr[1:], styles[1:]):
            regions = inp["regions"]
            if regions == "all":
                regions = range(style.shape[1])
            for r in regions:
                style[:, r] = other[:, r]
        return style

    def compute_style_from_lr(self, image_lr: np.ndarray, label: np.ndarray) -> torch.Tensor:
        if self.exp.model.net_e != "combinedstyle":
            raise ValueError("only the independent model can compute the style "
                             "from an LR image (demo.py:115)")
        cfg = self.exp.model
        batch = self.system.preprocess({
            "image_lr": image_lr, "label": label,
            "image_hr": np.zeros((1, cfg.crop_size, cfg.crop_size, 3), np.float32)})
        return encode_only(self.system, batch, encode_full=False)

    # -- main -------------------------------------------------------------

    def run(self, path_image_lr: str, path_semantics: str,
            path_encoded_style: str = "",
            encoded_style: Optional[np.ndarray] = None,
            inputs_hr: Sequence[Dict] = (),
            out_dir: str = "./results") -> Dict:
        cfg = self.exp.model
        image_lr = self.load_image(path_image_lr, cfg.start_size)
        label = self.load_label(path_semantics)

        if path_encoded_style:
            encoded_style = self.system.to_device(load_style_matrix(path_encoded_style)[None])
        elif encoded_style is not None:
            encoded_style = self.system.to_device(np.asarray(encoded_style, np.float32))
            if encoded_style.dim() == 2:
                encoded_style = encoded_style[None]
        elif inputs_hr:
            loaded = [{
                "image_hr": self.load_image(h["path_image_hr"], cfg.crop_size),
                "label": self.load_label(h["path_semantics"]),
                "regions": h.get("regions", "all"),
            } for h in inputs_hr]
            encoded_style = self.compute_style_from_hr(loaded)
        else:
            encoded_style = self.compute_style_from_lr(image_lr, label)

        batch = self.system.preprocess({"image_lr": image_lr, "label": label})
        fake = generate_with_style(self.system, batch, encoded_style)

        os.makedirs(out_dir, exist_ok=True)
        stem = os.path.splitext(os.path.basename(path_image_lr))[0]
        png_path = os.path.join(out_dir, f"demo_{stem}.png")
        save_image(tensor2im(fake[0].cpu().numpy()), png_path)
        save_style_matrix(encoded_style[0].cpu().numpy(), png_path[:-4] + ".csv")
        print(f"Saved {png_path}")
        return {"fake_image": fake, "encoded_style": encoded_style,
                "save_path": png_path}


def parse_hr_images(specs: Sequence[str], path_semantics: str) -> List[Dict]:
    """--hr_image "path[:r1,r2,...]" entries -> run()'s inputs_hr."""
    inputs_hr = []
    for spec in specs:
        if ":" in spec:
            path, regions = spec.rsplit(":", 1)
            regions = [int(r) for r in regions.split(",")]
        else:
            path, regions = spec, "all"
        inputs_hr.append({"path_image_hr": path, "path_semantics": path_semantics,
                          "regions": regions})
    return inputs_hr


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--name", default="8x_independent_256x256")
    p.add_argument("--image_lr", required=True)
    p.add_argument("--semantics", required=True)
    p.add_argument("--style_csv", default="")
    p.add_argument("--hr_image", action="append", default=[],
                   help="path[:r1,r2,...] -- HR style image with region list")
    p.add_argument("--checkpoint", default="",
                   help="orbax checkpoint dir: not read by this port (convert it with "
                        "scripts/export_torch.py, pass the output as --torch_checkpoint)")
    p.add_argument("--torch_checkpoint", default="",
                   help="directory holding reference-format "
                        "<epoch>_net_{SR,E}.pth released checkpoints")
    p.add_argument("--epoch", default="latest",
                   help="epoch tag of --torch_checkpoint files")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 quantized inference: not in this port yet")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu, for the plain CPU versions")
    p.add_argument("--out", default="./results")
    args = p.parse_args(argv)
    if args.checkpoint:
        p.error("--checkpoint (orbax) is not read by deepsee_torch: convert the JAX "
                "trainer's checkpoint with scripts/export_torch.py on a machine with flax and "
                "orbax, and pass its output directory of <epoch>_net_{SR,E}.pth files as "
                "--torch_checkpoint (the port's own trainer writes those files)")
    if args.int8:
        p.error("--int8 is not in deepsee_torch yet: int8 serving needs the "
                "Hopper int8/FP8 conv kernel (K4) of a later slice")

    from deepsee_torch.config import get_preset
    from deepsee_torch.weights import load_reference_checkpoint

    demo = Demo(get_preset(args.name).replace(is_train=False), device=args.device)
    if args.torch_checkpoint:
        load_reference_checkpoint(demo.system, args.torch_checkpoint, epoch=args.epoch)
    demo.run(args.image_lr, args.semantics, path_encoded_style=args.style_csv,
             inputs_hr=parse_hr_images(args.hr_image, args.semantics), out_dir=args.out)


if __name__ == "__main__":
    main()
