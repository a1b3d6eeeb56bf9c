"""python -m deepsee_torch.evaluate_folder: the port of the repository's
evaluate_folder.py (reference: evaluator/evaluate_folder.py).

Compares a folder of generated images with a ground-truth folder: PSNR,
SSIM, MS-SSIM, RMSE, LPIPS and FID (deepsee_torch/eval/), the ground truth
center-cropped and resized as its dataset is (evaluate_folder.py:199-207);
writes a per-sample metrics.csv and prints the means and standard
deviations.

    python -m deepsee_torch.evaluate_folder --fake_dir results/visuals/fake_image \\
        --real_dir /data/CelebAMask-HQ/images --dataset celebamaskhq \\
        --crop_size 256 --out metrics_out/

Both folders decode through the native codec (data/codec.py, bit-exact with
Pillow) where it builds, through Pillow otherwise.  Runs on the card unless
--device cpu is given, and raises without one.  Without --inception_weights
and --alexnet_weights the FID and LPIPS networks are seeded random ones:
their values are comparable only with each other.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from deepsee_torch.data import codec


def load_real(path: str, dataset: str, crop_size: int,
              center_crop_size: int = 178) -> np.ndarray:
    """The ground truth as float32 (crop, crop, 3) in [-1, 1]: CelebA's
    center crop, then a bicubic resize to crop_size."""
    ops = codec.make_ops(center_crop=center_crop_size if dataset == "celeba" else 0,
                         resize=(crop_size, crop_size))
    arr = codec.decode_image(path, ops, (crop_size, crop_size))
    if arr is not None:
        return arr
    from PIL import Image

    with Image.open(path) as opened:
        img = opened.convert("RGB")
    if dataset == "celeba":
        w, h = img.size
        cc = center_crop_size
        left, top = int(round((w - cc) / 2.0)), int(round((h - cc) / 2.0))
        img = img.crop((left, top, left + cc, top + cc))
    if img.size != (crop_size, crop_size):
        img = img.resize((crop_size, crop_size), Image.BICUBIC)
    return np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0


def load_fake(path: str) -> np.ndarray:
    """A generated image as float32 (H, W, 3) in [-1, 1], at its own size."""
    with open(path, "rb") as f:
        data = f.read()
    dims = codec.probe(data)
    if dims is not None:
        arr = codec.decode_image(data, codec.make_ops(), (dims[1], dims[0]))
        if arr is not None:
            return arr
    import io

    from PIL import Image

    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0 * 2.0 - 1.0


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--real_dir", required=True)
    p.add_argument("--dataset", default="celebamaskhq", choices=("celeba", "celebamaskhq"))
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--center_crop_size", type=int, default=178)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--no_fid", action="store_true")
    p.add_argument("--no_lpips", action="store_true")
    p.add_argument("--inception_weights", default="")
    p.add_argument("--alexnet_weights", default="")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = parse_args(argv)
    from deepsee_torch.eval import fid as fid_mod
    from deepsee_torch.eval.evaluator import MetricsCSVWriter, strict_float32
    from deepsee_torch.eval.lpips import load_lpips
    from deepsee_torch.eval.metrics import MetricsAccumulator, batch_metrics

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate_folder runs on CUDA and no CUDA device is available; "
                           "pass --device cpu for the plain CPU versions")
    fake_paths = sorted(glob.glob(os.path.join(args.fake_dir, "*.png"))
                        + glob.glob(os.path.join(args.fake_dir, "*.jpg")))
    if args.max_samples:
        fake_paths = fake_paths[:args.max_samples]
    if not fake_paths:
        raise FileNotFoundError(f"No images in {args.fake_dir}")
    if not args.no_fid:
        inception, fid_exact = fid_mod.load_inception(args.inception_weights or None,
                                                      device=device)
        if not fid_exact:
            print("[warn] FID inception weights unavailable — relative FID only")
    if not args.no_lpips:
        lpips, lpips_exact = load_lpips(alexnet_path=args.alexnet_weights or None, device=device)
        if not lpips_exact:
            print("[warn] LPIPS alexnet weights unavailable — relative LPIPS only")

    writer = None
    if args.out:
        writer = MetricsCSVWriter(args.out, ["ID", "PSNR", "SSIM", "MSSSIM", "RMSE", "LPIPS"])
    acc = MetricsAccumulator()
    act_fake, act_real = [], []
    batch_f, batch_r, batch_ids = [], [], []

    def flush():
        if not batch_f:
            return
        fake = torch.from_numpy(np.stack(batch_f)).to(device)
        real = torch.from_numpy(np.stack(batch_r)).to(device)
        with torch.inference_mode():
            m = batch_metrics(fake, real)
            with strict_float32():
                if not args.no_lpips:
                    m["lpips"] = lpips(fake, real)
                if not args.no_fid:
                    m["act_fake"] = fid_mod.inception_pool3(inception, fake)
                    m["act_real"] = fid_mod.inception_pool3(inception, real)
        m = {k: v.cpu().numpy() for k, v in m.items()}
        for name in ("psnr", "ssim", "ms_ssim", "rmse") + (() if args.no_lpips else ("lpips",)):
            acc.add(name, m[name])
        if not args.no_fid:
            act_fake.append(m["act_fake"])
            act_real.append(m["act_real"])
        if writer:
            for i, sid in enumerate(batch_ids):
                writer.append_line([sid, m["psnr"][i], m["ssim"][i], m["ms_ssim"][i],
                                    m["rmse"][i], "" if args.no_lpips else m["lpips"][i]])
        batch_f.clear(), batch_r.clear(), batch_ids.clear()

    missing = 0
    for fp in fake_paths:
        stem = os.path.splitext(os.path.basename(fp))[0]
        rp = next((c for c in (os.path.join(args.real_dir, stem + ext)
                               for ext in (".jpg", ".png", ".jpeg")) if os.path.exists(c)), None)
        if rp is None:
            missing += 1
            continue
        batch_f.append(load_fake(fp))
        batch_r.append(load_real(rp, args.dataset, args.crop_size, args.center_crop_size))
        batch_ids.append(stem)
        if len(batch_f) == args.batch_size:
            flush()
    flush()
    if writer:
        writer.close()

    result: Dict[str, float] = {}
    if not args.no_fid and act_fake:
        try:
            result["FID"] = fid_mod.fid_from_activations(np.concatenate(act_fake),
                                                         np.concatenate(act_real))
        except Exception as e:  # noqa: BLE001 - the reference logs 500 on any failure
            print(f"FID failed ({e}); default 500")
            result["FID"] = 500.0
    result.update(acc.result())
    if missing:
        print(f"[warn] {missing} fake images had no GT counterpart")
    for k, v in result.items():
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
