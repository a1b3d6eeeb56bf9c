"""Training observability: an own copy of deepsee_tpu/utils/visualizer.py
(reference: util/visualizer.py): plain-text loss lines with samples/s in
`loss_log.txt`, a self-refreshing HTML page of image rows under
`<checkpoints>/<name>/web/`, and the evaluation's per-key image folders with
a side-by-side strip (`save_images_only`).  Only the images need Pillow,
imported where they are written.  Under a process group only rank 0 writes
(and prints) the run directory's files."""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence

import numpy as np

from deepsee_torch.config import Experiment
from deepsee_torch.parallel import distributed
from deepsee_torch.utils.images import label2im, save_image, tensor2im

_HTML_HEADER = """<!DOCTYPE html><html><head>
<meta http-equiv="refresh" content="30">
<title>{title}</title>
<style>table{{border-collapse:collapse}} td{{padding:4px;text-align:center;
font-family:monospace}} img{{max-width:256px}}</style></head><body>
<h1>{title}</h1>
"""


class Visualizer:
    def __init__(self, exp: Experiment):
        self.exp = exp
        self.active = distributed.is_main_process()
        self.run_dir = os.path.join(exp.checkpoints_dir, exp.name)
        self.web_dir = os.path.join(self.run_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        self.log_path = os.path.join(self.run_dir, "loss_log.txt")
        if self.active:
            os.makedirs(self.img_dir, exist_ok=True)
            with open(self.log_path, "a") as f:
                f.write(f"=============== Training Loss ({time.strftime('%c')}) "
                        "===============\n")
        self.rows: List[Dict] = []

    def _to_uint8(self, key: str, value: np.ndarray) -> np.ndarray:
        value = np.asarray(value)
        if "label" in key or "semantics" in key:
            return label2im(value, self.exp.model.label_nc)
        return tensor2im(value)

    def display_current_results(self, visuals: Dict[str, np.ndarray], epoch: int,
                                step: int) -> None:
        """visuals: (H, W, C) arrays in [-1, 1], or label maps."""
        if not self.active:
            return
        files = {}
        for key, value in visuals.items():
            fname = f"epoch{epoch:03d}_step{step}_{key}.png"
            save_image(self._to_uint8(key, value), os.path.join(self.img_dir, fname))
            files[key] = fname
        self.rows.insert(0, {"epoch": epoch, "step": step, "files": files})
        with open(os.path.join(self.web_dir, "index.html"), "w") as f:
            f.write(_HTML_HEADER.format(title=f"Experiment {self.exp.name}"))
            for row in self.rows[:50]:
                f.write(f"<h3>epoch {row['epoch']} step {row['step']}</h3><table><tr>")
                for key, fname in row["files"].items():
                    f.write(f"<td><img src='images/{fname}'><br>{key}</td>")
                f.write("</tr></table>\n")
            f.write("</body></html>\n")

    def print_current_errors(self, epoch: int, i: int, errors: Dict[str, float],
                             time_per_sample: float) -> None:
        if not self.active:
            return
        message = (f"(epoch: {epoch}, iters: {i}, "
                   f"samples/sec: {1.0 / max(time_per_sample, 1e-9):.3f}) ")
        for k, v in errors.items():
            message += f"{k}: {float(v):.3f} "
        print(message)
        with open(self.log_path, "a") as f:
            f.write(message + "\n")


def save_images_only(visuals: Dict[str, np.ndarray], paths: Sequence[str],
                     folder_out: str, label_nc: int = 19) -> None:
    """Per-key folders and a combined side-by-side strip per sample
    (util/visualizer.py:181-215): visuals are (B, H, W, C) images in
    [-1, 1] or (B, H, W) label maps, named by the stems of `paths`."""
    os.makedirs(folder_out, exist_ok=True)
    batch = None
    combined = {}
    for key, value in visuals.items():
        value = np.asarray(value)
        is_label = "label" in key or "semantics" in key
        if value.ndim < 4 and not is_label:
            continue
        arrs = []
        for b in range(value.shape[0]):
            arr = label2im(value[b], label_nc) if is_label else tensor2im(value[b])
            name = os.path.splitext(os.path.basename(paths[b]))[0]
            save_image(arr, os.path.join(folder_out, key, f"{name}.png"), create_dir=True)
            arrs.append(arr)
        combined[key] = arrs
        batch = len(arrs)
    for b in range(batch or 0):
        h = max(a[b].shape[0] for a in combined.values())
        strips = []
        for arrs in combined.values():
            a = arrs[b]
            if a.shape[0] != h:  # upscale smaller (e.g. LR) inputs
                from PIL import Image
                a = np.asarray(Image.fromarray(a).resize((h * a.shape[1] // a.shape[0], h),
                                                         Image.NEAREST))
            strips.append(a)
        name = os.path.splitext(os.path.basename(paths[b]))[0]
        save_image(np.concatenate(strips, axis=1),
                   os.path.join(folder_out, "combined", f"{name}.png"), create_dir=True)
