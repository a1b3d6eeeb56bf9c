"""Run reproducibility, port of deepsee_tpu/utils/files.py::copy_src
(reference: util/files.py:59-84).  `is_main_process` lives in
deepsee_torch/parallel/distributed.py."""

from __future__ import annotations

import os
import subprocess
import time
import zipfile
from typing import Optional

# directories left out of the snapshot: caches, run outputs, and the
# unpacked checkouts of other commits that .gitignore lists under _checkout/
SKIPPED_DIRS = ("__pycache__", ".git", "checkpoints", "results", ".pytest_cache", "_checkout")


def copy_src(run_dir: str, src_root: Optional[str] = None) -> str:
    """Zip the repository's Python sources into `run_dir` as
    src_<timestamp>.zip, with GIT_REVISION.txt where git names the
    revision; returns the zip's path."""
    src_root = src_root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"src_{time.strftime('%Y%m%d-%H%M%S')}.zip")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(src_root):
            dirs[:] = sorted(d for d in dirs if d not in SKIPPED_DIRS)
            for f in sorted(files):
                if f.endswith(".py"):
                    full = os.path.join(root, f)
                    zf.write(full, os.path.relpath(full, src_root))
        try:
            rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=src_root,
                                 capture_output=True, text=True, timeout=5)
        except (OSError, subprocess.SubprocessError):  # no git, or it hung
            rev = None
        if rev is not None and rev.returncode == 0:
            zf.writestr("GIT_REVISION.txt", rev.stdout.strip() + "\n")
    return path
