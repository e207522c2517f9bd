"""Image comparison metrics and CLI — the port's copy of
``tpurt/utils/image_metrics.py`` (numpy).

The acceptance gate is per-pixel closeness to the reference (<= 1% RMSE at
matched configs, BASELINE.md): RMSE, PSNR and max-abs over u8 or float
images, as a library or as
``python -m tpurt_torch.utils.image_metrics a.png b.png [--threshold 0.01]``.
The CLI reads PNGs with PIL, imported inside ``main`` only; the library
needs numpy alone.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def to_float(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def rmse(a, b) -> float:
    a, b = to_float(a), to_float(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.sqrt(np.mean((a - b) ** 2)))


def psnr(a, b) -> float:
    e = rmse(a, b)
    if e == 0:
        return float("inf")
    return float(20.0 * np.log10(1.0 / e))


def max_abs(a, b) -> float:
    return float(np.abs(to_float(a) - to_float(b)).max())


def diff_report(a, b) -> dict:
    return dict(rmse=rmse(a, b), psnr=psnr(a, b), max_abs=max_abs(a, b),
                mismatch_frac=float((to_float(a) != to_float(b)).mean()))


def main(argv=None):
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_a")
    p.add_argument("image_b")
    p.add_argument("--threshold", type=float, default=0.01,
                   help="RMSE pass/fail gate (default 1%%)")
    args = p.parse_args(argv)

    a = np.asarray(Image.open(args.image_a).convert("RGB"))
    b = np.asarray(Image.open(args.image_b).convert("RGB"))
    rep = diff_report(a, b)
    status = "PASS" if rep["rmse"] <= args.threshold else "FAIL"
    print(f"RMSE {rep['rmse']:.5f}  PSNR {rep['psnr']:.2f} dB  "
          f"max|d| {rep['max_abs']:.4f}  -> {status} "
          f"(threshold {args.threshold})")
    return 0 if status == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
