"""The comparison that decides ``correct``: frames that the measured window
produced, each against the plain reference's frame at the same pose,
noise index and instance transforms, at the window's size.

Numbers, each the largest over the checked frames:

* image_rmse: the RMSE of the u8 sRGB images over every pixel and
  channel, as a share of 255 (tests/test_torch_oracle.py's whole-frame
  gate);
* image_off_share: the share of pixels with a channel more than
  ``OFF_LEVELS`` u8 levels off, which a fault spread thinly over many
  pixels (a mip level, a storage format) moves far more than the few
  pixels that rounding flips at an edge;
* hit_mismatch: the share of pixels that hit geometry on one side only;
* depth_p999: the 99.9th percentile, over pixels both sides hit, of the
  view depth's error relative to the reference's;
* normal_off_share: the share of pixels both sides hit whose stored
  normal encoding (R11G11B10F of n * 0.5 + 0.5, view space) is more than
  ``NORMAL_OFF`` off in a channel (half an ulp of the format's 6-bit
  channels in [0.5, 1)): a share, like the image's, so that the few
  pixels an edge flips weigh little beside a fault of the encoding;
* ao_rmse: the RMSE of the final AO term as a share of 255;
* undecided: the share of pixels left out (below), a limit on how much
  of the frame the comparison covers.

Pixels that the reference cannot decide (``reference/trace.py``: a
primary ray through an edge, a shadow ray whose only occluder ends at
t_max or touches an edge) are left out: of every number where the primary
ray is undecided, of the image's also where a shadow ray is.

A frame is correct when every number is finite and within its limit
(``limits/<workload>.json``).
"""
from __future__ import annotations

import math

import torch

MISS_DEPTH = 5000.0   # the program writes 10000 for a miss
OFF_LEVELS = 2
NORMAL_OFF = 2.0 ** -8
NUMBERS = ("image_rmse", "image_off_share", "hit_mismatch", "depth_p999",
           "normal_off_share", "ao_rmse", "undecided")


def frame_numbers(prog: dict, ref: dict) -> dict:
    """The numbers of one frame: `prog` the program's outputs (image, depth,
    normal, ao), `ref` the reference's (the same, hit and the undecided
    masks), same device."""
    sure = ~ref["hit_undecided"]
    lit = sure & ~ref["shadow_undecided"]
    a = prog["image"].to(torch.float64)[lit]
    b = ref["image"].to(torch.float64)[lit]
    image = torch.sqrt(torch.mean((a - b) ** 2)) / 255.0
    off = (torch.abs(a - b).amax(-1) > OFF_LEVELS).double().mean()
    hit_p = prog["depth"] < MISS_DEPTH
    hit_r = ref["hit"]
    both = hit_p & hit_r & sure
    dp = prog["depth"].to(torch.float64)[both]
    dr = ref["depth"].to(torch.float64)[both]
    rel = torch.abs(dp - dr) / torch.clamp_min(torch.abs(dr), 1e-6)
    depth = (torch.quantile(rel, 0.999) if rel.numel()
             else torch.tensor(float("inf")))
    dn = torch.abs(prog["normal"].to(torch.float64)[both]
                   - ref["normal"].to(torch.float64)[both]).amax(-1)
    normal = (dn > NORMAL_OFF).double().mean()
    ao = torch.sqrt(torch.mean((prog["ao"].to(torch.float64)[sure]
                                - ref["ao"].to(torch.float64)[sure]) ** 2))
    return dict(image_rmse=float(image), image_off_share=float(off),
                hit_mismatch=float((hit_p != hit_r)[sure].double().mean()),
                depth_p999=float(depth), normal_off_share=float(normal),
                ao_rmse=float(ao) / 255.0,
                undecided=float((~lit).double().mean()))


def worst(per_frame: list) -> dict:
    return {k: max(f[k] for f in per_frame) for k in NUMBERS}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}}) over the limited numbers."""
    checks = {k: dict(value=numbers[k], limit=float(limits[k]))
              for k in NUMBERS if k in limits}
    ok = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
