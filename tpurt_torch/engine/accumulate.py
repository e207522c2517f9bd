"""Progressive accumulation with checkpoint and resume — port of
``tpurt/engine/accumulate.py``.

The ground-truth configuration (BASELINE.json config 5: 1024 spp
converged) renders many jittered samples of the frame and averages them in
linear HDR. The state (the sum, the sample count and the random state) can
be saved to an ``.npz`` file mid-render and resumed.

The random state is a ``torch.Generator`` on the CPU, where tpurt keeps a
``jax.random`` key. Every jitter is two floats drawn by ``_uniform_jitter``
from that generator, so a seed gives the same jitters whether the samples
render on the card or on the host. tpurt's two draw orders are kept:
``accumulate_samples`` draws nothing for the very first sample (the pixel
center), ``accumulate_samples_scan`` draws one jitter per sample and
replaces the first with the center when the state is empty (ROADMAP F18).

The sum lives on the scene's device: ``init_accumulation`` and
``load_checkpoint`` make it on the host, and the first accumulation moves
it to the device the samples render on.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..passes.encodings import divide
from .frame import render_sample_hdr


@dataclass
class AccumulationState:
    color_sum: torch.Tensor   # (H, W, 3) f32 linear HDR sum
    num_samples: int
    key: torch.Generator      # CPU generator of the jitters

    @property
    def mean(self) -> torch.Tensor:
        return divide(self.color_sum, max(self.num_samples, 1))


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def init_accumulation(height: int, width: int,
                      seed: int = 0) -> AccumulationState:
    return AccumulationState(
        color_sum=torch.zeros((height, width, 3), dtype=torch.float32),
        num_samples=0, key=_generator(seed))


def _uniform_jitter(generator: torch.Generator) -> torch.Tensor:
    """One sub-pixel jitter: (2,) f32 uniform in [-0.5, 0.5) on the CPU."""
    return torch.rand(2, generator=generator, dtype=torch.float32) - 0.5


def _accumulate(state: AccumulationState, scene: dict, camera: dict,
                lights: dict, num_samples: int, width: int, height: int,
                draw_center: bool) -> AccumulationState:
    """Add `num_samples` jittered samples; the first sample of an empty
    state is the pixel center, for which a jitter is drawn (and dropped)
    only with `draw_center`. The input state is left as it was."""
    color_sum = state.color_sum.to(scene["tris"].device)
    key = torch.Generator(device="cpu")
    key.set_state(state.key.get_state())
    for s in range(num_samples):
        center = state.num_samples == 0 and s == 0
        if draw_center or not center:
            jitter = _uniform_jitter(key)
        if center:
            jitter = (0.0, 0.0)
        color_sum = color_sum + render_sample_hdr(
            scene, camera, lights, jitter, width=width, height=height)
    return AccumulationState(color_sum=color_sum,
                             num_samples=state.num_samples + num_samples,
                             key=key)


def accumulate_samples(state: AccumulationState, scene: dict, camera: dict,
                       lights: dict, num_samples: int, *, width: int,
                       height: int) -> AccumulationState:
    """Add `num_samples` jittered samples to the accumulator. The very
    first sample of a state (num_samples == 0) is the pixel center, drawn
    from nothing, so one sample equals the real-time frame's color."""
    return _accumulate(state, scene, camera, lights, num_samples, width,
                       height, draw_center=False)


def accumulate_samples_scan(state: AccumulationState, scene: dict,
                            camera: dict, lights: dict, num_samples: int, *,
                            width: int, height: int) -> AccumulationState:
    """tpurt's scan form (one compiled program there, the same loop here):
    one jitter drawn per sample, the first replaced by the pixel center
    when the state is empty. The draws differ from
    ``accumulate_samples``'s, so the two give different sums."""
    return _accumulate(state, scene, camera, lights, num_samples, width,
                       height, draw_center=True)


def _ckpt_path(path: str) -> str:
    """np.savez appends '.npz' to bare paths; normalize so save and load
    always agree (a mismatch silently restarts long renders from sample 0)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: AccumulationState):
    """Write tpurt's three fields: color_sum, num_samples and key, the
    generator's state bytes."""
    path = _ckpt_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, color_sum=state.color_sum.cpu().numpy(),
             num_samples=state.num_samples,
             key=state.key.get_state().numpy())


def load_checkpoint(path: str) -> Optional[AccumulationState]:
    """The state saved at `path`, or None when there is no file. A file
    tpurt wrote resumes too: its color_sum and num_samples carry over as
    they are, and its two-word uint32 key [hi, lo] seeds the generator with
    hi * 2**32 + lo (so ``PRNGKey(s)``'s file draws as
    ``init_accumulation(seed=s)`` would); the draws that follow are the
    port's, so the mean continues from tpurt's sum."""
    path = _ckpt_path(path)
    if not os.path.exists(path):
        return None
    data = np.load(path)
    key = np.asarray(data["key"])
    if key.dtype == np.uint32 and key.shape == (2,):
        generator = _generator((int(key[0]) << 32) | int(key[1]))
    else:
        generator = torch.Generator(device="cpu")
        generator.set_state(torch.from_numpy(key.astype(np.uint8)))
    return AccumulationState(
        color_sum=torch.from_numpy(np.asarray(data["color_sum"],
                                              np.float32)),
        num_samples=int(data["num_samples"]), key=generator)
