"""Shared inputs of the ground-truth tests (tests/test_torch_{rays,aa,
accumulate,rtao,oracle*}.py): the cut bench scene of tests/torch_frames.py
at 32x32 for both packages, and tpurt's ``jax.random`` draws, which the
tests hand to the port's draw functions (monkeypatch) so that both
packages take the same samples.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

SIZE = 32
FIELD = dict(nx=3, nz=3, subdiv=2)
CUBES = 2


def renderers(size=SIZE, **config):
    """(tpurt's Renderer with tracer="bvh8", the port's on the CPU), each
    with the cut bench scene at `size` x `size` and `config`."""
    from tpurt.engine import Renderer as RefRenderer
    from tpurt.engine import RendererConfig as RefConfig
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    ref_r = build_bench_scene(
        RefRenderer(RefConfig(width=size, height=size, tracer="bvh8",
                              **config)), field=FIELD, cubes=CUBES)
    port_r = build_bench_scene(
        Renderer(RendererConfig(width=size, height=size, device="cpu",
                                **config)), field=FIELD, cubes=CUBES)
    return ref_r, port_r


def ref_inputs(ref_r):
    """tpurt's camera and light arrays of a renderer, as jnp."""
    cam = {k: jnp.asarray(v) for k, v in ref_r.camera.uniform().items()}
    lights = {k: jnp.asarray(v)
              for k, v in ref_r.lights.shader_arrays().items()}
    return cam, lights


def ref_jitters(seed: int, n: int) -> np.ndarray:
    """The jitters tpurt's accumulation draws from PRNGKey(seed), in order:
    key, sub = split(key); uniform(sub, (2,), -0.5, 0.5). (n, 2) f32."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (2,), minval=-0.5,
                                                 maxval=0.5)))
    return np.stack(out).astype(np.float32)


def ref_planes(key, sample: int, shape):
    """The uniforms of tpurt's RTAO sample `sample` of a frame's key
    (rtao.py: sub = fold_in(key, s); u1 from sub, u2 from fold_in(sub, 1))."""
    sub = jax.random.fold_in(key, sample)
    return (np.array(jax.random.uniform(sub, shape)),
            np.array(jax.random.uniform(jax.random.fold_in(sub, 1),
                                        shape)))


class Feed:
    """A stand-in for a port draw function that returns the given draws
    in order and counts the calls."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.calls = 0

    def __call__(self, *args, **kwargs):
        out = self.draws[self.calls]
        self.calls += 1
        return out
