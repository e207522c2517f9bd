"""Rank processes for tests/test_torch_dist.py: gloo on the CPU, spawned
with ``torch.multiprocessing`` (spawn start method), one thread each. The
module imports only torch and tpurt_torch, as each rank's process does."""
from __future__ import annotations

import contextlib
import os
import socket

import numpy as np
import torch

W, H = 40, 36
FIELD = dict(nx=3, nz=3, subdiv=2)
CUBES = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, *args):
    """Run fn(rank, world, port, *args) on `world` gloo ranks; raises here
    when a rank raises."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=(world, free_port()) + args, nprocs=world,
                       join=True, start_method="spawn")


def _init(rank, world, port):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)


def renderer(**config):
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.engine import Renderer, RendererConfig

    return build_bench_scene(Renderer(RendererConfig(
        width=W, height=H, device="cpu", **config)), field=FIELD,
        cubes=CUBES)


def _equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), (what, sorted(a), sorted(b))
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (what,
                                                                       k)
        assert torch.equal(a[k], b[k]), (what, k)


def frame_worker(rank, world, port, out_dir):
    """Every rank: its band of render_frame_sharded equals the same rows of
    the single-device frame (spp 2, no tonemap, bent normals with two
    denoise passes), bit for bit in every output; RendererConfig.mesh
    through render() gives every rank the whole frame, two frames running,
    and so does render_passes() with every step entered; rank 0 writes the
    default frame's outputs for the parent."""
    import torch.distributed as dist

    from tpurt_torch.dist import make_mesh, render_frame_sharded
    from tpurt_torch.dist.sharding import transport
    from tpurt_torch.engine.frame import SPANS, STEPS
    from tpurt_torch.passes.gtao import GtaoSettings, noise_maps_64

    _init(rank, world, port)
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.size() == world and mesh.get_local_rank() == rank
        assert transport(mesh, torch.device("cpu")) == "gloo"
        config = dict(spp=2, enable_tonemap=False,
                      gtao=GtaoSettings(3, 3, denoise=2, bent_normals=True))
        single = renderer(**config)
        want = [single.render() for _ in range(2)]
        r = renderer(**config)
        cam, lights, gtao = r._frame_inputs()
        c = r.config
        band = render_frame_sharded(
            r.scene_device, cam, lights, gtao, r._lpm,
            noise_maps_64(0, "cpu"), width=W, height=H,
            gtao_settings=c.gtao, mesh=mesh, enable_gtao=True,
            enable_tonemap=False, spp=2)
        rows = slice(rank * H // world, (rank + 1) * H // world)
        _equal(band, {k: v[rows] for k, v in want[0].items()}, "band")
        assert "bent_normals" in band

        r.config.mesh = mesh
        for i in range(2):
            _equal(r.render(), want[i], f"render() frame {i}")
        assert r.rendered_frames == 2 and r.stats() == dict(
            single.stats(), rendered_frames=2)
        # the profilers' frame is render()'s: the sharded one, every step,
        # with the frame's other spans in SPANS' order
        seen = []

        def step(name):
            seen.append(name)
            return contextlib.nullcontext()

        _equal(r.render_passes(0, step), want[0], "render_passes")
        assert [n for n in seen if n in STEPS] == list(STEPS)
        assert list(dict.fromkeys(seen)) == [n for n in SPANS if n in seen]
        assert r.rendered_frames == 2

        default = renderer(mesh=mesh)
        out = default.render()
        if rank == 0:
            np.savez(os.path.join(out_dir, f"frame{world}.npz"),
                     **{k: v.numpy() for k, v in out.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


def refusal_worker(rank, world, port):
    """The sharded frame refuses a height the ranks do not divide and a
    scene on another device than the mesh's; make_mesh refuses a mesh
    smaller than the world."""
    import pytest
    import torch.distributed as dist

    from tpurt_torch.dist import make_mesh, render_frame_sharded
    from tpurt_torch.passes.gtao import noise_maps_64

    _init(rank, world, port)
    try:
        mesh = make_mesh(device_type="cpu")
        r = renderer()
        cam, lights, gtao = r._frame_inputs()
        noise = noise_maps_64(0, "cpu")
        kw = dict(width=W, gtao_settings=r.config.gtao)
        with pytest.raises(ValueError, match="divisible"):
            render_frame_sharded(r.scene_device, cam, lights, gtao, r._lpm,
                                 noise, height=H + 1, mesh=mesh, **kw)
        cuda_mesh = make_mesh(device_type="cuda")
        with pytest.raises(ValueError, match="the mesh on cuda"):
            render_frame_sharded(r.scene_device, cam, lights, gtao, r._lpm,
                                 noise, height=H, mesh=cuda_mesh, **kw)
        with pytest.raises(ValueError):
            make_mesh(world - 1, device_type="cpu")
    finally:
        dist.destroy_process_group()
