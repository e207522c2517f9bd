"""The band-sharded frame — port of ``tpurt/dist/sharding.py`` on
``torch.distributed``.

tpurt runs one ``shard_map`` program over a device mesh; here each rank is
a process that runs the body for its own band, and the collectives go
through the mesh's process group:

* the scene (BVH, geometry, textures) is replicated: every rank holds the
  whole scene and rays never cross ranks;
* rank k renders rows [k * band, (k + 1) * band) through the
  single-device frame's own G-buffer producer and pass tail
  (``engine.frame.render_gbuffer``, ``finish_frame``), so spp, anisotropic
  taps, the ray cone (which spreads over the whole image's height), the
  quantization and the tonemap are the frame's;
* the pass tail all-gathers the quantized depth and normal rows, because
  GTAO samples depth up to its screen-space radius away, and runs GTAO for
  the band plus a denoise halo (``passes.gtao.compute_ao_band``: K3 over
  the band's rows, K4 over that array).

``ring_shift`` is the port's ``jax.lax.ppermute`` around the ring, which
the sharded-geometry frame (``dist/geometry.py``) rides.

Transport: the band tensors are gathered in one collective on the mesh's
group, on the tensors' own device. NCCL needs one card per rank; gloo
(which the CPU runs use, and which several ranks sharing one card need,
since NCCL refuses two ranks on one GPU) takes CPU tensors and, in torch
2.11, CUDA tensors too (``chip_smoke.py`` phase 13 runs it so on the card).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from ..engine.frame import finish_frame, no_step, render_gbuffer
from ..passes.gtao import GtaoSettings


def make_mesh(n=None, axis: str = "x", device_type: str = "cuda"):
    """A 1-D DeviceMesh named `axis` over the initialized world (tpurt's
    ``make_mesh``, which returns a ``jax.sharding.Mesh``): `n` ranks, all
    of them by default. ``device_type`` is that of the tensors the ranks
    render on ("cuda" unless the caller asks for "cpu")."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized")
    world = dist.get_world_size()
    n = world if n is None else int(n)
    if n != world:
        raise ValueError(f"make_mesh: a mesh of {n} ranks over a world of "
                         f"{world}; every rank renders a band")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))


def transport(mesh, device: torch.device) -> str:
    """The backend that carries band tensors on `device` across the mesh's
    group: "nccl" (CUDA tensors only) or "gloo"."""
    backend = dist.get_backend(mesh.get_group())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("render_frame_sharded: an NCCL mesh needs CUDA "
                         "tensors")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"render_frame_sharded: unsupported backend "
                         f"{backend!r}")
    return backend


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' (R, ...) tensors stacked along rows in rank order: (n *
    R, ...), on x's device (``transport`` says which backend carries
    them)."""
    x = x.contiguous()
    out = x.new_empty((mesh.size() * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_single replaces all_gather_into_tensor in newer torch
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=mesh.get_group())
    return out


def ring_shift(tree, mesh):
    """tpurt's ``jax.lax.ppermute`` over the mesh with the perm i -> i + 1:
    `tree` (a tensor, or a list, tuple or dict of them) as rank r - 1
    holds it, on rank r. Every tensor goes out in one all-gather of their
    bytes (each padded to 8), and each rank keeps its predecessor's slice:
    n times the bytes of a true ring, on the one collective that NCCL and
    gloo take for CPU and CUDA tensors alike (``transport``). With one
    rank it is the identity and makes no collective call."""
    n = mesh.size()
    if n == 1:
        return tree
    leaves, spec = pytree.tree_flatten(tree)
    pieces, offsets = [], [0]
    for x in leaves:
        b = x.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 8
        pieces.append(torch.cat([b, b.new_zeros(pad)]) if pad else b)
        offsets.append(offsets[-1] + b.numel() + pad)
    got = all_gather_rows(torch.cat(pieces)[None], mesh)
    row = got[(mesh.get_local_rank() - 1) % n].clone()
    out = [row[a:a + x.numel() * x.element_size()].view(x.dtype)
           .reshape(x.shape) for x, a in zip(leaves, offsets)]
    return pytree.tree_unflatten(out, spec)


def render_frame_sharded(scene: dict, camera: dict, lights: dict, gtao: dict,
                         lpm: dict, noise, *, width: int,
                         height: int, gtao_settings: GtaoSettings, mesh,
                         enable_gtao: bool = True,
                         enable_tonemap: bool = True, spp: int = 1,
                         aniso_taps: int = 1, step=no_step) -> dict:
    """This rank's band of one frame over the 1-D `mesh` (every rank of the
    mesh calls it with the same inputs). The height must divide by the
    mesh size. Returns the single-device frame's outputs
    (``engine.frame.finish_frame``) for rows [rank * band, (rank + 1) *
    band): image, color, depth, normal, ao and, with bent normals,
    bent_normals. The scene's tensors must lie on the mesh's device type;
    nothing moves to another device. step as in ``render_frame``."""
    n = mesh.size()
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    device = scene["tris"].device
    if device.type != mesh.device_type:
        raise ValueError(f"render_frame_sharded: the scene is on {device}, "
                         f"the mesh on {mesh.device_type}")
    transport(mesh, device)
    band = height // n
    row0 = mesh.get_local_rank() * band
    g = render_gbuffer(scene, camera, lights, width=width, height=height,
                       row_start=row0, num_rows=band, spp=spp,
                       aniso_taps=aniso_taps, step=step)
    return finish_frame(g, gtao, lpm, noise, width=width,
                        height=height, gtao_settings=gtao_settings,
                        enable_gtao=enable_gtao,
                        enable_tonemap=enable_tonemap, step=step,
                        row_start=row0, num_rows=band,
                        gather=lambda x: all_gather_rows(x, mesh))


def gather_frame(band_out: dict, mesh) -> dict:
    """Every output of ``render_frame_sharded`` all-gathered to the whole
    frame's shape (the shapes tpurt's out_specs assemble), on every rank."""
    return {k: all_gather_rows(v, mesh) for k, v in band_out.items()}
