"""Rank processes for tests/test_torch_geometry_*.py: gloo on the CPU,
spawned as ``torch_dist_worker`` spawns them, one thread each, on the
same 40x36 frame of the cut bench scene (446 tris, 3 shadow-casting
lights). The module imports only torch, numpy and tpurt_torch, as each
rank's process does."""
from __future__ import annotations

import os

import numpy as np
import torch

from torch_dist_worker import (  # noqa: F401
    CUBES, FIELD, H, W, _init, renderer, spawn)

# ring_gather's table (tpurt's test_ring_gather_matches_direct): 103 rows,
# no multiple of 2 or 4
GATHER_ROWS = 103
GATHER_IDX = 257
# the frames each rank renders: (case, RendererConfig kwargs, the mip tier
# forced by zeroing the budgets above it)
FRAME_CASES = (("default", {}, None),
               ("mip_quad", dict(mipmaps=True), "quad"),
               ("mip_pair", dict(mipmaps=True), "pair"))
TIERS = ("bvh8", "xla")


def gather_inputs(seed: int = 3):
    """The table (f32 rows of 40 and u8 rows of 64) and global indices
    ring_gather is held to: every index in range, plus indices into the
    zero padding and past the last chunk."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((GATHER_ROWS, 40)).astype(np.float32)
    u8 = rng.integers(0, 256, (GATHER_ROWS, 64)).astype(np.uint8)
    idx = rng.integers(0, GATHER_ROWS, GATHER_IDX).astype(np.int32)
    padded = np.array([GATHER_ROWS, GATHER_ROWS + 1, 10 ** 6, -1],
                      np.int32)
    return dict(f32=f32, u8=u8), idx, padded


def ring_worker(rank, world, port, out_dir):
    """ring_shift moves a tree of mixed dtypes and shapes one rank along;
    ring_gather of the f32 and u8 tables (each rank holding its chunk, as
    shard_tables cuts them) for in-range and padded indices; rank 0
    writes the gathered rows."""
    import torch.distributed as dist

    from tpurt_torch.dist import make_mesh, ring_gather, ring_shift
    from tpurt_torch.dist.geometry import _chunked

    _init(rank, world, port)
    try:
        mesh = make_mesh(device_type="cpu")

        def tree(r):
            g = torch.Generator().manual_seed(r)
            return dict(f=torch.randn(7, 3, generator=g),
                        b=(torch.randn(5, generator=g) > 0),
                        pair=(torch.arange(3, dtype=torch.int64) + r,
                              torch.full((2, 3), r, dtype=torch.uint8)),
                        i=torch.full((1,), r, dtype=torch.int32),
                        empty=torch.zeros(0, 4))

        got = ring_shift(tree(rank), mesh)
        want = tree((rank - 1) % world)
        flat_got = torch.utils._pytree.tree_flatten(got)[0]
        flat_want = torch.utils._pytree.tree_flatten(want)[0]
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(flat_got, flat_want)), (rank, got, want)

        tables, idx, padded = gather_inputs()
        out = {}
        for name, table in tables.items():
            chunks, chunk = _chunked(table, world)
            mine = torch.from_numpy(chunks[rank])
            for which, ix in (("idx", idx), ("padded", padded)):
                out[f"{name}_{which}"] = ring_gather(
                    mine, chunk, torch.from_numpy(ix), mesh).numpy()
        if rank == 0:
            np.savez(os.path.join(out_dir, f"gather{world}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tier_renderer(tier_budget, **config):
    """The cut bench renderer with the mip tier `tier_budget` forced."""
    import tpurt_torch.scene.scene as scene_mod

    old = scene_mod.MIP_QUAD_BUDGET_BYTES
    if tier_budget == "pair":
        scene_mod.MIP_QUAD_BUDGET_BYTES = 0
    try:
        return renderer(**config)
    finally:
        scene_mod.MIP_QUAD_BUDGET_BYTES = old


def _traces_agree(r, mesh, rank, world, tier, shard):
    """On the band's camera rays the ring's t equals the single-device
    K1 trace's bit for bit, its tri differs only where t is equal (a tie),
    and the ring's occlusion of every light's shadow rays equals the
    per-light K2 traces. Returns the tie count."""
    from tpurt_torch.dist.geometry import (ring_any, ring_closest,
                                           shard_tracers)
    from tpurt_torch.kernels.traverse_bvh8 import (trace_any_bvh8,
                                                   trace_closest_bvh8)
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import SHADOW_T_MIN, shadow_rays

    band = H // world
    cam, lights, _ = r._frame_inputs()
    o, d = camera_rays(cam, W, H, rank * band, band)
    closest, any_hit = shard_tracers(shard, tier, band, W)
    band_hits = ring_closest(closest, o, d, mesh)
    want = trace_closest_bvh8(r.scene_device, o, d, T_MIN, T_MAX,
                              height=band, width=W)
    assert torch.equal(band_hits["t"], want["t"]), (tier, "t")
    ties = band_hits["tri"] != want["tri"]
    assert torch.equal(band_hits["u"][~ties], want["u"][~ties])
    rays = shadow_rays(r.scene_device, cam, lights, want, d, height=band,
                       image_rows=H, aniso_taps=r.config.aniso_taps)
    occ = ring_any(any_hit, rays[0][0], torch.stack([x[1] for x in rays]),
                   SHADOW_T_MIN, torch.stack([x[2] for x in rays]), mesh)
    for i, (so, sd, tm) in enumerate(rays):
        assert torch.equal(occ[i], trace_any_bvh8(
            r.scene_device, so, sd, SHADOW_T_MIN, tm, height=band,
            width=W)), (tier, "occlusion", i)
    return int(ties.sum())


def frame_worker(rank, world, port, out_dir):
    """Every rank renders FRAME_CASES in both tiers (and the default case's
    quad rows in the arena layout, "bvh8"): its band's traces against the
    single-device ones (``_traces_agree``) and every output gathered by
    gather_frame against the single-device frame, bit for bit; rank 0
    writes the frames, the tie counts and the output mismatches."""
    import torch.distributed as dist

    from tpurt_torch.dist import (freeze_meta, gather_frame, make_mesh,
                                  rank_tensors,
                                  render_frame_sharded_geometry,
                                  shard_geometry, shard_tables)
    from tpurt_torch.dist import geometry
    from tpurt_torch.passes.gtao import noise_maps_64

    _init(rank, world, port)
    try:
        mesh = make_mesh(device_type="cpu")
        saved, report = {}, {}
        for case, config, tier_budget in FRAME_CASES:
            r = _tier_renderer(tier_budget, **config)
            want = r.render_passes(0)
            pt = r.scene.as_pytree()
            if tier_budget is not None:
                assert pt.get(f"tex_mip_{tier_budget}") is not None, case
            cam, lights, gtao = r._frame_inputs()
            variants = [(t, pt) for t in TIERS]
            if case == "default":
                # the arena's flat rows, addressed by tex_quad48_base
                arena = dict(pt, tex_quad48=r.scene_device["tex_quad"]
                             .numpy(), tex_quad48_base=r.scene_device[
                                 "tex_quad_base"].numpy())
                variants.append(("bvh8", arena))
            for i, (tier, scene) in enumerate(variants):
                shards = shard_geometry(scene, world, tier)
                tbl, meta = shard_tables(scene, world) if tier == "bvh8" \
                    else (None, None)
                sc, shard, chunks = rank_tensors(scene, shards, tbl, rank,
                                                 "cpu")
                if tier == "bvh8":
                    assert "tri_attr" not in sc and not any(
                        k in sc for k in geometry.TEXEL_TABLES + (
                            "tex_quad",)), sorted(sc)
                band = render_frame_sharded_geometry(
                    sc, shard, cam, lights, gtao, r._lpm,
                    noise_maps_64(0, "cpu"), width=W,
                    height=H, gtao_settings=r.config.gtao, mesh=mesh,
                    tables=tier, shade_tables=chunks,
                    meta=None if meta is None else freeze_meta(meta))
                ties = _traces_agree(r, mesh, rank, world, tier, shard)
                full = gather_frame(band, mesh)
                label = f"{case}_{tier}" + ("_arena" if i == 2 else "")
                assert sorted(full) == sorted(want), label
                mismatch = {k: int((full[k] != want[k]).reshape(
                    H, W, -1).any(-1).sum()) for k in want}
                ties = torch.tensor([ties])
                dist.all_reduce(ties)
                report[label] = dict(ties=int(ties), **mismatch)
                saved[label] = {k: v.numpy() for k, v in full.items()}
        if rank == 0:
            np.savez(os.path.join(out_dir, f"frames{world}.npz"),
                     **{f"{label}/{k}": v for label, out in saved.items()
                        for k, v in out.items()})
            np.save(os.path.join(out_dir, f"report{world}.npy"), report)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def refusal_worker(rank, world, port):
    """The sharded-geometry frame refuses a height the ranks do not
    divide, shards on another device than the mesh's, an unknown tier and
    the "bvh8" tier without its tables."""
    import pytest
    import torch.distributed as dist

    from tpurt_torch.dist import (make_mesh, rank_tensors,
                                  render_frame_sharded_geometry,
                                  shard_geometry)
    from tpurt_torch.passes.gtao import noise_maps_64

    _init(rank, world, port)
    try:
        mesh = make_mesh(device_type="cpu")
        r = renderer()
        pt = r.scene.as_pytree()
        cam, lights, gtao = r._frame_inputs()
        sc, shard, _ = rank_tensors(pt, shard_geometry(pt, world, "bvh8"),
                                    None, rank, "cpu")
        kw = dict(width=W, gtao_settings=r.config.gtao)
        args = (sc, shard, cam, lights, gtao, r._lpm,
                noise_maps_64(0, "cpu"))
        with pytest.raises(ValueError, match="divisible"):
            render_frame_sharded_geometry(*args, height=H + 1, mesh=mesh,
                                          **kw)
        with pytest.raises(ValueError, match="the mesh on cuda"):
            render_frame_sharded_geometry(*args, height=H, mesh=make_mesh(
                device_type="cuda"), **kw)
        with pytest.raises(ValueError, match="unknown tables"):
            render_frame_sharded_geometry(*args, height=H, mesh=mesh,
                                          tables="bvh4", **kw)
        with pytest.raises(ValueError, match="shade_tables and meta"):
            render_frame_sharded_geometry(*args, height=H, mesh=mesh,
                                          tables="bvh8", **kw)
        with pytest.raises(ValueError, match="empty"):
            shard_geometry(pt, 10 ** 4, "bvh8")
    finally:
        dist.destroy_process_group()


# the cuda worker's frames: (case, RendererConfig kwargs, the mip tier
# forced); the mip frame's texel rows come through ring_gather to K9. The
# sharded-geometry frame samples one tap, as tpurt's (it takes no
# aniso_taps); K9 over the ring's rows is also held at RING_TAPS
CUDA_CASES = (("default", {}, None),
              ("mip_pair", dict(mipmaps=True), "pair"))
RING_TAPS = (1, 4)


def _texels_through_ring(r, pt, tier, chunks, quad_chunk, mesh, rank,
                         world, w, h, taps):
    """K9 at `taps` taps on the band's camera hits over the host tables
    `pt` (which the rank's scene addresses; the renderer's own rows sit in
    its arena) against K9 over the rows ring_gather serves: True when
    bit-equal (NaN where NaN)."""
    from tpurt_torch.dist.geometry import ring_gather
    from tpurt_torch.kernels.mip_texels import mip_texels
    from tpurt_torch.kernels.traverse_bvh8 import trace_closest_bvh8
    from tpurt_torch.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt_torch.passes.shade import _normalize, cone_spread

    band = h // world
    cam, _, _ = r._frame_inputs()
    o, d = camera_rays(cam, w, h, rank * band, band)
    hits = trace_closest_bvh8(r.scene_device, o, d, T_MIN, T_MAX,
                              height=band, width=w)
    dev = d.device

    def table(key):
        return torch.from_numpy(pt[key]).to(dev)

    attr = table("tri_attr")[torch.clamp_min(hits["tri"], 0).long()]
    u, v = hits["u"][:, None], hits["v"][:, None]
    wgt = 1.0 - u - v
    uv = attr[:, 3:5] * wgt + attr[:, 15:17] * u + attr[:, 27:29] * v
    normal = _normalize(attr[:, 5:8] * wgt + attr[:, 17:20] * u
                        + attr[:, 29:32] * v)
    args = (table(f"tex_mip_{tier}_offsets"), table("tex_mip_sizes"),
            hits["t"], d, normal, attr, uv, cone_spread(cam, h), taps)
    direct = mip_texels(tier, table(f"tex_mip_{tier}"), *args)
    ring = mip_texels(tier, None, *args, gather=lambda f: ring_gather(
        chunks["quad_rows"], quad_chunk, f, mesh))
    nan = torch.isnan(direct)
    return bool(torch.equal(torch.isnan(ring), nan)
                and torch.equal(ring[~nan].view(torch.int32),
                                direct[~nan].view(torch.int32)))


def cuda_worker(rank, world, port, out_dir):
    """On the card (cuda:0, gloo ranks): the "bvh8" ring frames of a 96x80
    cut bench scene (CUDA_CASES) against render(); each rank launches K1
    and K5 once per shard, K10 and its epilogue, K3h, K3 over its band and
    K4 once, and no K2;
    on the mip scene K9's rows and K9 once, and K9 over the ring's rows
    equals K9 over the table on the band's hits at RING_TAPS taps. Rank 0
    writes each case's masks of differing pixels per output and the
    launches' and texels' verdicts; a rank records a failed check there
    rather than raising, so that every rank reaches every collective."""
    import torch.distributed as dist

    import tpurt_torch.scene.scene as scene_mod
    from tpurt_torch.app.bench_scene import build_bench_scene
    from tpurt_torch.dist import (freeze_meta, gather_frame, make_mesh,
                                  rank_tensors,
                                  render_frame_sharded_geometry,
                                  shard_geometry, shard_tables)
    from tpurt_torch.engine import Renderer, RendererConfig
    from tpurt_torch.kernels import build
    from tpurt_torch.passes.gtao import noise_maps_64

    torch.cuda.set_device(0)
    _init(rank, world, port)
    try:
        mesh = make_mesh(device_type="cuda")
        w, h = 96, 80
        saved = {}
        for case, config, tier in CUDA_CASES:
            old = scene_mod.MIP_QUAD_BUDGET_BYTES
            if tier == "pair":
                scene_mod.MIP_QUAD_BUDGET_BYTES = 0
            try:
                r = build_bench_scene(Renderer(RendererConfig(
                    width=w, height=h, device="cuda", **config)),
                    field=dict(nx=4, nz=4, subdiv=3), cubes=4)
            finally:
                scene_mod.MIP_QUAD_BUDGET_BYTES = old
            want = r.render_passes(0)
            pt = r.scene.as_pytree()
            tbl, meta = shard_tables(pt, world)
            sc, shard, chunks = rank_tensors(
                pt, shard_geometry(pt, world, "bvh8"), tbl, rank, "cuda")
            cam, lights, gtao = r._frame_inputs()
            build.reset_counts()
            band = render_frame_sharded_geometry(
                sc, shard, cam, lights, gtao, r._lpm,
                noise_maps_64(0, "cuda"), width=w, height=h,
                gtao_settings=r.config.gtao, mesh=mesh, tables="bvh8",
                shade_tables=chunks, meta=freeze_meta(meta))
            launched = {k: v for k, v in build.launch_counts.items() if v}
            texels = {} if tier is None else dict(mip_texel_rows=1,
                                                  mip_texels=1)
            launches_ok = launched == dict(
                bvh8_closest=world, bvh8_any_multi=world, gtao_noise=1,
                gtao_main_band=1, gtao_denoise=1, shade_light_rays=1,
                shade_light_sum=1, shade_surface=1, shade_surface_nmap=1,
                **texels)
            got = gather_frame(band, mesh)
            saved.update({f"{case}/{k}": (got[k] != want[k]).reshape(
                h, w, -1).any(-1).cpu().numpy() for k in want})
            ok = torch.tensor([launches_ok, tier is None or all(
                _texels_through_ring(r, pt, tier, chunks,
                                     freeze_meta(meta)[1], mesh, rank,
                                     world, w, h, taps)
                for taps in RING_TAPS)], dtype=torch.int32)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            saved[f"{case}/ok_launches"] = np.array(bool(ok[0]))
            saved[f"{case}/ok_texels"] = np.array(bool(ok[1]))
        if rank == 0:
            np.savez(os.path.join(out_dir, "cuda.npz"), **saved)
        dist.barrier()
    finally:
        dist.destroy_process_group()
