"""The sharded-geometry frame — port of ``tpurt/dist/geometry.py`` on
``torch.distributed``.

The band-sharded frame (``dist/sharding.py``) holds the whole scene on
every rank. Here each rank holds one shard of it:

* the triangles split into n contiguous runs of the global BVH's leaf
  order (spatially coherent), and rank r holds shard r's own SAH BVH and
  triangles, with global triangle ids;
* rays visit every shard by riding a ring (``sharding.ring_shift``, the
  port's ppermute i -> i + 1), carrying their best hit; after n stops a
  band's rays are home with the global result:

      for stop in range(n):
          carry = trace_local(shard, carry)
          carry = ring_shift(carry)

  the band that starts on rank r visits shards r, r + 1, ..., which
  decides the triangle that wins an equal-t tie between shards;
* ``tables="bvh8"`` (tpurt's flagship tier): each stop runs K1 with the
  carried hit distance as the rays' t_max; every light's shadow rays ride
  one tour of K5 (occluded lanes park with t_max = 0), and the shading
  tables are row-sharded (``shard_tables``) and served by ``ring_gather``,
  the table analogue of the ray ring;
* ``tables="xla"`` (tpurt's prototype tier, traced there by its XLA
  tracer): each shard is a binary BVH traced by K6, one tour for the
  primary rays and one per light; the shading tables stay replicated.

Every rank runs the same body for its band (one process per rank), then
the pass tail of the band-sharded frame (``engine/frame.finish_frame``
with the depth and normal rows all-gathered: K3h, K3 over the band, K4,
the tonemap). A rank holds its shard, its table chunks and the small
replicated tables, and allocates no large table of another rank's;
``hbm_accounting`` counts those bytes.

Host side, from the flattened scene's pytree (``FlatScene.as_pytree()``
of either package): ``shard_geometry`` and ``shard_tables`` build every
rank's tables, ``rank_tensors`` uploads one rank's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bvh.builder import build_bvh_sah
from ..bvh.flat import check_traversal_depth, tri_aabbs
from ..bvh.wide import collapse8, compact_bvh8
from ..engine.convert import (_check_bvh8, bvh2_tensors, pack_tris,
                              texel_tensors)
from ..engine.frame import finish_frame
from ..kernels.traverse_bvh2 import trace_any_bvh2, trace_closest_bvh2
from ..kernels.traverse_bvh8 import trace_any_bvh8_multi, trace_closest_bvh8
from ..passes.gtao import GtaoSettings
from ..passes.rays import T_MAX, T_MIN, camera_rays
from ..passes.shade import shade
from .sharding import all_gather_rows, ring_shift, transport

# the shards' SAH leaves, tpurt's, and K6's leaf width in the "xla" tier
MAX_LEAF = 4
TIERS = ("xla", "bvh8")
# the texel tables a scene may ship, in tpurt's order of precedence for
# sharding (shard_tables)
TEXEL_TABLES = ("tex_mip_block4", "tex_mip_pair", "tex_mip_quad",
                "tex_quad48")


def shard_geometry(scene: dict, n_shards: int, tables: str = "xla") -> list:
    """Host side: split the scene's triangles into n_shards contiguous runs
    of the global BVH's leaf order, build one SAH BVH per shard (leaves of
    up to MAX_LEAF) and return each shard's traversal tables (numpy),
    triangle ids global. tables="bvh8": ``nodes8`` (M, 128) from
    ``collapse8``, its compact table ``nodes8c`` (M, 56), ``tris`` (T, 12)
    and ``depth8``, what K1 and K5 read; tables="xla": K6's ``nodes2``,
    ``nodes2c``, ``tris`` and ``depth2`` (``engine/convert.bvh2_tensors``).
    Shards are not padded: a rank holds only its own."""
    if tables not in TIERS:
        raise ValueError(f"unknown tables {tables!r}, not one of {TIERS}")
    geom = {k: np.asarray(v) for k, v in scene["geom"].items()}
    order = geom["tri_id"]
    bounds = np.linspace(0, len(order), n_shards + 1).astype(np.int64)
    if np.any(np.diff(bounds) == 0):
        raise ValueError(f"{len(order)} triangles in {n_shards} shards: "
                         f"a shard would be empty")
    shards = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        v0, e1, e2 = (geom[k][lo:hi] for k in ("v0", "e1", "e2"))
        amin, amax = tri_aabbs(v0, v0 + e1, v0 + e2)
        bvh = build_bvh_sah(amin, amax, max_leaf_size=MAX_LEAF)
        ro = np.asarray(bvh.tri_order)
        g = dict(v0=v0[ro], e1=e1[ro], e2=e2[ro],
                 tri_id=order[lo:hi][ro].astype(np.int32))
        if tables == "bvh8":
            nodes8 = collapse8(bvh.as_pytree())[0]
            shards.append(dict(
                nodes8=nodes8,
                nodes8c=compact_bvh8(torch.from_numpy(nodes8)).numpy(),
                tris=pack_tris(g), depth8=_check_bvh8(nodes8)))
        else:
            t = bvh2_tensors(bvh.as_pytree(), g, check_traversal_depth(bvh),
                             "cpu")
            shards.append({k: v.numpy() if isinstance(v, torch.Tensor)
                           else v for k, v in t.items()})
    return shards


def _chunked(a, n):
    """(n, ceil(rows / n), ...) zero-padded row chunks of `a`, and the
    chunk's rows."""
    a = np.asarray(a)
    rows = a.shape[0]
    chunk = -(-rows // n)
    out = np.zeros((n * chunk,) + a.shape[1:], a.dtype)
    out[:rows] = a
    return out.reshape(n, chunk, *a.shape[1:]), chunk


def shard_tables(scene: dict, n_shards: int):
    """Host side: row-shard the shading tables into n_shards chunks of
    ceil(rows / n) rows, zero-padded (tpurt's). Returns (tables, meta):
    tables ``tri_attr`` and, when the scene ships a texel table,
    ``quad_rows`` (block4, pair or mip quad rows, the quad slab flattened
    to (U*H*W, 64), or the arena's flat rows, which ``tex_quad48_base``
    addresses), each (n, chunk, ...); meta ``attr_chunk``, ``quad_chunk``,
    ``quad_shape`` (the slab's (U, H, W, C), else None) and ``mip_rows``.
    Rank c owns rows [c * chunk, (c + 1) * chunk) of each table, served to
    any rank by ``ring_gather`` on global indices: the row split is
    independent of the geometry's."""
    attr, attr_chunk = _chunked(scene["tri_attr"], n_shards)
    tables = dict(tri_attr=attr)
    meta = dict(attr_chunk=attr_chunk, quad_shape=None, mip_rows=None)
    key = next((k for k in TEXEL_TABLES if scene.get(k) is not None), None)
    if key is not None:
        full = np.asarray(scene[key])
        if key != "tex_quad48":
            meta["mip_rows"] = int(full.shape[0])
        elif full.ndim == 4:
            meta["quad_shape"] = tuple(full.shape)
            full = full.reshape(-1, full.shape[-1])
        tables["quad_rows"], meta["quad_chunk"] = _chunked(full, n_shards)
    return tables, meta


def freeze_meta(meta: dict) -> tuple:
    """shard_tables' meta -> (attr_chunk, quad_chunk, quad_shape,
    mip_rows), the form render_frame_sharded_geometry takes (tpurt's
    static argument)."""
    return (meta["attr_chunk"], meta.get("quad_chunk"),
            meta.get("quad_shape"), meta.get("mip_rows"))


def _nbytes(a) -> int:
    return int(np.asarray(a).nbytes) if a is not None else 0


def _shard_bytes(shard: dict) -> int:
    return sum(int(v.nbytes) for v in shard.values()
               if isinstance(v, np.ndarray))


def hbm_accounting(scene: dict, shards: list, tables: dict | None,
                   n_shards: int, rank=None) -> dict:
    """Device bytes per rank: the replicated frame's residency against the
    sharded-geometry frame's (tpurt's keys and headline). Replicated:
    every flat table of 1 MiB or more and the named shading tables on
    their own lines, the smaller ones lumped, and ``traversal``, what
    ``convert.scene_tensors`` uploads for it (``nodes8``, ``nodes8c``,
    ``tris`` and ``uvp``). Per rank: its shard's tables (`rank`'s, or the
    largest shard's with rank=None: the rank that sets the ceiling), one
    chunk of each sharded table, or with tables=None (the "xla" tier) the
    replicated ``tri_attr`` and texel table, and the small tables. The
    headline ``ceiling_ratio`` is how much larger a scene fits per rank.

    tpurt sums ``nbytes // n`` over its stacked shards' values, which in
    its "xla" tier are dicts of 8 bytes each, and counts no shading table
    in that tier (ROADMAP F24); the port counts the arrays a rank holds."""
    named = ("tri_attr",) + TEXEL_TABLES
    flat = {k: _nbytes(v) for k, v in scene.items()
            if k not in ("bvh", "geom")}
    big_cut = 1 << 20
    replicated = {k: b for k, b in flat.items()
                  if b >= big_cut or k in named}
    for k in named:
        replicated.setdefault(k, 0)
    nodes = np.asarray(scene["bvh"]["nodes8"])
    geom = scene["geom"]
    replicated["traversal"] = (
        nodes.nbytes + nodes.shape[0] * 56 * 4
        + pack_tris({k: np.asarray(geom[k]) for k in ("v0", "e1", "e2",
                                                      "tri_id")}).nbytes
        + _nbytes(geom.get("uvp")))
    small = sum(b for k, b in flat.items()
                if b < big_cut and k not in named)
    replicated["small_replicated"] = small

    per = [_shard_bytes(s) for s in shards]
    per_chip = dict(small_replicated=small,
                    traversal=max(per) if rank is None else per[rank])
    if tables is not None:
        per_chip["tri_attr"] = int(tables["tri_attr"][0].nbytes)
        q = tables.get("quad_rows")
        per_chip["texture_rows"] = int(q[0].nbytes) if q is not None else 0
    else:
        per_chip["tri_attr"] = flat["tri_attr"]
        per_chip["texture_rows"] = sum(flat.get(k, 0) for k in TEXEL_TABLES)
    rep_total = sum(replicated.values())
    shard_total = sum(per_chip.values())
    return dict(n_shards=n_shards,
                replicated_bytes=replicated, replicated_total=rep_total,
                sharded_per_chip=per_chip, sharded_total=shard_total,
                ceiling_ratio=rep_total / max(shard_total, 1))


def rank_tensors(scene: dict, shards: list, tables: dict | None, rank: int,
                 device):
    """Upload one rank's inputs of render_frame_sharded_geometry to
    `device`: (scene, shard, shade_tables). `scene` holds the replicated
    tables the rank's shade reads: with `tables` (the "bvh8" tier) only
    the small ones (the mip sizes and offsets, the arena's
    ``tex_quad_base``), the sharded tables left out; with tables=None (the
    "xla" tier) also ``tri_attr`` and the texel table. `shard` is shard
    `rank`'s traversal tables, shade_tables its chunk of each table of
    `tables` (None without)."""
    def up(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    sharded = set(TEXEL_TABLES) if tables is not None else set()
    rep = texel_tensors({k: v for k, v in scene.items()
                         if k not in sharded}, device)
    if tables is None:
        rep["tri_attr"] = up(scene["tri_attr"], torch.float32)
    if scene.get("tex_quad48_base") is not None:
        rep["tex_quad_base"] = up(scene["tex_quad48_base"], torch.int32)
    shard = {k: up(v) if isinstance(v, np.ndarray) else v
             for k, v in shards[rank].items()}
    chunks = None if tables is None else {k: up(v[rank])
                                          for k, v in tables.items()}
    return rep, shard, chunks


def serve_rows(table, chunk: int, rank: int, idx, acc):
    """One stop of ``ring_gather``: `acc` with the rows of global indices
    `idx` that `rank` owns (rows [rank * chunk, (rank + 1) * chunk), its
    (chunk, ...) `table`) filled in. The local index is clamped before the
    gather, since torch raises where XLA clamps."""
    local = idx.long() - rank * chunk
    ok = (local >= 0) & (local < chunk)
    rows = table[torch.clamp(local, 0, chunk - 1)]
    return torch.where(ok.reshape(ok.shape + (1,) * (rows.ndim - ok.ndim)),
                       rows, acc)


def ring_gather(table, chunk: int, idx, mesh):
    """A row gather from a row-sharded table over the mesh's ring: `table`
    is this rank's (chunk, ...) rows, `idx` global row indices. The (idx,
    rows) block tours the ring; at each of the n stops the resident rank
    serves the rows it owns (``serve_rows``). Rows no rank owns stay 0."""
    if table.shape[0] != chunk:
        raise ValueError(f"ring_gather: a chunk of {table.shape[0]} rows, "
                         f"not {chunk}")
    me = mesh.get_local_rank()
    acc = table.new_zeros(tuple(idx.shape) + tuple(table.shape[1:]))
    for _ in range(mesh.size()):
        acc = serve_rows(table, chunk, me, idx, acc)
        idx, acc = ring_shift((idx, acc), mesh)
    return acc


def ring_closest(trace, origin, direction, mesh) -> dict:
    """The ray ring's closest hit: n stops of trace(origin, direction,
    t_max) -> dict(t, tri, u, v) on this rank's shard, each with the
    carried hit distance as t_max; a strictly smaller t replaces (t, tri,
    u, v). The rays and their carry ride the ring between stops."""
    n = origin.shape[0]
    t = torch.full((n,), T_MAX, dtype=torch.float32, device=origin.device)
    carry = (origin, direction, t,
             torch.full((n,), -1, dtype=torch.int32, device=origin.device),
             torch.zeros_like(t), torch.zeros_like(t))
    for _ in range(mesh.size()):
        o, d, t, tri, u, v = carry
        h = trace(o, d, t)
        better = h["t"] < t
        carry = ring_shift((o, d, torch.where(better, h["t"], t),
                            torch.where(better, h["tri"], tri),
                            torch.where(better, h["u"], u),
                            torch.where(better, h["v"], v)), mesh)
    return dict(zip(("t", "tri", "u", "v"), carry[2:]))


def ring_any(trace, origin, dirs, t_min: float, t_maxs, mesh):
    """The ray ring's occlusion of S ray sets sharing `origin`: dirs (S, N,
    3), t_maxs (S, N); n stops of trace(origin, dirs, t_min, t_maxs) ->
    (S, N) bool on this rank's shard, occluded lanes parked with t_max =
    0 (no tracer occludes t_max <= t_min). Returns (S, N) bool."""
    occ = torch.zeros(t_maxs.shape, dtype=torch.bool, device=origin.device)
    carry = (origin, dirs, t_maxs, occ)
    for _ in range(mesh.size()):
        o, d, tm, occ = carry
        occ = occ | trace(o, d, t_min, torch.where(occ, 0.0, tm))
        carry = ring_shift((o, d, tm, occ), mesh)
    return carry[3]


def shard_tracers(shard: dict, tables: str, band: int, width: int):
    """(closest, any) tracers of one shard over a band's pixels, as the
    tours call them: K1 and K5 ("bvh8"), or K6's closest and any hit per
    set ("xla")."""
    kw = dict(height=band, width=width)
    if tables == "bvh8":
        def closest(o, d, t_max):
            return trace_closest_bvh8(shard, o, d, T_MIN, t_max, pop2=False,
                                      uv_payload=False, **kw)

        def any_hit(o, dirs, t_min, t_maxs):
            return trace_any_bvh8_multi(shard, o, dirs, t_min, t_maxs,
                                        pop2=False, **kw)
    else:
        def closest(o, d, t_max):
            return trace_closest_bvh2(shard, o, d, T_MIN, t_max,
                                      max_leaf=MAX_LEAF, **kw)

        def any_hit(o, dirs, t_min, t_maxs):
            return torch.stack([trace_any_bvh2(shard, o, d, t_min, tm,
                                               max_leaf=MAX_LEAF, **kw)
                                for d, tm in zip(dirs, t_maxs)])
    return closest, any_hit


def render_frame_sharded_geometry(scene: dict, shards: dict, camera: dict,
                                  lights: dict, gtao: dict, lpm: dict,
                                  noise, *, width: int,
                                  height: int, gtao_settings: GtaoSettings,
                                  mesh, enable_gtao: bool = True,
                                  enable_tonemap: bool = True,
                                  tables: str = "xla",
                                  shade_tables: dict | None = None,
                                  meta: tuple | None = None) -> dict:
    """This rank's band of one frame with the geometry sharded over the
    1-D `mesh` (every rank calls it; the height must divide by the mesh
    size). `scene`, `shards` and `shade_tables` are this rank's
    (``rank_tensors``); `meta` is ``freeze_meta(shard_tables(...)[1])``,
    needed with tables="bvh8". Returns rows [rank * band, (rank + 1) *
    band) of image, color, depth, normal, ao (and bent_normals with bent
    settings), as ``render_frame_sharded`` does; ``gather_frame``
    assembles them.

    The band's camera rays take the closest-hit ring; "bvh8" gathers the
    hit triangles' attribute rows and the texel rows through
    ``ring_gather`` and sends every light's shadow rays on one K5 tour,
    "xla" shades from its replicated tables with one K6 tour per light.
    Both tiers pass the band (height, width) and the image's rows to
    shade, so a mip scene's ray cone spreads over the whole image; tpurt's
    "xla" tier passes neither (ROADMAP F25)."""
    if tables not in TIERS:
        raise ValueError(f"unknown tables {tables!r}, not one of {TIERS}")
    n = mesh.size()
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    device = shards["tris"].device
    if device.type != mesh.device_type:
        raise ValueError(f"render_frame_sharded_geometry: the shard is on "
                         f"{device}, the mesh on {mesh.device_type}")
    transport(mesh, device)
    band = height // n
    row0 = mesh.get_local_rank() * band
    origin, direction = camera_rays(camera, width, height, row0, band)
    closest, any_hit = shard_tracers(shards, tables, band, width)
    hits = ring_closest(closest, origin, direction, mesh)
    kw = dict(height=band, width=width, direction=direction,
              image_rows=height)
    if tables == "bvh8":
        if shade_tables is None or meta is None:
            raise ValueError("tables='bvh8' needs shade_tables and meta "
                             "(shard_tables, freeze_meta)")
        attr_chunk, quad_chunk, quad_shape, _ = meta

        def quad_gather(flat):
            return ring_gather(shade_tables["quad_rows"], quad_chunk, flat,
                               mesh)

        def shadows(o, dirs, t_min, t_maxs):
            return ring_any(any_hit, o, torch.stack(list(dirs)), t_min,
                            torch.stack(list(t_maxs)), mesh)

        kw.update(attr_rows=ring_gather(shade_tables["tri_attr"],
                                        attr_chunk,
                                        torch.clamp_min(hits["tri"], 0),
                                        mesh),
                  quad_gather=(quad_gather if "quad_rows" in shade_tables
                               else None),
                  quad_shape=quad_shape, shadow_trace_multi_fn=shadows)
    else:
        def shadow(o, d, t_min, t_max):
            return ring_any(any_hit, o, d[None], t_min, t_max[None], mesh)[0]

        kw.update(shadow_trace_fn=shadow)
    g = shade(scene, camera, lights, hits, **kw)
    return finish_frame(g, gtao, lpm, noise, width=width,
                        height=height, gtao_settings=gtao_settings,
                        enable_gtao=enable_gtao,
                        enable_tonemap=enable_tonemap, row_start=row0,
                        num_rows=band,
                        gather=lambda x: all_gather_rows(x, mesh))
