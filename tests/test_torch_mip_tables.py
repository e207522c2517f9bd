"""The mip texel tables: the port's ``_box_mip``, its four atlas builders
(per-layer, quad, pair, block4), ``mip_quad_bytes``, ``mip_pair_bytes``,
the tier cutover of ``flatten_scene(mipmaps=True)`` and which table
``as_pytree``, ``as_object_pytree`` and ``as_full_pytree`` ship, against
tpurt's ``scene/scene.py`` bit for bit. Extents: tpurt's
tests/test_block4.py:30-32 (odd extents exercise the padding) and
``material_field``'s defaults (16-128). The tier is forced by patching
both packages' budgets, as tpurt's tests/test_block4.py does."""
import numpy as np
import pytest

from torch_parity import same_host_builder  # noqa: F401

SIZES = {"even": [(16, 16), (8, 32)], "odd": [(13, 7), (5, 5), (1, 1)]}
BUILDERS = ("build_mip_atlas", "build_mip_quad_atlas",
            "build_mip_pair_atlas", "build_mip_block4_atlas")
TIERS = ("quad", "pair", "block4")


def _stack(sizes, seed=11):
    rng = np.random.default_rng(seed)
    hmax = max(h for h, w in sizes)
    wmax = max(w for h, w in sizes)
    stack = np.zeros((len(sizes) * 3, hmax, wmax, 4), np.uint8)
    for p, (h, w) in enumerate(sizes):
        for layer in range(3):
            stack[p * 3 + layer, :h, :w] = rng.integers(
                0, 256, (h, w, 4), dtype=np.uint8)
    return stack, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("shape", [(16, 16), (13, 7), (1, 9), (6, 1),
                                   (1, 1), (3, 3)])
def test_box_mip_matches(shape):
    from tpurt.scene.scene import _box_mip as ref
    from tpurt_torch.scene.scene import _box_mip

    arr = np.random.default_rng(3).integers(0, 256, (*shape, 4),
                                            dtype=np.uint8)
    got, want = _box_mip(arr), ref(arr)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("sizes", sorted(SIZES))
def test_builders_match(builder, sizes):
    import tpurt.scene.scene as ref
    import tpurt_torch.scene.scene as port

    stack, tex_size = _stack(SIZES[sizes])
    n = len(SIZES[sizes])
    # a duplicate of primitive 0 aliases its rows (dedup_images)
    stack = np.concatenate([stack, stack[:3]])
    tex_size = np.concatenate([tex_size, tex_size[:1]])
    img_of_prim = np.asarray(list(range(n)) + [0], np.int32)
    args = (stack, tex_size, img_of_prim, list(range(n)))
    want = getattr(ref, builder)(*args)
    got = getattr(port, builder)(*args)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if builder != "build_mip_atlas":
        assert got[0].shape[1] == 64 and got[0].dtype == np.uint8
    uniq = list(range(n))
    assert port.mip_quad_bytes(tex_size, uniq) == ref.mip_quad_bytes(
        tex_size, uniq)
    assert port.mip_pair_bytes(tex_size, uniq) == ref.mip_pair_bytes(
        tex_size, uniq)
    if builder == "build_mip_pair_atlas":
        assert got[0].nbytes == port.mip_pair_bytes(tex_size, uniq)


@pytest.mark.parametrize("builder", BUILDERS[:2])
def test_builders_without_dedup(builder):
    import tpurt.scene.scene as ref
    import tpurt_torch.scene.scene as port

    stack, tex_size = _stack(SIZES["odd"], seed=5)
    for g, w in zip(getattr(port, builder)(stack, tex_size),
                    getattr(ref, builder)(stack, tex_size)):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def fields():
    """material_field with its default extents (16-128), resident."""
    from tpurt_torch.scene.procedural import material_field

    model = material_field(nx=3, nz=3, subdiv=1)
    model.update_model_status(np.zeros(3))
    assert model.is_device_resident()
    return [model]


def _flatten_both(models, tier):
    """Both packages' FlatScene with mips, the tier forced by the
    budgets (tpurt's constants patched alike)."""
    import tpurt.scene.scene as ref
    import tpurt_torch.scene.scene as port

    budgets = dict(quad=(1 << 40, 1 << 40), pair=(0, 1 << 40),
                   block4=(0, 0))[tier]
    saved = [(m, m.MIP_QUAD_BUDGET_BYTES, m.MIP_PAIR_BUDGET_BYTES)
             for m in (ref, port)]
    try:
        for m in (ref, port):
            m.MIP_QUAD_BUDGET_BYTES, m.MIP_PAIR_BUDGET_BYTES = budgets
        return (ref.flatten_scene(models, mipmaps=True),
                port.flatten_scene(models, mipmaps=True))
    finally:
        for m, q, p in saved:
            m.MIP_QUAD_BUDGET_BYTES, m.MIP_PAIR_BUDGET_BYTES = q, p


def _assert_same_tree(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("tier", TIERS)
def test_flatten_tier_and_shipped_tables(fields, tier):
    want, got = _flatten_both(fields, tier)
    for t in TIERS:
        built = getattr(got, f"tex_mip_{t}") is not None
        assert built == (t == tier)
        assert built == (getattr(want, f"tex_mip_{t}") is not None)
    assert got.tex_quad48 is None and want.tex_quad48 is None
    for k in ("tex_mip_sizes", "tex_stack", "tex_stack12", "tex_img_of_prim",
              "tri_attr", "tex_size", f"tex_mip_{tier}",
              f"tex_mip_{tier}_offsets"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    # tpurt keeps its per-layer atlas on the host; the port builds the
    # same one on demand from the flattened stack, and ships none
    import tpurt_torch.scene.scene as port

    dedup = port.dedup_images(got.tex_stack12, got.tex_size)
    for g, w in zip(port.build_mip_atlas(got.tex_stack, got.tex_size,
                                         *dedup),
                    (want.tex_atlas, want.tex_mip_offsets,
                     want.tex_mip_sizes)):
        np.testing.assert_array_equal(g, w)
    pt = got.as_pytree()
    _assert_same_tree(pt, want.as_pytree())
    assert f"tex_mip_{tier}" in pt and "tex_mip_sizes" in pt
    for dead in ("tex_stack", "tex_stack12", "tex_atlas", "tex_quad48"):
        assert dead not in pt
    obj = got.as_object_pytree()
    _assert_same_tree(obj, want.as_object_pytree())
    assert f"tex_mip_{tier}" in obj and "tex_stack" not in obj
    full = got.as_full_pytree()
    assert sorted(full) == sorted(want.as_full_pytree())
    np.testing.assert_array_equal(full["tex_stack"], want.tex_stack)
    np.testing.assert_array_equal(full["vtx_pos"], want.vtx_pos)


def test_tier_budget_cutover_is_tpurts(fields):
    """The default budgets pick the quad tier here, and the bytes the
    cutover reads are the built table's but for the 1x1 levels the builder
    repeats up to the global chain length (one 64-byte row each)."""
    import tpurt_torch.scene.scene as port

    flat = port.flatten_scene(fields, mipmaps=True)
    assert flat.tex_mip_quad is not None
    uniq = list(np.unique(flat.tex_img_of_prim, return_index=True)[1])
    levels = flat.tex_mip_sizes.shape[1]
    repeats = sum(levels - (int(np.ceil(np.log2(max(flat.tex_size[p])))) + 1)
                  for p in uniq)
    assert port.mip_quad_bytes(flat.tex_size, uniq) + 64 * repeats == \
        flat.tex_mip_quad.nbytes
    assert port.MIP_QUAD_BUDGET_BYTES == 256 * 1024 * 1024
    assert port.MIP_PAIR_BUDGET_BYTES == 1024 * 1024 * 1024


def test_quad48_only_without_mips(fields):
    import tpurt.scene.scene as ref
    import tpurt_torch.scene.scene as port

    want = ref.flatten_scene(fields)
    got = port.flatten_scene(fields)
    assert got.tex_mip_sizes is None and want.tex_atlas is None
    np.testing.assert_array_equal(got.tex_quad48, want.tex_quad48)
    _assert_same_tree(got.as_pytree(), want.as_pytree())
    _assert_same_tree(got.as_object_pytree(), want.as_object_pytree())
    assert sorted(got.as_full_pytree()) == sorted(want.as_full_pytree())
