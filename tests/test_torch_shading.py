"""The per-triangle material gather (``ops/shading.material_rows``) on the
CPU: both table builders give the values and the leaves' gradients of the
four gathers they used before it, bit for bit; the plain version of the
CUDA reduction and its launch plan. The kernel itself is held against a
float64 reference on the card (tests/test_torch_cuda.py).

One intra-op thread: with more, the CPU's ``index_put_(accumulate=True)``
sums a large index set in an order that changes from run to run.
"""

import dataclasses

import pytest
import torch

import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops import shading
from mini_opencl_raytracer_tpu_torch.ops.cuda import build
from mini_opencl_raytracer_tpu_torch.ops.cuda import material_rows as pmr
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk

torch.set_num_threads(1)

LEAVES = ("diffuse", "specular", "emission", "roughness")


def _four_gathers(materials, mat_idx):
    """The material columns as the builders gathered them before
    ``material_rows``: one gather per leaf."""
    m = mat_idx.to(torch.int64)
    return [materials.diffuse[m], materials.specular[m], materials.emission[m],
            materials.roughness[m][:, None]]


def _shading_table_before(g, materials):
    return torch.cat([g.v0, g.v1, g.v2, g.n0, g.n1, g.n2, g.uv0, g.uv1, g.uv2]
                     + _four_gathers(materials, g.mat_idx), dim=1)


def _mega_table_before(g, materials):
    rows = torch.cat([g.v0.T, (g.v1 - g.v0).T, (g.v2 - g.v0).T, g.n0.T, g.n1.T, g.n2.T]
                     + [c.T for c in _four_gathers(materials, g.mat_idx)], dim=0)
    return torch.nn.functional.pad(rows.to(torch.float32),
                                   (0, pmk._tri_pad(g.num_triangles) - g.num_triangles,
                                    0, pmk._C_PAD - pmk._C))


def _scene(case):
    """Cornell's geometry with the case's material indices, or the bunny."""
    scene = P.cornell_scene(device="cpu")
    g, M = scene.geometry, scene.materials.diffuse.shape[0]
    gen = torch.Generator().manual_seed(7)
    if case == "cornell":
        mi = g.mat_idx
    elif case == "one material":
        mi = torch.full_like(g.mat_idx, 3)
    elif case == "unused material":
        mi = torch.randint(0, M - 1, g.mat_idx.shape, generator=gen, dtype=torch.int32)
        assert not (mi == M - 1).any()
    elif case == "bunny skew":   # 69,696 of 69,732 rows on one material
        return P.bunny_scene(device="cpu")
    else:
        raise ValueError(case)
    return dataclasses.replace(scene, geometry=dataclasses.replace(g, mat_idx=mi))


def _with_leaves(scene, dtype):
    leaves = {k: getattr(scene.materials, k).to(dtype).clone().requires_grad_(True)
              for k in LEAVES}
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, **leaves)), \
        [leaves[k] for k in LEAVES]


@pytest.mark.parametrize("builder", ["material_rows", "shading table", "mega table"])
@pytest.mark.parametrize("case,dtype", [
    ("cornell", torch.float32),
    ("one material", torch.float32),
    ("unused material", torch.float32),
    ("bunny skew", torch.float32),
    ("cornell", torch.float64),
    ("unused material", torch.float64),
])
def test_material_gather_bitwise_as_before(builder, case, dtype):
    """The value and the four leaves' gradients, under a cotangent that
    reaches the builder as autograd hands it over (a strided view of the
    table's gradient), are bitwise what the four gathers gave."""
    scene = _scene(case)
    new, before = {
        "material_rows": (lambda g, m: shading.material_rows(m, g.mat_idx),
                          lambda g, m: torch.cat(_four_gathers(m, g.mat_idx), dim=1)),
        "shading table": (lambda g, m: shading.build_shading_table(g, m).table,
                          _shading_table_before),
        "mega table": (pmk.build_mega_table, _mega_table_before),
    }[builder]
    outs = []
    for fn in (new, before):
        sc, leaves = _with_leaves(scene, dtype)
        value = fn(sc.geometry, sc.materials)
        cot = torch.randn(value.shape, generator=torch.Generator().manual_seed(1),
                          dtype=value.dtype)
        outs.append((value, torch.autograd.grad(value, leaves, cot)))
    (v_new, g_new), (v_old, g_old) = outs
    assert v_new.dtype == v_old.dtype and torch.equal(v_new, v_old)
    for name, a, b in zip(LEAVES, g_new, g_old):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert any(g.abs().sum() > 0 for g in g_new)


def test_material_rows_takes_no_kernel_on_the_cpu():
    scene, leaves = _with_leaves(P.cornell_scene(device="cpu"), torch.float32)
    before = {"material_rows_bwd": build.LAUNCHES["material_rows_bwd"]}
    rows = shading.material_rows(scene.materials, scene.geometry.mat_idx)
    torch.autograd.grad(rows.sum(), leaves)
    assert {k: build.LAUNCHES[k] for k in before} == before
    assert rows.grad_fn is not None and "MaterialRows" not in type(rows.grad_fn).__name__


def test_pack_materials_columns_are_the_table_s():
    mats = P.cornell_scene(device="cpu").materials
    packed = shading.pack_materials(mats)
    st = shading.ShadingTable
    assert packed.shape == (mats.diffuse.shape[0], st.COLS - st.KD) == (6, pmr.COLS)
    assert torch.equal(packed[:, st.KS - st.KD:st.KE - st.KD], mats.specular)
    assert torch.equal(packed[:, st.NS - st.KD], mats.roughness)


@pytest.mark.parametrize("T", [0, 1, 36, 1037, 69_732])
def test_reduce_plain_is_the_sum_by_material(T):
    """The plain version the kernel is held against (and the backward it
    replaces): rows summed by material, negative indices from the end."""
    gen = torch.Generator().manual_seed(T)
    mi = torch.randint(-6, 6, (T,), generator=gen)
    cot = torch.randn(T, 34, generator=gen)[:, 24:]
    ref = torch.zeros(6, 10, dtype=torch.float64).index_add_(
        0, torch.where(mi < 0, mi + 6, mi), cot.double())
    got = pmr.reduce_plain(cot, mi, 6)
    assert got.shape == (6, 10) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M", [1, 6, 64, 65, 1000, 2048, 2049, 100_000])
def test_material_rows_launch_plan(M):
    """Blocks take whole rounds of 256 rows, at least four, and the block
    partials (G x M x 10 floats) stay under 10 bytes a triangle and one
    partial, however many materials (and slices of 2048) there are."""
    rows = pmr.rows_per_block(M)
    assert rows % 256 == 0 and rows >= 1024
    for T in (36, 69_732, 2_000_000):
        G = -(-T // rows)
        assert G * rows >= T > (G - 1) * rows
        assert G * M * pmr.COLS * 4 <= 10 * T + M * pmr.COLS * 4
