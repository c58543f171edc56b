"""The port's sharded paths (parallel/shard.py, comm.py, mesh.py) against
the JAX package's on the CPU, at the same mesh shapes.

The JAX side runs as tests/test_sharding.py does, on the first W of the
8 virtual CPU devices. The port side runs W processes, one per rank, in
a gloo group on the CPU (tests/_torch_parallel_child.py, which imports
no JAX), on the same inputs carried across as numpy arrays
(``convert.scene_from_numpy``); every world size is started once, by the
module's fixture, while the JAX side computes. Each rank's image or
gradient must equal rank 0's bitwise (every rank holds the whole
result). Counterparts of tests/test_sharding.py's dp, ring, a2a, LBVH
ring, mega dp, spp, gradient, bucketed training-step and
``dryrun_multichip`` cases, plus a ring whose triangle count tp does not
divide (tp=3), a ring whose slices exceed 2048 triangles (the cluster
kernel's plain version per slice), and the collectives themselves. The
entry points are compiled programs (jit.py), which on the CPU run their
bodies eagerly; each is also held against JAX's at a frame given as a
0-d tensor, the form a captured graph reads at each replay.

Tolerances: images atol 2e-5, rtol 1e-4 (tests/test_torch_render.py);
gradients scale-normalised atol 1e-4 (tests/test_torch_grad.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu import grad as jgrad
from mini_opencl_raytracer_tpu.config import MeshConfig
from mini_opencl_raytracer_tpu.models import procedural as jproc
from mini_opencl_raytracer_tpu.parallel import mesh as jmesh
from mini_opencl_raytracer_tpu.parallel import shard as jshard

import _torch_parallel_run as run

CFG = J.RenderConfig(width=32, height=32, bounces=2, backend="bruteforce", ray_chunk=256)
CAM = J.Camera.default()


@pytest.fixture(scope="module")
def scenes():
    return {"cornell": J.cornell_scene(), "bunny4000": jproc.bunny_scene(target_tris=4000),
            "bunny6000": jproc.bunny_scene(target_tris=6000)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, scenes):
    work = str(tmp_path_factory.mktemp("parallel"))
    indir = os.path.join(work, "in")
    os.makedirs(indir)
    for name, scene in scenes.items():
        np.savez(os.path.join(indir, f"{name}.npz"), **run.scene_arrays(scene))
    np.savez(os.path.join(indir, "camera.npz"), **run.camera_arrays(CAM))
    r = run.Ranks(indir, work, [(4, "shard4"), (3, "shard3")])
    yield r
    r.close()


def _mesh(dp, tp):
    mc = MeshConfig(dp=dp, tp=tp)
    return jmesh.make_mesh(mc, jax.devices()[:dp * tp]), mc


def _image(ranks, group, name, ref):
    got = ranks.replicated(group, name)["img"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=run.ATOL, rtol=run.RTOL)


@pytest.mark.parametrize("name,fn,dp,tp,backend", [
    ("dp4", jshard.render_sample_dp, 4, 1, "bruteforce"),
    ("ring22", jshard.render_sample_ring, 2, 2, "bruteforce"),
    ("ring14", jshard.render_sample_ring, 1, 4, "bruteforce"),
    ("a2a22", jshard.render_sample_a2a, 2, 2, "bruteforce"),
    ("ring_bvh22", jshard.render_sample_ring, 2, 2, "bvh"),
])
def test_sharded_image_matches_jax(ranks, scenes, name, fn, dp, tp, backend):
    mesh, mc = _mesh(dp, tp)
    cfg = J.RenderConfig(width=32, height=32, bounces=2, backend=backend, ray_chunk=256)
    ref = np.asarray(fn(scenes["cornell"], CAM, cfg, mesh, mesh_cfg=mc))
    _image(ranks, "shard4", name, ref)


def test_dp_mega_matches_jax(ranks, scenes):
    """The dp render on ``mega``: the bounce kernels' plain versions on
    each rank's pixel slice, against JAX's megakernel (interpret mode)."""
    mesh, mc = _mesh(4, 1)
    cfg = J.RenderConfig(width=32, height=32, bounces=2, backend="mega")
    ref = np.asarray(jshard.render_sample_dp(scenes["cornell"], CAM, cfg, mesh, mesh_cfg=mc))
    _image(ranks, "shard4", "dp_mega4", ref)


def test_dp_honors_spp(ranks, scenes):
    mesh, mc = _mesh(4, 1)
    cfg = J.RenderConfig(width=32, height=32, bounces=2, backend="bruteforce",
                         ray_chunk=256, spp=2)
    ref = np.asarray(jshard.render_sample_dp(scenes["cornell"], CAM, cfg, mesh, mesh_cfg=mc))
    _image(ranks, "shard4", "dp_spp4", ref)


def test_ring_tp3_uneven_split(ranks, scenes):
    """3880 triangles over tp=3: the last slice is padded with degenerate
    triangles. The port's default backend (the panel kernel's plain
    version per slice) against JAX's oracle ring at the same mesh."""
    mesh, mc = _mesh(1, 3)
    ref = np.asarray(jshard.render_sample_ring(scenes["bunny4000"], CAM, CFG, mesh,
                                               mesh_cfg=mc))
    assert scenes["bunny4000"].num_triangles % 3
    _image(ranks, "shard3", "ring_tp3", ref)


def test_ring_clustered_slices(ranks, scenes):
    """Slices of 2906 triangles, above the panel's 2048: each runs the
    cluster kernel's plain version on its own accel."""
    mesh, mc = _mesh(2, 2)
    big = scenes["bunny6000"]
    assert -(-big.num_triangles // 2) > 2048
    ref = np.asarray(jshard.render_sample_ring(big, CAM, CFG, mesh, mesh_cfg=mc))
    got = ranks.replicated("shard4", "ring_big22")
    assert str(got["resolved"]) == "pallas"
    np.testing.assert_allclose(got["img"], ref, atol=run.ATOL, rtol=run.RTOL)


def test_sharded_gradients_match_jax(ranks, scenes):
    """d mean(render_sample_dp ** 2) / d every float scene leaf at dp=4
    against jax.grad of the same loss at the same mesh (squared, so that
    each rank's slice of the cotangent differs)."""
    mesh, mc = _mesh(4, 1)
    g = jgrad.grad_float_leaves(
        lambda s: jnp.mean(jshard.render_sample_dp(s, CAM, CFG, mesh, mesh_cfg=mc) ** 2),
        scenes["cornell"])
    run.assert_grads_close(ranks.replicated("shard4", "dp_grad4"), run.jax_leaves(g))


@pytest.mark.parametrize("buckets", [1, 4])
def test_train_step_dp_matches_jax(ranks, scenes, buckets):
    mesh, mc = _mesh(4, 1)
    loss, g = jshard.train_step_dp(scenes["cornell"], CAM, CFG, mesh, mesh_cfg=mc,
                                   grad_buckets=buckets)
    got = ranks.replicated("shard4", f"train{buckets}")
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
    run.assert_grads_close(got, run.jax_leaves(g))


def test_train_step_buckets_agree(ranks):
    """Bucketed and single all-reduce give the same loss and gradients."""
    one, four = ranks.replicated("shard4", "train1"), ranks.replicated("shard4", "train4")
    np.testing.assert_allclose(one["loss"], four["loss"], rtol=1e-6)
    run.assert_grads_close(four, one)


def test_dryrun_multichip_step_matches_jax(ranks, scenes):
    """The port of __graft_entry__.dryrun_multichip: one SGD step through
    render_sample_ring on the LBVH at dp x tp = 2 x 2, against the same
    step of the JAX package."""
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "tp"))
    mc = MeshConfig(dp=2, tp=2)
    cfg = J.RenderConfig(width=32, height=16, bounces=2, backend="bvh", ray_chunk=256)
    scene = scenes["cornell"]
    g = jgrad.grad_float_leaves(
        lambda s: jnp.mean(jshard.render_sample_ring(s, CAM, cfg, mesh, mesh_cfg=mc) ** 2),
        scene)
    got = ranks.replicated("shard4", "dryrun22")
    run.assert_grads_close(got, run.jax_leaves(g))
    new = np.asarray(scene.materials.diffuse - 0.1 * g.materials.diffuse)
    np.testing.assert_allclose(got["new_diffuse"], new, atol=1e-6)
    assert np.abs(got["materials.diffuse"]).max() > 0


@pytest.mark.parametrize("name,fn,dp,tp", [
    ("dp4_f5", jshard.render_sample_dp, 4, 1),
    ("ring22_f5", jshard.render_sample_ring, 2, 2),
    ("a2a22_f5", jshard.render_sample_a2a, 2, 2),
])
def test_tensor_frame_matches_jax(ranks, scenes, name, fn, dp, tp):
    """The port's entry point at frame torch.tensor(5) against JAX's at
    frame 5."""
    mesh, mc = _mesh(dp, tp)
    ref = np.asarray(fn(scenes["cornell"], CAM, CFG, mesh, frame=5, mesh_cfg=mc))
    _image(ranks, "shard4", name, ref)


def test_train_step_dp_tensor_frame_matches_jax(ranks, scenes):
    mesh, mc = _mesh(4, 1)
    loss, g = jshard.train_step_dp(scenes["cornell"], CAM, CFG, mesh, frame=5, mesh_cfg=mc,
                                   grad_buckets=4)
    got = ranks.replicated("shard4", "train4_f5")
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
    run.assert_grads_close(got, run.jax_leaves(g))


def test_collectives(ranks):
    """psum / pmin / pmax / tiled all_gather / all_to_all / ppermute on a
    2 x 2 mesh (rank = 2 dp + tp), their gradients, replicate's summed
    backward, and a self-pair's local copy."""
    per_rank = ranks.result("shard4", "comm")
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    w = np.arange(12, dtype=np.float32).reshape(4, 3) + 1
    for rank, got in enumerate(per_rank):
        dp, tp = divmod(rank, 2)
        x = lambda r: base + 10 * r
        row = [2 * dp, 2 * dp + 1]
        col = [tp, 2 + tp]
        assert (int(got["dp_index"]), int(got["tp_index"])) == (dp, tp)
        np.testing.assert_array_equal(got["sizes"], [2, 2])
        np.testing.assert_array_equal(got["psum_tp"], x(row[0]) + x(row[1]))
        np.testing.assert_array_equal(got["pmin_dp"], np.minimum(x(col[0]), x(col[1])))
        np.testing.assert_array_equal(got["pmax_dp"], np.maximum(x(col[0]), x(col[1])))
        np.testing.assert_array_equal(got["gather_tp"], np.concatenate([x(r) for r in row]))
        # all_to_all: block j of the result is block tp of rank j's x.
        np.testing.assert_array_equal(got["a2a_tp"], np.stack([x(r)[tp] for r in row]))
        np.testing.assert_array_equal(got["ring_tp"], x(row[1 - tp]))
        np.testing.assert_array_equal(got["shift_tp"], x(row[0]) if tp else 0 * base)
        np.testing.assert_array_equal(got["grad_gather_tp"], w[2 * tp:2 * tp + 2])
        np.testing.assert_array_equal(got["grad_shift_tp"], w[:2] if tp == 0 else 0 * base)
        # Row j of this rank's x went to rank j as its row tp, where the
        # cotangent is w[tp].
        np.testing.assert_array_equal(got["grad_a2a_tp"], np.stack([w[tp], w[tp]]))
        np.testing.assert_array_equal(got["grad_replicate_dp"], np.full_like(base, 3.0))
        np.testing.assert_array_equal(got["self_pair"], x(rank))
