"""The plain versions of the port's two bounce kernels against the JAX
megakernel's (``_run_bounce0_fwd`` / ``_run_bounce_fwd``, Pallas in
interpret mode on the CPU, where the selection divide is exact).

Same inputs on both sides, 32x32 rays. Tolerances: atol 2e-5, rtol 1e-4
on float outputs (those of tests/test_megakernel.py): the math is the same
float32 arithmetic in a different operation order, with transcendentals
from two libraries, so results differ by a few ulps. Seeds, winner
indices, occlusion bits and the alive mask are compared exactly. The port
reports winner -1 for rays that were not alive and occlusion bits only for
rays that stay alive; the JAX outputs are masked the same way before the
comparison.

The CUDA kernels themselves run only on a GPU: tests/test_torch_cuda.py
(marker ``cuda``) compares them with these plain versions there, and
chip_smoke.py does at full size.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mini_opencl_raytracer_tpu as J
from mini_opencl_raytracer_tpu.ops.linalg import cross as jcross
from mini_opencl_raytracer_tpu.ops.pallas import megakernel as jmk
import mini_opencl_raytracer_tpu_torch as P
from mini_opencl_raytracer_tpu_torch.ops import rng as trng
from mini_opencl_raytracer_tpu_torch.ops.cuda import megakernel as pmk

torch.set_num_threads(1)

ATOL, RTOL = 2e-5, 1e-4
W = H = 32
R = W * H
FRAME = 5
BOUNCE = 3


def _arrays(jscene):
    out = {}
    for group in ("geometry", "materials", "lights"):
        obj = getattr(jscene, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


def _two_lights():
    return J.Lights(
        position=jnp.array([[0.0, -10.0, 16.0], [0.0, 10.0, 16.0]]),
        direction=jnp.array([[-0.5, 0.4, -0.1], [0.0, 0.1, -1.0]]),
        light_type=jnp.array([J.LIGHT_POINT, J.LIGHT_SPOT], jnp.int32),
        intensity=jnp.array([16.0, 12.0]),
        attenuation=jnp.array([0.8, 0.05]),
        cos_cutoff=jnp.array([0.9, 0.7]))


CASES = {
    "defaults": ({}, False),
    "shadow_dspec_2lights": (dict(shadow_rays=True, direct_specular=True), True),
    "ggx": (dict(specular_model="ggx", specular_prob=0.7), False),
    "soft_edge": (dict(soft_edge_sigma=0.05), False),
}


def _panels_to_flat(a, n=R):
    """JAX [k, n_rows, 128] / [n_rows, 128] panels -> numpy [k, n] / [n]."""
    a = np.asarray(a)
    return a.reshape(a.shape[0], -1)[:, :n] if a.ndim == 3 else a.reshape(-1)[:n]


def _flat_to_panels(a: np.ndarray, fills=(0.0, 0.0, 0.0)):
    """numpy [k, R] / [R] -> JAX panels padded to whole tiles; row i of a
    [k, R] array is padded with fills[i] (directions pad z with 1, as
    megakernel.trace_paths_mega does)."""
    if a.ndim == 1:
        return jmk._to_panels(jnp.asarray(a), R)
    return jnp.stack([jmk._to_panels(jnp.asarray(a[i]), R, fill=fills[i])
                      for i in range(a.shape[0])])


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """Run both JAX kernels once per case; carry the inputs across."""
    kw, two = CASES[request.param]
    js = J.cornell_scene(lights=_two_lights() if two else None)
    jcfg = J.RenderConfig(width=W, height=H, **kw)
    pcfg = P.RenderConfig(width=W, height=H, **kw)
    cam = J.Camera.default()

    tableT = jmk.build_mega_table(js.geometry, js.materials)
    lv = jmk.pack_lights(js.lights)
    mt = jmk.build_mt_table(js.geometry)
    camv = jnp.concatenate([cam.position, jcross(cam.front, cam.up), cam.up,
                            cam.front, jnp.zeros(4)]).astype(jnp.float32)[None]
    # Pixels in a shuffled order (per-ray results must not depend on it).
    pid = np.random.default_rng(11).permutation(R).astype(np.uint32)
    pxy = jnp.stack([jmk._to_panels(jnp.asarray((pid % W).astype(np.float32)), R),
                     jmk._to_panels(jnp.asarray((pid // W).astype(np.float32)), R)])
    tile = np.ones((jmk._ROWS, jmk._LANES), np.uint32)
    rgcms = jnp.stack([jnp.asarray(tile * np.uint32(jmk._premixed_counter(0))),
                       jnp.asarray(tile * np.uint32(jmk._premixed_counter(1))),
                       jnp.asarray(tile * np.uint32(trng.premix(FRAME)))])
    out0 = jmk._run_bounce0_fwd(tableT, lv, mt, camv, pxy, rgcms,
                                jmk._bounce_cms(0), jcfg)
    j0 = [_panels_to_flat(a) for a in out0]

    # bounce_fwd inputs: bounce 0's state with beta scaled by random
    # factors and a random fifth of the rays dead.
    rs = np.random.default_rng(12)
    beta_in = (j0[2] * rs.uniform(0.2, 1.0, size=(3, R))).astype(np.float32)
    alive_in = (j0[3] * (rs.uniform(size=R) > 0.2)).astype(np.float32)
    seeds_in = j0[7].astype(np.uint32)
    out1 = jmk._run_bounce_fwd(tableT, lv, mt, _flat_to_panels(j0[0]),
                               _flat_to_panels(j0[1], fills=(0.0, 0.0, 1.0)),
                               _flat_to_panels(beta_in),
                               _flat_to_panels(alive_in),
                               jmk._to_panels(jnp.asarray(seeds_in), R),
                               jmk._bounce_cms(BOUNCE), jcfg)
    j1 = [_panels_to_flat(a) for a in out1]

    ps = P.scene_from_numpy(_arrays(js), device="cpu")
    port = dict(
        table=pmk.build_mega_table(ps.geometry, ps.materials).T.contiguous(),
        tris=pmk.build_accel(ps.geometry),
        lv=pmk.pack_lights(ps.lights),
        camv=pmk.camera_vector(P.Camera.default(device="cpu")),
        pid=torch.from_numpy(pid.astype(np.int32)),
        o=torch.from_numpy(np.ascontiguousarray(j0[0])),
        d=torch.from_numpy(np.ascontiguousarray(j0[1])),
        beta=torch.from_numpy(beta_in), alive=torch.from_numpy(alive_in),
        seeds=torch.from_numpy(seeds_in.view(np.int32)))
    return dict(j0=j0, j1=j1, alive_in=alive_in, port=port, cfg=pcfg)


def _compare(got, ref, alive_in):
    """got: port outputs (o, d, beta, alive, rad, winner, occ) as tensors;
    ref: the JAX kernel's outputs as numpy.

    The next ray (o, d) is compared on rays that still carry throughput.
    A ray whose throughput became exactly zero (a specular pick on a Ks = 0
    material) contributes nothing from here on, and GGX sampling of the
    near-mirror Ns = 9999 boxes computes 1 - cos^2 by cancellation: XLA
    fuses that multiply-add and torch does not, so such rays' next
    directions differ by up to ~1e-3. For them both sides must agree that
    the throughput is exactly zero."""
    carries = np.abs(ref[2]).max(axis=0) > 0
    np.testing.assert_array_equal(np.abs(got[2].numpy()).max(axis=0) > 0, carries)
    for name, g, r in zip(("o", "d"), got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy()[:, carries], r[:, carries],
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    for name, g, r in zip(("beta", "alive", "radiance"), got[2:5], ref[2:5]):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL, rtol=RTOL, err_msg=name)
    alive_next = got[3].numpy() > 0
    np.testing.assert_array_equal(got[3].numpy(), ref[3])
    np.testing.assert_array_equal(got[5].numpy(), np.where(alive_in > 0, ref[5], -1))
    np.testing.assert_array_equal(got[6].numpy(), np.where(alive_next, ref[6], 0))


def test_bounce0_fwd_plain_matches_jax(case):
    p = case["port"]
    before = dict(pmk.LAUNCHES)
    got = pmk.bounce0_fwd(p["table"], p["tris"], p["lv"], p["camv"], p["pid"],
                          FRAME, case["cfg"])
    assert pmk.LAUNCHES == before  # CPU tensors run the plain version
    j0 = case["j0"]
    np.testing.assert_array_equal(got[7].numpy(), j0[7].astype(np.uint32).view(np.int32))
    _compare(got[:7], j0[:7], np.ones(R, np.float32))
    assert (got[5].numpy() >= 0).mean() > 0.5  # most primary rays hit


def test_bounce_fwd_plain_matches_jax(case):
    p = case["port"]
    got = pmk.bounce_fwd(p["table"], p["tris"], p["lv"], p["o"], p["d"], p["beta"],
                         p["alive"], p["seeds"], BOUNCE, case["cfg"])
    _compare(got, case["j1"], case["alive_in"])
    if case["cfg"].shadow_rays:
        assert (got[6].numpy() != 0).any()  # some shadow ray is blocked


def test_wrappers_check_inputs():
    scene, cfg = P.cornell_scene(device="cpu"), P.RenderConfig(width=8, height=8)
    table, tris, lv = pmk._tables(scene, cfg, None)
    camv = pmk.camera_vector(P.Camera.default(device="cpu"))
    pid = torch.arange(64, dtype=torch.int32)
    with pytest.raises(TypeError):
        pmk.bounce0_fwd(table, tris, lv, camv, pid.to(torch.int64), 0, cfg)
    with pytest.raises(ValueError):
        pmk.bounce0_fwd(table, tris[:, :8].contiguous(), lv, camv, pid, 0, cfg)
    with pytest.raises(ValueError):
        pmk.bounce0_fwd(table.T, tris, lv, camv, pid, 0, cfg)
    # A wrapper alone is not differentiable: it refuses inputs that need
    # grad, and trace_paths_mega_cam carries the gradient instead.
    with pytest.raises(ValueError, match="autograd"):
        pmk.bounce0_fwd(table.clone().requires_grad_(), tris, lv, camv, pid, 0, cfg)
    out = pmk.bounce0_fwd(table, tris, lv, camv, pid, 0, cfg)
    o, d, beta, alive, _, _, _, seeds = out
    with pytest.raises(ValueError):
        pmk.bounce_fwd(table, tris, lv, o.T, d, beta, alive, seeds, 1, cfg)
    with pytest.raises(ValueError, match="autograd"):
        pmk.bounce_fwd(table, tris, lv, o.clone().requires_grad_(), d, beta, alive,
                       seeds, 1, cfg)
    cot = (o, d, beta, o)
    with pytest.raises(TypeError):
        pmk.bounce_bwd(table, lv, o, d, beta, alive, seeds, out[5].long(), out[6],
                       cot, 1, cfg)
    with pytest.raises(ValueError):
        pmk.bounce0_bwd(table, lv, camv, pid, 0, out[5], out[6], cot[:3], cfg)
    # Gradients flow through trace_paths_mega_cam to the scene and camera.
    kd = scene.materials.diffuse.clone().requires_grad_()
    pos = P.Camera.default(device="cpu").position.clone().requires_grad_()
    lit = P.Scene(scene.geometry,
                  P.Materials(kd, *[getattr(scene.materials, k) for k in
                                    ("specular", "emission", "roughness", "ior")]),
                  scene.lights)
    cam = P.Camera(pos, P.Camera.default(device="cpu").front, P.Camera.default(device="cpu").up)
    rad = pmk.trace_paths_mega_cam(lit, cfg, cam, pid, 0)
    g_kd, g_pos = torch.autograd.grad(rad.mean(), (kd, pos))
    assert torch.isfinite(g_kd).all() and g_kd.abs().sum() > 0
    assert torch.isfinite(g_pos).all() and g_pos.abs().sum() > 0
