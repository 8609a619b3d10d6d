"""The bench's garment substep in the PyTorch port against the JAX
package: cloth on a body-mesh collider (K4 splat -> K5 mesh branch) with
joint pinning (K4 splat -> K5 mover branch) and a sticky floor, in the
fused order (one collider, K5), the unfused order (two colliders), with a
sand block (K8), and through MPMSolver.frame with a moving collider.  JAX
runs p2g2p(column_k=0, fused_grid=True, fused_stress=True), its Pallas
kernels in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import assert_close, port_collider, port_of

from mpmavatar_tpu.core import colliders as jcol
from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.sim import MPMSolver as JSolver

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.core import linalg
from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.core.types import build_body_sphere, build_cloth
from mpmavatar_tpu_torch.sim import MPMSolver

torch.set_num_threads(1)

F32 = jnp.float32
DT = 1e-4
G = 32
# golden bounds of tests/test_substep_golden.py::compare; F of the sand
# at the JAX package's fused-vs-(T,3,3) bound
ATOL = {"x": 2e-5, "v": 1e-3, "d": 2e-4, "F": 2e-5}
FLOOR = jcol.SurfaceCollider(
    point=jnp.asarray([0.0, 0.1, 0.0], F32),
    normal=jnp.asarray([0.0, 1.0, 0.0], F32), friction=F32(0.0),
    start_time=F32(0.0), end_time=F32(999.0))
# the sphere's top (1.17) half a cell under the cloth (1.2), rising into
# it at 0.5 m/s: the collider's cells overlap the cloth's from the first
# substep
BODY_CENTER, BODY_R = (1.0, 0.92, 1.0), 0.25
MESH_V = (0.0, 0.5, 0.0)


def _scene(sand=0, seed=0):
    """JAX (cfg, state, model, scene) of a reduced bench scene: 12 x 12
    cloth, G = 32, 16 pinned vertices and 8 pinned faces with random joint
    velocities, random particle velocities, optional sand around the
    sphere's top with a perturbed F_trial."""
    rng = np.random.default_rng(seed)
    verts, faces = build_cloth(12, 12, y0=1.2, extent=0.5)
    cfg = jtypes.MPMStaticConfig(
        n_elements=len(faces), n_traditional=sand, n_vertices=len(verts),
        n_grid=G, grid_lim=2.0, material=2 if sand else 7, num_joint_v=16,
        num_joint_f=8)
    d, r_inv, evol, vvol = jtypes.cloth_geometry(jnp.asarray(verts),
                                                 jnp.asarray(faces))
    sand_x = rng.uniform([0.85, 1.12, 0.85], [1.15, 1.3, 1.15],
                         (sand, 3)).astype(np.float32)
    x = jnp.concatenate([jnp.asarray(verts)[faces].mean(1),
                         jnp.asarray(sand_x), jnp.asarray(verts)], 0)
    vol = jnp.concatenate([evol, jnp.full((sand,), 1e-7, F32), vvol], 0)
    state = jtypes.make_state(cfg, x, faces=faces, d=d, R_inv=r_inv,
                              vol=vol)
    P = cfg.n_particles
    state = dataclasses.replace(
        state, v=jnp.asarray(rng.normal(0, 0.05, (P, 3)), F32),
        F_trial=jnp.asarray(np.eye(3) + 0.05 * rng.standard_normal(
            (sand, 3, 3)), F32))
    model = jtypes.make_model(P, E=2000.0, nu=0.3)
    body_v, body_f = build_body_sphere(center=BODY_CENTER, r=BODY_R)
    # wound outward, so that the collider resists motion into the body
    # (build_body_sphere, as the JAX bench builds it, winds inward)
    body_f = body_f[:, [0, 2, 1]]
    scene = dict(
        mesh_x=body_v,
        mesh_v=np.broadcast_to(np.float32(MESH_V), body_v.shape).copy(),
        joint_verts_v=rng.normal(0, 0.1, (16, 3)).astype(np.float32),
        joint_faces_v=rng.normal(0, 0.1, (8, 3)).astype(np.float32))
    return cfg, state, model, scene, body_f


def _mesh(faces, friction=0.5):
    return jcol.MeshCollider(faces=jnp.asarray(faces, jnp.int32),
                             friction=F32(friction))


def _r33(d):
    return linalg.qr3_pos(torch.as_tensor(np.array(d)))[1][:, 2, 2]


def _tied(d_a, d_b):
    """Elements whose R33 (QR of d) is within 4 ulps of 1, the anisotropic
    return map's branch point, in either state, or on different sides of
    it: there each package's last bits pick the branch, and d3's
    tangential part is kept on one side and scaled to ~0 on the other."""
    ra, rb = _r33(d_a), _r33(d_b)
    return (((ra - 1.0).abs() <= 4.8e-7) | ((rb - 1.0).abs() <= 4.8e-7)
            | ((ra > 1.0) != (rb > 1.0))).numpy()


def _run_both(cfg, state, model, colliders, scene, n=5):
    """n substeps in both packages; also returns the elements that were
    tied (``_tied``) after some substep.  (A flat cloth starts with every
    element on the tie; one substep moves nearly all off it.)"""
    tcfg, tst, tm = port_of(cfg, state, model)
    tcolliders = port_collider(colliders)
    tscene = convert.scene_from_numpy(scene, "cpu")
    jscene = {k: jnp.asarray(v) for k, v in scene.items()}
    tied = np.zeros(cfg.n_elements, bool)
    for s in range(n):
        time = np.float32(s * DT)
        state = jstep.p2g2p(cfg, colliders, state, model, F32(DT),
                            F32(time), column_k=0, fused_grid=True,
                            fused_stress=True, **jscene)
        tst = tstep.p2g2p(tcfg, tcolliders, tst, tm, DT, float(time),
                          **tscene)
        tied |= _tied(state.d, tst.d)
    return state, tst, tied


def _assert_match(out, ref, tied, fields=("x", "v", "d")):
    """Each field at its golden bound; d on the elements that were never
    tied.  The separated branch sets R33 to exactly 1, so every stretched
    element returns to the tie each substep: 14-22% of these scenes'
    elements are tied, and off the tie d agrees to ~1e-6."""
    assert tied.mean() <= 0.3, f"{tied.sum()} of {len(tied)} tied"
    for name in fields:
        a, b = np.asarray(getattr(out, name)), np.asarray(getattr(ref, name))
        if name == "d":
            a, b = a[~tied], b[~tied]
        assert_close(a, b, ATOL[name], name)


def _collider_moved_the_cloth(cfg, state, model, colliders, scene, ref):
    """The scene is a contact scene: without the collider the cloth's
    velocities come out otherwise."""
    free = dataclasses.replace(colliders, mesh_colliders=())
    alone, _, _ = _run_both(cfg, state, model, free, scene)
    assert float(jnp.abs(alone.v - ref.v).max()) > 10 * ATOL["v"]


def test_fused_order_matches_jax():
    """One mesh collider + mover + floor: K4 (face and joint splats) ->
    K5 with its mesh and mover branches on, in both packages."""
    cfg, state, model, scene, body_f = _scene()
    colliders = jcol.ColliderSet(grid_post=(FLOOR,),
                                 mesh_colliders=(_mesh(body_f),),
                                 use_particle_mover=True)
    ref, out, tied = _run_both(cfg, state, model, colliders, scene)
    _assert_match(out, ref, tied)
    _collider_moved_the_cloth(cfg, state, model, colliders, scene, ref)


def test_unfused_order_matches_jax():
    """Two mesh colliders (the sphere's faces in two halves, different
    frictions) take the unfused grid_update -> apply_mesh_collider x 2 ->
    apply_particle_mover -> apply_grid_bc order in both packages."""
    cfg, state, model, scene, body_f = _scene(seed=1)
    half = len(body_f) // 2
    colliders = jcol.ColliderSet(
        grid_post=(FLOOR,),
        mesh_colliders=(_mesh(body_f[:half], 0.5), _mesh(body_f[half:], 0.2)),
        use_particle_mover=True)
    ref, out, tied = _run_both(cfg, state, model, colliders, scene)
    _assert_match(out, ref, tied)


def test_sand_and_cloth_match_jax():
    """A material-2 scene: K8 on the sand block, K1 on the cloth, the
    collider and the mover on both."""
    cfg, state, model, scene, body_f = _scene(sand=200, seed=2)
    colliders = jcol.ColliderSet(grid_post=(FLOOR,),
                                 mesh_colliders=(_mesh(body_f),),
                                 use_particle_mover=True)
    ref, out, tied = _run_both(cfg, state, model, colliders, scene)
    _assert_match(out, ref, tied, ("x", "v", "d", "F"))


def test_frame_with_moving_collider_matches_jax_solver():
    """MPMSolver.frame advances the collider mesh on the device as
    mesh_x + (s dt) mesh_v: 5 substeps against the JAX MPMSolver.frame."""
    cfg, state, model, scene, body_f = _scene(seed=3)
    tcfg, tst, tm = port_of(cfg, state, model)
    js = JSolver(cfg, column_k=0, fused_grid=True, fused_stress=True)
    ts = MPMSolver(tcfg, device="cpu")
    for s in (js, ts):
        s.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
        s.add_mesh_collider(body_f, friction=0.5)
        s.add_particle_mover()
    ref, t_j = js.frame(state, model, DT, 5, 0.0,
                        **{k: jnp.asarray(v) for k, v in scene.items()})
    out, t_t = ts.frame(tst, tm, DT, 5, 0.0,
                        **convert.scene_from_numpy(scene, "cpu"))
    assert t_t == float(t_j)
    _assert_match(out, ref, _tied(out.d, ref.d))


@pytest.mark.parametrize("field", ["mesh_x", "mesh_v"])
def test_mesh_collider_needs_its_mesh(field):
    cfg, state, model, scene, body_f = _scene()
    tcfg, tst, tm = port_of(cfg, state, model)
    colliders = port_collider(jcol.ColliderSet(
        mesh_colliders=(_mesh(body_f),)))
    tscene = convert.scene_from_numpy(scene, "cpu")
    tscene[field] = None
    with pytest.raises(ValueError, match="mesh_x"):
        tstep.p2g2p(tcfg, colliders, tst, tm, DT, 0.0, **tscene)
