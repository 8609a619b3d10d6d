"""The port's multi-device stepping (mpmavatar_tpu_torch/parallel/) against
the JAX package's, on the CPU.

JAX runs ``make_sharded_frame`` / ``make_sharded_material_step`` on a
mesh of N of conftest's 8 CPU devices, its dense path, as
tests/test_parallel.py runs them; the port runs N gloo ranks in spawned
processes (tests/torch_ranks.py), each on its block of the same padded
state, and the blocks are put back together in rank order.  N = 2 and 4.

The scenes are tests/test_parallel.py's: its 9 x 9 cloth on 32^3
(``_build``, here under its two-triangle collider), the cloth with 64
sand, a slip floor and the bounding box, the 7 x 7 cloth under the
sphere collider with 4 pinned vertices, and per-element mu/lam with 8
pinned faces.  Tolerances are JAX's own in tests/test_parallel.py: x
2e-5, F 3e-4 (float32 sums in other orders over a few substeps).

The material step's scene is ``_build``'s cloth with R_inv scaled by
1.1, stretched, so that every gradient is well away from zero.  The
port's gradient is the true gradient of the loss it returns; JAX's is N
times it (it all-reduces the gradient of an all-reduced loss), which
``test_jax_sharded_gradient_is_n_times_its_single_device_gradient``
states.  Both losses count the padded vertices (N-dependent).

JAX is imported inside the fixtures only: the spawned ranks import
tests/torch_ranks.py and the port, never JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_ranks import (collective_gradients, run_ranks, sharded_frames,
                         sharded_material_step)

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.core import colliders as tcol
from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.core.types import MPMStaticConfig
from mpmavatar_tpu_torch.ops import grid_pipeline as tgp
from mpmavatar_tpu_torch.parallel import sharded as tsh
from mpmavatar_tpu_torch.sim import MPMSolver

torch.set_num_threads(1)

NS = (2, 4)
DT = 1e-4
X_TOL, F_TOL = 2e-5, 3e-4
# the vertices' velocities, as chip_smoke.py holds its paths (the cloth's
# return-map ties move v by up to ~1e-4 between the packages)
V_TOL = 1e-3
# the scenes' seeded particle speeds (m/s): ~6e-4 of motion in 6 substeps
SPEED = 1.0
# the material step: the loss of the same float32 rollout, and the
# gradient per leaf relative to its own size, or to a hundredth of the
# largest leaf's where its own is smaller (gamma, kappa and
# friction_coeff read ~1e-23 against mu's ~1e-11 in the port, exactly 0
# in JAX)
LOSS_REL = 1e-6
GRAD_REL = 1e-4
FACTOR_TOL = 1e-3
MAT_SUBSTEPS = 4
# the scenes whose JAX frame runs at each N (one shard_map compile each)
JAX_FRAMES = {2: ("cloth", "mixed", "mesh_joints"),
              4: ("cloth", "mixed", "per_element")}


def _np(tree) -> dict:
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)}


def _tri(n_pad_to, mverts, mfaces):
    tri = np.asarray(mverts, np.float32)[np.asarray(mfaces)]
    pad = (-len(tri)) % n_pad_to
    return np.concatenate([tri, np.tile(tri[-1:], (pad, 1, 1))], 0)


def _scenes():
    """name -> dict(cfg, state (JAX MPMState), model (JAX MPMModel),
    um (JAX UniformModel), grid_post (JAX colliders), options, inputs
    (name, array or None), n_sub, um_sharded, mesh (faces, friction))."""
    import jax.numpy as jnp
    from bench import build_body_sphere
    from test_parallel import _build
    from test_substep_golden import build_pair, make_cloth

    from mpmavatar_tpu.core import types
    from mpmavatar_tpu.parallel import UniformModel
    from mpmavatar_tpu.sim import MPMSolver as JSolver

    scenes = {}
    cfg, state, _, um = _build(8)
    mv = np.array([[0.6, 0.9, 0.6], [1.4, 0.9, 0.6], [1.4, 0.9, 1.4],
                   [0.6, 0.9, 1.4]], np.float32)
    tri = _tri(8, mv, [[0, 1, 2], [0, 2, 3]])
    scenes["cloth"] = dict(
        cfg=cfg, state=state, um=um, grid_post=(), n_sub=5,
        model=types.make_model(cfg.n_particles, E=200.0, nu=0.3),
        options=dict(with_mesh=True),
        inputs=[("mesh_x", tri), ("mesh_v", np.zeros_like(tri))])

    verts, faces = make_cloth(nx=7, ny=7, y0=1.1, extent=0.4)
    sand = (np.random.default_rng(0).random((64, 3)).astype(np.float32)
            * 0.15 + np.array([0.9, 1.3, 0.9], np.float32))
    E, T, V = len(faces), len(sand), len(verts)
    cfg = types.MPMStaticConfig(n_elements=E, n_traditional=T, n_vertices=V,
                                n_grid=32, grid_lim=2.0, material=2)
    d, r_inv, evol, vvol = types.cloth_geometry(
        jnp.asarray(verts, jnp.float32), jnp.asarray(faces))
    x = jnp.concatenate([jnp.asarray(verts, jnp.float32)[faces].mean(1),
                         jnp.asarray(sand), jnp.asarray(verts, jnp.float32)])
    vol = jnp.concatenate([evol, jnp.full((T,), 1e-6, jnp.float32), vvol])
    state = types.make_state(cfg, x, faces=faces, d=d, R_inv=r_inv, vol=vol)
    model = types.make_model(cfg.n_particles, E=300.0, nu=0.3)
    solver = JSolver(cfg)
    solver.add_surface_collider([0.0, 0.95, 0.0], [0.0, 1.0, 0.0],
                                surface="slip")
    solver.add_bounding_box()
    scenes["mixed"] = dict(
        cfg=cfg, state=state, model=model, n_sub=6,
        grid_post=solver.colliders.grid_post, options=dict(with_mesh=False),
        inputs=[], um=UniformModel(
            mu=jnp.float32(model.mu[0]), lam=jnp.float32(model.lam[0]),
            gamma=jnp.float32(500.0), kappa=jnp.float32(500.0),
            friction_coeff=model.friction_coeff, gravity=model.gravity,
            mesh_friction=jnp.float32(0.5), alpha=model.alpha))

    verts, faces = make_cloth(nx=7, ny=7, y0=1.05, extent=0.4)
    _, cfg, state, model = build_pair(verts, faces, E=300.0, n_grid=32)
    cfg = dataclasses.replace(cfg, num_joint_v=4)
    bv, bf = build_body_sphere(n_theta=8, n_phi=8, center=(1.0, 0.9, 1.0),
                               r=0.18)
    tri = _tri(8, bv, bf)
    solver = JSolver(cfg)
    solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    solver.add_bounding_box()
    scenes["mesh_joints"] = dict(
        cfg=cfg, state=state, model=model, n_sub=6,
        grid_post=solver.colliders.grid_post,
        options=dict(with_mesh=True, with_joints=True, num_joint_v=4),
        inputs=[("mesh_x", tri), ("mesh_v", np.zeros_like(tri)),
                ("joint_verts_v", np.zeros((4, 3), np.float32))],
        um=UniformModel(
            mu=jnp.float32(model.mu[0]), lam=jnp.float32(model.lam[0]),
            gamma=jnp.float32(500.0), kappa=jnp.float32(500.0),
            friction_coeff=model.friction_coeff, gravity=model.gravity,
            mesh_friction=jnp.float32(0.5)))

    verts, faces = make_cloth(nx=9, ny=9, y0=1.1, extent=0.4)
    E, V, njf = len(faces), len(verts), 8
    cfg = types.MPMStaticConfig(n_elements=E, n_traditional=0, n_vertices=V,
                                n_grid=32, grid_lim=2.0, material=7,
                                num_joint_f=njf)
    d, r_inv, evol, vvol = types.cloth_geometry(
        jnp.asarray(verts, jnp.float32), jnp.asarray(faces))
    x = jnp.concatenate([jnp.asarray(verts, jnp.float32)[faces].mean(1),
                         jnp.asarray(verts, jnp.float32)])
    state = types.make_state(cfg, x, faces=faces, d=d, R_inv=r_inv,
                             vol=jnp.concatenate([evol, vvol]))
    mu_e = (200.0 / 2.6 * (1.0 + (np.arange(E) % 2))).astype(np.float32)
    lam_e = np.full(E, 200.0 * 0.3 / (1.3 * 0.4), np.float32)
    model = types.make_model(cfg.n_particles, E=200.0, nu=0.3)
    model = dataclasses.replace(
        model, mu=jnp.asarray(np.concatenate([mu_e, np.zeros(V, np.float32)])),
        lam=jnp.asarray(np.concatenate([lam_e, np.zeros(V, np.float32)])))
    jfv = np.random.default_rng(0).normal(0, 0.05, (njf, 3)).astype(
        np.float32)
    scenes["per_element"] = dict(
        cfg=cfg, state=state, model=model, n_sub=4, grid_post=(),
        um_sharded=("mu", "lam"),
        options=dict(with_mesh=False, with_joints=True, num_joint_f=njf),
        inputs=[("joint_verts_v", None), ("joint_faces_v", jfv)],
        um=UniformModel(
            mu=jnp.asarray(mu_e), lam=jnp.asarray(lam_e),
            gamma=jnp.float32(500.0), kappa=jnp.float32(500.0),
            friction_coeff=model.friction_coeff, gravity=model.gravity,
            mesh_friction=jnp.float32(0.0), alpha=model.alpha))
    # a seeded velocity on every particle, so that each scene moves by
    # far more than the tolerances over its few substeps
    rng = np.random.default_rng(11)
    for sc in scenes.values():
        st = sc["state"]
        sc["state"] = dataclasses.replace(st, v=jnp.asarray(
            SPEED * rng.normal(size=st.v.shape).astype(np.float32)))
    return scenes


def _port_collider(col):
    from test_torch_core import port_collider
    return port_collider(col)


def _padded(scene, n):
    """The JAX padded state and per-element um leaves at n devices, as
    numpy."""
    from mpmavatar_tpu.parallel.sharded import (make_sharded_cloth_state,
                                                pad_to_multiple)
    st = _np(make_sharded_cloth_state(scene["cfg"], scene["state"], n))
    um = _np(scene["um"])
    for k in scene.get("um_sharded", ()):
        um[k] = np.asarray(pad_to_multiple(um[k], n))
    return st, um


def _jax_frame(scene, n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from mpmavatar_tpu.parallel import (UniformModel, make_sharded_cloth_state,
                                        make_sharded_frame, shard_state)
    from mpmavatar_tpu.parallel.sharded import pad_to_multiple

    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    st = shard_state(mesh, make_sharded_cloth_state(scene["cfg"],
                                                    scene["state"], n))
    um, spec = scene["um"], None
    if scene.get("um_sharded"):
        put = lambda a: jax.device_put(pad_to_multiple(a, n),
                                       NamedSharding(mesh, P("dp")))
        um = dataclasses.replace(um, mu=put(um.mu), lam=put(um.lam))
        spec = UniformModel(mu=P("dp"), lam=P("dp"), gamma=P(), kappa=P(),
                            friction_coeff=P(), gravity=P(),
                            mesh_friction=P(), alpha=P())
    frame = make_sharded_frame(scene["cfg"], mesh, num_substeps=scene["n_sub"],
                               dt=DT, grid_post=scene["grid_post"],
                               model_spec=spec, **scene["options"])
    inputs = [None if a is None else jnp.asarray(a)
              for _, a in scene["inputs"]]
    return _np(frame(st, um, *inputs))


def _port_jobs(scenes, n):
    jobs = []
    for name, sc in scenes.items():
        st, um = _padded(sc, n)
        jobs.append(dict(cfg=dataclasses.asdict(sc["cfg"]), state=st, um=um,
                         um_sharded=sc.get("um_sharded", ()),
                         grid_post=tuple(_port_collider(c)
                                         for c in sc["grid_post"]),
                         options=dict(sc["options"], num_substeps=sc["n_sub"],
                                      dt=DT),
                         inputs=sc["inputs"]))
    return jobs


def _gathered(blocks):
    return {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """name -> {"jax": {N: final padded state}, "port": {N: ...},
    "single": the port's single-device MPMSolver run, "scene": ...}."""
    scenes = _scenes()
    out = {name: {"scene": sc, "jax": {}, "port": {}}
           for name, sc in scenes.items()}
    for n in NS:
        per_rank = run_ranks(sharded_frames, n, tmp_path_factory.mktemp("f"),
                             _port_jobs(scenes, n))
        for i, name in enumerate(scenes):
            out[name]["port"][n] = _gathered([r[i] for r in per_rank])
        for name in JAX_FRAMES[n]:
            out[name]["jax"][n] = _jax_frame(scenes[name], n)
    for name, sc in scenes.items():
        out[name]["single"] = _single_device(sc)
    return out


def _single_device(sc):
    """The scene through the port's MPMSolver.frame (one device, CPU)."""
    from test_torch_core import port_of
    cfg, state, model = port_of(sc["cfg"], sc["state"], sc["model"])
    um = convert.uniform_model_from_numpy(_np(sc["um"]), "cpu")
    P, E = cfg.n_particles, cfg.n_elements
    full = lambda v: torch.cat([v, torch.zeros(P - len(v))]) \
        if v.dim() else v.expand(P).clone()
    model = dataclasses.replace(
        model, mu=full(um.mu), lam=full(um.lam), gamma=full(um.gamma),
        kappa=full(um.kappa), friction_coeff=um.friction_coeff,
        gravity=um.gravity, alpha=um.alpha)
    solver = MPMSolver(cfg, device="cpu")
    solver.colliders = tcol.ColliderSet(
        grid_post=tuple(_port_collider(c) for c in sc["grid_post"]))
    inputs = dict(sc["inputs"])
    scene = {}
    if sc["options"].get("with_mesh"):
        tri = inputs["mesh_x"]
        solver.add_mesh_collider(np.arange(3 * len(tri)).reshape(-1, 3),
                                 friction=float(um.mesh_friction))
        scene.update(mesh_x=tri.reshape(-1, 3),
                     mesh_v=inputs["mesh_v"].reshape(-1, 3))
    if sc["options"].get("with_joints"):
        solver.add_particle_mover()
        scene.update(joint_verts_v=inputs.get("joint_verts_v"),
                     joint_faces_v=inputs.get("joint_faces_v"))
    out, _ = solver.frame(state, model, DT, sc["n_sub"], 0.0, **scene)
    T = cfg.n_traditional
    return {"xe": out.x[:E].numpy(), "xv": out.x[E + T:].numpy(),
            "vv": out.v[E + T:].numpy(), "xt": out.x[E:E + T].numpy(),
            "Ft": out.F_trial.numpy()}


def _unpad(sc, st):
    cfg = sc["cfg"]
    E, T, V = cfg.n_elements, cfg.n_traditional, cfg.n_vertices
    return {"xe": st["xe"][:E], "xv": st["xv"][:V], "vv": st["vv"][:V],
            "xt": st["xt"][:T], "Ft": st["Ft"][:T]}


def _assert_state(got, ref, label):
    for k, tol in (("xv", X_TOL), ("xe", X_TOL), ("xt", X_TOL),
                   ("Ft", F_TOL)):
        np.testing.assert_allclose(got[k], ref[k], atol=tol,
                                   err_msg=f"{label}: {k}")


@pytest.mark.parametrize("name,n", [(name, n) for n in NS
                                    for name in JAX_FRAMES[n]])
def test_sharded_frame_matches_jax(frames, name, n):
    fr = frames[name]
    sc = fr["scene"]
    got, ref = _unpad(sc, fr["port"][n]), _unpad(sc, fr["jax"][n])
    _assert_state(got, ref, f"{name}, N={n}")
    np.testing.assert_allclose(got["vv"], ref["vv"], atol=V_TOL)
    # the padded elements stay frozen at identity d in both
    E = sc["cfg"].n_elements
    for st in (fr["port"][n], fr["jax"][n]):
        np.testing.assert_array_equal(st["d"][E:], np.broadcast_to(
            np.eye(3, dtype=np.float32), st["d"][E:].shape))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", ["cloth", "mixed", "mesh_joints",
                                  "per_element"])
def test_sharded_frame_matches_the_single_device_solver(frames, name, n):
    fr = frames[name]
    got, ref = _unpad(fr["scene"], fr["port"][n]), fr["single"]
    _assert_state(got, ref, f"{name}, N={n}")
    np.testing.assert_allclose(got["vv"], ref["vv"], atol=V_TOL)


def test_scenes_move_and_touch_what_they_test(frames):
    """Each scene does what it is there for: the cloth falls, the sand
    meets the slip floor's band, the pinned vertices stay, the pinned
    faces follow their velocities."""
    for name, fr in frames.items():
        x0 = _unpad(fr["scene"], _padded(fr["scene"], 1)[0])
        for k in ("xv", "xe", "xt"):
            if len(x0[k]):
                assert np.abs(fr["port"][2][k][:len(x0[k])]
                              - x0[k]).max() > 10 * X_TOL, (name, k)
    sc = frames["mesh_joints"]
    x0 = np.asarray(sc["scene"]["state"].x)
    E = sc["scene"]["cfg"].n_elements
    np.testing.assert_allclose(sc["port"][2]["xv"][:4], x0[E:E + 4],
                               atol=1e-6)


def test_make_sharded_cloth_state_matches_jax():
    """The port's padding of an MPMState equals JAX's, field by field,
    and shard_state's blocks put back together are the padded state."""
    from mpmavatar_tpu.parallel import make_sharded_cloth_state
    from test_torch_core import port_of
    for name, sc in _scenes().items():
        cfg, state, _ = port_of(sc["cfg"], sc["state"], sc["model"])
        for n in NS:
            ref = _np(make_sharded_cloth_state(sc["cfg"], sc["state"], n))
            got = tsh.make_sharded_cloth_state(cfg, state, n)
            for k, a in ref.items():
                np.testing.assert_array_equal(getattr(got, k).numpy(), a,
                                              err_msg=f"{name} {k} N={n}")
            blocks = [tsh.shard_state(got, r, n) for r in range(n)]
            assert torch.equal(torch.cat([b.xv for b in blocks]), got.xv)


# ---- K5 and the unfused grid phase on a slab --------------------------

def _slab_fields(G, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = G ** 3
    w = lambda: torch.where(torch.rand(n, generator=g) > 0.33,
                            0.5 + torch.rand(n, generator=g), 0.0)
    return (torch.randn(n, 3, generator=g), w(), torch.randn(n, 6,
                                                             generator=g),
            w(), torch.randn(n, 3, generator=g), w())


def _bcs():
    f32 = lambda *v: torch.tensor(v)
    # plane points off the grid nodes
    return (tcol.SurfaceCollider(f32(0.0, 0.2017, 0.0), f32(0.0, 0.8, 0.6),
                                 f32(0.0), f32(0.0), f32(1.0), tcol.STICKY),
            tcol.SurfaceCollider(f32(0.0, 0.503, 0.0), f32(0.0, 1.0, 0.0),
                                 f32(0.3), f32(0.0), f32(1.0), tcol.SLIP),
            tcol.SurfaceCollider(f32(0.0, 0.0, 1.0037), f32(0.0, 0.6, 0.8),
                                 f32(0.4), f32(0.0), f32(1.0),
                                 tcol.FRICTIONAL),
            tcol.BoundingBoxCollider(f32(0.0), f32(1.0)))


@pytest.mark.parametrize("n", NS)
def test_grid_pipeline_on_slabs_equals_the_whole_grid(n):
    """K5's plain version on each of n slabs, from each slab's first
    cell, concatenated, is the whole-grid call: mesh and mover branches,
    sticky / slip / frictional surfaces and the bounding box, whose
    positions and indices come from the global cell."""
    G = 16
    cfg = MPMStaticConfig(n_elements=0, n_traditional=0, n_vertices=1,
                          n_grid=G)
    post = _bcs()
    pipe = tgp.make_grid_pipeline(cfg, post, has_mesh=True, has_mover=True)
    surf = tgp.pack_surface_params(post)
    fields = _slab_fields(G)
    scal = (torch.tensor([0.0, -9.8, 0.0]), torch.tensor(0.9),
            torch.tensor(0.5))
    whole = pipe(*fields, *scal, 0.01, DT, surf)
    k = G ** 3 // n
    parts = [pipe(*(f[r * k:(r + 1) * k] for f in fields), *scal, 0.01, DT,
                  surf, cell_start=r * k) for r in range(n)]
    assert torch.equal(torch.cat(parts), whole)
    # the slab's cells are its own: the same rows at cell 0 differ (the
    # BCs depend on where a cell is)
    assert not torch.equal(
        pipe(*(f[k:2 * k] for f in fields), *scal, 0.01, DT, surf), parts[1])
    with pytest.raises(ValueError):
        pipe(*(f[:k] for f in fields), *scal, 0.01, DT, surf,
             cell_start=G ** 3 - k + 1)


@pytest.mark.parametrize("n", NS)
def test_unfused_grid_bcs_on_slabs_equal_the_whole_grid(n):
    """The unfused route (BCs K5 does not support) on slabs: every BC
    type of apply_grid_bc, and the slab grid stage around it."""
    G = 16
    cfg = MPMStaticConfig(n_elements=0, n_traditional=0, n_vertices=1,
                          n_grid=G)
    f32 = lambda *v: torch.tensor(v)
    mask = (torch.rand((G, G, G), generator=torch.Generator().manual_seed(1))
            > 0.7).to(torch.int32)
    post = (*_bcs(),
            tcol.SurfaceCollider(f32(0.0, 0.7013, 0.0), f32(0.0, 1.0, 0.0),
                                 f32(0.0), f32(0.0), f32(1.0), tcol.CUT),
            tcol.CuboidCollider(f32(1.0, 1.0, 1.0), f32(0.3, 0.2, 0.25),
                                f32(0.1, 0.0, 0.0), f32(0.0), f32(1.0)),
            tcol.GridMaskCollider(mask))
    gv, gm, acc, mw, mv, mvw = _slab_fields(G, seed=2)
    um = tsh.UniformModel(
        mu=f32(1.0), lam=f32(1.0), gamma=f32(1.0), kappa=f32(1.0),
        friction_coeff=f32(0.5), gravity=f32(0.0, -9.8, 0.0),
        mesh_friction=f32(0.4))
    stage = tsh.make_slab_grid_stage(cfg, post, True, True)
    k = G ** 3 // n
    sl = lambda a, r: a[r * k:(r + 1) * k]
    whole = stage(gv, gm, (acc, mw), (mv, mvw), um, 0.01, DT, 0)
    parts = [stage(sl(gv, r), sl(gm, r), (sl(acc, r), sl(mw, r)),
                   (sl(mv, r), sl(mvw, r)), um, 0.01, DT, r * k)
             for r in range(n)]
    assert torch.equal(torch.cat(parts), whole)
    # and the whole-grid route is the single-device unfused grid phase
    col = tcol.MeshCollider(faces=torch.zeros((0, 3), dtype=torch.int64),
                            friction=um.mesh_friction)
    v = torch.where((gm > 1e-15)[:, None],
                    gv / torch.clamp_min(gm, 1e-15)[:, None]
                    + DT * um.gravity, 0.0)
    v = tstep.project_on_mesh(acc, mw, col.friction, v)
    v = torch.where((mvw > 1e-15)[:, None],
                    mv / torch.clamp_min(mvw, 1e-15)[:, None], v)
    for c in post:
        v = tstep.apply_grid_bc(cfg, c, v, 0.01, DT)
    assert torch.equal(whole, v)


def test_slab_stage_k5_and_unfused_routes_agree():
    """On BCs K5 supports, the fused slab stage (K5's plain version) and
    the unfused route compute the same grid phase."""
    G, n = 16, 4
    cfg = MPMStaticConfig(n_elements=0, n_traditional=0, n_vertices=1,
                          n_grid=G)
    f32 = lambda *v: torch.tensor(v)
    um = tsh.UniformModel(
        mu=f32(1.0), lam=f32(1.0), gamma=f32(1.0), kappa=f32(1.0),
        friction_coeff=f32(0.5), gravity=f32(0.0, -9.8, 0.0),
        mesh_friction=f32(0.4))
    post = _bcs()
    fused = tsh.make_slab_grid_stage(cfg, post, True, True)
    cut = (tcol.SurfaceCollider(f32(0.0, -5.0, 0.0), f32(0.0, 1.0, 0.0),
                                f32(0.0), f32(0.0), f32(1.0), tcol.CUT),)
    unfused = tsh.make_slab_grid_stage(cfg, post + cut, True, True)
    gv, gm, acc, mw, mv, mvw = _slab_fields(G, seed=3)
    k = G ** 3 // n
    for r in range(n):
        sl = lambda a: a[r * k:(r + 1) * k]
        args = (sl(gv), sl(gm), (sl(acc), sl(mw)), (sl(mv), sl(mvw)), um,
                0.01, DT, r * k)
        torch.testing.assert_close(fused(*args), unfused(*args), rtol=0,
                                   atol=1e-6)


# ---- the material step ------------------------------------------------

def _material_scene():
    import jax.numpy as jnp
    from test_parallel import _build
    from mpmavatar_tpu.core import types
    cfg, state, _, um = _build(8)
    state = dataclasses.replace(state, R_inv=state.R_inv * 1.1)
    tri = np.tile(np.array([[[0.0, 0.01, 0.0], [0.02, 0.01, 0.0],
                             [0.0, 0.01, 0.02]]], np.float32), (8, 1, 1))
    model = types.make_model(cfg.n_particles, E=200.0, nu=0.3)
    return cfg, state, model, um, tri, jnp


@pytest.fixture(scope="module")
def material(tmp_path_factory):
    import jax
    from jax.sharding import Mesh
    from mpmavatar_tpu.parallel import (make_sharded_cloth_state,
                                        make_sharded_material_step,
                                        shard_state)
    cfg, state, model, um, tri, jnp = _material_scene()
    out = {"jax": {}, "port": {}, "scene": (cfg, state, model, um, tri)}
    for n in NS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
        st = make_sharded_cloth_state(cfg, state, n)
        target = np.asarray(st.xv) * np.float32(0.999)
        step = make_sharded_material_step(cfg, mesh,
                                          num_substeps=MAT_SUBSTEPS, dt=DT)
        loss, grads, new_st, _ = step(shard_state(mesh, st), um,
                                      jnp.asarray(tri),
                                      jnp.zeros_like(jnp.asarray(tri)), None,
                                      jnp.asarray(target))
        out["jax"][n] = (float(loss), _np(grads), np.asarray(new_st.xv))
        ranks = run_ranks(sharded_material_step, n,
                          tmp_path_factory.mktemp("m"),
                          dataclasses.asdict(cfg), _np(st), _np(um),
                          MAT_SUBSTEPS, DT, tri, target)
        losses = {r[0] for r in ranks}
        assert len(losses) == 1, f"the ranks' losses differ: {losses}"
        for r in ranks[1:]:
            for k, g in r[1].items():
                np.testing.assert_array_equal(g, ranks[0][1][k])
        out["port"][n] = (ranks[0][0], ranks[0][1],
                          np.concatenate([r[2] for r in ranks]))
    return out


def _grad_close(got, ref, label):
    scale = max(float(np.abs(g).max()) for g in ref.values())
    for k, g in ref.items():
        err = float(np.abs(got[k] - g).max())
        lim = GRAD_REL * max(float(np.abs(g).max()), 1e-2 * scale)
        assert err <= lim, (label, k, got[k], g)


@pytest.mark.parametrize("n", NS)
def test_sharded_material_step_matches_jax(material, n):
    """The loss equals JAX's at the same N; every leaf's gradient is
    JAX's divided by N; the final vertices agree."""
    loss, grads, xv = material["port"][n]
    j_loss, j_grads, j_xv = material["jax"][n]
    assert abs(loss - j_loss) <= LOSS_REL * abs(j_loss), (loss, j_loss)
    _grad_close(grads, {k: g / n for k, g in j_grads.items()}, f"N={n}")
    assert float(np.abs(grads["mu"]).max()) > 0.0
    np.testing.assert_allclose(xv, j_xv, atol=X_TOL)


@pytest.fixture(scope="module")
def single_device_material(material):
    """The port's single-device autograd of the same loss (one device,
    MPMSolver's substep), w.r.t. every UniformModel leaf: (the loss over
    the real vertices' error, grads)."""
    from test_torch_core import port_of
    jcfg, jstate, jmodel, jum, tri = material["scene"]
    cfg, state, model = port_of(jcfg, jstate, jmodel)
    um = convert.uniform_model_from_numpy(_np(jum), "cpu")
    leaves = {f.name: getattr(um, f.name).clone().requires_grad_(True)
              for f in dataclasses.fields(um)}
    P, E = cfg.n_particles, cfg.n_elements
    model = dataclasses.replace(
        model, mu=leaves["mu"].expand(P), lam=leaves["lam"].expand(P),
        gamma=leaves["gamma"].expand(P), kappa=leaves["kappa"].expand(P),
        friction_coeff=leaves["friction_coeff"], gravity=leaves["gravity"],
        alpha=leaves["alpha"])
    solver = MPMSolver(cfg, device="cpu")
    solver.colliders = tcol.ColliderSet(mesh_colliders=(tcol.MeshCollider(
        faces=torch.arange(3 * len(tri)).reshape(-1, 3),
        friction=leaves["mesh_friction"]),))
    mesh_x = torch.as_tensor(tri.reshape(-1, 3))
    out, _ = solver.frame(state, model, DT, MAT_SUBSTEPS, 0.0, mesh_x=mesh_x,
                          mesh_v=torch.zeros_like(mesh_x))
    target = state.x[E:] * np.float32(0.999)
    err = torch.sum((out.x[E:] - target) ** 2)
    grads = torch.autograd.grad(err, list(leaves.values()),
                                allow_unused=True)
    grads = {k: np.zeros(tuple(v.shape), np.float32) if g is None
             else g.numpy() for (k, v), g in zip(leaves.items(), grads)}
    return float(err), grads, cfg


@pytest.mark.parametrize("n", NS)
def test_sharded_material_gradient_equals_the_single_device_gradient(
        material, single_device_material, n):
    """The port's sharded gradient is the single-device autograd of the
    same loss (its error over the real vertices, over 3 V_padded), and
    its loss is that error plus JAX's padded-vertex term: each padded
    vertex ends at 2 dx on every axis (G2P's clamp) against a zero
    target."""
    err, grads, cfg = single_device_material
    loss, p_grads, xv = material["port"][n]
    nv = len(xv)
    _grad_close(p_grads, {k: g / (3.0 * nv) for k, g in grads.items()},
                f"N={n}")
    n_pad = nv - cfg.n_vertices
    np.testing.assert_array_equal(xv[cfg.n_vertices:], 2.0 * cfg.dx)
    pad_term = n_pad * 3 * (2.0 * cfg.dx) ** 2
    assert abs(loss - (err + pad_term) / (3.0 * nv)) <= LOSS_REL * loss


def test_jax_sharded_gradient_is_n_times_its_single_device_gradient(
        material):
    """The reference's factor, stated: JAX's sharded step returns N times
    the gradient of the loss it returns (tests/test_parallel.py's
    rel < 0.05 check compares 0 with 0 on its unstretched cloth)."""
    import jax
    import jax.numpy as jnp
    from mpmavatar_tpu.core import stepping
    from mpmavatar_tpu.core.colliders import ColliderSet, MeshCollider

    cfg, state, model, um, tri = material["scene"]
    mesh_x = jnp.asarray(tri.reshape(-1, 3))
    faces = jnp.arange(3 * len(tri)).reshape(-1, 3)
    nv_pad = {n: len(material["jax"][n][2]) for n in NS}
    target = np.asarray(state.x[cfg.n_elements:]) * np.float32(0.999)

    @jax.jit
    def err_fn(mu, lam):
        P = cfg.n_particles
        m = dataclasses.replace(
            model, mu=jnp.full((P,), mu), lam=jnp.full((P,), lam),
            gamma=jnp.full((P,), um.gamma), kappa=jnp.full((P,), um.kappa),
            friction_coeff=um.friction_coeff, gravity=um.gravity)
        cols = ColliderSet(mesh_colliders=(MeshCollider(
            faces=faces, friction=um.mesh_friction),))
        s = state
        for k in range(MAT_SUBSTEPS):
            s = stepping.p2g2p(cfg, cols, s, m, DT, jnp.float32(k * DT),
                               mesh_x=mesh_x, mesh_v=jnp.zeros_like(mesh_x))
        return jnp.sum((s.x[cfg.n_elements:] - target) ** 2)

    g = jax.jit(jax.grad(err_fn, argnums=(0, 1)))(um.mu, um.lam)
    for n in NS:
        j_grads = material["jax"][n][1]
        for name, gi in zip(("mu", "lam"), g):
            single = float(gi) / (3.0 * nv_pad[n])
            assert abs(single) > 0.0
            ratio = float(j_grads[name]) / single
            assert abs(ratio - n) <= FACTOR_TOL * n, (name, n, ratio)


def test_collective_backwards_match_finite_differences(tmp_path):
    """all_gather -> reduce_scatter -> all_reduce in float64 over 2 gloo
    ranks: each rank's autograd gradient (the JAX transposes as the
    backwards) against central differences of the ranks' summed loss."""
    ranks = run_ranks(collective_gradients, 2, tmp_path, 7, 1e-6)
    fd = ranks[0][1]
    np.testing.assert_allclose(ranks[1][1], fd, rtol=0, atol=1e-12)
    for r, (grad, _) in enumerate(ranks):
        np.testing.assert_allclose(grad, fd[r], rtol=1e-7, atol=1e-9)
    assert np.abs(fd).min() > 1e-3
