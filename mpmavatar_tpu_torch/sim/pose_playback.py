"""Pose playback: the posed SMPL-X body as the solver's moving collider,
and the re-posed tracked cloth driving the pinned vertices (the pose
playback of the JAX package's scripts/run_demo.py:64-145, without sand,
chair or render).

The tracked first frame is the bench's flat 183 x 183 cloth at y = 1.3
(33,489 vertex and 66,248 element particles; anisotropic cloth, E = 2000,
nu = 0.3) over a 128^3 grid with the sticky floor at y = 0.1.  The body
is a synthetic archive in the official SMPLX_*.npz layout at SMPL-X's
widths (``write_body_npz``: 55 joints, 400 shape and 486 pose directions,
45-wide hand PCA), loaded by ``avatar.load_smplx_npz``: its template is
``build_body_sphere(97, 108)`` (10,476 vertices, 20,736 faces) stretched
into a torso-sized ellipsoid whose top is 0.02 under the cloth, its faces
wound outward so that the collider resists the cloth.  The first fit is
the rest pose; the pose sequence (``make_poses``) turns the root about
the vertical axis, raises ``trans`` and walks the body pose by seeded
offsets, one pose per frame of ``substeps`` substeps (fps = 1 / (substeps
dt) = 100 at dt = 1e-4 and 100 substeps).

``prepare_pose_playback`` re-poses the cloth through every pose
(``avatar.deform_tracked_to_poses``, k = 10) and takes frame velocities;
each frame then gives ``MPMSolver.frame`` the posed body as ``mesh_x`` /
``mesh_v`` and the re-posed cloth's velocities on the first 256 vertices
and 128 faces (the mover), as run_demo.py does.  The scene is built in
sim coordinates: the SimTransform is the identity.  Runs on the CUDA
device through the port's kernels; ``--device cpu`` runs the plain
PyTorch path instead.

    python -m mpmavatar_tpu_torch.sim.pose_playback
    python -m mpmavatar_tpu_torch.sim.pose_playback --device cpu --nx 24 \\
        --grid 48 --body 25x28 --substeps 20
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from .. import resolve_device
from ..avatar import deform_tracked_to_poses, frame_velocities, load_smplx_npz
from ..core.types import (MPMModel, MPMState, build_body_sphere,
                          build_cloth, cloth_scene)
from ..utils import profiling
from .solver import MPMSolver, SimTransform

NUM_JOINTS, NUM_BETAS, NUM_EXPR = 55, 300, 100
NUM_JOINT_V, NUM_JOINT_F = 256, 128
CLOTH_Y = 1.3
# the torso: an ellipsoid of these semi-axes whose top is 0.02 under the
# cloth
BODY_RADII = (0.17, 0.30, 0.12)
BODY_CENTER = (1.0, CLOTH_Y - 0.02 - BODY_RADII[1], 1.0)
# per pose: the root's turn about the vertical axis (rad), the rise of
# trans (m) and the spread of the body pose's seeded offsets (rad).  With
# this archive's joint tree, offsets of 0.02 move the surface at up to
# ~1.2 m/s between poses 0.01 s apart (0.05 would move it at ~2.9 m/s)
ROOT_TURN, RISE, POSE_SIGMA = 0.01, 0.003, 0.02
KNN_K = 10
# the time step (s), the archive's and the poses' seed, and the poses
DT, SEED, N_POSES = 1e-4, 0, 3
SIM_TF = SimTransform(scale=1.0, shift=np.zeros(3, np.float32))


def write_body_npz(path, n_theta: int = 97, n_phi: int = 108) -> None:
    """A synthetic SMPL-X archive in the official layout (key names,
    shapes, the uint32 root marker of ``kintree_table``) whose template
    is the closed torso ellipsoid, wound outward: the joint sites lie
    inside it, ``J_regressor``'s rows are normalised bumps of the
    template around them, and ``weights`` the normalised inverse squared
    distances to the 4 nearest sites."""
    rng = np.random.default_rng(SEED)
    unit, faces = build_body_sphere(n_theta, n_phi, center=(0.0, 0.0, 0.0),
                                    r=1.0)
    radii, center = np.asarray(BODY_RADII), np.asarray(BODY_CENTER)
    v = (unit * radii + center).astype(np.float32)
    n_verts = len(v)
    # joint sites inside the ellipsoid, the root at its centre
    dirs = rng.normal(size=(NUM_JOINTS, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    depth = 0.7 * rng.random((NUM_JOINTS, 1)) ** (1.0 / 3.0)
    sites = center + dirs * depth * radii
    sites[0] = center
    parents = np.zeros(NUM_JOINTS, np.uint32)
    parents[0] = np.iinfo(np.uint32).max      # the official root marker
    parents[1:] = rng.integers(0, np.arange(1, NUM_JOINTS))
    d2 = np.sum((v[None] - sites[:, None]) ** 2, -1)        # (J, V)
    bumps = np.exp(-d2 / (2.0 * 0.08 ** 2))
    j_regressor = bumps / bumps.sum(1, keepdims=True)
    near = np.argsort(d2, axis=0)[:4]                      # (4, V)
    weights = np.zeros((n_verts, NUM_JOINTS))
    cols = np.arange(n_verts)
    weights[cols[None], near] = 1.0 / np.maximum(
        d2[near, cols[None]], 1e-6)
    weights /= weights.sum(1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)
    np.savez(
        path,
        v_template=v,
        shapedirs=f32(rng.normal(0, 1e-4, (n_verts, 3, NUM_BETAS
                                           + NUM_EXPR))),
        posedirs=f32(rng.normal(0, 1e-4, (n_verts, 3,
                                          (NUM_JOINTS - 1) * 9))),
        J_regressor=f32(j_regressor),
        weights=f32(weights),
        kintree_table=np.stack([parents,
                                np.arange(NUM_JOINTS, dtype=np.uint32)]),
        f=faces[:, [0, 2, 1]].astype(np.uint32),
        hands_componentsl=f32(rng.normal(size=(45, 45))),
        hands_componentsr=f32(rng.normal(size=(45, 45))),
        hands_meanl=f32(rng.normal(0, 0.1, 45)),
        hands_meanr=f32(rng.normal(0, 0.1, 45)))


def make_poses():
    """(first_params, pose_params) as numpy dicts: the first fit is the
    rest pose (with small seeded shape and expression coefficients); pose
    k of N_POSES turns the root by k ROOT_TURN about the vertical axis,
    raises trans by k RISE and walks the body pose by k seeded offsets of
    POSE_SIGMA."""
    rng = np.random.default_rng(SEED)
    beta = rng.normal(0, 0.1, (1, NUM_BETAS)).astype(np.float32)
    expr = rng.normal(0, 0.1, (1, NUM_EXPR)).astype(np.float32)
    first = {"body_pose": np.zeros((1, 63), np.float32),
             "orient": np.zeros((1, 3), np.float32),
             "trans": np.zeros((1, 3), np.float32),
             "beta": beta, "expr": expr}
    steps = np.arange(N_POSES, dtype=np.float32)
    offsets = rng.normal(0, POSE_SIGMA, (N_POSES, 63)).astype(np.float32)
    offsets[0] = 0.0
    poses = {"body_pose": np.cumsum(offsets, 0),
             "orient": np.stack([0 * steps, ROOT_TURN * steps, 0 * steps],
                                -1),
             "trans": np.stack([0 * steps, RISE * steps, 0 * steps], -1),
             "beta": np.repeat(beta, N_POSES, 0),
             "expr": np.repeat(expr, N_POSES, 0)}
    return first, {k: v.astype(np.float32) for k, v in poses.items()}


def prepare_pose_playback(model, first_params: dict, pose_params: dict,
                          first_frame_verts, lbs_w=None, fps: float = 25.0,
                          k: int = KNN_K) -> dict:
    """Animate the tracked cloth through a pose sequence (the JAX
    package's train/demo.py::prepare_pose_playback): inverse-LBS the
    first tracked frame to the canonical pose with the first SMPL-X fit,
    forward-LBS it through every pose.  Parameters are tensors on the
    model's device.  Returns dict(verts (T, V, 3), verts_velo
    (T-1, V, 3), smplx (T, Vb, 3), smplx_velo (T-1, Vb, 3))."""
    deformed, out_poses, _ = deform_tracked_to_poses(
        model, first_frame_verts, first_params, pose_params, lbs_w=lbs_w,
        k=k)
    smplx_seq = out_poses.vertices
    return {"verts": deformed, "verts_velo": frame_velocities(deformed, fps),
            "smplx": smplx_seq,
            "smplx_velo": frame_velocities(smplx_seq, fps)}


@dataclasses.dataclass
class PosePlayback:
    """The scene: the solver with its colliders, the cloth's initial
    state and material, and the posed sequence."""
    solver: MPMSolver
    state: MPMState
    model: MPMModel
    playback: dict

    def inputs(self, i: int) -> dict:
        """Frame i's inputs of ``MPMSolver.frame`` (run_demo.py:124-145):
        the posed body and its velocity, then (past the last pose) the
        last pose held still; the re-posed cloth's velocities on the
        pinned vertices, and on each pinned face the mean of its three
        vertices' taken from the pinned vertices' velocities alone, as
        run_demo.py does: a face vertex past them reads the last pinned
        vertex's (JAX's gather clamps the index)."""
        with profiling.span("frame.inputs"):
            pb, tf, cfg = self.playback, SIM_TF, self.solver.cfg
            n_pose = pb["smplx"].shape[0]
            moving = i < n_pose - 1
            bx = pb["smplx"][min(i, n_pose - 1)]
            bv = pb["smplx_velo"][i] if moving else torch.zeros_like(bx)
            vv = tf.vel2sim(pb["verts_velo"][i] if moving
                            else torch.zeros_like(pb["verts"][0]))
            jv = vv[:cfg.num_joint_v]
            faces = self.state.faces[:cfg.num_joint_f].long()
            return {"mesh_x": tf.wld2sim(bx), "mesh_v": tf.vel2sim(bv),
                    "joint_verts_v": jv,
                    "joint_faces_v": jv[faces.clamp(max=len(jv) - 1)].mean(1)}


def load_body(n_theta: int = 97, n_phi: int = 108, device=None):
    """The synthetic body archive written to a temporary directory and
    loaded by ``load_smplx_npz`` onto ``device``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "SMPLX_NEUTRAL.npz")
        write_body_npz(path, n_theta, n_phi)
        return load_smplx_npz(path, device=device)


def build(nx: int = 183, grid: int = 128, n_theta: int = 97,
          n_phi: int = 108, substeps: int = 100, friction: float = 0.5,
          num_joint_v: int = NUM_JOINT_V, num_joint_f: int = NUM_JOINT_F,
          body=None, device=None) -> PosePlayback:
    """The pose-playback scene on ``device``: the cloth re-posed through
    the body's poses at fps = 1 / (substeps DT), its first
    ``num_joint_v`` vertices and ``num_joint_f`` faces pinned.  ``body``
    (an SMPLXModel on ``device``) replaces the synthetic archive's."""
    device = resolve_device(device)
    model = body if body is not None else load_body(n_theta, n_phi, device)
    verts, faces = build_cloth(nx, nx, y0=CLOTH_Y)
    first, poses = make_poses()
    t = lambda d: {k: torch.as_tensor(v, device=device) for k, v in d.items()}
    playback = prepare_pose_playback(
        model, t(first), t(poses), torch.as_tensor(verts, device=device),
        fps=1.0 / (substeps * DT))
    cfg, state, mpm_model = cloth_scene(verts, faces, grid, device=device)
    cfg = dataclasses.replace(cfg, num_joint_v=min(num_joint_v, len(verts)),
                              num_joint_f=min(num_joint_f, len(faces)))
    solver = MPMSolver(cfg, device=device)
    solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    solver.add_mesh_collider(model.faces.cpu().numpy(), friction=friction)
    solver.add_particle_mover()
    return PosePlayback(solver, state, mpm_model, playback)


def run(scene: PosePlayback, frames: int, substeps: int, log=print):
    """``frames`` x ``substeps`` substeps of the scene; returns the final
    state."""
    solver, state, t = scene.solver, scene.state, 0.0
    cloth = slice(solver.cfg.n_elements, None)
    for f in range(frames):
        t0 = time.perf_counter()
        state, t = solver.frame(state, scene.model, DT, substeps, t,
                                **scene.inputs(f))
        solver.check_finite(state, context=f"pose playback frame {f}")
        y = state.x[cloth, 1].cpu()
        wall = time.perf_counter() - t0
        log(f"frame {f}: cloth y range [{float(y.min()):.4f}, "
            f"{float(y.max()):.4f}], {1e3 * wall / substeps:.3f} "
            f"ms/substep")
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nx", type=int, default=183,
                        help="cloth vertices per side")
    parser.add_argument("--grid", type=int, default=128)
    parser.add_argument("--body", default="97x108",
                        help="the body template's n_theta x n_phi")
    parser.add_argument("--frames", type=int, default=2,
                        help="frames past the last pose interval hold the "
                        "body still at the last pose")
    parser.add_argument("--substeps", type=int, default=100)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)
    n_theta, n_phi = (int(s) for s in args.body.split("x"))
    scene = build(args.nx, args.grid, n_theta, n_phi,
                  substeps=args.substeps, device=args.device)
    run(scene, args.frames, args.substeps)
    print("pose playback complete")


if __name__ == "__main__":
    main()
