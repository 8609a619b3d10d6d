"""The zero-shot interaction demo CLI (chair, poured sand, orbit render),
port of scripts/run_demo.py.

The chain: the optional pose playback (the tracked cloth and the SMPL-X
body animated through a pose sequence by inverse + forward LBS), the
mixed cloth + sand simulation (``train/demo.py::build_demo_sim``, 250^3 by
default, the sand released layer by layer from ``--sand_release_frame``)
writing the cloth and the sand as OBJs per frame, then, with
``--avatar_dir`` and ``--uv_path``, per frame an AO bake
(``render/ao.py``) and the orbit render with the sand and the chair's
gaussians, as PNGs; the video is made when ffmpeg is present.  Runs on
the CUDA device; ``--device cpu`` runs the plain PyTorch path.

    python -m mpmavatar_tpu_torch.data.make_demo_assets --out A
    python -m mpmavatar_tpu_torch.train.run_demo --cloth_obj A/cloth.obj \\
        --body_obj A/body.obj --chair_obj A/chair.obj \\
        --chair_gs A/chair_gs.npz --smplx_model_npz A/smplx_model.npz \\
        --first_smplx_npz A/first_smplx.npz --pose_npz A/pose_seq.npz \\
        --avatar_dir A/tracked --uv_path A/uv.obj --out_dir output/demo
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..sim.solver import SimTransform
from ..utils.io import read_obj, write_obj
from .demo import build_demo_sim, get_sand, prepare_pose_playback

FPS = 25.0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cloth_obj", required=True,
                        help="the garment mesh at the first tracked frame")
    parser.add_argument("--body_obj", required=True,
                        help="the static body collider (first frame)")
    parser.add_argument("--chair_obj", default=None)
    parser.add_argument("--chair_gs", default=None,
                        help="the chair's gaussians (npz or 3DGS ply) for "
                        "the orbit render")
    parser.add_argument("--out_dir", default="./output/demo")
    parser.add_argument("--num_frames", type=int, default=60)
    parser.add_argument("--extra_frames", type=int, default=130,
                        help="frames simulated past the pose sequence")
    parser.add_argument("--grid_size", type=int, default=250)
    parser.add_argument("--substep", type=int, default=400)
    parser.add_argument("--num_joint_v", type=int, default=0,
                        help="leading cloth vertices pinned to the body")
    parser.add_argument("--num_joint_f", type=int, default=0)
    parser.add_argument("--sand_release_frame", type=int, default=100,
                        help="the frame at which the sand starts releasing")
    parser.add_argument("--smplx_model_npz", default=None)
    parser.add_argument("--first_smplx_npz", default=None,
                        help="the SMPL-X fit of the first tracked frame")
    parser.add_argument("--pose_npz", default=None,
                        help="the pose sequence (a1_sitting.npz layout)")
    parser.add_argument("--lbs_w_npy", default=None)
    parser.add_argument("--avatar_dir", default=None,
                        help="the tracking directory (params_*.npz) to "
                        "render with")
    parser.add_argument("--avatar_ckpt", default=None,
                        help="an appearance checkpoint directory")
    parser.add_argument("--uv_path", default=None)
    parser.add_argument("--skip_video", action="store_true")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    return parser


def main(argv=None, log=print) -> dict:
    """Run the CLI.  Returns the wall clock by stage (s: "playback",
    "build", "sim", "render"), the per-frame sim seconds ("frame_s"), the
    orbit render's per-frame records ("orbit": bake and render seconds,
    the rasterizer's overflow counts), and the simulation as it ended:
    "cfg", "solver", "state", "model", "time", "dt" and the last frame's
    ``MPMSolver.frame`` inputs ("inputs")."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    result = {"frame_s": []}
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    cloth_v, cloth_f = read_obj(args.cloth_obj)
    body_v, body_f = read_obj(args.body_obj)

    # the optional pose playback: the body and the pinned cloth per frame
    t0 = time.perf_counter()
    playback = None
    if args.pose_npz:
        assert args.smplx_model_npz and args.first_smplx_npz, \
            "--pose_npz needs --smplx_model_npz and --first_smplx_npz"
        from ..avatar.smplx import load_smplx_npz
        smplx_model = load_smplx_npz(args.smplx_model_npz, device=device)
        dev = lambda path: {k: torch.as_tensor(v, device=device)
                            for k, v in np.load(path).items()}
        lbs_w = (torch.as_tensor(np.load(args.lbs_w_npy), device=device)
                 if args.lbs_w_npy else None)
        playback = prepare_pose_playback(
            smplx_model, dev(args.first_smplx_npz), dev(args.pose_npz),
            torch.as_tensor(cloth_v, device=device), lbs_w=lbs_w)
        n_pose = int(playback["verts"].shape[0])
        args.num_frames = n_pose + args.extra_frames
        body_v = playback["smplx"][0].cpu().numpy()
        log(f"pose playback: {n_pose} poses + {args.extra_frames} extra "
            f"frames")
    sync()
    result["playback"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    n_body = len(body_v)
    if args.chair_obj:
        chair_v, chair_f = read_obj(args.chair_obj)
        body_f = np.concatenate([body_f, chair_f + n_body])
        body_v = np.concatenate([body_v, chair_v])
    n_chair = len(body_v) - n_body

    sand, sand_vol = get_sand()
    tf = SimTransform.from_verts(cloth_v)
    cfg, state, model, solver = build_demo_sim(
        cloth_v, cloth_f, sand, sand_vol, body_v, body_f, tf,
        grid_size=args.grid_size, num_joint_v=args.num_joint_v,
        num_joint_f=args.num_joint_f, device=device)
    # the gradual sand release after the avatar is seated
    release_t0 = args.sand_release_frame / FPS
    sand_z = tf.wld2sim(sand)[:, 2]
    solver.release_particles_sequentially(
        state, [0.0, 0.0, 1.0], float(sand_z.max()), float(sand_z.min()),
        start_time=release_t0,
        end_time=release_t0 + (args.num_frames
                               - args.sand_release_frame) / FPS)
    result["cfg"], result["solver"] = cfg, solver
    sync()
    result["build"] = time.perf_counter() - t0

    os.makedirs(os.path.join(args.out_dir, "uvmesh"), exist_ok=True)
    os.makedirs(os.path.join(args.out_dir, "sand"), exist_ok=True)
    dt = (1.0 / FPS) / args.substep
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    chair_sim = tf.wld2sim(f32(body_v[n_body:]))
    zeros_chair = torch.zeros((n_chair, 3), device=device)
    joint_f = torch.as_tensor(np.asarray(cloth_f[:args.num_joint_f]),
                              dtype=torch.int64, device=device)
    t_sim = time.perf_counter()
    t = 0.0
    for i in range(args.num_frames):
        t_f = time.perf_counter()
        jv = jf = None
        if playback is not None:
            n_pose = playback["smplx"].shape[0]
            moving = i < n_pose - 1
            bx = playback["smplx"][min(i, n_pose - 1)]
            bv = playback["smplx_velo"][i] if moving else \
                torch.zeros_like(bx)
            mesh_x = torch.cat([tf.wld2sim(bx), chair_sim], 0)
            mesh_v = torch.cat([bv * tf.scale, zeros_chair], 0)
            if args.num_joint_v:
                jv = (playback["verts_velo"][i, :args.num_joint_v]
                      if moving else torch.zeros(
                          (args.num_joint_v, 3), device=device)) * tf.scale
                # a face vertex past the pinned ones reads the last
                # pinned vertex, as JAX's gather clamps the index
                jf = jv[joint_f.clamp(max=args.num_joint_v - 1)].mean(1)
        else:
            mesh_x = tf.wld2sim(f32(body_v))
            mesh_v = torch.zeros_like(mesh_x)
        inputs = dict(mesh_x=mesh_x, mesh_v=mesh_v, joint_verts_v=jv,
                      joint_faces_v=jf)
        state, t = solver.frame(state, model, dt, args.substep, t, **inputs)
        solver.check_finite(state, context=f"demo frame {i}")
        e, n_t = cfg.n_elements, cfg.n_traditional
        cloth = tf.sim2wld(state.x[e + n_t:]).cpu().numpy()
        sand_w = tf.sim2wld(state.x[e:e + n_t]).cpu().numpy()
        result["frame_s"].append(time.perf_counter() - t_f)
        write_obj(os.path.join(args.out_dir, "uvmesh", f"{i:03d}.obj"),
                  cloth, cloth_f)
        write_obj(os.path.join(args.out_dir, "sand", f"{i:03d}.obj"), sand_w)
        log(f"frame {i}: cloth y [{cloth[:, 1].min():.3f}, "
            f"{cloth[:, 1].max():.3f}]")
    result["sim"] = time.perf_counter() - t_sim
    result.update(state=state, model=model, time=t, dt=dt, inputs=inputs)

    t0 = time.perf_counter()
    if args.avatar_dir and args.uv_path:
        result["orbit"] = render_orbit(args, device, log)
    result["render"] = time.perf_counter() - t0
    steady = 1e3 * result["frame_s"][-1] / args.substep
    log(f"demo: {args.num_frames} frames x {args.substep} substeps; wall "
        f"clock: pose playback {result['playback']:.2f} s, build "
        f"{result['build']:.2f} s, simulation with OBJs "
        f"{result['sim']:.2f} s (the last frame {steady:.4f} ms/substep), "
        f"bakes and orbit renders {result['render']:.2f} s")
    return result


def render_orbit(args, device, log=print) -> list:
    """Bake AO per simulated frame and render it from the orbit with the
    trained avatar, the sand and the chair's gaussians (PNGs under
    out_dir/video/frames).  Returns per frame {"bake_s", "render_s",
    "big_overflow"}."""
    from PIL import Image

    from ..render.ao import bake_ao, load_uv_chart
    from ..render.avatar_model import (load_avatar_checkpoint,
                                       load_mesh_avatar)
    from ..render.cameras import Camera
    from ..utils.misc import frames_to_video
    from .demo import get_spherical_cam, load_chair_gaussians, \
        render_demo_frame

    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    avatar, params = load_mesh_avatar(args.avatar_dir, args.uv_path,
                                      device=device)
    if args.avatar_ckpt:
        params = load_avatar_checkpoint(args.avatar_ckpt, params)
    chair = chair_shs = None
    if args.chair_gs:
        chair, chair_shs = load_chair_gaussians(args.chair_gs, device)
    chart = load_uv_chart(args.uv_path, resolution=256)
    faces = avatar.tensor("faces", device)

    k = np.array([[1000.0, 0, 512], [0, 1000.0, 512], [0, 0, 1]])
    cams = get_spherical_cam(Camera.from_kw2c("ref", 1024, 1024, k,
                                              np.eye(4)), args.num_frames)
    img_dir = os.path.join(args.out_dir, "video", "frames")
    os.makedirs(img_dir, exist_ok=True)
    records = []
    for i in range(args.num_frames):
        verts, _ = read_obj(os.path.join(args.out_dir, "uvmesh",
                                         f"{i:03d}.obj"))
        sand, _ = read_obj(os.path.join(args.out_dir, "sand", f"{i:03d}.obj"))
        verts = torch.as_tensor(verts, device=device)
        t0 = time.perf_counter()
        ao = bake_ao(verts, faces, chart.face_idx, chart.bary,
                     chart.texel_ij)
        sync()
        t1 = time.perf_counter()
        img, out = render_demo_frame(
            avatar, params, verts, ao, cams[i], 0,
            sand_xyz=torch.as_tensor(sand, device=device) if len(sand)
            else None, chair=chair, chair_shs=chair_shs)
        arr = (np.clip(img.permute(1, 2, 0).cpu().numpy(), 0, 1)
               * 255).astype(np.uint8)
        t2 = time.perf_counter()
        Image.fromarray(arr).save(os.path.join(img_dir, f"{i:04d}.png"))
        records.append({"bake_s": t1 - t0, "render_s": t2 - t1,
                        "big_overflow": int(out["big_overflow"])})
        log(f"orbit frame {i}: bake {1e3 * (t1 - t0):.1f} ms, render "
            f"{1e3 * (t2 - t1):.1f} ms")
    if not args.skip_video:
        frames_to_video(os.path.join(img_dir, "%04d.png"),
                        os.path.join(args.out_dir, "video", "video.mp4"))
    return records


if __name__ == "__main__":
    main()
