"""Run the port's multi-device code in gloo ranks on the CPU, for the
tests: ``run_ranks(job, world, tmp_path, *args)`` spawns ``world``
processes, joins them into one gloo process group through a ``file://``
init in ``tmp_path`` (so that parallel test workers never share a port),
calls ``job(rank, world, group, *args)`` in each and returns the ranks'
results in rank order.  A rank that fails, or that has not ended within
the timeout (stuck in a collective), fails the caller; every process is
joined or killed before it returns.

This module and the jobs below import torch and the port only: the
spawned ranks import it, and they must not import JAX.  The arguments
and results are numpy arrays, dicts and lists of them, Python scalars
and the port's collider objects.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import pickle
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 60.0


def _rank_main(job, rank, world, tmp, args):
    torch.set_num_threads(1)
    out = Path(tmp)
    try:
        dist.init_process_group("gloo", init_method=f"file://{out / 'init'}",
                                rank=rank, world_size=world)
        result = job(rank, world, dist.group.WORLD, *args)
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(job, world: int, tmp_path, *args, timeout: float = TIMEOUT_S):
    tmp = Path(tempfile.mkdtemp(prefix=f"{job.__name__}_{world}_",
                                dir=tmp_path))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    errs = "\n".join(f.read_text() for f in sorted(tmp.glob("rank*.err")))
    if stuck:
        raise AssertionError(f"{job.__name__}: ranks {stuck} of {world} had "
                             f"not ended after {timeout:.0f} s\n{errs}")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise AssertionError(f"{job.__name__}: exit codes {codes}\n{errs}")
    results = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _numpy(obj) -> dict:
    return {f.name: getattr(obj, f.name).detach().numpy()
            for f in dataclasses.fields(obj)}


# ---- jobs ---------------------------------------------------------------

def sharded_frames(rank, world, group, frames):
    """Each of ``frames`` (dicts: cfg, state (the padded state's arrays),
    um (arrays; the names in um_sharded are per-element and sharded),
    grid_post (the port's colliders), options, inputs (name, array or
    None; the mesh inputs sharded)) through ``make_sharded_frame`` on
    this rank's block; this rank's final block per frame."""
    from mpmavatar_tpu_torch import convert
    from mpmavatar_tpu_torch.core.types import MPMStaticConfig
    from mpmavatar_tpu_torch.parallel import make_sharded_frame, shard_state
    from mpmavatar_tpu_torch.parallel.sharded import _block

    outs = []
    for fr in frames:
        st = shard_state(convert.sharded_state_from_numpy(fr["state"], "cpu"),
                         rank, world)
        um = dict(fr["um"])
        for k in fr.get("um_sharded", ()):
            um[k] = _block(um[k], rank, world)
        um = convert.uniform_model_from_numpy(um, "cpu")
        inputs = [None if a is None else
                  _block(torch.as_tensor(a), rank, world)
                  if name.startswith("mesh") else torch.as_tensor(a)
                  for name, a in fr["inputs"]]
        frame = make_sharded_frame(MPMStaticConfig(**fr["cfg"]), group,
                                   grid_post=fr["grid_post"],
                                   **fr["options"])
        outs.append(_numpy(frame(st, um, *inputs)))
    return outs


def sharded_material_step(rank, world, group, cfg, state, um, num_substeps,
                          dt, mesh_x, target):
    """``make_sharded_material_step`` on this rank's block: (loss, the
    gradient per leaf, this rank's final xv)."""
    from mpmavatar_tpu_torch import convert
    from mpmavatar_tpu_torch.core.types import MPMStaticConfig
    from mpmavatar_tpu_torch.parallel import (make_sharded_material_step,
                                              shard_state)
    from mpmavatar_tpu_torch.parallel.sharded import _block

    st = shard_state(convert.sharded_state_from_numpy(state, "cpu"), rank,
                     world)
    um = convert.uniform_model_from_numpy(um, "cpu")
    mx = _block(torch.as_tensor(mesh_x), rank, world)
    tgt = _block(torch.as_tensor(target), rank, world)
    step = make_sharded_material_step(MPMStaticConfig(**cfg), group,
                                      num_substeps, dt)
    loss, grads, new_st = step(st, um, mx, torch.zeros_like(mx), None, tgt)
    return float(loss), _numpy(grads), new_st.xv.numpy()


def collective_gradients(rank, world, group, seed, eps):
    """The collectives chained in float64 on this rank: x (k,) ->
    all_gather -> tanh(. w) -> reduce_scatter -> all_reduce(. ** 2 u) ->
    loss = sum(c .); the objective J is the sum of the ranks' losses.
    Returns this rank's autograd gradient dJ/dx and, by central finite
    differences of J over every rank's x, the whole gradient (all ranks
    compute it; each returns it)."""
    from mpmavatar_tpu_torch.parallel import collectives as C

    k = 3
    rng = np.random.default_rng(seed + rank)
    x0 = torch.as_tensor(rng.normal(size=k))
    w = torch.as_tensor(rng.normal(size=k * world))
    u = torch.as_tensor(rng.normal(size=k))
    c = torch.as_tensor(rng.normal(size=k))

    def loss_of(x):
        h = torch.tanh(C.all_gather(x, group) * w)
        s = C.reduce_scatter(h, group)
        return torch.sum(c * C.all_reduce(s ** 2 * u, group))

    x = x0.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(loss_of(x), x)
    fd = np.zeros((world, k))
    with torch.no_grad():
        for r in range(world):
            for i in range(k):
                js = []
                for sign in (1.0, -1.0):
                    xp = x0.clone()
                    if r == rank:
                        xp[i] += sign * eps
                    js.append(float(C.all_reduce(loss_of(xp), group)))
                fd[r, i] = (js[0] - js[1]) / (2 * eps)
    return grad.numpy(), fd


def dp_appearance_steps(rank, world, group, avatar, params, batch, lr,
                        steps, raster):
    """``steps`` steps of ``make_dp_appearance_step`` on this rank's share
    of ``batch`` (cam arrays by field, camera_idx, timestep, verts_base,
    ao_map, rgb, msk; the global batch), with SGD at ``lr`` over every
    float leaf, or the stage-2 Adam (``make_optimizer``) when ``lr`` is
    None.  Returns (the losses, the float leaves after the last step by
    name, the densification state, the last step's metrics)."""
    from mpmavatar_tpu_torch import convert
    from mpmavatar_tpu_torch.data import OptimizationParams
    from mpmavatar_tpu_torch.parallel.appearance_dp import (
        make_dp_appearance_step, shard_batch)
    from mpmavatar_tpu_torch.render import gaussians as G
    from mpmavatar_tpu_torch.train.appearance import (float_leaves,
                                                      make_optimizer)

    av = convert.mesh_avatar_from_numpy(avatar)
    p = convert.avatar_params_from_numpy(**params, device="cpu")
    opt = OptimizationParams()
    optimizer = (make_optimizer(opt, 1.0, p) if lr is None else
                 torch.optim.SGD(list(float_leaves(p).values()), lr=lr))
    step = make_dp_appearance_step(av, opt, optimizer, group, 0, False,
                                   **raster)
    cam, *rest = batch
    full = (convert.camera_arrays_from_numpy(cam, "cpu"),
            *(torch.as_tensor(a) for a in rest))
    local = shard_batch(full, rank, world)
    ds = G.init_densify_state(p.splats.capacity, "cpu")
    losses = []
    for _ in range(steps):
        ds, loss, metrics = step(p, ds, *local)
        losses.append(float(loss))
    return (losses, {k: v.detach().numpy() for k, v in float_leaves(p).items()},
            _numpy(ds), {k: v.numpy() for k, v in metrics.items()})
