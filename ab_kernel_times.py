#!/usr/bin/env python3
"""Time K1 (cloth stress), K3 (G2P), K8 (sand stress) and K4 (the splat)
of one tree of the port by CUDA-graph replay, to compare two trees on one
card.

    python3 ab_kernel_times.py [TREE] [--kernels k1,k3,k8,k4]

TREE (default: this script's directory) is a checkout whose
``mpmavatar_tpu_torch`` is built and timed.  The shapes, the seeded inputs
and the timing (``graph_ms``) are this script's and this directory's
``chip_fixtures.py``'s, whatever the tree; the K1, K3 and K8 group calls no
API that the tree before their redesigns lacks, and the K4 group none that
the tree before K4's redesign (with the posed body) lacks.  So a parent
unpacked with ``git archive`` under the git-ignored ``scratch/`` and the
working tree can be timed in turns in one call:

    for t in scratch/parent . . scratch/parent; do
        python3 ab_kernel_times.py $t || exit 1; done

K1 at the cloth drop's shape; K3 at the cloth drop's particle order, a
random permutation of it and path B's initial state, on seeded grid
velocities; K8 on ``chip_fixtures.sand_set`` at path B's 100,000 particles
(tip / cone / reflected, four fifths selected), on the same set with
every particle selected (path B's case), and on path B's sand after
chip_smoke's 2 x 100 substeps (run by the tree's own kernels; the mean
and largest |F_trial - I| of that sand are printed); K4 at
``chip_fixtures.k4_shapes`` (path A's collider faces and joint points, the
posed body's faces in mesh order and shuffled, the icosphere torso in
both face orders, the material trainer's mover, the random points), with
its blocks by branch where the tree's ``splat`` counts them, and beside
it the wrapper's zero fill alone (two fills, as the wrapper makes them,
and one fill of both outputs' size).  Where the toolkit's ``cuobjdump``
is found, it also counts the SASS instructions a thread of K8 issues per
particle and the issue floor they set at path B's 100,000 particles
(``sand_sass``), and K4's atomic and match instructions at CH = 6
(``splat_sass``).  ``--kernels`` picks the groups timed (default: all).
It holds no kernel against its plain version (``chip_smoke.py`` does
that) and prints one JSON line: the times in ms, the SASS counts, the
tree and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from chip_fixtures import (DT, FRAMES, GRID, GRID_B, NX, OUT, REPO, SAND_B,
                           SUBSTEPS, graph_floor_ms, graph_ms, k1_inputs,
                           k4_shapes, nvidia_smi_line, random_order,
                           sand_set)

# one instruction of cuobjdump's listing, "/*1e00*/  @!P0 FFMA R1, ...":
# its address and opcode; a branch's target address
SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
SASS_TARGET = re.compile(r"BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")


def cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "cuobjdump"
    return str(cand) if cand.exists() else None


def sass_issue_count(listing: str, trips: int) -> dict:
    """Instructions a thread issues through one function of a cuobjdump
    ``-sass`` listing, NOPs left out.  ``arithmetic``: those between the
    block's last two ``BAR.SYNC`` (K8: after the staged rows arrive and
    before the slabs go out; one particle's SVD, return map and stress,
    and an unselected particle's copy), the loop of its largest backward
    branch (K8's Jacobi sweeps, where they are not unrolled; ``loop_body``)
    counted ``trips`` times; ``staging``: the rest up to the last
    ``EXIT``, counted once (an upper bound: a thread runs the aligned or
    the scalar copies, and each copy loop two or three times).  The code
    after the last EXIT (the IEEE division's and square root's slow
    paths, called only for operands out of their fast range) is not
    counted."""
    insts = [(int(m.group(1), 16), m.group(2), line)
             for line in listing.splitlines()
             if (m := SASS_LINE.search(line))]
    exits = [i for i, (_, op, _) in enumerate(insts) if op == "EXIT"]
    insts = insts[:exits[-1] + 1] if exits else insts
    bars = [i for i, (_, op, _) in enumerate(insts)
            if op.startswith("BAR.SYNC")]
    lo, hi = (bars[-2], bars[-1]) if len(bars) >= 2 else (0, len(insts))
    index = {addr: i for i, (addr, _, _) in enumerate(insts)}
    live = [op != "NOP" for _, op, _ in insts]
    loop_body = 0
    for i in range(lo, hi):
        _, op, line = insts[i]
        m = SASS_TARGET.search(line) if op == "BRA" else None
        target = index.get(int(m.group(1), 16)) if m and m.group(1) else None
        if target is not None and lo <= target < i:
            loop_body = max(loop_body, sum(live[target:i + 1]))
    region = sum(live[lo:hi])
    return {"arithmetic": region + (trips - 1) * loop_body,
            "loop_body": loop_body,
            "staging": sum(live) - region}


def kernel_sass(lib: Path, name: str, tag: str) -> str | None:
    """The SASS listing of the first function of the built library
    ``lib`` whose (mangled) name contains ``name``, written to
    ``name``-``tag``.sass in ``chip_fixtures.OUT``; None without
    ``cuobjdump`` or such a function."""
    tool = cuobjdump()
    if tool is None:
        return None
    listing = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, check=True).stdout
    found = [part for part in listing.split("Function : ")
             if name in part.split("\n", 1)[0]]
    if not found:
        return None
    (OUT / f"{name}-{tag}.sass").write_text(found[0])
    return found[0]


def sand_sass(lib: Path, tag: str, n_particles: int) -> dict | None:
    """K8's SASS instruction counts (``sass_issue_count``) in the built
    library ``lib``, and the issue floor they set on ``n_particles``: one
    warp instruction per clock on each of an SM's 4 schedulers, at the
    card's highest SM clock.  The listing goes to sand_kernel-``tag``.sass
    in ``chip_fixtures.OUT``."""
    import torch
    listing = kernel_sass(lib, "sand_kernel", tag)
    if listing is None:
        return None
    counts = sass_issue_count(listing, trips=8)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = -(-n_particles // 32)
    floor_s = warps * counts["arithmetic"] / (sms * 4 * mhz * 1e6)
    return {**counts, "sms": sms, "max_sm_mhz": mhz,
            "issue_floor_ms": 1e3 * floor_s}


def splat_sass(lib: Path, tag: str) -> dict | None:
    """K4's atomic, reduction and match instructions at CH = 6 (the
    instantiation splat_kernel<6>, or the one kernel of a tree that has no
    template) in the built library ``lib``, by opcode, over the whole
    listing (not per point)."""
    listing = kernel_sass(lib, "splat_kernelILi6E", tag) \
        or kernel_sass(lib, "splat_kernel", tag)
    if listing is None:
        return None
    ops = {}
    for line in listing.splitlines():
        m = SASS_LINE.search(line)
        if m and m.group(2).startswith(("ATOM", "RED", "MATCH")):
            ops[m.group(2)] = ops.get(m.group(2), 0) + 1
    return ops


def k1_k3_k8_times(dev, times) -> dict:
    """K1, K3 and K8 of the imported tree into ``times``; returns the
    mean and largest |F_trial - I| of path B's sand after its run."""
    import torch
    from mpmavatar_tpu_torch.ops import stress as kstress
    from mpmavatar_tpu_torch.ops import transfer as ktransfer
    from mpmavatar_tpu_torch.sim import bench_scene, cloth_drop
    solver, state, model = cloth_drop.build(NX, GRID, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_in = k1_inputs(state, model, solver.cfg.n_elements, gen)
    times["cloth_stress"] = graph_ms(lambda: kstress.cloth_stress(*k1_in))
    solver_b, state_b, model_b, scene_b = bench_scene.build(
        GRID_B, SAND_B, device=dev)
    perm = random_order(solver.cfg).to(dev)
    for label, x, cfg in (
            ("g2p", state.x, solver.cfg),
            ("g2p (random order)", state.x[perm], solver.cfg),
            (f"g2p (path B, {GRID_B}^3)", state_b.x, solver_b.cfg)):
        g = cfg.n_grid
        grid_v = torch.randn((g ** 3, 3), generator=gen, device=dev)
        times[label] = graph_ms(
            lambda: ktransfer.g2p(x, grid_v, g, cfg.inv_dx))
    sets = {label: sand_set(SAND_B, dev, all_selected=every)
            for label, every in (
                ("sand_stress (tip / cone / reflected set)", False),
                ("sand_stress (every particle selected)", True))}
    # path B's sand after chip_smoke's 2 x 100 substeps, run by the tree's
    # own kernels
    t_b = 0.0
    for _ in range(FRAMES):
        state_b, t_b = solver_b.frame(state_b, model_b, DT, SUBSTEPS,
                                      t_b, **scene_b)
    sl = slice(solver_b.cfg.n_elements, solver_b.cfg.n_no_vertices)
    sets["sand_stress (path B's sand after its run)"] = (
        state_b.F_trial, state_b.F, (state_b.selection[sl] == 0).float(),
        model_b.mu[sl], model_b.lam[sl], model_b.alpha)
    # free-falling sand keeps F = I but for rounding, which K8's F_new
    # (u v^T on the tip branch) feeds back every substep
    drift = (state_b.F_trial - torch.eye(3, device=dev)).abs()
    for label, args in sets.items():
        times[label] = graph_ms(lambda: kstress.sand_stress(*args))
    return {"mean": float(drift.mean()), "max": float(drift.max())}


def k4_times(dev, times, blocks) -> None:
    """K4 of the imported tree at ``chip_fixtures.k4_shapes`` into ``times``,
    and its blocks by branch into ``blocks`` where its ``splat`` counts
    them; the zero fill alone at the posed body's shape, two fills and
    one."""
    import torch
    from mpmavatar_tpu_torch.ops import splat as ksplat
    from mpmavatar_tpu_torch.sim import bench_scene, pose_playback
    solver_a, state_a, _, scene_a = bench_scene.build(GRID, device=dev)
    scene_p = pose_playback.build(
        NX, GRID, body=pose_playback.load_body(device=dev), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    counted = "branch_counts" in inspect.signature(ksplat.splat).parameters
    for label, pts, vals, g, bc in k4_shapes(
            dev, gen, solver_a, state_a, scene_a, scene_p).values():
        times[label] = graph_ms(
            lambda: ksplat.splat(pts, vals, g, g / 2.0, bc))
        if counted:
            counts = torch.zeros(2, dtype=torch.int32, device=dev)
            ksplat.splat(pts, vals, g, g / 2.0, bc, branch_counts=counts)
            blocks[label] = counts.tolist()
    n, ch = GRID ** 3, 6
    times[f"zero fill, two ({GRID}^3, CH={ch})"] = graph_ms(
        lambda: (torch.zeros((n, ch), device=dev),
                 torch.zeros((n,), device=dev)))
    times[f"zero fill, one of both sizes ({GRID}^3, CH={ch})"] = \
        graph_ms(lambda: torch.zeros((n * (ch + 1),), device=dev))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("tree", nargs="?", default=str(REPO))
    parser.add_argument("--kernels", default="k1,k3,k8,k4",
                        help="comma-separated groups: k1, k3 and k8 (timed "
                             "together), k4")
    args = parser.parse_args()
    groups = set(args.kernels.split(","))
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("ab_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from mpmavatar_tpu_torch.ops import _build
    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {_build.__file__}, not from {tree}")
    dev = torch.device("cuda")
    _build.library()
    lib = Path(_build.build_info()["path"])
    OUT.mkdir(exist_ok=True)
    times = {"graph_floor": graph_floor_ms(dev)}
    out = {"tree": str(tree), "ms": times}
    if groups & {"k1", "k3", "k8"}:
        out["sand_f_trial_minus_i"] = k1_k3_k8_times(dev, times)
        out["sand_sass"] = sand_sass(lib, tree.name, SAND_B)
    if "k4" in groups:
        out["splat_blocks_tile_direct"] = {}
        k4_times(dev, times, out["splat_blocks_tile_direct"])
        out["splat_sass"] = splat_sass(lib, tree.name)
    out["card"] = nvidia_smi_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
