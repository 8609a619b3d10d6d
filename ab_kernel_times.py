#!/usr/bin/env python3
"""Time K1 (cloth stress) and K3 (G2P) of one tree of the port by CUDA-graph
replay, to compare two trees on one card.

    python3 ab_kernel_times.py [TREE]

TREE (default: this script's directory) is a checkout whose
``mpmavatar_tpu_torch`` is built and timed.  The shapes, the seeded inputs
and the timing (``graph_ms``) are this script's and this directory's
``chip_smoke.py``'s, whatever the tree, and the script calls no API that
the tree before K1's and K3's redesign lacks.  So a parent unpacked with
``git archive`` under the git-ignored ``scratch/`` and the working tree
can be timed in turns in one call:

    for t in scratch/parent . . scratch/parent; do
        python3 ab_kernel_times.py $t || exit 1; done

K1 at the cloth drop's shape; K3 at the cloth drop's particle order, a
random permutation of it and path B's initial state, on seeded grid
velocities.  It holds no kernel against its plain version
(``chip_smoke.py`` does that) and prints one JSON line: the times in ms,
the tree and the card's name and power limit.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import chip_smoke as cs


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else cs.REPO).resolve()
    sys.path.insert(0, str(tree))
    import torch
    if not torch.cuda.is_available():
        print("ab_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import stress as kstress
    from mpmavatar_tpu_torch.ops import transfer as ktransfer
    from mpmavatar_tpu_torch.sim import bench_scene, cloth_drop
    if not Path(_build.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {_build.__file__}, not from {tree}")
    dev = torch.device("cuda")
    _build.library()
    solver, state, model = cloth_drop.build(cs.NX, cs.GRID, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    k1_in = cs.k1_inputs(state, model, solver.cfg.n_elements, gen)
    times = {"graph_floor": cs.graph_floor_ms(dev),
             "cloth_stress": cs.graph_ms(
                 lambda: kstress.cloth_stress(*k1_in))}
    solver_b, state_b = bench_scene.build(cs.GRID_B, cs.SAND_B,
                                          device=dev)[:2]
    perm = cs.random_order(solver.cfg).to(dev)
    for label, x, cfg in (
            ("g2p", state.x, solver.cfg),
            ("g2p (random order)", state.x[perm], solver.cfg),
            (f"g2p (path B, {cs.GRID_B}^3)", state_b.x, solver_b.cfg)):
        g = cfg.n_grid
        grid_v = torch.randn((g ** 3, 3), generator=gen, device=dev)
        times[label] = cs.graph_ms(
            lambda: ktransfer.g2p(x, grid_v, g, cfg.inv_dx))
    print(json.dumps({"tree": str(tree), "ms": times,
                      "card": cs.nvidia_smi_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
