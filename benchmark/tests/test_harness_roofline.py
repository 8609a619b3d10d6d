"""``roofline.py``'s counts against counts made by hand on a tiny
scene."""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.roofline import SubstepShape, Work


def test_one_point_touches_its_27_cells():
    # G = 8 over [0, 2): dx = 0.25; x = 1.0 -> x / dx - 0.5 = 3.5, base 3
    cells = roofline.stencil_cells(torch.tensor([[1.0, 1.0, 1.0]]), 8, 4.0,
                                   False)
    want = sorted((i * 8 + j) * 8 + k for i in (3, 4, 5) for j in (3, 4, 5)
                  for k in (3, 4, 5))
    assert cells.tolist() == want


def test_shared_and_separate_stencils_are_counted_once():
    g, inv_dx = 16, 8.0
    same = torch.tensor([[1.0, 1.0, 1.0], [1.01, 1.0, 1.0]])
    apart = torch.tensor([[0.5, 0.5, 0.5], [1.5, 1.5, 1.5]])
    assert roofline.stencil_cells(same, g, inv_dx, False).numel() == 27
    assert roofline.stencil_cells(apart, g, inv_dx, False).numel() == 54
    # next to a face (base 4 on x: 5 cells of x)
    near = torch.tensor([[0.6, 1.0, 1.0], [0.7, 1.0, 1.0]])
    assert roofline.stencil_cells(near, g, inv_dx, False).numel() == 36


def test_the_splats_drop_a_point_off_the_grid():
    g, inv_dx = 8, 4.0
    pts = torch.tensor([[1.0, 1.0, 1.0], [1.9, 1.0, 1.0]])   # base 7 on x
    assert roofline.stencil_cells(pts, g, inv_dx, True).numel() == 27
    assert roofline.stencil_cells(pts, g, inv_dx, False).numel() == 27 + 9


def test_a_substep_by_hand():
    s = SubstepShape(E=2, T=1, V=3, faces=4, pinned=1, cells=30,
                     collider_cells=20, pinned_cells=10)
    P = 6
    hand_bytes = 4 * (2 * 45 + 30 * 1 + (17 * P + 9 * 3 + 3 * 3 + 4 * 30)
                      + (9 * 4 + 7 * 20) + (6 * 1 + 4 * 10)
                      + (7 * 30 + 7 * 20 + 4 * 10) + (24 * P + 3 * 30))
    hand_flops = (2 * 310 + 2000 + 1800 * P + 4 * (30 + 54 * 7)
                  + (30 + 54 * 4) + 60 * 30 + 1900 * P)
    w = roofline.substep_work(s)
    assert w.bytes == hand_bytes and w.flops == hand_flops
    assert w.seconds() == max(hand_bytes / 3.35e12, hand_flops / 67e12)


def test_a_training_step_counts_each_substep_twice():
    s = SubstepShape(E=2, T=0, V=3, faces=4, pinned=1, cells=30,
                     collider_cells=20, pinned_cells=10)
    one = roofline.substep_work(s)
    step = roofline.train_step_seconds(s, frames=2, substeps=5)
    extra = Work(2 * 3 * 6 * 4 + 48, 2 * 3 * 9.0 + 60)
    assert step == (one * 20 + extra).seconds()


def test_shape_of_a_scene():
    x = torch.tensor([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.5, 1.5, 1.5]])
    s = roofline.shape_of(x, 1, 0, 2, 16, 2.0, x[:1], x[2:])
    assert (s.P, s.cells, s.collider_cells, s.pinned_cells) == (3, 54, 27, 27)
