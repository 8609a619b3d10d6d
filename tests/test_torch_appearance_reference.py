"""The port's stage-2 step against the benchmark's plain reference
(``benchmark/reference/appearance.py``), on the CPU at the cut size
``bench_appearance`` takes (96 x 64, a 20 x 18 body mesh, ``work_cap``
64, 4 views, 3 frames): the loss, each leaf's gradient and Adam's change
after one step from the same seeded weights, LPIPS on and off; a planted
error in the program (a shadow-UNet weight's sign, a regulariser left
out) fails the same comparison.  The reference modules load nothing of
the program or of JAX, and the benchmark's driver loads no JAX."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import avatar_scene, harness
from benchmark.drivers import appearance_step
from benchmark.reference.appearance import Appearance
from benchmark.reference.arith import Arith
from mpmavatar_tpu_torch.render import avatar_model, gaussians, shadow
from mpmavatar_tpu_torch.train import appearance

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEED = 2147483777
# the loss: float32 sums over 6,144 pixels and the regularisers' means,
# in other orders (the compositor's scan, SSIM's band products against
# its filter, LPIPS's reductions): a few ulp of a loss near 2
LOSS_TOL = 1e-5
# a gradient element against its leaf's largest reference element:
# the two compositors and SSIM's two filters round alike to ~1e-6 of a
# leaf's scale; 1e-4 leaves room for the colour and shadow sums over
# every pixel
GRAD_TOL = 1e-4
# Adam's first step moves an element by about lr sign(g): on the
# elements whose reference gradient stands above round-off (1e-3 of the
# leaf's largest), each step agrees to within float32's rounding of
# lr / (|g| / sqrt(g^2) + eps)
CHANGE_TOL = 1e-4
# a leaf's gradient is held against its own largest element, or against
# this share of the largest over all leaves where that is larger: the
# rotations' gradient is exactly zero at the start (each splat is a
# ball, whose covariance no rotation turns), so both sides compute
# round-off there, and their Adam steps are round-off's signs
ROUND_OFF = 1e-6


def _cut(lpips: bool):
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic = harness.cell_files(spec, "avatar1500.appearance_step")
    cfg["image"].update(width=96, height=64, focal=1400.0 * 96 / 1500)
    cfg["mesh"].update(n_theta=20, n_phi=18)
    cfg["raster"]["work_cap"] = 64
    cfg["cameras"], cfg["frames"] = 4, 3
    cfg["loss_weights"]["lpips"] = 0.2 if lpips else 0.0
    traffic.update(setup_steps=1, views=1, keep_within=1)
    return cfg, traffic


def _one_step(lpips: bool):
    """(program, reference): each the loss, gradients and leaves after
    one step from the same first leaves.  The driver's warm-up step keeps
    the state the first step left: Adam's first moment is (1 - 0.9) g."""
    cfg, traffic = _cut(lpips)
    drv = appearance_step.Driver(cfg, traffic, SEED, CPU)
    after = drv.held["before"]
    got = {"loss": drv.setup_losses[0],
           "grad": {k: after[k]["m"] / 0.1 for k in drv.names},
           "p1": {k: after[k]["p"] for k in drv.names}}
    ref = Appearance(cfg, drv.raw, drv.alive0, drv.binding0, CPU,
                     Arith(False))
    names = drv.names
    loss, grads, p1, _ = ref.adam_step(
        drv.init, {k: torch.zeros_like(drv.init[k]) for k in names},
        {k: torch.zeros_like(drv.init[k]) for k in names}, 0,
        *drv.setup_draws[0],
        avatar_scene.ground_truth(cfg, SEED, *drv.setup_draws[0], CPU))
    return drv, got, {"loss": loss, "grad": grads, "p1": p1}


def _gaps(drv, got, ref) -> dict:
    """The worst gap of each kind: the loss's relative gap, and per leaf
    the gradient's and the change's largest element gap against the
    leaf's largest reference element (or the round-off floor)."""
    out = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
           "grad": 0.0, "change": 0.0}
    floor = ROUND_OFF * max(float(g.abs().max())
                            for g in ref["grad"].values())
    for k in drv.names:
        g, gr = got["grad"][k], ref["grad"][k]
        scale = float(gr.abs().max())
        out["grad"] = max(out["grad"], float((g - gr).abs().max())
                          / max(scale, floor))
        certain = gr.abs() > max(1e-3 * scale, floor)
        d = got["p1"][k] - drv.init[k]
        dr = ref["p1"][k] - drv.init[k]
        big = float(dr.abs().max())
        if big > 0.0 and bool(certain.any()):
            out["change"] = max(out["change"], float(
                (d - dr).abs()[certain].max()) / big)
    return out


@pytest.mark.parametrize("lpips", [True, False], ids=["lpips", "no_lpips"])
def test_one_step_matches_the_reference(lpips):
    drv, got, ref = _one_step(lpips)
    gaps = _gaps(drv, got, ref)
    assert gaps["loss"] <= LOSS_TOL, gaps
    assert gaps["grad"] <= GRAD_TOL, gaps
    assert gaps["change"] <= CHANGE_TOL, gaps
    # every leaf that Adam holds moved or has a zero learning rate
    moved = [k for k in drv.names
             if bool((got["p1"][k] != drv.init[k]).any())]
    assert {k for k in drv.names if k not in moved} == {
        "splats.features_rest", "verts_offset"}


def _flip_enc1(real):
    def wn(params, name):
        w = real(params, name)
        return -w if name == "enc1" else w
    return wn


@pytest.mark.parametrize("planted", ["shadow_sign", "no_area"])
def test_a_planted_error_fails_the_comparison(planted, monkeypatch):
    if planted == "shadow_sign":
        monkeypatch.setattr(shadow, "_wn", _flip_enc1(shadow._wn))
    else:
        monkeypatch.setattr(avatar_model.MeshAvatar, "area_loss",
                            lambda self, verts: verts.sum() * 0.0)
    drv, got, ref = _one_step(False)
    gaps = _gaps(drv, got, ref)
    assert gaps["loss"] > LOSS_TOL or gaps["grad"] > GRAD_TOL \
        or gaps["change"] > CHANGE_TOL, gaps


def _loaded(imports: str) -> set:
    code = (f"import sys, json; {imports}; print(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_reference_and_the_count_load_nothing_of_the_program():
    loaded = _loaded("import benchmark.reference.appearance, "
                     "benchmark.reference.splatting, "
                     "benchmark.roofline_appearance, "
                     "benchmark.avatar_scene")
    assert not loaded & {"jax", "jaxlib", "flax", "mpmavatar_tpu",
                         "mpmavatar_tpu_torch"}


def test_the_driver_loads_no_jax():
    loaded = _loaded("import benchmark.drivers.appearance_step, "
                     "benchmark.faults_appearance")
    assert "mpmavatar_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "mpmavatar_tpu"}


def test_the_programs_first_state_is_the_published_one():
    """``init_from_mesh`` and ``init_shadow_unet`` against the first
    state the benchmark draws from MPMAvatar's initialisation (the cell
    loads that state, so its runs do not see the program's): every splat
    leaf, the binding and the alive mask equal; the UNet's layout, g =
    |v|, zero biases, the mean AO and beta equal, and v Kaiming-uniform
    with the leaky ReLU's gain (its draws are each side's own)."""
    cfg, _ = _cut(False)
    raw = avatar_scene.inputs(cfg, SEED)
    first = avatar_scene.first_state(cfg, raw, SEED)
    nf = len(raw["faces"])
    splats = gaussians.init_from_mesh(
        nf, cfg["sh_degree"], rgb=raw["rgb"],
        capacity=int(nf * cfg["capacity_factor"]), device=CPU)
    for f in (*appearance.SPLAT_FLOATS, "binding", "alive"):
        torch.testing.assert_close(getattr(splats, f), first[f"splats.{f}"],
                                   rtol=0, atol=1e-6, msg=f)
    sh = cfg["shadow"]
    unet = shadow.init_shadow_unet(
        SEED % 2 ** 31, raw["ao"].mean(axis=0), uv_size=sh["uv_size"],
        shadow_size=sh["shadow_size"], n_dims=sh["n_dims"],
        lrelu_slope=sh["lrelu_slope"], device=CPU)
    want = {k.split(".", 1)[1]: v for k, v in first.items()
            if k.startswith("shadow.")}
    assert list(unet) == list(want)
    for k, v in unet.items():
        assert v.shape == want[k].shape, k
        if k.endswith("_v"):
            slope = 1.0 if k == "pred_v" else sh["lrelu_slope"]
            bound = (2.0 / (1.0 + slope ** 2) * 3.0 / (9 * v.shape[1])) ** 0.5
            for w in (v, want[k]):
                assert 0.5 * bound < float(w.abs().max()) <= bound, k
        elif not k.endswith("_g"):
            torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    for k in (k for k in unet if k.endswith("_g")):
        v = unet[k[:-2] + "_v"]
        torch.testing.assert_close(unet[k], v.pow(2).sum((1, 2, 3),
                                                         keepdim=True).sqrt())
