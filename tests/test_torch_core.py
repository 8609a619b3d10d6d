"""PyTorch port: package hygiene, types, linalg and constitutive parity
against the JAX package (CPU, float32).  Also holds the helpers the other
test_torch_* files use to hand identical data to both packages."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmavatar_tpu.core import constitutive as jcon
from mpmavatar_tpu.core import linalg as jla
from mpmavatar_tpu.core import types as jtypes

import mpmavatar_tpu_torch
from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.core import colliders as tcol
from mpmavatar_tpu_torch.core import constitutive as tcon
from mpmavatar_tpu_torch.core import linalg as tla
from mpmavatar_tpu_torch.core import types as ttypes

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "mpmavatar_tpu_torch"


# ----------------------------------------------------------------------
# helpers shared by the test_torch_* files
# ----------------------------------------------------------------------
def np_fields(obj) -> dict:
    return {f.name: np.array(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def port_of(cfg, state, model):
    """The port's (cfg, state, model) on the CPU from the JAX ones."""
    return (ttypes.MPMStaticConfig(**dataclasses.asdict(cfg)),
            convert.state_from_numpy(np_fields(state), "cpu"),
            convert.model_from_numpy(np_fields(model), "cpu"))


def port_collider(col):
    """The port's collider of the same type and values as a JAX one; a
    release window also gets the host's copy of its interval, as the
    port's registration keeps it."""
    cls = getattr(tcol, type(col).__name__)
    kw = {}
    for f in dataclasses.fields(col):
        val = getattr(col, f.name)
        if isinstance(val, tuple):
            val = tuple(port_collider(c) for c in val)
        elif hasattr(val, "shape"):
            val = torch.as_tensor(np.array(val))
        kw[f.name] = val
    if issubclass(cls, tcol._Window):
        kw.update(start_s=float(np.float32(col.start_time)),
                  end_s=float(np.float32(col.end_time)))
    return cls(**kw)


def t(a):
    return torch.as_tensor(np.array(a))


def assert_close(port, ref, atol, name=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol,
                               err_msg=name)


# ----------------------------------------------------------------------
# package hygiene
# ----------------------------------------------------------------------
def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "mpmavatar_tpu")


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "chip_fixtures.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(REPO)), m) for f in files
           for m in _imported_roots(f) if _forbidden(m)]
    assert not bad, bad


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import mpmavatar_tpu_torch\n"
        "import mpmavatar_tpu_torch.sim.solver, mpmavatar_tpu_torch.convert\n"
        "import mpmavatar_tpu_torch.sim.cloth_drop\n"
        "import mpmavatar_tpu_torch.sim.bench_scene\n"
        "import mpmavatar_tpu_torch.ops.splat\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mpmavatar_tpu')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_card_scripts_import_and_chip_smoke_needs_a_card(monkeypatch):
    """The card scripts import on the CPU (a name they take from
    chip_fixtures.py that it no longer has fails here), and
    chip_smoke.main() returns 2 without a CUDA device."""
    import ab_kernel_times  # noqa: F401
    import chip_fixtures  # noqa: F401
    import chip_smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 2


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mpmavatar_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttypes.make_model(4)
    from mpmavatar_tpu_torch.sim import MPMSolver
    cfg = ttypes.MPMStaticConfig(n_elements=0, n_traditional=4,
                                 n_vertices=0, n_grid=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MPMSolver(cfg)
    assert mpmavatar_tpu_torch.resolve_device("cpu") == torch.device("cpu")


# ----------------------------------------------------------------------
# types
# ----------------------------------------------------------------------
def _cloth(nx=6):
    verts, faces = ttypes.build_cloth(nx, nx, y0=1.1, extent=0.5)
    return verts, faces


def test_cloth_geometry_matches_jax():
    verts, faces = _cloth()
    ref = jtypes.cloth_geometry(jnp.asarray(verts), jnp.asarray(faces))
    out = ttypes.cloth_geometry(t(verts), t(faces))
    for a, b, n in zip(out, ref, ("dir", "R_inv", "evol", "vvol")):
        assert_close(a, b, 1e-6 * max(1.0, float(jnp.abs(b).max())), n)


def test_make_state_and_model_match_jax():
    verts, faces = _cloth()
    cfg = jtypes.MPMStaticConfig(n_elements=len(faces), n_traditional=3,
                                 n_vertices=len(verts), n_grid=16)
    x = np.random.default_rng(0).uniform(0.5, 1.5, (cfg.n_particles, 3))
    vol = np.full(cfg.n_particles, 1e-5, np.float32)
    js = jtypes.make_state(cfg, jnp.asarray(x, jnp.float32), faces=faces,
                           vol=jnp.asarray(vol), yield_stress=2.0)
    jm = jtypes.make_model(cfg.n_particles, E=1000.0, nu=0.25,
                           friction_angle=30.0, rpic_damping=0.1)
    tcfg = ttypes.MPMStaticConfig(**dataclasses.asdict(cfg))
    ts = ttypes.make_state(tcfg, x, faces=faces, vol=vol, yield_stress=2.0,
                           device="cpu")
    tm = ttypes.make_model(tcfg.n_particles, E=1000.0, nu=0.25,
                           friction_angle=30.0, rpic_damping=0.1,
                           device="cpu")
    for name, ref in np_fields(js).items():
        assert_close(getattr(ts, name), ref, 0, name)
    for name, ref in np_fields(jm).items():
        assert_close(getattr(tm, name), ref, 1e-7 * max(1, np.abs(ref).max()),
                     name)
    fin = ttypes.finalize_mu_lam(dataclasses.replace(tm, E=tm.E * 2))
    jfin = jtypes.finalize_mu_lam(dataclasses.replace(jm, E=jm.E * 2))
    assert_close(fin.mu, jfin.mu, 1e-3)
    assert_close(fin.lam, jfin.lam, 1e-3)
    assert tcfg.dx == cfg.dx and tcfg.n_no_vertices == cfg.n_no_vertices


def test_convert_round_trip():
    verts, faces = _cloth()
    cfg, state, model = ttypes.cloth_scene(verts, faces, 16, device="cpu")
    back = convert.state_from_numpy(convert.to_numpy(state), "cpu")
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    m2 = convert.model_from_numpy(convert.to_numpy(model), "cpu")
    assert torch.equal(m2.gravity, model.gravity)
    assert state.to("cpu").x.device.type == "cpu"


# ----------------------------------------------------------------------
# linalg
# ----------------------------------------------------------------------
def _mats(n=300, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    m = np.eye(3) + scale * rng.standard_normal((n, 3, 3))
    m[: n // 10] *= -1.0          # some reflections (det < 0)
    return m.astype(np.float32)


def _lower(n=200, seed=1):
    rng = np.random.default_rng(seed)
    m = np.tril(rng.standard_normal((n, 3, 3))).astype(np.float32)
    m[:, range(3), range(3)] = rng.uniform(0.5, 2.0, (n, 3))
    return m


_LINALG = {
    "qr3_pos": (lambda la, m: la.qr3_pos(m), _mats, 1e-5),
    "svd3": (lambda la, m: la.svd3(m), _mats, 2e-5),
    "polar2x2": (lambda la, m: la.polar2x2_rotation(
        m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]), _mats, 1e-6),
    "inverse_lower_triangle": (lambda la, m: la.inverse_lower_triangle(m),
                               _lower, 1e-5),
    "safe_normalize": (lambda la, m: la.safe_normalize(m[:, 0]), _mats,
                       1e-6),
}


@pytest.mark.parametrize("name", sorted(_LINALG))
def test_linalg_matches_jax(name):
    fn, make, atol = _LINALG[name]
    m = make()
    ref = fn(jla, jnp.asarray(m))
    out = fn(tla, t(m))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for a, b in zip(out, ref):
        assert_close(a, b, atol, name)


def test_safe_sqrt_zero_gradient():
    x = torch.tensor([0.0, 4.0], requires_grad=True)
    tla.safe_sqrt(x).sum().backward()
    assert torch.isfinite(x.grad).all() and float(x.grad[0]) == 0.0


# ----------------------------------------------------------------------
# constitutive
# ----------------------------------------------------------------------
def _const_inputs(n=200, seed=2):
    rng = np.random.default_rng(seed)
    f = (np.eye(3) + 0.15 * rng.standard_normal((n, 3, 3))).astype(
        np.float32)
    mu = np.full(n, 400.0, np.float32)
    lam = np.full(n, 600.0, np.float32)
    ys = rng.uniform(0.0, 50.0, n).astype(np.float32)
    d = np.asarray(_mats(n, seed + 1, 0.2))
    d[:, :, 2] *= rng.uniform(0.5, 1.6, (n, 1)).astype(np.float32)
    r_inv = rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32)
    r_inv[:, 1] -= 1.25
    vol = np.full(n, 1e-3, np.float32)
    gamma = np.full(n, 500.0, np.float32)
    kappa = np.full(n, 500.0, np.float32)
    return dict(f=f, mu=mu, lam=lam, ys=ys, d=d, r_inv=r_inv, vol=vol,
                gamma=gamma, kappa=kappa)


def _svd_stress(kind):
    def run(mod, la, a):
        u, sig, v = la.svd3(a["f"])
        j = (jnp.linalg.det(a["f"]) if la is jla else la.det3(a["f"]))
        if kind == "fcr":
            return mod.kirchoff_stress_fcr(a["f"], u, v, j, a["mu"], a["lam"])
        if kind == "neo_hookean":
            return mod.kirchoff_stress_neo_hookean(a["f"], u, v, j, sig,
                                                   a["mu"], a["lam"])
        return mod.kirchoff_stress_stvk(a["f"], u, v, sig, a["mu"], a["lam"])
    return run


_CONST = {
    "fcr": (_svd_stress("fcr"), 5e-3),
    "neo_hookean": (_svd_stress("neo_hookean"), 5e-3),
    "stvk": (_svd_stress("stvk"), 5e-3),
    "von_mises": (lambda mod, la, a: mod.von_mises_return_mapping(
        a["f"], a["mu"], a["lam"], a["ys"], 0.5, 1), 2e-5),
    "von_mises_damage": (
        lambda mod, la, a: mod.von_mises_return_mapping_with_damage(
            a["f"], a["mu"], a["lam"], a["ys"], 0.1, 0.5, 1), 2e-5),
    "viscoplastic": (lambda mod, la, a:
                     mod.viscoplasticity_return_mapping_stvk(
                         a["f"], a["mu"], a["ys"], 10.0, 1e-4), 2e-5),
    "anisotropy_return_mapping": (
        lambda mod, la, a: mod.anisotropy_return_mapping(
            a["d"], a["gamma"], a["kappa"], 0.84), 2e-5),
    "anisotropic_stress": (lambda mod, la, a: mod.anisotropic_stress(
        a["r_inv"], a["d"], a["vol"], a["mu"], a["lam"], a["gamma"],
        a["kappa"]), 2e-5),
}


@pytest.mark.parametrize("name", sorted(_CONST))
def test_constitutive_matches_jax(name):
    """Each constitutive function on identical inputs; tolerance relative
    to the output's magnitude (stresses are O(mu))."""
    fn, rtol = _CONST[name]
    a = _const_inputs()
    ref = fn(jcon, jla, {k: jnp.asarray(v) for k, v in a.items()})
    out = fn(tcon, tla, {k: t(v) for k, v in a.items()})
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for a_, b_ in zip(out, ref):
        b_ = np.asarray(b_)
        assert_close(a_, b_, rtol * max(1.0, float(np.abs(b_).max())), name)
