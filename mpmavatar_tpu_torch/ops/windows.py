"""The release windows: a substep's particle impulses and velocity
modifiers (``core/stepping.py::_pre_p2g_velocity``) in one launch.

``apply_windows`` launches the CUDA kernel of ``csrc/windows.cu`` on CUDA
tensors and runs ``windows_plain`` on CPU tensors; with no window
registered it returns ``v`` itself and launches and builds nothing.  The
kernel replaces no TPU kernel: it fuses the glue of the JAX package's
pre-P2G loop (mpmavatar_tpu/core/stepping.py::p2g2p), ~6 launches per
window per substep, into one.

The kernel reads each window from a table and each particle's windows
from membership words: bit w of a particle is set where the loop's own
test selects it (an impulse's ``mask >= 1``, a modifier's ``mask ==
1``).  Both are built on the device once per ``ColliderSet`` object and
kept on it (``window_pack``); the solver makes a new set at every
registration, so a pack never outlives its windows.

On CUDA tensors that need grad the kernel's backward is autograd over
``windows_plain`` (``_autograd.call``), with respect to v, x and mass;
the windows' own tensors are constants there, as they are on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.colliders import ParticleImpulse, RotationVelocityModifier
from . import _autograd, _build

KERNEL = "windows"
# csrc/windows.cu's table: one row of ROW floats per window, and its kinds
ROW = 20
IMPULSE_BY_MASS, IMPULSE, VELOCITY, ROTATION = 0, 1, 2, 3
MAX_WINDOWS = 512
_PACK = "_window_pack"


@dataclasses.dataclass(frozen=True)
class WindowPack:
    """The kernel's view of a collider set's windows: ``table`` (W, ROW)
    float32, ``words`` (ceil(W / 32), P) int32 (bit w % 32 of word w // 32
    is window w's), and whether a rotation modifier or an impulse that
    scales by mass is registered (the kernel reads x, the mass, only
    then)."""
    table: torch.Tensor
    words: torch.Tensor
    reads_x: bool
    reads_mass: bool


def _windows(colliders):
    """The windows in the order they apply: impulses, then modifiers."""
    return colliders.impulses + colliders.velocity_modifiers


def selects(window) -> torch.Tensor:
    """The particles a window applies to while live: the plain loop's own
    test of its mask."""
    if isinstance(window, ParticleImpulse):
        return window.mask >= 1
    return window.mask == 1


def membership_words(windows) -> torch.Tensor:
    """(ceil(W / 32), P) int32: bit b of word k set where window 32 k + b
    selects the particle."""
    words = []
    for k in range(0, len(windows), 32):
        acc = torch.zeros_like(windows[0].mask, dtype=torch.int64)
        for b, w in enumerate(windows[k:k + 32]):
            acc |= selects(w).to(torch.int64) << b
        # the uint32 bit pattern as int32
        words.append(torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc)
                     .to(torch.int32))
    return torch.stack(words)


def window_table(windows) -> torch.Tensor:
    """(W, ROW) float32: kind, start, end, force or velocity, and a
    rotation modifier's point, normal, horizontal axes, rotation and
    translation scales (zeros for the others)."""
    dev = windows[0].mask.device
    rows = []
    for w in windows:
        geometry = torch.zeros(ROW - 6, device=dev)
        if isinstance(w, ParticleImpulse):
            kind = IMPULSE_BY_MASS if w.scale_by_mass else IMPULSE
            vec = w.force
        elif isinstance(w, RotationVelocityModifier):
            kind, vec = ROTATION, torch.zeros(3, device=dev)
            geometry = torch.cat([
                w.point, w.normal, w.horizontal_axis_1, w.horizontal_axis_2,
                w.rotation_scale.reshape(1), w.translation_scale.reshape(1)])
        else:
            kind, vec = VELOCITY, w.velocity
        rows.append(torch.cat([
            torch.tensor([float(kind)], device=dev), w.start_time.reshape(1),
            w.end_time.reshape(1), vec.reshape(3), geometry]))
    return torch.stack(rows).float().contiguous()


def window_pack(colliders) -> WindowPack:
    """The set's pack, built on the device at the first call and kept on
    the set."""
    pack = colliders.__dict__.get(_PACK)
    if pack is None:
        windows = _windows(colliders)
        pack = WindowPack(
            table=window_table(windows), words=membership_words(windows),
            reads_x=any(isinstance(w, RotationVelocityModifier)
                        for w in windows),
            reads_mass=any(w.scale_by_mass for w in colliders.impulses))
        object.__setattr__(colliders, _PACK, pack)   # a frozen dataclass
    return pack


def apply_windows(colliders, v, x, mass, dt: float, time: float):
    """The new particle velocities (P, 3) after every window of
    ``colliders`` that holds ``time``, in registration order (impulses,
    then velocity modifiers).  ``dt`` is a Python float, ``time`` a Python
    float or a float32 0-d tensor on ``v``'s device, which the kernel reads
    when it runs (a captured substep's clock); the window test is ``start
    <= time < end`` in float32.

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors."""
    if not _windows(colliders):
        return v
    if not v.is_cuda:
        return windows_plain(colliders, v, x, mass, dt, time)
    return _autograd.call(KERNEL, _launch_windows, windows_plain, colliders,
                          v, x, mass, dt, time)


def _launch_windows(colliders, v, x, mass, dt, time):
    pack = window_pack(colliders)
    n_windows, n = pack.table.shape[0], v.shape[0]
    if n_windows > MAX_WINDOWS:
        raise ValueError(f"windows: at most {MAX_WINDOWS} windows, got "
                         f"{n_windows}")
    v = _build.check_cuda("v", v)
    x = _build.check_cuda("x", x) if pack.reads_x else None
    mass = _build.check_cuda("mass", mass) if pack.reads_mass else None
    if v.shape != (n, 3) or pack.words.shape[1] != n or (
            x is not None and x.shape != (n, 3)) or (
            mass is not None and mass.shape != (n,)):
        raise ValueError("windows: inconsistent particle shapes")
    time, time_p = _build.time_arg(time)
    out = torch.empty_like(v)
    if n:
        _build.launch(KERNEL, "launch_windows", v.data_ptr(), _build.ptr(x),
                      _build.ptr(mass), pack.words.data_ptr(),
                      pack.table.data_ptr(), n_windows, pack.words.shape[0],
                      n, time, dt, time_p, out.data_ptr(),
                      _build.stream(v.device))
    return out


def kernel_info(n_windows: int) -> dict:
    """The kernel's registers, spills, shared memory and blocks per SM as
    built, at ``n_windows`` windows (CUDA only)."""
    return _build.kernel_attributes("windows_info", n_windows)


def windows_plain(colliders, v, x, mass, dt, time):
    """Plain PyTorch version of the kernel: the loop of the JAX package's
    pre-P2G step; runs on any device."""
    for imp in colliders.impulses:
        active = (time >= imp.start_time) & (time < imp.end_time)
        if imp.scale_by_mass:
            delta = imp.force[None, :] / mass[:, None] * dt
        else:
            delta = (imp.force[None, :] * dt).expand_as(v)
        v = torch.where((active & (imp.mask >= 1))[:, None], v + delta, v)
    for mod in colliders.velocity_modifiers:
        active = (time >= mod.start_time) & (time < mod.end_time)
        if isinstance(mod, RotationVelocityModifier):
            offset = x - mod.point[None, :]
            axial = torch.sum(offset * mod.normal[None, :], -1)
            radial = offset - axial[:, None] * mod.normal[None, :]
            hd = torch.sqrt(torch.sum(radial * radial, -1) + 1e-20)
            cosine = torch.sum(offset * mod.horizontal_axis_1[None, :],
                               -1) / hd
            theta = torch.arccos(torch.clamp(cosine, -1.0, 1.0))
            theta = torch.where(
                torch.sum(offset * mod.horizontal_axis_2[None, :], -1) > 0,
                theta, -theta)
            v_rot = (-hd * torch.sin(theta) * mod.rotation_scale)[:, None] \
                * mod.horizontal_axis_1[None, :] \
                + (hd * torch.cos(theta) * mod.rotation_scale)[:, None] \
                * mod.horizontal_axis_2[None, :] \
                + mod.translation_scale * mod.normal[None, :]
            v = torch.where((active & (mod.mask == 1))[:, None], v_rot, v)
        else:
            v = torch.where((active & (mod.mask == 1))[:, None],
                            mod.velocity.expand_as(v), v)
    return v
