"""The area lights' per-sample glue on the card (`csrc/light.cu`).

`models.whitted.area_light_term` runs each light sample as two launches
where it runs on the kernel path with CUDA tensors (under autograd too:
its backward replays the plain functions): `light_sample` prepares the sample's shadow rays (the plain
`whitted.light_cone` + `whitted.light_shadow_rays`, its draw taken by each
lane's row) and, after the sample's any-hit query, `light_fold` adds its
visibility into the light's sum, and at the light's last sample the light's
term into the level's total, the estimator's PyTorch lines. Both give the
plain version's bits on the card (the source says how) and write every
lane, alive or not.

The wrappers take CUDA tensors of one card only: there is no plain version
here to fall back to, since the plain functions are the callers' own. They
raise ValueError on a tensor of another dtype, shape, layout or device
before any launch; `light_sample` does not check the values of its
`rows`. `LAUNCHES["light_sample"]` and `LAUNCHES["light_fold"]` count the
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raytracing_tpu_torch.geometry.mesh import SphereLight
from raytracing_tpu_torch.kernels import cuda
from raytracing_tpu_torch.kernels.traverse import (LAUNCHES, _count, _ptr,
                                                   _stream)

LAUNCHES.update({"light_sample": 0, "light_fold": 0})


def _check(who: str, x: torch.Tensor, dtype, shape,
           strided: bool = False) -> None:
    """Raise unless x is dtype and shape, and contiguous unless strided
    (an [N, 3] or [N] array read with its strides)."""
    if (x.dtype != dtype or tuple(x.shape) != tuple(shape)
            or not (strided or x.is_contiguous())):
        raise ValueError(
            f"light kernels: {who} must be {'' if strided else 'contiguous '}"
            f"{dtype} {list(shape)}, not {x.dtype} {list(x.shape)}"
            f"{'' if x.is_contiguous() else ' (strided)'}")


def _check_light(lights: SphereLight, li: int) -> int:
    """The light count; raises unless the tables are contiguous f32 [L, 3],
    [L], [L, 3] and li one of their rows."""
    nl = lights.center.shape[0] if lights.center.dim() else 0
    _check("lights.center", lights.center, torch.float32, (nl, 3))
    _check("lights.radius", lights.radius, torch.float32, (nl,))
    _check("lights.emission", lights.emission, torch.float32, (nl, 3))
    if not 0 <= li < nl:
        raise ValueError(f"light kernels: light {li} of {nl}")
    return nl


def _card(*tensors: torch.Tensor) -> torch.device:
    """The one CUDA device of the tensors; raises for anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(
            f"light kernels take the CUDA tensors of one card, not tensors "
            f"on {sorted(map(str, devs))} (elsewhere the plain functions "
            f"run)")
    return next(iter(devs))


def _row(table: torch.Tensor, li: int) -> ctypes.c_void_p:
    """Pointer to row li of a contiguous light table."""
    return ctypes.c_void_p(table.data_ptr()
                           + li * table.stride(0) * table.element_size())


def light_sample(pos: torch.Tensor, n: torch.Tensor, hit: torch.Tensor,
                 u: torch.Tensor, rows: Optional[torch.Tensor],
                 lights: SphereLight, li: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One sample of light li at the shaded points pos, n [N, 3] (any
    strides) with hit [N] bool, from the draw u [N, 2] (any strides), lane
    i taking row rows[i] or, with rows None, row i: (direction
    [N, 3], n·direction [N], alive [N] bool, t_max [N]), the bits of
    `whitted.light_shadow_rays(whitted.light_cone(lights, li, pos), pos, n,
    hit, u[rows])` on the card. rows: int64 [N], a permutation of [0, N)
    as the bin sort gives it; its values are not checked (a check would
    read them back to the host), and one outside [0, N) reads out of
    bounds."""
    rays = pos.shape[0]
    f32 = torch.float32
    _check("pos", pos, f32, (rays, 3), strided=True)
    _check("n", n, f32, (rays, 3), strided=True)
    _check("hit", hit, torch.bool, (rays,))
    _check("u", u, f32, (rays, 2), strided=True)
    if rows is not None:
        _check("rows", rows, torch.int64, (rays,))
    _check_light(lights, li)
    dev = _card(pos, n, hit, u, *lights, *([] if rows is None else [rows]))
    w_dir = torch.empty((rays, 3), dtype=f32, device=dev)
    ndl = torch.empty(rays, dtype=f32, device=dev)
    alive = torch.empty(rays, dtype=torch.bool, device=dev)
    t_max = torch.empty(rays, dtype=f32, device=dev)
    if rays:
        with torch.cuda.device(dev):
            cuda.check(cuda.library().rt_light_sample(
                rays, _ptr(pos), pos.stride(0), pos.stride(1), _ptr(n),
                n.stride(0), n.stride(1), _ptr(hit), _ptr(u), u.stride(0),
                u.stride(1), _ptr(rows), _row(lights.center, li),
                _row(lights.radius, li), _ptr(w_dir),
                _ptr(ndl), _ptr(alive), _ptr(t_max), _stream(pos)),
                "light_sample")
        _count("light_sample")
    return w_dir, ndl, alive, t_max


def light_fold(acc: torch.Tensor, total: torch.Tensor, alive: torch.Tensor,
               occluded: torch.Tensor, ndl: torch.Tensor, s: int, ns: int,
               li: int, lights: SphereLight, pos: torch.Tensor,
               albedo_pi: torch.Tensor, color: torch.Tensor) -> None:
    """Fold sample s of ns of light li, in place: acc [N] (read unless
    s == 0) += where(alive & ~occluded, max(ndl, 0), 0); at s == ns - 1,
    total [N, 3] (read unless li == 0) += (acc / ns * omega)[:, None] *
    emission[li], omega the light's solid angle from pos [N, 3], and after
    the last light total *= albedo_pi[:, None] * color: `area_light_term`'s
    estimator on the card. pos, color [N, 3] and albedo_pi [N] are read
    with their strides; the rest is contiguous."""
    rays = acc.shape[0]
    f32 = torch.float32
    _check("acc", acc, f32, (rays,))
    _check("total", total, f32, (rays, 3))
    _check("alive", alive, torch.bool, (rays,))
    _check("occluded", occluded, torch.bool, (rays,))
    _check("ndl", ndl, f32, (rays,))
    _check("pos", pos, f32, (rays, 3), strided=True)
    _check("albedo_pi", albedo_pi, f32, (rays,), strided=True)
    _check("color", color, f32, (rays, 3), strided=True)
    nl = _check_light(lights, li)
    if not 0 <= s < ns:
        raise ValueError(f"light kernels: sample {s} of {ns}")
    dev = _card(acc, total, alive, occluded, ndl, pos, albedo_pi, color,
                *lights)
    if not rays:
        return
    with torch.cuda.device(dev):
        cuda.check(cuda.library().rt_light_fold(
            rays, s, ns, li, nl, _ptr(alive), _ptr(occluded), _ptr(ndl),
            _ptr(acc), _ptr(pos), pos.stride(0), pos.stride(1),
            _row(lights.center, li),
            _row(lights.radius, li), _row(lights.emission, li),
            _ptr(albedo_pi), albedo_pi.stride(0), _ptr(color),
            color.stride(0), color.stride(1), _ptr(total), _stream(pos)),
            "light_fold")
    _count("light_fold")
