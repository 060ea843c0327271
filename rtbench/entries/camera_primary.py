"""Entry: whole-frame camera-mode primary queries through the port's
`kernels.traverse.nearest_hit_camera_soa(accel, offs, width=..., height=...,
spp=...)`.

A step is call k, waited for: its sample offsets are entry k of a pool of
POOL offset sets jittered inside their strata, drawn from the seed in
set-up, so that a call's input costs no device work. The
window's calls give
`primary_rays_per_s`: every primary ray of every call over the window's
seconds.

The check: for each kept call, `check_rays` rays drawn from (seed, k) out
of the frame's block order; the reference finds each ray's nearest
triangle by brute force. The program's answer is t and the triangle its
slot holds (`accel.order_ext`). Numbers: `mismatch_share`, the share of
rays whose hit or triangle differs, and `t_rel_err_max`, the largest
relative gap of t where both hit the same triangle.
"""

from __future__ import annotations

import torch

from rtbench import program
from rtbench.device import sync
from rtbench.inputs import Draws, jittered_offsets, uniform
from rtbench.reference.scene import build_scene
from rtbench.reference.tracer import Groups
from rtbench.reference.whitted import primary

# Offset sets drawn in set-up, more than a window holds calls (~15,000 at
# 51 s in the fastest cell); call k takes set k modulo POOL.
POOL = 131072


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.draws = Draws(seed, self.device)
        r = dict(config["render"], **traffic.get("render", {}))
        self.width, self.height = int(r["width"]), int(r["height"])
        self.spp = int(r["samples_per_pixel"])
        self.scale = float(r.get("scale", 1.0))
        self.pool = jittered_offsets(
            self.draws("offs", shape=(POOL, self.spp, 2)), self.spp)

    @property
    def rays(self) -> int:
        return self.width * self.height * self.spp

    def offsets(self, k: int):
        return self.pool[k % POOL]

    def setup(self) -> None:
        mesh = program.build_mesh(self.config["scene"], self.device)
        self.accel = program.build_accel(mesh, self.config)

    def query(self, offs):
        from raytracing_tpu_torch.kernels.traverse import \
            nearest_hit_camera_soa

        return nearest_hit_camera_soa(self.accel, offs, width=self.width,
                                      height=self.height, spp=self.spp,
                                      scale=self.scale)

    def warm_up(self) -> None:
        for k in range(int(self.traffic["warmup_steps"])):
            self.query(self.offsets(-1 - k))
        sync(self.device)

    def step(self, k: int):
        offs = self.offsets(k)
        t, slot = self.query(offs)
        sync(self.device)
        return offs, t, slot

    def keep(self, k: int, out):
        return (k,) + tuple(out)

    def traced_steps(self, n: int):
        return range(n, n + int(self.traffic["traced_steps"]))

    def end_to_end(self, times: list, window_s: float) -> dict:
        return {"primary_rays_per_s": self.rays * len(times) / window_s}

    def release(self, kept: list) -> list:
        """The kept calls as (k, offs, t, triangle id); the program's state
        freed; the reference set up."""
        order = self.accel.order_ext.long()
        out = []
        for k, offs, t, slot in kept:
            hit = torch.isfinite(t)
            tri = order[torch.where(hit, slot.long(), 0)]
            out.append((k, offs, t, torch.where(hit, tri, -1)))
        del self.accel, order
        self.use_reference()
        return out

    def use_reference(self) -> None:
        self.reference = Groups(build_scene(self.config["scene"],
                                            self.device))

    def sample(self, k: int):
        g = torch.Generator().manual_seed(
            int(uniform(self.seed, "rays", k, hi=2.0 ** 62)))
        return torch.randint(0, self.rays, (int(self.traffic["check_rays"]),),
                             generator=g).to(self.device)

    def answer(self, groups: Groups, offs, ls):
        return primary(groups, ls, offs, self.width, self.height, self.spp,
                       self.scale)

    def check(self, item) -> dict:
        k, offs, t, tri = item
        ls = self.sample(k)
        return compare(t[ls], tri[ls], *self.answer(self.reference, offs, ls))

    def control(self, k: int, dtype) -> dict:
        """The numbers of the reference computed in `dtype`, put in the
        program's place, for call k."""
        low = Groups(build_scene(self.config["scene"], self.device, dtype))
        offs, ls = self.offsets(k), self.sample(k)
        return compare(*self.answer(low, offs, ls),
                       *self.answer(self.reference, offs, ls))


def compare(t, tri, t_ref, tri_ref) -> dict:
    t, t_ref = t.float(), t_ref.float()
    same = (tri == tri_ref) & (tri_ref >= 0)
    rel = ((t - t_ref).abs() / t_ref.abs())[same]
    rel = torch.where(torch.isnan(rel), torch.full_like(rel, float("inf")),
                      rel)
    return {"mismatch_share": float((tri != tri_ref).float().mean()),
            "t_rel_err_max": float(rel.max()) if rel.numel() else 0.0}
