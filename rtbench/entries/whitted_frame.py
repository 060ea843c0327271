"""Entry: whole Whitted frames through the port's
`models.whitted.render(scene, cfg, accel=..., gi_accel=..., uniforms=...)`.

A step renders frame k and waits for the card: the sun at the time
t0 + k / fps on the upstream orbit (t0 drawn from the seed in the mix's
`t0_range`), the diffuse fan's uniforms of chunk i drawn from (seed, k,
i, tag). The window's frames give `frame_s` (its seconds over its
frames) and `frame_p90_s` (the 90th percentile of its frames).

The check: for each kept frame, `check_pixels` pixels drawn from (seed,
k); the reference renders each pixel's samples with the same sun and
the same fan uniforms. Numbers: `bad_px_share`, the share of those
pixels whose largest channel gap exceeds one 8-bit level (1/255), and
`mean_abs_err`, the mean gap over their channels.
"""

from __future__ import annotations

import statistics

import torch

from rtbench import program
from rtbench.device import sync
from rtbench.inputs import Draws, sun_at, uniform
from rtbench.reference.scene import build_scene
from rtbench.reference.whitted import Whitted

LEVEL = 1.0 / 255.0


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.draws = Draws(seed, self.device)
        self.t0 = uniform(seed, "t0", lo=traffic["t0_range"][0],
                          hi=traffic["t0_range"][1])
        self.render_cfg = dict(config["render"], **traffic.get("render", {}))
        self.cfg = program.render_config(self.render_cfg)

    def time_of(self, k: int) -> float:
        return self.t0 + k / float(self.traffic["fps"])

    def setup(self) -> None:
        self.mesh = program.build_mesh(self.config["scene"], self.device)
        accel = program.build_accel(self.mesh, self.config)
        self.accel, self.gi = program.frame_accels(
            self.mesh, sun_at(self.t0, self.device), accel, self.cfg)

    def render(self, k: int):
        from raytracing_tpu_torch.geometry.mesh import Scene
        from raytracing_tpu_torch.models.whitted import render

        def uniforms(i, tag, shape):
            return self.draws("fan", k, i, tag, shape=shape)

        return render(Scene(self.mesh, sun_at(self.time_of(k), self.device)),
                      self.cfg, accel=self.accel, gi_accel=self.gi,
                      uniforms=uniforms)

    def warm_up(self) -> None:
        for k in range(int(self.traffic["warmup_steps"])):
            self.render(-1 - k)
        sync(self.device)

    def step(self, k: int):
        img = self.render(k)
        sync(self.device)
        return img

    def keep(self, k: int, img):
        return k, img

    def traced_steps(self, n: int):
        return range(n, n + int(self.traffic["traced_steps"]))

    def end_to_end(self, times: list, window_s: float) -> dict:
        p90 = (statistics.quantiles(times, n=10, method="inclusive")[8]
               if len(times) > 1 else times[0])
        return {"frame_s": window_s / len(times), "frame_p90_s": p90}

    def release(self, kept: list) -> list:
        """Free the program's state; set up the reference."""
        del self.mesh, self.accel, self.gi
        self.use_reference()
        return kept

    def use_reference(self) -> None:
        self.reference = Whitted(
            build_scene(self.config["scene"], self.device), self.render_cfg)

    def sample(self, k: int):
        """The pixels (ys, xs) checked in frame k."""
        r = self.render_cfg
        g = torch.Generator().manual_seed(
            int(uniform(self.seed, "pixels", k, hi=2.0 ** 62)))
        n = int(self.traffic["check_pixels"])
        return (torch.randint(0, r["height"], (n,), generator=g),
                torch.randint(0, r["width"], (n,), generator=g))

    def reference_pixels(self, ref: Whitted, k: int, ys, xs):
        from rtbench.reference.whitted import stratified_offsets

        r = ref.cfg
        shape = (r["diffuse_scatter"], min(
            r["chunk_size"], r["samples_per_pixel"] * r["width"]
            * r["height"]), 2)
        return ref.pixels(ys, xs, sun_at(self.time_of(k), self.device),
                          stratified_offsets(r["samples_per_pixel"]),
                          lambda c: self.draws("fan", k, c, 1, shape=shape))

    def check(self, item) -> dict:
        k, img = item
        ys, xs = self.sample(k)
        got = img[ys.to(img.device), xs.to(img.device)].float()
        want = self.reference_pixels(self.reference, k, ys, xs)
        return compare(got, want)

    def control(self, k: int, dtype) -> dict:
        """The numbers of the reference computed in `dtype`, put in the
        program's place, for frame k."""
        low = Whitted(build_scene(self.config["scene"], self.device, dtype),
                      self.reference.cfg)
        ys, xs = self.sample(k)
        return compare(self.reference_pixels(low, k, ys, xs),
                       self.reference_pixels(self.reference, k, ys, xs))


def compare(got, want) -> dict:
    gap = (got.float() - want.float()).abs()
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")),
                      gap)
    return {"bad_px_share": float((gap.amax(dim=1) > LEVEL).float().mean()),
            "mean_abs_err": float(gap.mean())}
