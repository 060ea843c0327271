"""Entry: whole Whitted frames with the configuration's spherical area
lights, through the port's `models.whitted.render` with `Scene.lights`.

Everything else is `whitted_frame`'s: the steps, the sun, the fan's
uniforms, `frame_s` and `frame_p90_s`, the pixels checked and the
numbers compared. The lights' shadow samples take the uniforms of the
tag ("light", depth, light, sample) from the same draws as the fan,
(seed, k, chunk, tag), over the level's rows; the reference
(`reference/arealight.py`) takes each ray's draw by its row.

The check adds a second set of `check_pixels` pixels a frame, drawn from
(seed, k) among the pixels near those the lights reach, and one number:
`light_bad_px_share`, the share of the set's pixels that a light reaches
in the reference (some sample's value takes a part from a light, at
either level) whose largest channel gap exceeds `LIGHT_GAP`. A light can
reach few of a frame's pixels, so the uniform set may hold a dozen of them
and its two numbers barely move when the lights' term is left out; this
one reads the light's soft shadows at both levels.

Where the lights reach: the reference renders a grid of about
`check_pixels` pixels of frame 0, one per square cell of the frame, and
the set is drawn from the cells it finds reached and their eight
neighbours. Frame 0 serves every frame: the light and the mesh stand
still, so the reached pixels move only with the draws.
"""

from __future__ import annotations

import math

import torch

from rtbench import program
from rtbench.entries import whitted_frame
from rtbench.inputs import sun_at, uniform
from rtbench.reference.arealight import AreaLight
from rtbench.reference.scene import build_scene
from rtbench.reference.whitted import stratified_offsets

# A reached pixel counts as off past this gap: 100x float32's rounding of
# a pixel (~1e-7), below what a reached pixel moves by in most of them when
# the light is left out or its level-2 samples are drawn anew (PERF.md).
LIGHT_GAP = 1e-5


class Entry(whitted_frame.Entry):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from raytracing_tpu_torch.geometry.mesh import SphereLight

        super().__init__(config, traffic, seed, device)
        self.render_cfg["light_samples"] = int(config["light_samples"])
        self.cfg = program.render_config(self.render_cfg)
        self.lights = SphereLight(*(
            torch.tensor([li[k] for li in config["lights"]],
                         dtype=torch.float32, device=self.device)
            for k in ("center", "radius", "emission")))
        self.pool = None

    def render(self, k: int):
        from raytracing_tpu_torch.geometry.mesh import Scene
        from raytracing_tpu_torch.models.whitted import render

        def uniforms(i, tag, shape):
            return self.draws("fan", k, i, tag, shape=shape)

        scene = Scene(self.mesh, sun_at(self.time_of(k), self.device),
                      self.lights)
        return render(scene, self.cfg, accel=self.accel, gi_accel=self.gi,
                      uniforms=uniforms)

    def _reference(self, dtype) -> AreaLight:
        return AreaLight(build_scene(self.config["scene"], self.device, dtype),
                         self.render_cfg, self.config["lights"])

    def use_reference(self) -> None:
        self.reference = self._reference(torch.float32)

    def reference_pixels(self, ref: AreaLight, k: int, ys, xs,
                         with_lit=False):
        r = ref.cfg
        shape = (r["diffuse_scatter"], min(
            r["chunk_size"], r["samples_per_pixel"] * r["width"]
            * r["height"]), 2)

        def light_draw(c, depth, li, s, n_rows):
            return self.draws("fan", k, c, ("light", depth, li, s),
                              shape=(n_rows, 2))

        return ref.pixels(ys, xs, sun_at(self.time_of(k), self.device),
                          stratified_offsets(r["samples_per_pixel"]),
                          lambda c: self.draws("fan", k, c, 1, shape=shape),
                          light_draw, with_lit=with_lit)

    def light_pool(self) -> torch.Tensor:
        """The flat indices of the pixels the light set is drawn from."""
        if self.pool is None:
            w, h = self.render_cfg["width"], self.render_cfg["height"]
            step = max(1, math.ceil(math.sqrt(
                w * h / int(self.traffic["check_pixels"]))))
            gy, gx = torch.meshgrid(torch.arange(step // 2, h, step),
                                    torch.arange(step // 2, w, step),
                                    indexing="ij")
            _, lit = self.reference_pixels(
                self.reference, 0, gy.reshape(-1), gx.reshape(-1),
                with_lit=True)
            cells = lit.reshape(1, 1, *gy.shape).float().cpu()
            near = torch.nn.functional.max_pool2d(
                cells, 3, stride=1, padding=1)[0, 0] > 0
            cy = (torch.arange(h) // step).clamp_max(near.shape[0] - 1)
            cx = (torch.arange(w) // step).clamp_max(near.shape[1] - 1)
            self.pool = near[cy][:, cx].reshape(-1).nonzero().squeeze(1)
        return self.pool

    def light_sample(self, k: int):
        """The pixels (ys, xs) of frame k's light set."""
        pool = self.light_pool()
        g = torch.Generator().manual_seed(
            int(uniform(self.seed, "light_pixels", k, hi=2.0 ** 62)))
        n = min(int(self.traffic["check_pixels"]), pool.numel())
        pick = pool[torch.randperm(pool.numel(), generator=g)[:n]]
        w = self.render_cfg["width"]
        return pick // w, pick % w

    def _light_numbers(self, got_of, k: int) -> dict:
        ys, xs = self.light_sample(k)
        want, lit = self.reference_pixels(self.reference, k, ys, xs,
                                          with_lit=True)
        return {"light_bad_px_share": light_share(got_of(ys, xs), want, lit)}

    def check(self, item) -> dict:
        k, img = item

        def got(ys, xs):
            return img[ys.to(img.device), xs.to(img.device)].float()

        return {**super().check(item), **self._light_numbers(got, k)}

    def control(self, k: int, dtype) -> dict:
        """The numbers of the reference computed in `dtype`, put in the
        program's place, for frame k."""
        low = self._reference(dtype)

        def got(ys, xs):
            return self.reference_pixels(low, k, ys, xs)

        ys, xs = self.sample(k)
        return {**whitted_frame.compare(
                    got(ys, xs),
                    self.reference_pixels(self.reference, k, ys, xs)),
                **self._light_numbers(got, k)}


def light_share(got, want, lit) -> float:
    """The share of the pixels in `lit` whose largest channel gap between
    got and want [P, 3] exceeds LIGHT_GAP (NaN counts as a gap); 0 where
    no pixel is in `lit`."""
    gap = (got.float() - want.float()).abs().amax(dim=1)
    bad = torch.isnan(gap) | (gap > LIGHT_GAP)
    lit = lit.to(bad.device)
    return float(bad[lit].float().mean()) if bool(lit.any()) else 0.0
