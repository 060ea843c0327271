"""Entry: steps of an inverse fit of pose + vertices through the port's
`models.inverse.Fitter.step`, as `models.inverse.fit` calls it; the
accel's geometry is refit on the card inside every step (`Fitter` does
so whenever it fits verts or pose).

Set-up builds the configuration's mesh and its primary accel, renders
the target (the port's frame at the true parameters under the run's sun,
at t0 drawn from the seed, its fan uniforms from (seed, "target", chunk,
tag)) and starts the fit from the configuration's `fit` block: the true
vertices and the start pose of object `pose_obj`. The sun stays at t0.
Warm-up runs steps and then puts the fit back to its start, so the
window's step 0 is the fit's first; the window is one fit, never
restarted.

Step k draws `rays_per_step` of the frame's primary rays, uniformly with
replacement (`torch.randint` under a generator seeded from (seed, "fit",
k, "rays")), takes its fan uniforms from (seed, "fit", k, tag), runs one
`Fitter.step` (closed loop: the next step starts when this one's loss is
on the host) and waits for the card. A step is the cell's "frame":
`frame_s` is the window's seconds over its steps, `frame_p90_s` the
90th percentile of its steps.

A kept step (`Kept`) holds k, its loss, the fitted parameters before it
and after it, their gradients, and Adam's state before it. The check
recomputes the step with `reference/fit.py` from the parameters and
Adam's state before it, the step's replayed rays and draws, and the
reference's own target (`reference/whitted.py` at the true parameters,
with the target's draws, at the pixels the step's rays fall in):
`loss_rel_err` (|L - L_ref| / L_ref), `pose_grad_rel_err` and
`verts_grad_rel_err` (the norm of the gradient's gap over the norm of
the reference's: over the pose's 6 numbers, and over every vertex), and
`step_rel_err` (the same of the change Adam made to all the fitted
numbers, the reference's from its own gradient by `reference.fit.adam`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtbench.device import sync
from rtbench.entries import whitted_frame
from rtbench.inputs import subseed, sun_at
from rtbench.reference.fit import Fit, Numbers, adam, compare
from rtbench.reference.scene import build_scene
from rtbench.reference.whitted import Whitted, stratified_offsets

PIXEL_BLOCK = 65536


class Kept(NamedTuple):
    k: int
    loss: float
    before: dict      # name -> the fitted parameter before the step
    grads: dict       # name -> its gradient
    after: dict       # name -> the parameter after the step
    adam: dict        # name -> Adam's (count, first, second moment) before


class Entry(whitted_frame.Entry):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.fit_cfg = dict(config["fit"], **traffic.get("fit", {}))
        self.names = list(self.fit_cfg["params"])
        self.fitter = None
        self.kept = {}

    def setup(self) -> None:
        from raytracing_tpu_torch.accel.packets import build_cluster_accel

        from rtbench import program

        self.mesh = program.build_mesh(self.config["scene"], self.device)
        a = self.config["accel"]
        self.accel = build_cluster_accel(
            self.mesh, cluster_size=int(a["cluster_size"]),
            variants=tuple(a["variants"]))
        self._fitter()

    def _fitter(self):
        """The fit, made on first use (after the mesh and accel are set,
        by `setup` or by a caller that shares them)."""
        if self.fitter is None:
            from raytracing_tpu_torch.geometry.mesh import Scene
            from raytracing_tpu_torch.models.inverse import Fitter
            from raytracing_tpu_torch.models.whitted import render

            scene = Scene(self.mesh, sun_at(self.t0, self.device))
            f = self.fit_cfg
            self.target = render(
                scene, self.cfg, accel=self.accel,
                uniforms=lambda i, tag, shape: self.draws(
                    "target", i, tag, shape=shape))
            params = {"pose": torch.tensor(f["start_pose"],
                                           dtype=torch.float32,
                                           device=self.device),
                      "verts": self.mesh.verts}
            self.fitter = Fitter(
                scene, self.target, {k: params[k] for k in self.names},
                self.cfg, accel=self.accel,
                learning_rate=float(f["learning_rate"]),
                pose_obj=int(f["pose_obj"]))
            if not getattr(self.fitter, "refits_geometry", False):
                raise SystemExit("rtbench: this port's Fitter does not refit "
                                 "the accel's geometry inside a step; it "
                                 "cannot run this configuration")
            self.rebuild_every = int(f["rebuild_every"])
            self.start = {"params": {k: v.detach().clone() for k, v
                                     in self.fitter.params.items()},
                          "opt_state": self.fitter.optimizer.state_dict()}
            self.before = self._snapshot()
        return self.fitter

    def _snapshot(self):
        """(parameters, Adam's state) of the fit as they stand, copied."""
        f = self.fitter
        params, state = {}, {}
        for n, p in f.params.items():
            params[n] = p.detach().clone()
            st = f.optimizer.state.get(p)
            state[n] = ((float(st["step"]), st["exp_avg"].clone(),
                         st["exp_avg_sq"].clone()) if st else
                        (0.0, torch.zeros_like(params[n]),
                         torch.zeros_like(params[n])))
        return params, state

    def warm_up(self) -> None:
        for k in range(int(self.traffic["warmup_steps"])):
            self.step(-1 - k)
        sync(self.device)
        self.fitter.load_state(self.start)
        self.before = self._snapshot()

    def rays(self, k: int) -> torch.Tensor:
        """Step k's ray ids: rays_per_step of the frame's, uniformly with
        replacement."""
        r = self.render_cfg
        n = r["samples_per_pixel"] * r["width"] * r["height"]
        g = self.draws.gen
        g.manual_seed(subseed(self.seed, "fit", k, "rays"))
        return torch.randint(0, n, (int(self.traffic["rays_per_step"]),),
                             generator=g, device=self.device)

    def uniforms(self, k: int):
        return lambda tag, shape: self.draws("fit", k, tag, shape=shape)

    def step(self, k: int):
        f = self._fitter()
        if self.rebuild_every and k > 0 and k % self.rebuild_every == 0:
            f.rebuild()
        loss = f.step(self.rays(k), self.uniforms(k))
        sync(self.device)
        return loss

    def keep(self, k: int, loss) -> Kept:
        after = self._snapshot()
        item = Kept(k, loss, self.before[0],
                    {n: p.grad for n, p in self.fitter.params.items()},
                    after[0], self.before[1])
        self.before = after
        return item

    def release(self, kept: list) -> list:
        """Free the program's state; set up the reference."""
        self.fitter = self.before = None
        for name in ("mesh", "accel", "target"):
            self.__dict__.pop(name, None)
        self.kept = {item.k: item for item in kept}
        self.use_reference()
        return kept

    def use_reference(self) -> None:
        """The reference of the fit (float32) and of its target."""
        self.reference = self._reference(torch.float32)
        self.ref_target = Whitted(
            build_scene(self.config["scene"], self.device), self.render_cfg)
        r = self.render_cfg
        self.target_px = torch.zeros((r["width"] * r["height"], 3),
                                     device=self.device)
        self.target_done = torch.zeros(r["width"] * r["height"],
                                       dtype=torch.bool, device=self.device)

    def _reference(self, dtype) -> Fit:
        return Fit(self.config["scene"], self.render_cfg,
                   int(self.fit_cfg["pose_obj"]), self.device, dtype)

    def target_rows(self, ids) -> torch.Tensor:
        """The reference's target at the pixel of each ray id [R, 3],
        rendered where not yet rendered."""
        r = self.render_cfg
        w, h, spp = r["width"], r["height"], r["samples_per_pixel"]
        pix = ids.to(self.device) % (w * h)
        need = torch.unique(pix[~self.target_done[pix]])
        shape = (r["diffuse_scatter"], min(r["chunk_size"], spp * w * h), 2)
        sun = sun_at(self.t0, self.device)
        for a in range(0, need.shape[0], PIXEL_BLOCK):
            p = need[a:a + PIXEL_BLOCK]
            self.target_px[p] = self.ref_target.pixels(
                p // w, p % w, sun, stratified_offsets(spp),
                lambda c: self.draws("target", c, 1, shape=shape))
            self.target_done[p] = True
        return self.target_px[pix]

    def reference_step(self, ref: Fit, item: Kept):
        """(the reference's `Numbers`, its parameters after the step, its
        Adam state after it) of step item.k, from the parameters and
        Adam's state before it."""
        before = item.before
        pose = before.get("pose", torch.tensor(self.fit_cfg["start_pose"]))
        verts = before.get("verts", ref.verts)
        ids = self.rays(item.k)
        fan = self.draws("fit", item.k, 1, shape=(
            self.render_cfg["diffuse_scatter"], ids.shape[0], 2))
        loss, g_pose, g_verts = ref.step(verts, pose, ids, fan,
                                         self.target_rows(ids),
                                         sun_at(self.t0, self.device))
        grads = {"pose": g_pose, "verts": g_verts}
        after, state = adam([before[n] for n in self.names],
                            [grads[n] for n in self.names],
                            [item.adam[n] for n in self.names],
                            float(self.fit_cfg["learning_rate"]), ref.dtype)
        change = torch.cat([(a.float() - before[n].to(a.device).float())
                            .reshape(-1) for n, a in zip(self.names, after)])
        return (Numbers(loss, g_pose, g_verts, change),
                dict(zip(self.names, after)), dict(zip(self.names, state)))

    def program_numbers(self, item: Kept) -> Numbers:
        def grad(name, shape):
            g = item.grads.get(name)
            return torch.zeros(shape) if g is None else g

        change = torch.cat([(item.after[n].float() - item.before[n].float())
                            .reshape(-1) for n in self.names])
        return Numbers(item.loss, grad("pose", (6,)),
                       grad("verts", self.reference.verts.shape), change)

    def check(self, item: Kept) -> dict:
        return compare(self.program_numbers(item),
                       self.reference_step(self.reference, item)[0])

    def replay(self, k: int) -> Kept:
        """Step k of the reference's own fit (float32) from the start, as
        a kept step without the program's numbers."""
        ref = self.reference
        params = {"pose": torch.tensor(self.fit_cfg["start_pose"],
                                       device=self.device),
                  "verts": ref.verts.float()}
        params = {n: params[n] for n in self.names}
        state = {n: (0.0, torch.zeros_like(p), torch.zeros_like(p))
                 for n, p in params.items()}
        for j in range(k):
            _, params, state = self.reference_step(
                ref, Kept(j, None, params, None, None, state))
        return Kept(k, None, params, None, None, state)

    def control(self, k: int, dtype) -> dict:
        """The numbers of the reference computed in `dtype`, put in the
        program's place, at step k: a kept step's parameters and Adam
        state before it, else the reference's own fit replayed to k."""
        item = self.kept.get(k) or self.replay(k)
        low = self.reference_step(self._reference(dtype), item)[0]
        return compare(low, self.reference_step(self.reference, item)[0])
