"""The plain reference: its cull drops no hit that brute force finds, its
scene is the port's scene, and at a tiny frame it agrees with the port's
plain versions (the CPU path) pixel for pixel and ray for ray."""

import json
import os

import numpy as np
import pytest
import torch

from rtbench import spec
from rtbench.harness import Reservoir, judge, window
from rtbench.reference.scene import build_scene
from rtbench.reference.tracer import Groups, moller_trumbore
from rtbench.reference.whitted import camera_dirs, ray_of_block_index
from rtbench.tests.conftest import tiny_cell


def config(name):
    with open(os.path.join(spec.ROOT, "rtbench", "configs",
                           name + ".json")) as f:
        return json.load(f)


def brute(sc, o, d):
    t = moller_trumbore(o[:, None], d[:, None], sc.v0[None], sc.e1[None],
                        sc.e2[None], torch.full((o.shape[0], 1), np.inf))
    tmin, tri = t.min(dim=1)
    return tmin, torch.where(torch.isfinite(tmin), tri, -1)


@pytest.mark.parametrize("group", [16, 128])
def test_cull_keeps_every_hit(group):
    sc = build_scene(config("two_teapots")["scene"])
    g = torch.Generator().manual_seed(3)
    o = torch.zeros(384, 3)
    o[128:] = torch.rand(256, 3, generator=g) * 6 - 3
    o[128:, 2] += 7
    d = torch.randn(384, 3, generator=g)
    d[:128] = camera_dirs(torch.zeros(128, dtype=torch.long),
                          torch.randint(0, 64, (128,), generator=g),
                          torch.randint(0, 64, (128,), generator=g),
                          torch.full((1, 2), 0.5), 64, 64, 1.0,
                          torch.float32)
    t, tri = Groups(sc, group).query(o, d)
    bt, btri = brute(sc, o, d)
    assert torch.equal(tri, btri) and torch.equal(t, bt)
    assert 0.2 < float((tri >= 0).float().mean()) < 0.95
    occ = Groups(sc, group).query(o, d, t_max=bt * 0.5, any_hit=True)
    b2, _ = brute(sc, o, d)
    assert not occ[torch.isinf(b2)].any()


def test_reference_scene_is_the_ports():
    from rtbench import program

    for name, cut in (("two_teapots", None), ("teapot_1m6", 2)):
        scene = config(name)["scene"]
        if cut:
            scene["objects"][0]["subdivide"] = cut
        sc = build_scene(scene)
        mesh = program.build_mesh(scene, "cpu")
        tv = mesh.tri_v.long()
        assert torch.equal(sc.v0, mesh.verts[tv[:, 0]])
        assert torch.equal(sc.e1, mesh.verts[tv[:, 1]] - mesh.verts[tv[:, 0]])
        assert torch.equal(sc.normal, mesh.normals)
        assert torch.equal(sc.color, mesh.colors)
        mat = mesh.materials[mesh.obj_id.long()]
        assert torch.equal(torch.stack([sc.albedo_pi, sc.refl, sc.rough], 1),
                           mat)


def test_block_order_round_trip():
    from rtbench.reference.whitted import block_order_index

    ls = torch.arange(4 * 32 * 48)
    s, y, x = ray_of_block_index(ls, 4, 48)
    assert torch.equal(block_order_index(s, y, x, 4, 48), ls)


@pytest.mark.parametrize("name", ["two_teapots.whitted",
                                  "two_teapots.primary"])
def test_port_on_the_cpu_agrees_with_the_reference(name):
    """The whole run but the card: window, release, check, on the port's
    plain versions at 16x16; every number reads as good as exact."""
    cell = tiny_cell(name)
    e = spec.entry(cell.traffic).Entry(cell.config, cell.traffic, 2 ** 31 + 5,
                                       "cpu")
    e.setup()
    res = Reservoir(2, 9)
    window(e, 0.0, res)
    window(e, 0.0, res)
    kept = e.release(res.items)
    correct, failed, checks = judge([e.check(it) for it in kept],
                                    cell.limits)
    assert correct and failed == 0
    for c in checks.values():
        assert c["value"] <= 1e-5
