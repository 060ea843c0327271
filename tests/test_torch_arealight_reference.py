"""The port's area-light frame against the benchmark's plain reference
(`rtbench/reference/arealight.py`), on the CPU through the port's plain
kernel versions, as the cell `teapot_1m6.arealight` runs it: its entry,
configuration and draws, the teapot subdivided once (25,280 triangles),
a 32x32 frame at 4 spp in two chunks of 2,048 rays, so that level 2, the
diffuse fan of every primary hit, is binned.

Bar: every channel of every pixel within 1e-5 of the reference. The two
compute the same float32 operations, in an order that differs only in a
few sums, so they may differ by rounding: a few ulps of values below 2;
1e-5 is the bar of the port's frames against the JAX package's. Three
controls must miss it by 10x: the reference computed in bfloat16; the port
with its former draws, where a binned level handed the sorted ray at
place i row i of each light draw (emulated by draws that the test
permutes by the level's bin order); and the reference without the
light.

The cell's check, as the benchmark's harness judges it under the cell's
limits, passes the port's frame and fails the former draws and a frame
rendered without the light: those two it sees only through its number of
the pixels the light reaches (`light_bad_px_share`)."""

import copy

import pytest
import torch

from raytracing_tpu_torch.models import whitted as TW
from rtbench import spec
from rtbench.harness import judge
from rtbench.reference.arealight import AreaLight

torch.set_num_threads(2)

CELL = "teapot_1m6.arealight"
RENDER = {"width": 32, "height": 32, "samples_per_pixel": 4,
          "chunk_size": 2048}
SEED = 2 ** 33 + 7
ATOL = 1e-5


def _entry():
    cell = spec.load_cell(CELL, spec.load_benchmark())
    config = copy.deepcopy(cell.config)
    config["scene"]["objects"][0]["subdivide"] = 1
    traffic = dict(cell.traffic, render=RENDER)
    e = spec.entry(traffic).Entry(config, traffic, SEED, "cpu")
    e.setup()
    return e


def _sorted_order_frame(e, monkeypatch):
    """Frame 0 with each binned level's light draws in its sorted order:
    the draw handed to the port is permuted so that its row sidx[i] holds
    row i of the real draw."""
    last = {}
    real_bin, real_draws = TW._bin_bounce, e.draws

    def bin_bounce(*a):
        out = real_bin(*a)
        last["sidx"] = out[0]
        return out

    def draws(*parts, shape):
        u = real_draws(*parts, shape=shape)
        tag = parts[-1]
        if isinstance(tag, tuple) and tag[1] > 1:
            v = torch.empty_like(u)
            v[last["sidx"]] = u
            return v
        return u

    with monkeypatch.context() as mp:
        mp.setattr(TW, "_bin_bounce", bin_bounce)
        mp.setattr(e, "draws", draws)
        return e.step(0)


@pytest.fixture(scope="module")
def frames():
    """The port's frame 0, binned and unbinned, with the former draws, and
    the entry with its reference set up."""
    e = _entry()
    out = {"binned": e.step(0)}
    cfg = e.cfg
    e.cfg = cfg.replace(bin_secondary=False)
    out["unbinned"] = e.step(0)
    e.cfg = cfg
    with pytest.MonkeyPatch.context() as mp:
        out["sorted_draws"] = _sorted_order_frame(e, mp)
    lights, e.lights = e.lights, None
    out["no_light"] = e.step(0)
    e.lights = lights
    e.release([])
    ys, xs = torch.meshgrid(torch.arange(32), torch.arange(32),
                            indexing="ij")
    out["px"] = ys.reshape(-1), xs.reshape(-1)
    out["entry"] = e
    out["want"] = e.reference_pixels(e.reference, 0, *out["px"])
    return out


def _gap(frames, img):
    ys, xs = frames["px"]
    return (img[ys, xs] - frames["want"]).abs().amax(dim=1)


def test_binned_level_is_binned(frames):
    """The frame's level 2 runs binned, and the light's draws there are
    what tells the former draws apart (else the controls prove nothing)."""
    assert not torch.equal(frames["binned"], frames["sorted_draws"])


def test_port_frame_matches_the_reference(frames):
    assert float(_gap(frames, frames["binned"]).max()) <= ATOL


def test_binning_changes_no_bit(frames):
    assert torch.equal(frames["binned"], frames["unbinned"])


@pytest.mark.parametrize("control", ["bfloat16", "sorted_draws",
                                     "no_light"])
def test_controls_miss_the_bar(frames, control):
    """The reference without the light shows that the bar sees the light,
    which sits above and behind the teapot and lights little of what the
    camera sees: it moves a few pixels, by up to ~0.01."""
    e = frames["entry"]
    if control == "sorted_draws":
        gap = _gap(frames, frames[control])
    else:
        ref = (e._reference(torch.bfloat16) if control == "bfloat16" else
               AreaLight(e.reference.sc, e.render_cfg, []))
        gap = (e.reference_pixels(ref, 0, *frames["px"])
               - frames["want"]).abs().amax(dim=1)
    assert float(gap.max()) > 10 * ATOL


@pytest.mark.parametrize("frame", ["binned", "sorted_draws", "no_light"])
def test_cell_check_sees_the_light(frames, frame):
    """Judged as a run is: the port's frame is correct, the other two are
    not, and the light's number is what refuses them."""
    limits = spec.load_cell(CELL, spec.load_benchmark()).limits
    numbers = frames["entry"].check((0, frames[frame]))
    correct, failed, _ = judge([numbers], limits)
    light = numbers["light_bad_px_share"]
    if frame == "binned":
        assert correct and light == 0.0, numbers
    else:
        assert not correct and failed == 1, numbers
        assert light > 2 * limits["light_bad_px_share"], numbers
        assert all(numbers[k] <= limits[k] for k in limits
                   if k != "light_bad_px_share"), numbers
