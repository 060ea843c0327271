"""The system under test, set up from a configuration file through the
port's own loaders: its mesh (`geometry.obj.read_obj`,
`geometry.scene.ground_plane_object`,
`geometry.subdivide.subdivide_arrays`, `geometry.mesh.concat_objects`),
its render configuration and its accels (`build_cluster_accel`, and the
bounce accel `models.whitted.frame_accels` builds). The only harness
module besides the entries that imports the port."""

from __future__ import annotations

import os

from rtbench.spec import HERE


def build_mesh(scene_cfg: dict, device):
    from raytracing_tpu_torch.geometry.mesh import concat_objects
    from raytracing_tpu_torch.geometry.obj import read_obj
    from raytracing_tpu_torch.geometry.scene import ground_plane_object
    from raytracing_tpu_torch.geometry.subdivide import subdivide_arrays

    objects = []
    for ob in scene_cfg["objects"]:
        color = (tuple(c / 255.0 for c in ob["color_u8"]) if "color_u8" in ob
                 else tuple(ob["color"]))
        if "plane" in ob:
            objects.append(ground_plane_object(
                float(ob["plane"]["half_extent"]), float(ob["plane"]["y"]),
                color=color, material=tuple(ob["material"])))
            continue
        d = read_obj(os.path.join(HERE, "scenes", ob["mesh"]),
                     offset=tuple(ob.get("offset", (0.0, 0.0, 0.0))),
                     color=color, material=tuple(ob["material"]))
        if ob.get("subdivide", 0):
            d["verts"], d["tri_v"] = subdivide_arrays(
                d["verts"], d["tri_v"], int(ob["subdivide"]))
        objects.append(d)
    return concat_objects(objects).to(device)


def render_config(render: dict):
    """The port's RenderConfig of a configuration's `render` block."""
    from raytracing_tpu_torch.config import RenderConfig

    kw = dict(render)
    kw["sky_color"] = tuple(kw["sky_color"])
    return RenderConfig(**kw)


def build_accel(mesh, config: dict):
    """The primary accel of the configuration's `accel` block: its cluster
    size, with the port's defaults for the rest."""
    from raytracing_tpu_torch.accel.packets import build_cluster_accel

    return build_cluster_accel(
        mesh, cluster_size=int(config["accel"]["cluster_size"]))


def frame_accels(mesh, sun, accel, cfg):
    """(accel, gi_accel): the bounce accel the renderer builds itself for
    `cfg` (its gi_cluster_size; None where the primary accel is already
    as coarse), built once here."""
    from raytracing_tpu_torch.geometry.mesh import Scene
    from raytracing_tpu_torch.models.whitted import frame_accels as fa

    return fa(Scene(mesh, sun), cfg, accel, None)
