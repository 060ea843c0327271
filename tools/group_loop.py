"""The K1 group loop: a cluster table above the group budget walked by one
K1 launch (`walk`) per group of clusters, each with its own frustum lists,
the groups merged by elementwise nearest (a later group wins only with a
smaller t, so ties keep the lower slot). Rays are independent, so grouping
is exact: this is a third witness of the streamed-groups walk (K3,
`walk_gstream`), which the package runs for such tables, and no path of
the package. tests/test_torch_dispatch.py, tests/test_torch_gpu.py and
chip_smoke.py hold K3 against it; a test sends every over-budget query
through it by patching `traverse._walk_over_budget` with `walk_groups_loop`.

    from tools.group_loop import walk_groups_loop
"""

from __future__ import annotations

import torch

from raytracing_tpu_torch.kernels import traverse as T


def walk_groups_loop(accel, rp, eps, nearest, t_max, n_attrs,
                     early_exit=None, shared_origin=None, tmax_row=None,
                     attr_kind="shade", variant="pmt"):
    """What `traverse._walk_over_budget` returns (a table above the group
    budget), from one K1 launch per group of `_group_clusters` clusters,
    in the intersector family of `variant`."""
    cs = accel.cluster_size
    gsz = T._group_clusters(accel, n_attrs)
    best = None
    for lo in range(0, accel.num_clusters, gsz):
        hi = min(lo + gsz, accel.num_clusters)
        args, kw = T._groups_walk_args(
            accel, rp, eps, nearest, t_max, n_attrs, early_exit=early_exit,
            shared_origin=shared_origin, tmax_row=tmax_row,
            clusters=(lo, hi), attr_kind=attr_kind, variant=variant)
        t_g, s_g, a_g = T.walk(*args, **kw)
        if nearest:
            s_g = s_g + lo * cs
        if best is None:
            best = (t_g, s_g, a_g)
        elif nearest:
            better = t_g < best[0]
            best = (torch.minimum(best[0], t_g),
                    torch.where(better, s_g, best[1]),
                    torch.where(better, a_g, best[2]) if n_attrs else None)
        else:
            best = (torch.minimum(best[0], t_g), best[1] | s_g, None)
    return best
