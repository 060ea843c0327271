"""The layers device time is sorted into, by kernel name: a frozen copy of
the `LAYERS` table of the port's `tools/profile_frame.py` (first match
wins; the last layer takes every name), under short keys that the
per-layer metrics name."""

from __future__ import annotations

# (key, what it holds, substrings of the kernel name)
LAYERS = (
    ("walk_k1_k2", "walk, K1 + K2 and their camera forms (walk.cu, "
     "camera.cu), and the fill launch of every split walk",
     ("walk_kernel", "walk_fill_kernel")),
    ("walk_k3_k4", "walk, K3 and K4 (gstream.cu, wq.cu)",
     ("gstream_kernel", "wq_")),
    ("refine", "refine, K5 dense (with K6's extents in the dense query) "
     "and gathered (refine.cu)", ("refine_kernel", "refine_lists_kernel")),
    ("lists", "lists, K6's extents and the visit lists in one launch, or "
     "the lists from extents given (lists.cu)", ("lists_kernel",)),
    ("extents", "extents, K6 alone (extents.cu)", ("extents_kernel",)),
    ("sorts", "sorts (bin keys, visit lists)",
     ("sort", "Sort", "radix", "Radix")),
    ("reductions", "reductions (any, amin, sums)", ("reduce", "Reduce")),
    ("gathers", "gathers/scatters", ("index", "gather", "scatter", "Index",
                                     "Gather", "Scatter")),
    ("memcpy", "memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
    ("glue", "shading/binning glue (torch elementwise)", ("",)),
)

KEYS = tuple(k for k, _, _ in LAYERS)


def layer_of(name: str) -> str:
    """The key of the layer a device operation's name falls in."""
    for key, _, subs in LAYERS:
        if any(s in name for s in subs):
            return key
    raise AssertionError("the last layer matches every name")
