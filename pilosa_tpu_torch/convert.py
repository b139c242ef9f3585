"""State carried across from the JAX package.

``load_planes`` installs fragment planes — uint32 ``[rows, 32768]`` numpy
arrays with ``plane[r]`` the words of row id ``r``, as the JAX package's
fragments hold them — into this port's fragments: each fragment's
device mirror is uploaded, its rank cache recounted through the fused
popcount kernel, and its roaring file written — into the standard view
or a BSI field's ``field_<name>`` view.  A data directory the JAX
``Server`` wrote and closed opens directly with ``Holder``/``Server``
(same on-disk formats), so no conversion is needed for that.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch.core.view import VIEW_STANDARD


def load_planes(
    holder, index: str, frame: str, view: str, planes: dict[int, np.ndarray]
) -> None:
    """Install ``{slice: plane}`` into ``index/frame/view``, creating the
    index and frame when absent.  ``view`` is the standard view or the
    view of a field the frame declares (planes: row 0 exists, row 1
    sign, row 2 + k magnitude bit k, as ``bsi`` lays them out)."""
    idx = holder.create_index_if_not_exists(index)
    f = idx.create_frame_if_not_exists(frame)
    if bsi.is_field_view(view):
        name = view[len(bsi.VIEW_FIELD_PREFIX) :]
        if f.bsi_field(name) is None:
            raise ValueError(f"frame {frame!r} has no field {name!r}")
    elif view != VIEW_STANDARD:
        raise ValueError(f"view {view!r} is not supported by this port yet")
    v = f.create_view_if_not_exists(view)
    # Highest slice first: the view grows its max slice once, so a
    # cluster node broadcasts one CreateSlice message, not one per slice.
    for slice_i, plane in sorted(planes.items(), reverse=True):
        v.create_fragment_if_not_exists(int(slice_i)).install_plane(plane)
