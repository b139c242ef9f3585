"""State carried across from the JAX package.

``load_planes`` installs fragments — the JAX package's two tiers, as
numpy — into this port's fragments: each fragment's rows are placed as
on open (the densest up to the dense budget in the plane, the rest in
the sparse tier), its device mirror uploaded, its rank cache recounted
through the fused popcount kernel, and its roaring file written — into
the standard view, the inverse view of an inverse-enabled frame, or a
BSI field's ``field_<name>`` view.  A data directory the JAX ``Server``
wrote and closed opens directly with ``Holder``/``Server`` (same
on-disk formats), so no conversion is needed for that.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch import bsi
from pilosa_tpu_torch.core.view import VIEW_INVERSE, VIEW_STANDARD


def load_planes(holder, index: str, frame: str, view: str, planes: dict) -> None:
    """Install ``{slice: fragment}`` into ``index/frame/view``, creating
    the index and frame when absent.  A fragment is either a plane —
    uint32 ``[rows, 32768]`` with ``plane[r]`` the words of row id r — or
    the JAX package's tiers ``(row_ids, words, sparse)``: the plane rows'
    ids (int64 ``[n]``, a JAX fragment's ``_slot_of`` in slot order),
    their words (uint32 ``[n, 32768]``, its ``_plane[:n]``) and its
    sparse tier (``{row id: sorted uint32 in-slice offsets}``, its
    ``_sparse``).  ``view`` is the standard view, the inverse view of a
    frame with inverse storage, or the view of a field the frame
    declares (planes: row 0 exists, row 1 sign, row 2 + k magnitude bit
    k, as ``bsi`` lays them out)."""
    idx = holder.create_index_if_not_exists(index)
    f = idx.create_frame_if_not_exists(frame)
    if bsi.is_field_view(view):
        name = view[len(bsi.VIEW_FIELD_PREFIX) :]
        if f.bsi_field(name) is None:
            raise ValueError(f"frame {frame!r} has no field {name!r}")
    elif view == VIEW_INVERSE:
        if not f.inverse_enabled:
            raise ValueError(f"frame {frame!r} has no inverse storage")
    elif view != VIEW_STANDARD:
        raise ValueError(f"view {view!r} is not supported by this port yet")
    v = f.create_view_if_not_exists(view)
    # Highest slice first: the view grows its max slice once, so a
    # cluster node broadcasts one CreateSlice message, not one per slice.
    for slice_i, frag in sorted(planes.items(), reverse=True):
        target = v.create_fragment_if_not_exists(int(slice_i))
        if isinstance(frag, np.ndarray):
            target.install_plane(frag)
        else:
            row_ids, words, sparse = frag
            target.install_rows(row_ids, words, sparse)
