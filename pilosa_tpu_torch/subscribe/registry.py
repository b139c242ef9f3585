"""Standing-query compilation: validate ``Subscribe(...)``, pick the
incremental strategy, and index the tree by the leaves it touches.

A subscription compiles ONCE at registration:

* ``Subscribe(Count(<tree>))`` / ``Subscribe(<tree>)`` — a standing
  count.  The tree is BSI-rewritten and decomposed into the same
  ``(expr, leaves)`` program the pull path launches, so incremental
  re-evaluation (the same K2 launch over the touched slices) is
  byte-identical to a pull by construction.
* ``Subscribe(TopN(...))`` — a standing ranking.  Any write to the
  frame may reshuffle it, so TopN subscriptions always re-run the full
  query on notification (the "ranking may have shifted" path).

``leaf_keys`` drive the write-side index: ``(frame, row)`` for plain
``Bitmap`` leaves (a write to another row cannot change the result),
``(frame, None)`` for everything whose touched rows aren't statically
known (Range time views, BSI predicate planes, inverse bitmaps, TopN).
"""

from __future__ import annotations

from pilosa_tpu_torch.exec import plan
from pilosa_tpu_torch.exec.executor import DEFAULT_FRAME
from pilosa_tpu_torch.pql.parser import Call

KIND_COUNT = "count"
KIND_TOPN = "topn"


class SubscribeError(ValueError):
    """Invalid standing-query registration (HTTP 400)."""


def _leaf_keys_for_tree(tree: Call) -> tuple[set, bool]:
    """``({(frame, row|None)}, force_pull)`` for a bitmap tree.

    ``force_pull`` is True when incremental slice evaluation over the
    standard orientation would be wrong (inverse-oriented leaves) —
    those subscriptions re-run through the executor, which resolves
    orientation exactly like the pull path.
    """
    keys: set = set()
    force_pull = False
    for leaf in plan.collect_leaf_calls(tree):
        frame = leaf.args.get("frame") or DEFAULT_FRAME
        if leaf.name == "Bitmap":
            row = leaf.args.get("rowID")
            if isinstance(row, bool) or not isinstance(row, int):
                # Inverse orientation (columnID=) or malformed: watch
                # the whole frame and evaluate via the pull path.
                keys.add((frame, None))
                force_pull = True
            else:
                keys.add((frame, row))
        else:
            # Range: time views or BSI comparisons — the set of rows a
            # write can touch isn't statically known.
            keys.add((frame, None))
    return keys, force_pull


def compile_subscription(call: Call):
    """Validate a parsed ``Subscribe(...)`` call.

    Returns ``(kind, inner, tree, leaf_keys, force_pull)``:

    * ``kind`` — :data:`KIND_COUNT` or :data:`KIND_TOPN`;
    * ``inner`` — the call the pull path executes (``Count(...)`` or
      ``TopN(...)``);
    * ``tree`` — the bitmap tree for incremental slice evaluation
      (None for TopN);
    * ``leaf_keys`` — ``{(frame, row|None)}`` the write index watches;
    * ``force_pull`` — never evaluate incrementally (inverse leaves).
    """
    if call.name != "Subscribe":
        raise SubscribeError("expected Subscribe(...)")
    if call.args:
        raise SubscribeError("Subscribe takes no arguments")
    if len(call.children) != 1:
        raise SubscribeError("Subscribe takes exactly one query call")
    inner = call.children[0]

    if inner.name == "TopN":
        frame = inner.args.get("frame") or DEFAULT_FRAME
        return KIND_TOPN, inner, None, {(frame, None)}, True

    if inner.name == "Count":
        if len(inner.children) != 1:
            raise SubscribeError("Count takes exactly one child call")
        tree = inner.children[0]
    elif inner.name in plan.FOLD_CALLS or inner.name in ("Bitmap", "Range"):
        # A bare bitmap tree subscribes to its Count: push updates
        # carry counts (row payloads stay on the pull path).
        tree = inner
        inner = Call(name="Count", children=[tree])
    else:
        raise SubscribeError(
            f"unsupported standing query: {inner.name}() "
            "(expected Count, TopN, or a bitmap tree)"
        )
    if tree.name not in plan.FOLD_CALLS and tree.name not in ("Bitmap", "Range"):
        raise SubscribeError(f"unsupported count subject: {tree.name}()")
    leaf_keys, force_pull = _leaf_keys_for_tree(tree)
    if not leaf_keys:
        raise SubscribeError("standing query touches no frames")
    return KIND_COUNT, inner, tree, leaf_keys, force_pull


def has_bsi_leaves(leaves) -> bool:
    """True when a decomposed program references BSI planes — its
    compiled form must be refreshed per evaluation because BSI depth
    grows with the values written (a new high limb adds leaves)."""
    return any(leaf.name in ("BsiPlane", "BsiPred", "BsiZero") for leaf in leaves)
