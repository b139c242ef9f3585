"""Storage hierarchy: Holder -> Index -> Frame -> View -> Fragment.

A fragment is one (frame, view, slice) dense uint32 bit-plane, held on
the host authoritatively and mirrored as an int32 bit-view tensor on the
holder's device for query execution.
"""
