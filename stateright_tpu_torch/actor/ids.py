"""Actor identifiers.

The counterpart of ``stateright_tpu/actor/ids.py`` (reference:
src/actor.rs:110-158), without the socket-address helpers of the UDP
runtime, which the port does not carry.
"""

from __future__ import annotations


class Id(int):
    """An actor identifier; an ``int`` subclass so it can index vectors
    directly.  It fingerprints as the plain integer."""

    __slots__ = ()

    def __repr__(self) -> str:  # match the reference's Display (the index)
        return f"Id({int(self)})"
