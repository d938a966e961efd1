"""What the port leaves out, by the ROADMAP item that ports it.

A part of the reference that the port lacks raises :func:`not_ported`
naming its item, on the recsys and the LM side alike.
"""
from __future__ import annotations

MULTI_DEVICE = "Multi-GPU (queue 1 item 4)"
SEQPAR = "seqpar_attention with multi-GPU"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a part of the reference that the port lacks raises: it
    names the ROADMAP item that ports it."""
    return NotImplementedError(
        f'{what} is not ported yet: it is the ROADMAP item "{item}"')
