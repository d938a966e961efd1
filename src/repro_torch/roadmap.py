"""What the port leaves out, by the ROADMAP item that ports it.

A part of the reference that the port lacks raises :func:`not_ported`
naming its item: sequence-parallel attention (``SEQPAR``, queue 1 item 4
(c)) is the one left.
"""
from __future__ import annotations

SEQPAR = "seqpar_attention with multi-GPU"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a part of the reference that the port lacks raises: it
    names the ROADMAP item that ports it."""
    return NotImplementedError(
        f'{what} is not ported yet: it is the ROADMAP item "{item}"')
