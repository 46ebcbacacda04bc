"""The session's own spans (``sigdigger_tpu_torch.utils.profiling``), as
the per-layer readers of a session cell's traced run take them.

The session records spans only while a ``torch.profiler`` session is
active: the stepping thread's ``an.feed`` and the drain worker's
``an.drain`` share each block's id.  A reader takes the window's blocks
alone (ids at least the blocks fed less the window's blocks) that hold
both roots, and averages over them.  Where there is nothing to read, on
a CPU run or in a program that records no such spans, it returns None.
"""

from __future__ import annotations

from collections import defaultdict

FEED, DRAIN = "an.feed", "an.drain"


def window_blocks(ctx) -> dict[int, list] | None:
    """{block id: its records} of the window's traced blocks, or None."""
    from sigdigger_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    fed = getattr(profiling, "blocks_fed", None)
    if records is None or fed is None or not ctx.blocks:
        return None
    first = fed() - ctx.blocks
    blocks: dict[int, list] = defaultdict(list)
    for r in records():
        if r.block is not None and r.block >= first:
            blocks[r.block].append(r)
    whole = {b: rs for b, rs in blocks.items()
             if {FEED, DRAIN} <= {r.name for r in rs}}
    return whole or None


def ms_a_block(ctx, name: str) -> float | None:
    """Host ms a traced block spends in spans ``name``, summed."""
    blocks = window_blocks(ctx)
    if blocks is None:
        return None
    ns = [r.ns for rs in blocks.values() for r in rs if r.name == name]
    return sum(ns) / len(blocks) / 1e6 if ns else None


def attr_mean(ctx, name: str, attr: str) -> float | None:
    """Mean of attribute ``attr`` over the window's traced spans
    ``name`` that carry it."""
    blocks = window_blocks(ctx) or {}
    vals = [r.attrs[attr] for rs in blocks.values() for r in rs
            if r.name == name and attr in r.attrs]
    return sum(vals) / len(vals) if vals else None
