"""Cells of BENCHMARK.json at a size the CPU tests can hold: the same
runtime, mix and comparison, with the model cut to its family's small
model (``SMOKE`` in ``reference/<family>.py``) and the mix to that
family's short rows (``SMOKE_SEQ``). Tests only."""

from __future__ import annotations

import copy

__all__ = ["smoke_cell"]


def smoke_cell(name: str, dtype: str = "float32", limits=None, spec=None, traffic=None):
    """Cell ``name`` (of ``spec``, BENCHMARK.json's when None; with the mix
    ``traffic`` in place of its file's when given) with its family's small
    model in ``dtype``, the family's short rows (4 rows a step for a plain
    mix) and ``limits`` (the cell's own when None)."""
    from portbench import harness

    full = harness.resolve(name, spec, traffic=traffic)
    config = copy.deepcopy(full.config)
    config["model"] = dict(full.family.SMOKE, dtype=dtype)
    small = dict(full.traffic, seq=full.family.SMOKE_SEQ)
    if "rows" in small:
        small["rows"] = 4
    return harness.resolve(name, spec, config=config, traffic=small,
                           limits=full.limits if limits is None else limits)
