"""BAD: spec dataclass without frozen=True.

Spec dataclasses (`*Config`/`*Run`/`*Spec`, `Case`, `Reduction`, ...)
are batch-grouping and grid dedupe keys; a mutable one invites in-place
edits that silently split (or merge) the batches.
"""

import dataclasses


@dataclasses.dataclass  # <-- spec-dataclass-not-frozen
class WobblyRun:
    rho: float = 1.0
    iters: int = 100
