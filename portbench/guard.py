"""What a run may not have loaded: JAX and the JAX package the port was made
from. Names are compared by their top-level part (before the first dot),
whole: `rvc_tpu_torch` is the program under test, `rvc_tpu` is not."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "rvc_tpu")


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among `names` whose top-level part is forbidden."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
