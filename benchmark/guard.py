"""The look for JAX: the top-level names of the loaded modules, each
compared whole (the part before the first dot), against the JAX stack
and the JAX package.  ``octvr_tpu_torch`` is the port and passes;
``octvr_tpu`` is the JAX package and fails."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "octvr_tpu")


def jax_modules(names=None):
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
