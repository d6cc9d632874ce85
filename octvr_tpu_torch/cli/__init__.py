"""CLI entry points, each run as ``python -m octvr_tpu_torch.cli.<name>``
with the JAX CLI's arguments.

``apply_platform_env()`` reads the JAX CLIs' ``OCTVR_PLATFORM`` variable
and returns the CLIs' torch device: "cpu" gives the CPU; unset, "gpu" or
"cuda" gives the card, and without one it raises
(``utils.device.resolve_device``): nothing falls back to the CPU."""

import os

from ..template import load_dat, load_npz
from ..utils.device import resolve_device

ENV_PLATFORM = "OCTVR_PLATFORM"


def apply_platform_env():
    plat = (os.environ.get(ENV_PLATFORM) or "cuda").lower()
    if plat == "gpu":
        plat = "cuda"
    if plat not in ("cpu", "cuda"):
        raise ValueError(f"{ENV_PLATFORM}={plat!r}: the port runs on 'cpu' or 'cuda' ('gpu')")
    return resolve_device(plat)


def load_template(path):
    """A template from a ``.npz`` (save_npz) or ``.dat`` (dump_dat) file."""
    if str(path).endswith(".npz"):
        return load_npz(path)
    with open(path, "rb") as f:
        return load_dat(f)
