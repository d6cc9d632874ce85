"""PTGui vignette model: reciprocal radial falloff 1/(a + b r^2 + c r^4 + d r^6)
with the exposure EV folded into the coefficients (vignette.cpp:19-55).

The map is baked at a fixed working resolution (512x512 like the reference,
template.cpp:18-19) and bilinearly resized to the input frame size by the
online mapper.
"""

import numpy as np

VIG_MAP_SIZE = 512

__all__ = ["vignette_map", "VIG_MAP_SIZE"]


def vignette_map(options: dict, width: int = VIG_MAP_SIZE, height: int = VIG_MAP_SIZE):
    """Return an (height, width) float32 gain map, or None if the rig JSON
    carries no vignette parameters."""
    if "vignette" not in options:
        return None
    a, b, c, d = (np.float32(v) for v in options["vignette"][:4])
    if "exposure" in options:
        ev = np.float32(2.0) ** np.float32(options["exposure"])
        a, b, c, d = a / ev, b / ev, c / ev, d / ev
    # integer pixel offsets from the half-size corner, like vignette.cpp:44-50
    i = np.arange(width, dtype=np.float32) - width // 2
    j = np.arange(height, dtype=np.float32) - height // 2
    rmax = np.sqrt(
        np.float32(width // 2) ** 2 + np.float32(height // 2) ** 2
    )
    r = np.sqrt(i[None, :] ** 2 + j[:, None] ** 2) / rmax
    r2 = r * r
    return (1.0 / (a + r2 * (b + r2 * (c + d * r2)))).astype(np.float32)
