"""Device selection and host-to-device transfer of plan arrays.

Plans are built once on the host in numpy (f32 for every float field)
and moved to the device here.  bf16 plan fields are made on the way with
``.to(torch.bfloat16)``, which rounds to nearest-even exactly as the
JAX package's ``ml_dtypes`` cast does (octvr_tpu/stitch/blenders.py).
"""

import dataclasses

import numpy as np
import torch

__all__ = ["resolve_device", "to_device", "tree_to"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  "cuda" without a usable card raises:
    nothing here falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def to_device(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """numpy array -> tensor on ``device``; float arrays cast to
    ``dtype`` when given.  Arrays whose dtype is named "bfloat16" (the
    ``ml_dtypes`` type the JAX package stores bf16 plans in) are read
    bit-for-bit through a uint16 view."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)


def tree_to(obj, device, dtype=None):
    """Recursively move every numpy array in ``obj`` (a dataclass, list,
    tuple or dict of them) to ``device`` with :func:`to_device`; other
    leaves (ints, shape tuples, strings, None) are returned as they are."""
    if isinstance(obj, np.ndarray):
        return to_device(obj, device, dtype)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(
            obj,
            **{
                f.name: tree_to(getattr(obj, f.name), device, dtype)
                for f in dataclasses.fields(obj)
                if f.init
            },
        )
    if isinstance(obj, dict):
        return {k: tree_to(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(tree_to(v, device, dtype) for v in obj)
    return obj
