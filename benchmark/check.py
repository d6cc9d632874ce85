"""The comparison that decides ``correct``.

Each kept frame set is stitched again by the plain reference
(``reference/``), from the same camera frames, with the reference's own
template worked out from the configuration's rig (cached under
``.cache/reference/``, keyed by the configuration and the reference's
sources).  Copier outputs take the reference owner's gains.  The
numbers, each the worst over the kept sets and outputs:

- ``y_mae``, ``uv_mae``: mean absolute difference of the Y plane and of
  the U|V planes, in levels of 8 bits;
- ``far_share``: the share of output bytes more than ``FAR`` levels off;
- ``gain_rel``: the largest relative gap of a solved gain (only where
  the timed path hands its gains back: resident cells).

Beside them, and held to no limit, ``max_diff``: the largest gap of a
byte, in levels, which says how far the sound runs lie from ``FAR``.
"""

import hashlib
import math
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from .reference.offline import compile_template
from .reference.stitch import ReferenceOutput
from .spec import HERE

FAR = 8
CACHE = HERE / ".cache" / "reference"
NUMBERS = ("y_mae", "uv_mae", "far_share", "gain_rel")
INFO = ("max_diff",)


def _key(config):
    h = hashlib.sha256(Path(config["path"]).read_bytes())
    for p in sorted((HERE / "reference").glob("*.py")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def reference_templates(config):
    """Per output, the reference's own template (compiled once, then
    cached as a pickle the benchmark itself wrote)."""
    path = CACHE / f"{config['name']}-{_key(config)}.pkl"
    if path.exists():
        with open(path, "rb") as f:
            return pickle.load(f)
    out = [compile_template(o["output"], config["rig"]["inputs"], *o["rect"][2:]) for o in config["outputs"]]
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    return out


class Reference:
    """The configuration's outputs in the reference, on ``device``."""

    def __init__(self, config, device):
        t0 = time.perf_counter()
        self.outputs = [
            ReferenceOutput(t, tuple(config["camera_size"]), o["blend"], o["gain_mode"] >= 0, device)
            for t, o in zip(reference_templates(config), config["outputs"])
        ]
        self.gain_modes = [o["gain_mode"] for o in config["outputs"]]
        self.order = sorted(range(len(self.outputs)), key=lambda k: 0 if self.gain_modes[k] in (-1, k) else 1)
        self.build_s = time.perf_counter() - t0

    def stitch(self, frames, quantize=None):
        outs = [None] * len(self.outputs)
        gains = [None] * len(self.outputs)
        for k in self.order:
            mode = self.gain_modes[k]
            ext = None if mode in (-1, k) else gains[mode]
            outs[k], gains[k] = self.outputs[k].stitch(frames, gains=ext, quantize=quantize)
        return outs, gains


def _worse(a, b):
    """The worse of two readings; NaN is the worst of all."""
    if a is None or math.isnan(a):
        return a
    return b if math.isnan(b) or b > a else a


def compare_one(out, ref):
    """(y_mae, uv_mae, far_share, max_diff) of one uint8 YUV420P output
    against the reference's."""
    a = (out.cpu() if isinstance(out, torch.Tensor) else torch.from_numpy(np.asarray(out))).to(torch.int16)
    b = ref.to(torch.int16)
    if a.shape != b.shape:
        return float("inf"), float("inf"), 1.0, float("inf")
    h = a.shape[0] * 2 // 3
    d = (a - b).abs().float()
    return d[:h].mean().item(), d[h:].mean().item(), (d > FAR).float().mean().item(), d.max().item()


def numbers(reference, pool, kept, outputs_of=None):
    """The numbers of ``kept`` ({set index: (pool index, outputs,
    gains or None)}) against the reference.  ``outputs_of`` replaces the
    kept outputs (the control: the reference in a lower precision)."""
    worst = dict.fromkeys(NUMBERS + INFO, 0.0)
    refs = {}
    for idx in sorted(kept):
        k, outs, gains = kept[idx]
        if k not in refs:
            refs[k] = reference.stitch(pool[k])
        ref_outs, ref_gains = refs[k]
        if outputs_of is not None:
            outs, gains = outputs_of(k)
        for o, r in zip(outs, ref_outs):
            for name, v in zip(("y_mae", "uv_mae", "far_share", "max_diff"), compare_one(o, r)):
                worst[name] = _worse(worst[name], v)
        if gains is None:
            worst["gain_rel"] = None
            continue
        for mode, (g, rg) in enumerate(zip(gains, ref_gains)):
            if reference.gain_modes[mode] == mode:
                g = torch.as_tensor(g).double().cpu().numpy()
                worst["gain_rel"] = _worse(worst["gain_rel"], float(np.max(np.abs(g - rg) / np.abs(rg))))
    return worst


def verdict(found, limits):
    """(correct, [[name, value, limit]]): every number found within its
    limit (a number that could not be read, such as gains that a live
    run never hands back, is left out)."""
    lines, ok = [], True
    for name in NUMBERS:
        v = found.get(name)
        if v is None or name not in limits:
            continue
        lines.append([name, v, limits[name]])
        ok = ok and v <= limits[name]  # False for NaN
    return ok and bool(lines), lines
