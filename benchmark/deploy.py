"""The system under test for one configuration: its rig templates, built
offline once and cached as users do with ``dump``, and one ``Mapper``
per output on the device.

The template cache lives in ``.cache/templates/`` under this folder
(git-ignored), one ``.dat`` per output, written and read by the port's
``template/io.py`` (``dump_dat``, ``load_dat``: the uncompressed,
reference-compatible file that the ``dump`` CLI writes), under a key
that hashes the configuration file and the port's offline sources
(``template/*.py``, ``cameras/*.py``).
"""

import hashlib
import time
from pathlib import Path

from .spec import HERE, ROOT

CACHE = HERE / ".cache"


def _key(config, sources):
    h = hashlib.sha256(Path(config["path"]).read_bytes())
    for pattern in sources:
        for p in sorted(ROOT.glob(pattern)):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def templates(config):
    """Per output, the port's MapperTemplate: loaded from the cache, or
    compiled (``compile_rig`` + ``create_masks``) and cached.  Returns
    (templates, compiled: bool)."""
    from octvr_tpu_torch.template import compile_rig
    from octvr_tpu_torch.template.io import dump_dat, load_dat

    d = CACHE / "templates" / f"{config['name']}-{_key(config, ('octvr_tpu_torch/template/*.py', 'octvr_tpu_torch/cameras/*.py'))}"
    out, compiled = [], False
    for o in config["outputs"]:
        path = d / f"{o['name']}.dat"
        if not path.exists():
            d.mkdir(parents=True, exist_ok=True)
            mt = compile_rig({"output": o["output"], "inputs": config["rig"]["inputs"]}, *o["rect"][2:])
            mt.create_masks()
            tmp = path.with_name(path.name + ".tmp")
            with open(tmp, "wb") as f:
                dump_dat(mt, f)
            tmp.replace(path)
            compiled = True
        with open(path, "rb") as f:
            out.append(load_dat(f))
    return out, compiled


class System:
    """The configuration's outputs as Mappers on ``device``, with the
    gain sharing of ``AsyncMultiMapper`` (owners solve, copiers reuse)."""

    def __init__(self, config, device):
        import torch
        from octvr_tpu_torch.stitch import Mapper

        t0 = time.perf_counter()
        mts, self.compiled = templates(config)
        self.template_s = time.perf_counter() - t0
        h, w = config["camera_size"]
        self.n_cams = len(config["rig"]["inputs"])
        self.cam_size = (h, w)
        m = config["mapper"]
        self.mappers, self.gain_modes = [], []
        for o, mt in zip(config["outputs"], mts):
            self.mappers.append(
                Mapper(
                    mt, [(h, w)] * self.n_cams, blend=o["blend"], enable_gain=o["gain_mode"] >= 0,
                    frame_format=m["frame_format"], blend_dtype=m["blend_dtype"], pipeline=m["pipeline"],
                    device=device,
                )
            )
            self.gain_modes.append(o["gain_mode"])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        self.order = sorted(range(len(self.mappers)), key=lambda k: 0 if self.gain_modes[k] in (-1, k) else 1)
        self.plan_build_s = time.perf_counter() - t0

    def stitch(self, frames):
        """Every output of one frame set, owners first: (outs, gains)."""
        outs = [None] * len(self.mappers)
        gains = [None] * len(self.mappers)
        for k in self.order:
            mode = self.gain_modes[k]
            ext = None if mode in (-1, k) else gains[mode]
            outs[k], gains[k] = self.mappers[k].stitch(frames, gains=ext)
        return outs, gains

