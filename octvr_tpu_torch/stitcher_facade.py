"""cv::Stitcher-style one-call facade, images in, panorama out: the port
of octvr_tpu/stitcher_facade.py.

Pipeline (stitcher.cpp:366 role): register (features -> match -> focal ->
rotations -> BA -> wave correction) at 0.6 MP, then compose through the
engine's own offline/online split: export the refined cameras as a rig,
compile a template (remap tables + seam masks) and run the Mapper's
per-frame stitch.  Registration, the colour conversions and the Mapper
run on ``device`` (default "cuda", which raises without a card);
``use_device=False`` composes on the host instead (the numpy remap and
seam paste), as the JAX facade's does."""

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .utils.device import resolve_device

__all__ = ["Stitcher", "StitchResult"]


@dataclass
class StitchResult:
    panorama: np.ndarray  # [H, W, 3] uint8
    indices: list  # images used
    rms: float
    rig: dict
    # the compiled MapperTemplate of ``rig`` (seam masks made), for
    # stitching further frames of the rig
    template: object = None
    # seconds: "register", "template" (compile_rig + create_masks),
    # "compose" (the Mapper's build and stitch, or the host paste)
    times: dict = field(default_factory=dict)


class Stitcher:
    def __init__(
        self,
        ba="ray",
        conf_thresh=1.0,
        blend=64,
        enable_gain=True,
        wave_kind="horiz",
        seam="distance",
        max_features=1500,
        finder="fast",
        levels=1,
        range_width=None,
        *,
        device="cuda",
    ):
        """``finder``/``levels``/``range_width`` mirror the reference
        Stitcher's setFeaturesFinder / setFeaturesMatcher choices
        (stitching.hpp:96, matchers.cpp:365-460): "fast" = FAST-9 +
        rBRIEF (ORB role), "blob" = Hessian blob detector (SURF role,
        low-texture rigs); levels > 1 = multi-scale pyramid detector;
        range_width = ordered-sequence range matcher.  ``seam``:
        "distance", or "graphcut", which passes the used images to
        ``create_masks`` for content-aware seams (host code, as in the
        JAX facade)."""
        self.device = resolve_device(device)
        self.ba = ba
        self.conf_thresh = conf_thresh
        self.blend = blend
        self.enable_gain = enable_gain
        self.wave_kind = wave_kind
        self.seam = seam
        self.max_features = max_features
        self.finder = finder
        self.levels = levels
        self.range_width = range_width

    def stitch(self, images, out_width=2048, out_height=0, use_device=True):
        """images: list of [H, W, 3] uint8/float arrays.  Returns
        StitchResult."""
        from .ops.color import rgb_to_yuv420p, yuv420p_to_rgb
        from .registration import cameras_to_rig, register_images
        from .template import compile_rig

        t0 = time.perf_counter()
        res = register_images(
            images,
            ba=self.ba,
            conf_thresh=self.conf_thresh,
            max_features=self.max_features,
            wave_kind=self.wave_kind,
            finder=self.finder,
            levels=self.levels,
            range_width=self.range_width,
            device=self.device,
        )
        if len(res.indices) < 2:
            raise RuntimeError("need at least 2 registrable images")
        used = [np.asarray(images[i])[..., :3] for i in res.indices]
        sizes = [(im.shape[1], im.shape[0]) for im in used]
        rig = cameras_to_rig(res, sizes)
        t1 = time.perf_counter()
        mt = compile_rig(rig, out_width, out_height or out_width // 2)
        mt.create_masks(used if self.seam == "graphcut" else None)
        t2 = time.perf_counter()

        if use_device:
            from .stitch import Mapper

            mapper = Mapper(
                mt,
                [(im.shape[0], im.shape[1]) for im in used],
                blend=self.blend,
                enable_gain=self.enable_gain,
                device=self.device,
            )
            frames = [
                rgb_to_yuv420p(torch.from_numpy(im.astype(np.float32)).to(self.device))
                for im in used
            ]
            out, _ = mapper.stitch(frames)
            pano = yuv420p_to_rgb(out).cpu().numpy()
            pano = np.clip(pano, 0, 255).astype(np.uint8)
        else:
            from .template.compiler import _remap_image_cpu

            W, H = mt.out_size
            pano = np.zeros((H, W, 3), np.uint8)
            for inp, sm, im in zip(mt.inputs, mt.seam_masks, used):
                x, y, rw, rh = inp.roi
                warped = _remap_image_cpu(im.astype(np.uint8), inp.map1, inp.map2)
                sel = sm > 128
                pano[y : y + rh, x : x + rw][sel] = warped[sel]

        times = {"register": t1 - t0, "template": t2 - t1, "compose": time.perf_counter() - t2}
        return StitchResult(
            panorama=pano, indices=res.indices, rms=res.rms, rig=rig, template=mt, times=times
        )
