"""octvr_gain_and_remap equivalent: offline cross-template exposure
harmonization (apps/octvr/gain_and_remap.cpp role).

Given a *stitch* template plus per-input *rmap* templates (canvas ->
original image geometry), it solves block-wise exposure gains on the
stitched working-scale canvas, pulls each image's gain map back into its
own source geometry (wrap border over the longitude seam), box-blurs it,
bakes it into the source pixels, and writes either the gained sources
(`.gain.png`) or their projections through extra *defish* templates
(`.defish-K.png`).

Usage (same positional convention as the reference CLI):
    python -m octvr_tpu_torch.cli.gain_and_remap stitch.dat \
        img0.png ... rmap0.dat ... [defish0.dat ... [defish0b.dat ...]]

The port of octvr_tpu/cli/gain_and_remap.py, with the same arguments
and files.  The block-gain solve (``stitch/gain_blocks.py``) runs on the
device ``apply_platform_env`` gives: the card, or the CPU with
OCTVR_PLATFORM=cpu.  The warps, the pullback and the blur are host numpy.
"""

import sys

import numpy as np
import torch

WORKING_MEGAPIX = 0.1  # gain_and_remap.cpp:30
BLUR_BLOCK = 16.0  # gain_and_remap.cpp:31


def _load_template(path):
    from . import load_template

    print(f"Loading template {path}", file=sys.stderr)
    return load_template(path)


def _remap_wrap(img, map1, map2, out_w, out_h):
    """Bilinear gather at normalized maps with wrap border (the gain-map
    pullback crosses the 360-degree longitude seam,
    gain_and_remap.cpp cv::BORDER_WRAP)."""
    px = map1.astype(np.float64) * out_w - 0.5
    py = map2.astype(np.float64) * out_h - 0.5
    x0 = np.floor(px).astype(np.int64)
    y0 = np.floor(py).astype(np.int64)
    fx = px - x0
    fy = py - y0
    h, w = img.shape[:2]
    xs = [x0 % w, (x0 + 1) % w]
    ys = [np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)]
    return (
        img[ys[0], xs[0]] * (1 - fx) * (1 - fy)
        + img[ys[0], xs[1]] * fx * (1 - fy)
        + img[ys[1], xs[0]] * (1 - fx) * fy
        + img[ys[1], xs[1]] * fx * fy
    ).astype(np.float32)


def _box_blur(img, k):
    """k x k box blur via cumulative sums (reflect-free: edge counts
    shrink like cv::blur's default border handling approximates)."""
    pad = k // 2
    padded = np.pad(img, pad, mode="edge").astype(np.float64)
    cs = np.cumsum(np.cumsum(padded, axis=0), axis=1)
    cs = np.pad(cs, ((1, 0), (1, 0)))
    h, w = img.shape
    out = (
        cs[k : k + h, k : k + w]
        - cs[:h, k : k + w]
        - cs[k : k + h, :w]
        + cs[:h, :w]
    ) / float(k * k)
    return out.astype(np.float32)


def main(argv=None):
    from . import apply_platform_env

    device = apply_platform_env()
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        print(
            "Usage: gain_and_remap stitch.dat img0.png ... rmap0.dat ..."
            " [defish0.dat ...]",
            file=sys.stderr,
        )
        return 1

    from ..ops.resize import resize_bilinear, resize_nearest
    from ..stitch.gain_blocks import build_blocks_gain_plan, solve_block_gains
    from ..template.compiler import _remap_image_cpu
    from ..utils.device import tree_to
    from ..utils.png import read_png, write_png

    mt = _load_template(argv[0])
    n = len(mt.inputs)
    rest = argv[1:]
    assert len(rest) % n == 0, f"argument count must be a multiple of {n}"
    print(f"{n} images found", file=sys.stderr)

    img_paths = rest[:n]
    rmap_paths = rest[n : 2 * n]
    defish_paths = rest[2 * n :]
    srcs = [read_png(p)[..., :3] for p in img_paths]

    W, H = mt.out_size
    working_scale = min(1.0, float(np.sqrt(WORKING_MEGAPIX * 1e6 / (W * H))))

    # remap sources onto the canvas, scale to working resolution
    scaled_imgs, scaled_masks, scaled_rois = [], [], []
    for inp, src in zip(mt.inputs, srcs):
        x, y, rw, rh = inp.roi
        sroi = (
            int(x * working_scale),
            int(y * working_scale),
            int(rw * working_scale),
            int(rh * working_scale),
        )
        warped = _remap_image_cpu(src, inp.map1, inp.map2).astype(np.float32)
        scaled_imgs.append(resize_bilinear(warped, sroi[3], sroi[2]))
        scaled_masks.append(np.asarray(resize_nearest(inp.mask, sroi[3], sroi[2])))
        scaled_rois.append(sroi)

    # block-gain solve on the working canvas (BlocksGainCompensator role)
    plan = build_blocks_gain_plan(
        scaled_masks,
        scaled_rois,
        (int(W * working_scale), int(H * working_scale)),
    )
    norms = [np.sqrt((im.astype(np.float32) ** 2).sum(axis=-1)) for im in scaled_imgs]
    gain_maps = solve_block_gains(
        tree_to(plan, device),
        [torch.from_numpy(nm).to(device) for nm in norms],
        out_rois=[inp.roi for inp in mt.inputs],
        scale=working_scale,
    )

    blur_size = ((int(BLUR_BLOCK / working_scale) >> 1) << 1) + 1
    gained = []
    for i, (inp, src) in enumerate(zip(mt.inputs, srcs)):
        rt = _load_template(rmap_paths[i])
        assert len(rt.inputs) == 1, "rmap template must have one input"
        x, y, rw, rh = inp.roi
        full = np.zeros((H, W), dtype=np.float32)
        full[y : y + rh, x : x + rw] = gain_maps[i].cpu().numpy()
        orig = _remap_wrap(full, rt.inputs[0].map1, rt.inputs[0].map2, W, H)
        orig = _box_blur(orig, blur_size)
        sh, sw = src.shape[:2]
        orig_full = np.asarray(resize_bilinear(orig, sh, sw))
        gained.append(
            np.clip(
                np.round(src.astype(np.float32) * orig_full[..., None]),
                0,
                255,
            ).astype(np.uint8)
        )

    if defish_paths:
        for d in range(len(defish_paths) // n):
            for i in range(n):
                dt = _load_template(defish_paths[d * n + i])
                assert len(dt.inputs) == 1
                out = _remap_image_cpu(
                    gained[i], dt.inputs[0].map1, dt.inputs[0].map2
                )
                name = f"{img_paths[i]}.defish-{d + 1}.png"
                write_png(name, out)
                print(f"Writing image {name}", file=sys.stderr)
    else:
        for i in range(n):
            name = f"{img_paths[i]}.gain.png"
            write_png(name, gained[i])
            print(f"Writing image {name}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
