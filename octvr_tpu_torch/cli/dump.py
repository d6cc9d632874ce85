"""octvr_dump equivalent: compile a rig JSON into a template file.

Usage: python -m octvr_tpu_torch.cli.dump [OPTIONS] -o OUTPUT_FILE CONFIG_JSON [IMAGES...]

Same flags as the reference CLI (apps/octvr/dump.cpp:33-39):
    -w X   output width (default 0 = derive from height/aspect)
    -h X   output height
    -d DIR save debug mask/seam/remap images
    -c     apply control-point morphing from the rig JSON
    -n     disable ROI-cropped maps

Output format by extension: .dat (reference-compatible VRv11) or .npz.
Passing input image paths enables graph-cut (content-aware) seams.

The port of octvr_tpu/cli/dump.py, with the same flags and files.  It
runs on the host alone (compile, seams, write); it reads OCTVR_PLATFORM
through ``apply_platform_env`` as every CLI of the port does, so without
a card it needs OCTVR_PLATFORM=cpu.
"""

import argparse
import json
import sys


def main(argv=None):
    from . import apply_platform_env

    apply_platform_env()
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("-w", type=int, default=0, dest="width")
    ap.add_argument("-h", type=int, default=0, dest="height")
    ap.add_argument("-o", required=True, dest="outfile")
    ap.add_argument("-d", default=None, dest="debug_dir")
    ap.add_argument("-c", action="store_true", dest="control_points")
    ap.add_argument("-n", action="store_false", dest="use_roi")
    ap.add_argument(
        "--seam",
        default="auto",
        choices=["auto", "distance", "dp", "dp_grad", "graphcut", "graphcut_grad"],
        help="seam finder; *_grad = COST_COLOR_GRAD "
        "(seam_finders.cpp:1283-1335); dp/graphcut need input images",
    )
    ap.add_argument("--help", action="help")
    ap.add_argument("config")
    ap.add_argument("images", nargs="*")
    args = ap.parse_args(argv)

    from ..template import MapperTemplate, dump_dat, save_npz
    from ..utils.png import read_png, write_png

    with open(args.config) as f:
        rig = json.load(f)

    out = rig["output"]
    mt = MapperTemplate.create(
        out["type"], out.get("options", {}), args.width, args.height
    )
    print(
        f"Output: {mt.out_size[0]}x{mt.out_size[1]} {out['type']}",
        file=sys.stderr,
    )
    for spec in rig.get("inputs", []):
        print(f"Input: {spec['type']}", file=sys.stderr)
        mt.add_input(
            spec["type"], spec.get("options", {}), overlay=False,
            use_roi=args.use_roi,
        )
    for spec in rig.get("overlays", rig.get("overlay_inputs", [])):
        print(f"Overlay input: {spec['type']}", file=sys.stderr)
        mt.add_input(
            spec["type"], spec.get("options", {}), overlay=True,
            use_roi=args.use_roi,
        )

    if args.control_points and "control_points" in rig:
        from ..template.morph import morph_control_points

        morph_control_points(mt, rig["control_points"])

    imgs = [read_png(p) for p in args.images] if args.images else None
    mt.create_masks(imgs, seam=args.seam)

    if args.outfile.endswith(".npz"):
        save_npz(mt, args.outfile)
    else:
        with open(args.outfile, "wb") as f:
            dump_dat(mt, f)
    print(f"Wrote {args.outfile}", file=sys.stderr)

    if args.debug_dir:
        import os

        os.makedirs(args.debug_dir, exist_ok=True)
        from ..template.compiler import is_empty

        for i, (inp, sm) in enumerate(zip(mt.inputs, mt.seam_masks)):
            if is_empty(inp):  # a camera that sees nothing of the output
                continue
            write_png(f"{args.debug_dir}/mask_{i}.png", inp.mask)
            write_png(f"{args.debug_dir}/seam_{i}.png", sm)
            if imgs is not None and i < len(imgs):
                from ..template.compiler import _remap_image_cpu

                write_png(
                    f"{args.debug_dir}/remap_{i}.png",
                    _remap_image_cpu(imgs[i], inp.map1, inp.map2),
                )


if __name__ == "__main__":
    main()
