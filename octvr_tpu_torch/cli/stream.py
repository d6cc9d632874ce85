"""Live streaming stitcher — the FFmpeg vr_map filter / OwlLiveCore role
(modules/octvr/readme.md:16-28, apps/livestitching/mainwindow.cpp:91-108):
N raw YUV420P input streams -> pipelined stitch -> one (or several) raw
YUV420P output streams, with per-stage timing and a rolling FPS meter.

Usage:
  python -m octvr_tpu_torch.cli.stream \
      --inputs in0.yuv,in1.yuv,... --in_size 1920x1920 \
      --outputs tmpl0.dat[:blend[:gain_mode]],tmpl1.dat... \
      --out out0.yuv[,out1.yuv...] [--frames N] [--preview prefix]

Raw streams interoperate with ffmpeg, e.g.
  ffmpeg -i cam0.mp4 -pix_fmt yuv420p -f rawvideo in0.yuv
  ffmpeg -f rawvideo -pix_fmt yuv420p -s 3840x1920 -i out0.yuv pano.mp4

The port of octvr_tpu/cli/stream.py, with the same flags.  It runs on
the card; OCTVR_PLATFORM=cpu runs it on the CPU.  The mappers choose
their own defaults for the device (``--pipeline auto`` and
``--blend_dtype``: yuv420 and bfloat16 on the card, rgb and float32 on
the CPU).  A bad ``--args_enc`` blob prints one line and exits with
EXIT_BAD_ARGS.  On the card the last line on stderr counts the remap
kernel's launches (``ops.cuda_remap``).
"""

import argparse
import sys
import time

import numpy as np
import torch

EXIT_BAD_ARGS = 3  # an --args_enc blob that does not decrypt


def main(argv=None):
    from . import apply_platform_env, load_template

    # confidential-argument mode (encryptor.cpp role): a supervisor may
    # pass the whole command line as one encrypted blob so stream keys
    # never show in process listings
    from ..utils.argcrypt import ArgCryptError, maybe_decrypt_argv

    try:
        argv = maybe_decrypt_argv(sys.argv[1:] if argv is None else list(argv))
    except ArgCryptError as e:
        print(f"stream: --args_enc: {e}", file=sys.stderr)
        raise SystemExit(EXIT_BAD_ARGS) from None
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--inputs",
        default=None,
        help="comma-separated paths (required unless --source synthetic)",
    )
    ap.add_argument("--in_size", required=True, help="WxH of every input")
    ap.add_argument(
        "--source",
        default="files",
        choices=("files", "synthetic"),
        help="synthetic: device-resident random frame sets instead of "
        "file reads — demonstrates the pipeline's device-bound fps "
        "without host transfers (use with --frames N)",
    )
    ap.add_argument(
        "--sharded",
        default=None,
        metavar="DATAxSPACE",
        help="stitch through ShardedMapper on a (data, space) band "
        "mesh, e.g. 1x4 (all bands on one device); the pipeline groups "
        "'data' frame sets per batch (async.cpp:247-259 fan-out)",
    )
    ap.add_argument(
        "--in_format",
        default="yuv420p",
        choices=("yuv420p", "uyvy"),
        help="raw input pixel layout; uyvy = packed 4:2:2 (DeckLink SDI "
        "capture, split per cudaimgproc splitUYVY + 4:2:0 chroma "
        "row-average)",
    )
    ap.add_argument(
        "--outputs",
        required=True,
        help="template[:blend[:gain_mode]] per output, comma-separated",
    )
    ap.add_argument("--out", required=True, help="output stream paths")
    ap.add_argument("--frames", type=int, default=0, help="stop after N")
    ap.add_argument(
        "--preview",
        default=None,
        help="PNG path prefix: writes <prefix><frame>.png of output 0 "
        "every --preview_interval frames (the shared-memory preview "
        "role, async.cpp:312-335)",
    )
    ap.add_argument("--preview_interval", type=int, default=30)
    ap.add_argument(
        "--preview_shm",
        default=None,
        help="mmap live-preview file: every frame of output 0 is "
        "published (downscaled to --preview_size) to a double-buffered "
        "seqlocked RGB24 buffer any process can read concurrently "
        "(runtime/preview.py; the QSharedMemory preview role, "
        "async.cpp:312-335 + octvr.hpp:93-101)",
    )
    ap.add_argument(
        "--preview_size",
        default=None,
        help="WxH of the mmap preview (default: output 0 at 1/2 scale)",
    )
    ap.add_argument(
        "--pipeline",
        default="auto",
        choices=("auto", "rgb", "yuv420"),
        help="online compute path: yuv420 = YUV-native (1-ch full-res Y "
        "and 2-ch half-res chroma remaps; needs even geometry); auto = "
        "yuv420 on the card when geometry allows, rgb on the CPU",
    )
    ap.add_argument(
        "--blend_dtype",
        default=None,
        choices=("float32", "bfloat16"),
        help="multiband pyramid precision (bfloat16 = the 16-bit "
        "analogue of the reference's CV_16S GPU pyramids); default "
        "bfloat16 on the card, float32 on the CPU",
    )
    ap.add_argument(
        "--drain",
        default="host",
        choices=("host", "checksum"),
        help="checksum: value-sync a scalar per frame instead of "
        "downloading it (measurement mode for the pipeline's "
        "device-bound rate on transfer-bound links); writers/preview "
        "are skipped",
    )
    ap.add_argument(
        "--timers",
        action="store_true",
        help="print per-stage [Timer stitch] upload/dispatch/drain ms "
        "every 10 frames (mapper.cpp:206-318 parity)",
    )
    args = ap.parse_args(argv)
    device = apply_platform_env()

    from ..ops.color import uyvy_to_yuv420p
    from ..runtime import AsyncMultiMapper, Timer
    from ..runtime.native_io import FrameReader, FrameWriter, native_available
    from ..stitch import Mapper

    print(f"# device {device}; native IO: {native_available()}", file=sys.stderr)

    w_in, h_in = (int(v) for v in args.in_size.lower().split("x"))
    if args.source == "synthetic":
        if not args.frames:
            raise SystemExit("--source synthetic requires --frames N")
        readers = None
        n_inputs = None  # resolved from the first template below
    else:
        if not args.inputs:
            raise SystemExit("--inputs required unless --source synthetic")
        in_paths = args.inputs.split(",")
        readers = [
            FrameReader(p, w_in, h_in, fmt=args.in_format) for p in in_paths
        ]
        n_inputs = len(readers)

    def to420(frame):
        if args.in_format != "uyvy":
            return frame
        # on the host, as the yuv420p frames: the device path is the
        # same for both input layouts.  The pure-Python reader's frames
        # are read-only buffers, which torch does not wrap: copied.
        return uyvy_to_yuv420p(torch.from_numpy(np.require(frame, requirements="W"))).numpy()

    mesh = None
    if args.sharded:
        from ..parallel.sharded import ShardedMapper, make_mesh

        n_data, n_space = (int(v) for v in args.sharded.lower().split("x"))
        mesh = make_mesh(n_data, n_space, device=device)

    mappers, gain_modes = [], []
    for k, spec in enumerate(args.outputs.split(",")):
        parts = spec.split(":")
        path = parts[0]
        blend = int(parts[1]) if len(parts) > 1 else 128
        gain_mode = int(parts[2]) if len(parts) > 2 else k
        mt = load_template(path)
        if n_inputs is None:
            n_inputs = len(mt.inputs)
        if len(mt.inputs) != n_inputs:
            raise SystemExit(f"template {path} wants {len(mt.inputs)} inputs, got {n_inputs}")
        if mesh is not None:
            pl = None if args.pipeline == "auto" else args.pipeline
            # blend_dtype None: the ShardedMapper's own default for the
            # device, as the single-chip Mapper's
            mappers.append(
                ShardedMapper(
                    mt,
                    [(h_in, w_in)] * n_inputs,
                    mesh,
                    blend=blend,
                    enable_gain=gain_mode >= 0,
                    pipeline=pl,
                    blend_dtype=args.blend_dtype,
                )
            )
            # copy modes (gain_mode == other output's index) are honored
            # sharded too: ShardedMapper.stitch_batch(gains=) injection,
            # async.cpp:75-91 semantics
            gain_modes.append(gain_mode)
        else:
            mappers.append(
                Mapper(
                    mt,
                    [(h_in, w_in)] * n_inputs,
                    blend=blend,
                    enable_gain=gain_mode >= 0,
                    pipeline=args.pipeline,
                    blend_dtype=args.blend_dtype,
                    device=device,
                )
            )
            gain_modes.append(gain_mode)

    writers = [
        FrameWriter(p, m.plan.out_size[0], m.plan.out_size[1])
        for p, m in zip(args.out.split(","), mappers)
    ]

    # synthetic sets are device-resident and REUSED across pushes: they
    # bypass the pipeline's rings and are never written
    amm = AsyncMultiMapper(
        mappers,
        gain_modes=gain_modes,
        timers=args.timers,
        drain=args.drain,
    )
    timer = Timer("stream")
    t_start = time.time()
    n_pushed = n_popped = 0
    eof = False

    shm = None
    if args.preview_shm:
        from ..runtime.preview import PreviewWriter

        W0, H0 = mappers[0].plan.out_size
        if args.preview_size:
            pw, ph = (int(v) for v in args.preview_size.lower().split("x"))
        else:
            pw, ph = max(2, W0 // 2), max(2, H0 // 2)
        shm = PreviewWriter(args.preview_shm, pw, ph)
        # nearest-sample index grids (host-side; the preview must not
        # add device work, async.cpp:149-171 copies out of the D2H mat)
        shm_yi = (np.arange(ph) * H0) // ph
        shm_xi = (np.arange(pw) * W0) // pw
        print(f"# preview: {args.preview_shm} ({pw}x{ph})", file=sys.stderr)

    def publish_shm(outs, frame_no):
        if shm is None:
            return
        buf = outs[0]
        W0, H0 = mappers[0].plan.out_size
        y = buf[:H0][shm_yi][:, shm_xi].astype(np.float32)
        u = (
            buf[H0:, : W0 // 2][shm_yi // 2][:, shm_xi // 2].astype(np.float32)
            - 128.0
        )
        v = (
            buf[H0:, W0 // 2 :][shm_yi // 2][:, shm_xi // 2].astype(np.float32)
            - 128.0
        )
        # full-range BT.601, same matrix as ops/color.py
        rgb = np.stack(
            [
                y + 1.402 * v,
                y - 0.344136 * u - 0.714136 * v,
                y + 1.772 * u,
            ],
            axis=-1,
        )
        shm.write(
            np.clip(rgb, 0, 255).astype(np.uint8),
            fps=amm.fps.value(),
            frame_no=frame_no,
        )

    def write_preview(outs, frame_no):
        if args.preview is None:
            return
        if frame_no % max(1, args.preview_interval) != 0:
            return
        from ..ops.color import yuv420p_to_rgb
        from ..utils.png import write_png

        rgb = yuv420p_to_rgb(torch.from_numpy(outs[0])).numpy()
        img = np.clip(rgb, 0, 255).astype(np.uint8)
        write_png(f"{args.preview}{frame_no:06d}.png", img)

    def drain_one():
        nonlocal n_popped
        outs = amm.pop()
        if args.drain == "host":
            for wtr, o in zip(writers, outs):
                wtr.push(o)
            write_preview(outs, n_popped)
            publish_shm(outs, n_popped)
        n_popped += 1
        if n_popped % 10 == 0:
            # read-only: the drain thread already ticks the meter once
            # per frame; ticking here too would double-count
            print(
                f"# frame {n_popped}  fps {amm.fps.value():.2f}",
                file=sys.stderr,
            )

    try:
        if args.source == "synthetic":
            # device-resident rotating frame sets: they skip the upload
            # rings, so the measured fps is the pipeline's rate without
            # H2D transfers
            rng = np.random.default_rng(0)
            K = 4
            sets = [
                [
                    torch.from_numpy(
                        rng.integers(
                            16, 235, (h_in * 3 // 2, w_in), dtype=np.uint8
                        )
                    ).to(device)
                    for _ in range(n_inputs)
                ]
                for _ in range(K)
            ]
            print(f"# synthetic source: {K} rotating device-resident "
                  f"frame sets", file=sys.stderr)
            for n in range(args.frames):
                amm.push(sets[n % K])
                n_pushed += 1
                while not amm._out_q.empty() or (n_pushed - n_popped) >= 3:
                    drain_one()
        else:
            while not eof:
                frames = []
                for r in readers:
                    item = r.next()
                    if item is None:
                        eof = True
                        break
                    frames.append(to420(item[1]))
                if eof:
                    break
                amm.push(frames)
                n_pushed += 1
                # drain opportunistically to keep the pipeline at depth
                while not amm._out_q.empty() or (n_pushed - n_popped) >= 3:
                    drain_one()
                if args.frames and n_pushed >= args.frames:
                    break
        amm.close_input()  # flush any partial sharded batch
        while n_popped < n_pushed:
            drain_one()
    finally:
        amm.close()
        for r in readers or []:
            r.close()
        for wtr in writers:
            wtr.close()
        if shm is not None:
            shm.close()
    timer.tick(f"{n_popped} frames")
    dt = time.time() - t_start
    if n_popped and dt > 0:
        print(
            f"# done: {n_popped} frames, end-to-end {n_popped/dt:.2f} fps "
            f"(incl. read + H2D + D2H + write)",
            file=sys.stderr,
        )
    else:
        print(f"# done: {n_popped} frames", file=sys.stderr)
    if device.type == "cuda":
        from ..ops import cuda_remap

        print(f"# remap launches: {cuda_remap.LAUNCHES} {cuda_remap.COUNTS}", file=sys.stderr)


if __name__ == "__main__":
    main()
