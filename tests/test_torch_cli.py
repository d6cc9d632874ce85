"""The port's CLIs and the host helpers they stand on, against the JAX
package's on the CPU.

CLIs (``octvr_tpu_torch.cli``, the port under OCTVR_PLATFORM=cpu) on the
same raw files and the same JAX-written templates as the JAX CLIs:
``stream`` (yuv420p and uyvy inputs, .npz and .dat templates, the PNG
and the mmap preview, a bad ``--args_enc`` blob, the sharded and
synthetic sources), ``map`` (``--cpu`` and the Mapper), ``monkey`` (raw
file, TCP, unequal feeds, the FramePair rendezvous) and ``monkey_gen``.
Helpers: ``utils.png``, ``utils.argcrypt``, ``runtime.native_io`` (the
native library and the Python path), ``runtime.preview``, the
interleaved colour functions, ``template.compiler._remap_image_cpu`` and
``presets``.

Tolerances: bit-equal for the numpy copies and the file formats (PNG
bytes, argcrypt blobs, preview files, raw frames read back); stitched
frames within the Mapper bars of tests/test_torch_mapper.py (Y and UV
mean abs < 0.2, max <= 2); f32 RGB from YUV within 1e-4 (the JAX and
torch f32 expressions may round differently in the last place).  A PNG
of stitched RGB holds the Mapper bar's mean per channel and a max of 6:
2 on Y plus 1.772 x 2 on chroma, the largest coefficient of the BT.601
matrix, rounded up."""

import base64
import dataclasses
import math
import os
import socket
import struct
import subprocess
import sys
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octvr_tpu import presets as jpresets
from octvr_tpu.cli import map as jmap
from octvr_tpu.cli import monkey as jmonkey
from octvr_tpu.cli import monkey_gen as jmonkey_gen
from octvr_tpu.cli import stream as jstream
from octvr_tpu.ops import color as jcolor
from octvr_tpu.runtime import native_io as jnative_io
from octvr_tpu.runtime import preview as jpreview
from octvr_tpu.template import compile_rig as jax_compile_rig
from octvr_tpu.template.compiler import _remap_image_cpu as jax_remap_image_cpu
from octvr_tpu.template.io import dump_dat, save_npz
from octvr_tpu.utils import argcrypt as jargcrypt
from octvr_tpu.utils import png as jpng
from octvr_tpu_torch import presets
from octvr_tpu_torch.cli import map as tmap
from octvr_tpu_torch.cli import monkey as tmonkey
from octvr_tpu_torch.cli import monkey_gen as tmonkey_gen
from octvr_tpu_torch.cli import stream as tstream
from octvr_tpu_torch.ops import color
from octvr_tpu_torch.runtime import native_io, preview
from octvr_tpu_torch.template.compiler import _remap_image_cpu
from octvr_tpu_torch.utils import argcrypt, png

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PI = math.pi
CAM = 128
N_FRAMES = 6
OUT_W, OUT_H = 128, 64
FRAME_BYTES = OUT_W * OUT_H * 3 // 2


def _rig(cam=CAM):
    lens = {"width": cam, "height": cam, "hfov": PI * 1.15, "center_dx": 0.0,
            "center_dy": 0.0, "radial": [0.0, 0.0, 0.0]}
    return {
        "output": {"type": "equirectangular", "options": {}},
        "inputs": [
            {"type": "fullframe_fisheye", "options": dict(lens)},
            {"type": "fullframe_fisheye",
             "options": {**lens, "rotation": {"roll": 0.0, "yaw": PI, "pitch": 0.0}}},
        ],
    }


def _scene_rgb(t, cam, size=CAM):
    """[size, size, 3] f32 RGB of a drifting gradient scene."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size), indexing="ij")
    base = 120 + 60 * np.sin(2 * PI * (xx + 0.1 * t + 0.3 * cam)) * np.cos(2 * PI * yy)
    return np.stack([base, base * 0.9 + 10, base * 1.1 - 10], -1).clip(0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX-written template (.npz and .dat), yuv420p and uyvy raw feeds
    of 6 frames per camera, and one PNG per camera."""
    d = tmp_path_factory.mktemp("cli")
    mt = jax_compile_rig(_rig(), OUT_W, OUT_H)
    mt.create_masks()
    save_npz(mt, str(d / "tmpl.npz"))
    with open(d / "tmpl.dat", "wb") as f:
        dump_dat(mt, f)
    yuv, uyvy, pngs = [], [], []
    for cam in range(2):
        with open(d / f"cam{cam}.yuv", "wb") as fy, open(d / f"cam{cam}.uyvy", "wb") as fu:
            for t in range(N_FRAMES):
                rgb = _scene_rgb(t, cam)
                fy.write(color.rgb_to_yuv420p(torch.from_numpy(rgb)).numpy().tobytes())
                y, u, v = color.split_yuv420p(color.rgb_to_yuv420p(torch.from_numpy(rgb)))
                u422, v422 = (c.repeat_interleave(2, 0) for c in (u, v))
                fu.write(color.merge_uyvy(y, u422, v422).numpy().tobytes())
        yuv.append(str(d / f"cam{cam}.yuv"))
        uyvy.append(str(d / f"cam{cam}.uyvy"))
        pngs.append(str(d / f"cam{cam}.png"))
        jpng.write_png(pngs[-1], _scene_rgb(0, cam).astype(np.uint8))
    return {"dir": d, "npz": str(d / "tmpl.npz"), "dat": str(d / "tmpl.dat"),
            "yuv": yuv, "uyvy": uyvy, "png": pngs, "mt": mt}


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("OCTVR_PLATFORM", "cpu")


def assert_mapper_bars(out, ref):
    h = ref.shape[0] * 2 // 3
    d = np.abs(out.astype(np.float32) - ref.astype(np.float32))
    for plane in (d[:h], d[h:]):
        assert plane.mean() < 0.2, plane.mean()
        assert plane.max() <= 2, plane.max()


def assert_rgb_bars(a, b):
    d = np.abs(a.astype(np.float32) - b.astype(np.float32))
    assert d.shape == a.shape and d.reshape(-1, 3).mean(0).max() < 0.2 and d.max() <= 6, (d.mean(), d.max())


# ------------------------------------------------------------------ stream


@pytest.mark.parametrize("fmt", ["yuv420p", "uyvy"])
def test_stream_cli_matches_jax(files, on_cpu, tmp_path, fmt):
    """Both stream CLIs on the same raw feeds and template (.npz for
    yuv420p, .dat for uyvy), with the PNG preview every 2 frames and the
    mmap preview: every frame within the Mapper bars, the PNGs within
    the RGB bars, and each package's preview file read by the other's
    reader."""
    tmpl = files["npz"] if fmt == "yuv420p" else files["dat"]
    feeds = files["yuv"] if fmt == "yuv420p" else files["uyvy"]
    outs = {}
    for name, cli in (("jax", jstream), ("port", tstream)):
        cli.main([
            "--inputs", ",".join(feeds), "--in_size", f"{CAM}x{CAM}", "--in_format", fmt,
            "--outputs", f"{tmpl}:8:0", "--out", str(tmp_path / f"{name}.yuv"), "--pipeline", "rgb",
            "--preview", str(tmp_path / f"{name}_"), "--preview_interval", "2",
            "--preview_shm", str(tmp_path / f"{name}.shm"), "--preview_size", "64x32",
        ])
        outs[name] = np.fromfile(tmp_path / f"{name}.yuv", np.uint8)
    assert len(outs["port"]) == len(outs["jax"]) == N_FRAMES * FRAME_BYTES
    for a, b in zip(outs["port"].reshape(N_FRAMES, -1), outs["jax"].reshape(N_FRAMES, -1)):
        assert_mapper_bars(a.reshape(OUT_H * 3 // 2, OUT_W), b.reshape(OUT_H * 3 // 2, OUT_W))
    for n in range(0, N_FRAMES, 2):
        assert_rgb_bars(png.read_png(tmp_path / f"port_{n:06d}.png"), jpng.read_png(tmp_path / f"jax_{n:06d}.png"))
    got = {}
    for writer, reader_mod in (("port", jpreview), ("jax", preview)):
        r = reader_mod.PreviewReader(str(tmp_path / f"{writer}.shm"))
        got[writer] = r.read()
        r.close()
    (prgb, _, pno), (jrgb, _, jno) = got["port"], got["jax"]
    assert prgb.shape == (32, 64, 3) and pno == jno == N_FRAMES - 1
    assert np.abs(prgb.astype(np.float32) - jrgb.astype(np.float32)).max() <= 6


def test_stream_cli_sharded_synthetic_and_checksum(files, on_cpu, tmp_path):
    """The port's stream CLI through ShardedMapper (2x2, an odd frame
    count, a gain copier equal to its owner), the synthetic source and
    the checksum drain (writers skipped)."""
    base = ["--in_size", f"{CAM}x{CAM}", "--pipeline", "yuv420"]
    o0, o1 = tmp_path / "o0.yuv", tmp_path / "o1.yuv"
    tstream.main(base + [
        "--inputs", ",".join(files["yuv"]), "--outputs", f"{files['npz']}:8:0,{files['npz']}:8:0",
        "--out", f"{o0},{o1}", "--sharded", "2x2", "--frames", "5",
    ])
    a, b = o0.read_bytes(), o1.read_bytes()
    assert len(a) == 5 * FRAME_BYTES and a == b
    syn = tmp_path / "syn.yuv"
    tstream.main(base + ["--outputs", f"{files['npz']}:8:0", "--out", str(syn), "--source", "synthetic", "--frames", "5"])
    data = np.fromfile(syn, np.uint8)
    assert len(data) == 5 * FRAME_BYTES and data[:FRAME_BYTES].std() > 1.0
    chk = tmp_path / "chk.yuv"
    tstream.main(base + ["--outputs", f"{files['npz']}:8:0", "--out", str(chk), "--source", "synthetic",
                         "--frames", "9", "--drain", "checksum"])
    assert chk.read_bytes() == b""
    with pytest.raises(SystemExit, match="requires --frames"):
        tstream.main(base + ["--outputs", f"{files['npz']}:8:0", "--out", str(chk), "--source", "synthetic"])


def test_stream_cli_args_enc(files, on_cpu, tmp_path, monkeypatch):
    """--args_enc: a blob made by the JAX package runs the port's stream;
    a bad blob prints one line to stderr and exits with EXIT_BAD_ARGS,
    no traceback."""
    key = "11" * 32
    monkeypatch.setenv("OCTVR_ARG_KEY", key)
    out = tmp_path / "enc.yuv"
    argv = ["--inputs", ",".join(files["yuv"]), "--in_size", f"{CAM}x{CAM}", "--outputs",
            f"{files['npz']}:8:0", "--out", str(out), "--frames", "2"]
    tstream.main(["--args_enc", jargcrypt.encrypt_args(argv, bytes.fromhex(key))])
    assert len(out.read_bytes()) == 2 * FRAME_BYTES
    res = subprocess.run(
        [sys.executable, "-m", "octvr_tpu_torch.cli.stream", "--args_enc", "not-a-blob"],
        cwd=ROOT, env=dict(os.environ), capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == tstream.EXIT_BAD_ARGS, res.stderr
    assert "Traceback" not in res.stderr and len(res.stderr.strip().splitlines()) == 1
    assert "base64" in res.stderr and res.stdout == ""


# --------------------------------------------------------------------- map


def test_map_cli_cpu_bit_equal(files, tmp_path):
    """map --cpu: the numpy remap and seam paste, the same PNG bytes."""
    for name, cli in (("jax", jmap), ("port", tmap)):
        cli.main(["-t", files["npz"], "-o", str(tmp_path / f"{name}.png"), "--cpu"] + files["png"])
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_map_cli_matches_jax(files, on_cpu, tmp_path, capfd):
    """map through the Mapper (blend 8, gains): the RGB within the RGB
    bars, the printed gains within 1e-3."""
    gains = {}
    for name, cli in (("jax", jmap), ("port", tmap)):
        cli.main(["-t", files["dat"], "-o", str(tmp_path / f"{name}.png"), "--blend", "8", "--gain"]
                 + files["png"])
        line = [s for s in capfd.readouterr().err.splitlines() if s.startswith("gains:")][0]
        gains[name] = np.array(line.split("[")[1].split("]")[0].split(), np.float32)
    assert_rgb_bars(png.read_png(tmp_path / "port.png"), jpng.read_png(tmp_path / "jax.png"))
    assert np.abs(gains["port"] - gains["jax"]).max() < 1e-3


# ------------------------------------------------------------------ monkey


def _nv12_feeds(d, lens, seed):
    feeds = []
    for cam, n in enumerate(lens):
        rng = np.random.default_rng(seed + cam)
        p = d / f"m{seed}_{cam}.nv12"
        with open(p, "wb") as f:
            for _ in range(n):
                yuv = torch.from_numpy(rng.integers(16, 235, (CAM * 3 // 2, CAM), dtype=np.uint8))
                f.write(color.merge_nv12(*color.split_yuv420p(yuv)).numpy().tobytes())
        feeds.append(str(p))
    return feeds


def _monkey_args(files, feeds):
    return ["-t", files["npz"], "--inputs", ",".join(feeds), "--in_size", f"{CAM}x{CAM}"]


def test_monkey_cli_matches_jax(files, on_cpu, tmp_path):
    """monkey to a raw file: the same number of NV12 frames, each within
    the Mapper bars of the JAX CLI's."""
    feeds = _nv12_feeds(tmp_path, (4, 4), seed=0)
    for name, cli in (("jax", jmonkey), ("port", tmonkey)):
        assert cli.main(_monkey_args(files, feeds) + ["--out", str(tmp_path / f"{name}.nv12")]) == 0
    a = np.fromfile(tmp_path / "port.nv12", np.uint8).reshape(4, OUT_H * 3 // 2, OUT_W)
    b = np.fromfile(tmp_path / "jax.nv12", np.uint8).reshape(4, OUT_H * 3 // 2, OUT_W)
    for x, y in zip(a, b):
        assert_mapper_bars(x, y)
    assert a[0, :OUT_H].std() > 1.0


def test_monkey_cli_tcp_and_unequal_feeds(files, on_cpu, tmp_path):
    """The TCP sink: length-prefixed frames equal to the raw sink's; feeds
    of unequal length end at the shorter one (either one shorter)."""
    feeds = _nv12_feeds(tmp_path, (3, 3), seed=10)
    raw = tmp_path / "raw.nv12"
    assert tmonkey.main(_monkey_args(files, feeds) + ["--out", str(raw)]) == 0
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    received = []

    def server():
        conn, _ = srv.accept()
        conn.settimeout(10)
        buf = b""
        with conn:
            while chunk := conn.recv(65536):
                buf += chunk
        off = 0
        while off + 4 <= len(buf):
            (n,) = struct.unpack_from("<I", buf, off)
            received.append(buf[off + 4 : off + 4 + n])
            off += 4 + n

    th = threading.Thread(target=server, daemon=True)
    th.start()
    assert tmonkey.main(_monkey_args(files, feeds) + ["--tcp", f"127.0.0.1:{srv.getsockname()[1]}"]) == 0
    th.join(timeout=15)
    srv.close()
    assert not th.is_alive() and b"".join(received) == raw.read_bytes()
    assert [len(r) for r in received] == [FRAME_BYTES] * 3

    for lens in ((2, 5), (5, 2)):
        out = tmp_path / f"u{lens[0]}.nv12"
        result = {}
        th = threading.Thread(
            target=lambda: result.update(
                rc=tmonkey.main(_monkey_args(files, _nv12_feeds(tmp_path, lens, seed=20)) + ["--out", str(out)])
            ),
            daemon=True,
        )
        th.start()
        th.join(timeout=60)
        assert not th.is_alive(), f"monkey hung on feeds of {lens} frames"
        assert result["rc"] == 0 and len(out.read_bytes()) == min(lens) * FRAME_BYTES


def test_frame_pair_rendezvous():
    """Back deposits and blocks until front pairs (monkey.cpp:92-130):
    per-feed order and backpressure kept; the parked back producer is
    released when the front feed ends."""
    pair = tmonkey.FramePair()
    got = []
    tb = threading.Thread(target=lambda: [pair.put_back(("b", i)) for i in range(5)])
    tf = threading.Thread(target=lambda: [got.append(pair.pair_front(("f", i))) for i in range(5)])
    tb.start()
    tf.start()
    tb.join(timeout=10)
    tf.join(timeout=10)
    assert not tb.is_alive() and not tf.is_alive()
    assert got == [(("b", i), ("f", i)) for i in range(5)]

    pair = tmonkey.FramePair()
    released = threading.Event()
    tb = threading.Thread(target=lambda: (pair.put_back(("b", 0)), released.set()), daemon=True)
    tb.start()
    assert not released.wait(timeout=0.3)  # parked: nobody pairs it
    pair.finish_front()
    assert released.wait(timeout=5.0)
    tb.join(timeout=5)
    assert not tb.is_alive()
    pair = tmonkey.FramePair()
    pair.finish_back()
    assert pair.pair_front(("f", 0)) is None  # the back feed ended with nothing pending


def test_monkey_gen_pngs_bit_equal(files, tmp_path, capsys):
    for name, cli in (("jax", jmonkey_gen), ("port", tmonkey_gen)):
        cli.main(["-t", files["npz"], "-o", str(tmp_path / name), "--border", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[:2] == lines[2:]
    for i in range(2):
        a = (tmp_path / "port" / f"weight_{i}.png").read_bytes()
        assert a == (tmp_path / "jax" / f"weight_{i}.png").read_bytes()


# ----------------------------------------------------------------- helpers


def _png_with_filters(img, seed):
    """A PNG of ``img`` whose rows carry random filter bytes 0-4 (raw row
    bytes kept as given: any filter decodes to a defined image)."""
    h, w, nch = img.shape
    ftype = np.random.default_rng(seed).integers(0, 5, h).astype(np.uint8)
    rows = np.concatenate([ftype[:, None], img.reshape(h, w * nch)], axis=1)
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[nch]

    def chunk(ctype, payload):
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(">I", zlib.crc32(ctype + payload))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


@pytest.mark.parametrize("nch", [1, 2, 3, 4])
def test_png_matches_jax(nch):
    rng = np.random.default_rng(nch)
    img = rng.integers(0, 256, (17, 23, nch), dtype=np.uint8)
    enc = png.encode_png(img if nch > 1 else img[..., 0])
    assert enc == jpng.encode_png(img if nch > 1 else img[..., 0])
    assert np.array_equal(png.decode_png(enc), jpng.decode_png(enc))
    filtered = _png_with_filters(img, seed=nch)
    assert np.array_equal(png.decode_png(filtered), jpng.decode_png(filtered))


def test_argcrypt_across_packages(monkeypatch):
    """A blob made by either package decrypts in the other (the format is
    shared: the empty argument list and a list of one empty argument both
    come back as [], as in the JAX package); a tampered blob or a wrong
    key raises ArgCryptError in both."""
    key = bytes(range(32))
    argv = ["--inputs", "a,b", "--out", "rtmp://host/live?key=x y", "ü"]
    for enc, dec in ((argcrypt, jargcrypt), (jargcrypt, argcrypt)):
        blob = enc.encrypt_args(argv, key)
        assert dec.decrypt_args(blob, key) == argv
        monkeypatch.setenv("OCTVR_ARG_KEY", key.hex())
        assert dec.maybe_decrypt_argv(["--args_enc", blob]) == argv
        for empty in ([], [""]):
            assert dec.decrypt_args(enc.encrypt_args(empty, key), key) == []
        raw = bytearray(base64.b64decode(blob))
        raw[20] ^= 1
        for bad, k in ((base64.b64encode(bytes(raw)).decode(), key), (blob, bytes(32)), ("%%%", key)):
            with pytest.raises(dec.ArgCryptError):
                dec.decrypt_args(bad, k)
    assert argcrypt.maybe_decrypt_argv(["--out", "x"]) == ["--out", "x"]
    with pytest.raises(argcrypt.ArgCryptError, match="not set"):
        argcrypt.load_key({"HOME": "/"})


@pytest.fixture(params=["native", "python"])
def io_path(request, monkeypatch):
    """The native library, or the Python path forced by hiding it."""
    if request.param == "python":
        monkeypatch.setattr(native_io, "_lib", False)
        monkeypatch.setattr(jnative_io, "_lib", False)
    else:
        assert native_io.native_available(), "native/liboctvr_io.so does not load"
    return request.param


@pytest.mark.parametrize("fmt", ["yuv420p", "uyvy"])
def test_frame_io_matches_jax(io_path, tmp_path, fmt):
    """FrameWriter output byte-equal to the JAX writer's; FrameReader
    reads every frame back in order and then None, on both IO paths."""
    assert native_io.native_available() == (io_path == "native")
    w, h = 16, 8
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (h * 3 // 2, w), dtype=np.uint8) for _ in range(5)]
    for mod, name in ((native_io, "port"), (jnative_io, "jax")):
        wr = mod.FrameWriter(str(tmp_path / f"{name}.raw"), w, h)
        for f in frames:
            wr.push(f)
        wr.close()
    data = (tmp_path / "port.raw").read_bytes()
    assert data == (tmp_path / "jax.raw").read_bytes() == b"".join(f.tobytes() for f in frames)
    # read the same bytes back as the format's frames
    r = native_io.FrameReader(str(tmp_path / "port.raw"), w if fmt == "yuv420p" else w * 3 // 4, h, fmt=fmt)
    got = []
    while (item := r.next()) is not None:
        got.append(item)
    r.close()
    size = r.frame_size
    assert [i for i, _ in got] == list(range(len(data) // size))
    assert b"".join(f.tobytes() for _, f in got) == data[: len(got) * size]
    assert all(f.shape == r.frame_shape for _, f in got)


def test_preview_files_across_packages(tmp_path):
    """The same writes give the same file bytes in both packages, and each
    reader reads the other's writer."""
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, (24, 40, 3), dtype=np.uint8) for _ in range(3)]
    for mod, name in ((preview, "port"), (jpreview, "jax")):
        wr = mod.PreviewWriter(str(tmp_path / f"{name}.shm"), 40, 24)
        for n, f in enumerate(frames):
            wr.write(f, fps=29.97, frame_no=n)
        wr.close()
    assert (tmp_path / "port.shm").read_bytes() == (tmp_path / "jax.shm").read_bytes()
    assert os.path.getsize(tmp_path / "port.shm") == preview.preview_size_bytes(40, 24)
    for mod, name in ((jpreview, "port"), (preview, "jax")):
        r = mod.PreviewReader(str(tmp_path / f"{name}.shm"))
        rgb, fps, no = r.read()
        r.close()
        assert np.array_equal(rgb, frames[-1]) and fps == 29.97 and no == 2


_COLOUR = {
    "yuv420p_to_rgb": (lambda rng: rng.integers(0, 256, (48, 64), dtype=np.uint8), 1e-4),
    "nv12_to_rgb": (lambda rng: rng.integers(0, 256, (48, 64), dtype=np.uint8), 1e-4),
    "rgb_to_yuv420p": (lambda rng: np.round(rng.uniform(0, 255, (32, 64, 3))).astype(np.float32), 0),
    "rgb_to_nv12": (lambda rng: rng.uniform(0, 255, (32, 64, 3)).astype(np.float32), 0),
    "uyvy_to_yuv420p": (lambda rng: rng.integers(0, 256, (32, 128), dtype=np.uint8), 0),
    "split_uyvy": (lambda rng: rng.integers(0, 256, (32, 64, 2), dtype=np.uint8), 0),
}


@pytest.mark.parametrize("name", sorted(_COLOUR))
def test_interleaved_colour_matches_jax(name):
    """The interleaved conversions against the JAX functions of the same
    name: uint8 results bit-equal, f32 RGB within 1e-4."""
    make, tol = _COLOUR[name]
    x = make(np.random.default_rng(len(name)))
    ref = getattr(jcolor, name)(jnp.asarray(x))
    got = getattr(color, name)(torch.from_numpy(x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.numpy().dtype == r.dtype
        if tol:
            assert np.abs(g.numpy() - r).max() < tol
        else:
            assert np.array_equal(g.numpy(), r)
    if name == "split_uyvy":
        assert np.array_equal(color.merge_uyvy(*got).numpy(), np.asarray(jcolor.merge_uyvy(*ref)))
        assert np.array_equal(color.merge_uyvy(*got).numpy(), x.reshape(32, 128))


@pytest.mark.parametrize("kind", ["rgb_u8", "gray_u8", "rgb_f32"])
def test_remap_image_cpu_bit_equal(kind):
    rng = np.random.default_rng(5)
    shape = (40, 56) if kind == "gray_u8" else (40, 56, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "rgb_f32":
        img = img.astype(np.float32) / 3.0
    map1 = rng.uniform(-0.05, 1.05, (30, 70)).astype(np.float32)
    map2 = rng.uniform(-0.05, 1.05, (30, 70)).astype(np.float32)
    map1[::7] = -1.0
    got, ref = _remap_image_cpu(img, map1, map2), jax_remap_image_cpu(img, map1, map2)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_presets_match_jax():
    def modes(mod):
        return {k: {**v, "regions": [dataclasses.asdict(r) for r in v["regions"]]}
                for k, v in mod.PROJECTION_MODES.items()}

    assert modes(presets) == modes(jpresets)
    for mode in sorted(presets.PROJECTION_MODES):
        for width, height in ((1152, 0), (2304, 1024), (641, 0)):
            got = presets.build_region_outputs(mode, width, height)
            assert got == jpresets.build_region_outputs(mode, width, height), (mode, width)
            (W, H), outs = got
            rects = [o["rect"] for o in outs]
            rng = np.random.default_rng(width)
            frames = [rng.integers(0, 256, (r[3], r[2], 3), dtype=np.uint8) for r in rects]
            canvas = presets.RegionComposer((W, H), rects).compose(frames)
            assert np.array_equal(canvas, jpresets.RegionComposer((W, H), rects).compose(frames))
