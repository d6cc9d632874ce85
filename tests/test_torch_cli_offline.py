"""The port's offline and operator CLIs against the JAX package's on the
CPU (the port under OCTVR_PLATFORM=cpu), on the same rigs, PNGs and raw
files:

* ``dump``: the ``.dat`` bytes equal to the JAX CLI's, with graph-cut
  seams from PNGs, with control-point morphing (``-c``), without ROI
  crops (``-n``), and the ``.npz`` and the debug PNGs (``-d``) with the
  dp seams;
* ``gain_and_remap``: the ``.gain.png`` and ``.defish-K.png`` outputs
  within 1 LSB of the JAX CLI's (the block gains are solved by torch on
  one side and JAX on the other; tests/test_torch_gain.py holds them at
  rtol 1e-5);
* ``live``: end to end as a process on tests/test_live_runner.py's
  scene, its panorama within the Mapper bars of the JAX ``live``'s (Y
  and UV mean abs < 0.2, max <= 2); its children are the port's modules,
  and ``--encrypt_args`` hands the stream child the same arguments as
  one blob;
* the helpers ``sinks``, ``console`` and ``inputs``: the cases of
  tests/test_console_sinks.py and tests/test_inputs.py on the port's
  copies, and the command builders equal to JAX's on the same
  arguments."""

import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from octvr_tpu.cli import dump as jdump
from octvr_tpu.cli import gain_and_remap as jgain
from octvr_tpu.cli import inputs as jinputs
from octvr_tpu.cli import sinks as jsinks
from octvr_tpu.template import compile_rig as jax_compile_rig
from octvr_tpu.template import save_npz as jax_save_npz
from octvr_tpu_torch.cli import console, dump, gain_and_remap, inputs, live, sinks
from octvr_tpu_torch.runtime.preview import PreviewWriter
from octvr_tpu_torch.template import compile_rig
from octvr_tpu_torch.utils import argcrypt
from octvr_tpu_torch.utils.png import read_png, write_png
from rigs import two_fisheye_rig
from test_stitch import render_camera_frames

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PI = math.pi
CAM = 128


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("OCTVR_PLATFORM", "cpu")


def _rig(cam=CAM, control_points=False):
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = cam
    if control_points:
        # tests/test_warpers_morph.py's control point, camera 1 perturbed
        mt = compile_rig(rig, 256, 128)
        ll = np.array([[PI / 2 * 0.95, 0.1]])
        p0, p1 = (cam.obj_to_image(ll)[0] for cam in mt._input_cams)
        rig["control_points"] = [[0, 1, float(p0[0]), float(p0[1]), float(p1[0]) + 0.004, float(p1[1])]]
    return rig


def _pngs(d, seed, cam=CAM):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (cam, cam, 3), dtype=np.uint8)
    paths = []
    for k, img in enumerate((base, np.roll(base, 5, axis=0) // 2 + 60)):
        paths.append(str(d / f"cam{k}.png"))
        write_png(paths[-1], img)
    return paths


DUMP_CASES = {
    "graphcut_pngs": (["--seam", "graphcut"], True, False),
    "control_points": (["-c"], False, True),
    "no_roi": (["-n"], False, False),
    "auto_pngs_no_roi": (["-n"], True, False),
}


@pytest.mark.parametrize("case", sorted(DUMP_CASES))
def test_dump_dat_bytes_equal_jax(case, tmp_path, on_cpu):
    flags, with_images, cps = DUMP_CASES[case]
    rig_path = tmp_path / "rig.json"
    rig_path.write_text(json.dumps(_rig(control_points=cps)))
    images = _pngs(tmp_path, seed=11) if with_images else []
    args = ["-w", "256", "-h", "128", *flags, str(rig_path), *images]
    jdump.main(["-o", str(tmp_path / "jax.dat"), *args])
    dump.main(["-o", str(tmp_path / "port.dat"), *args])
    got, want = (tmp_path / "port.dat").read_bytes(), (tmp_path / "jax.dat").read_bytes()
    assert len(got) > 1000 and got == want


def test_dump_npz_and_debug_pngs_equal_jax(tmp_path, on_cpu):
    rig_path = tmp_path / "rig.json"
    rig_path.write_text(json.dumps(_rig()))
    images = _pngs(tmp_path, seed=12)
    for pkg, main in (("jax", jdump.main), ("port", dump.main)):
        main(["-w", "256", "-o", str(tmp_path / f"{pkg}.npz"), "-d", str(tmp_path / pkg), "--seam", "dp_grad",
              str(rig_path), *images])
    jz, pz = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(jz.files) == sorted(pz.files)
    for k in jz.files:
        assert np.array_equal(jz[k], pz[k]), k
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for n in names:
        assert np.array_equal(read_png(str(tmp_path / "jax" / n)), read_png(str(tmp_path / "port" / n))), n


def _gain_files(d, cam=CAM):
    """tests/test_gain_and_remap.py's files: a stitch template, one rmap
    template per input (canvas -> source geometry), one defish template
    per input, and two PNGs, the second 1.5x brighter."""
    rig = _rig(cam)
    stitch = str(d / "stitch.npz")
    jax_save_npz(jax_compile_rig(rig, 256, 128), stitch)
    rmaps, defish = [], []
    for i, spec in enumerate(rig["inputs"]):
        rmaps.append(str(d / f"rmap{i}.npz"))
        jax_save_npz(jax_compile_rig({"output": spec, "inputs": [rig["output"]]}, cam, cam), rmaps[-1])
        defish.append(str(d / f"defish{i}.npz"))
        persp = {"type": "perspective", "options": {"aspect_ratio": 1.0, "sf": 1.5}}
        jax_save_npz(jax_compile_rig({"output": persp, "inputs": [spec]}, 96, 96), defish[-1])
    base = np.random.default_rng(0).integers(90, 110, (cam, cam, 3)).astype(np.uint8)
    imgs = {}
    for pkg in ("jax", "port"):
        (d / pkg).mkdir()
        imgs[pkg] = []
        for i, scale in enumerate((1.0, 1.5)):
            imgs[pkg].append(str(d / pkg / f"img{i}.png"))
            write_png(imgs[pkg][-1], np.clip(base.astype(np.float32) * scale, 0, 255).astype(np.uint8))
    return stitch, rmaps, defish, imgs


@pytest.mark.parametrize("defish", [False, True], ids=["gain_png", "defish_png"])
def test_gain_and_remap_matches_jax(tmp_path, on_cpu, defish):
    stitch, rmaps, defish_paths, imgs = _gain_files(tmp_path)
    extra = defish_paths if defish else []
    assert jgain.main([stitch, *imgs["jax"], *rmaps, *extra]) == 0
    assert gain_and_remap.main([stitch, *imgs["port"], *rmaps, *extra]) == 0
    suffix = ".defish-1.png" if defish else ".gain.png"
    for a, b in zip(imgs["port"], imgs["jax"]):
        got, want = read_png(a + suffix).astype(np.int16), read_png(b + suffix).astype(np.int16)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1
        print(f"{os.path.basename(a)}{suffix}: max diff {np.abs(got - want).max()}, "
              f"equal {(got == want).mean():.5f}")
    if not defish:  # the gains pull the exposures together, as in the JAX test
        g0, g1 = (read_png(p + suffix).astype(np.float32) for p in imgs["port"])
        i0, i1 = (read_png(p).astype(np.float32) for p in imgs["port"])
        assert abs(g1.mean() - g0.mean()) < 0.6 * abs(i1.mean() - i0.mean())


def test_gain_and_remap_usage(capsys, on_cpu):
    assert gain_and_remap.main(["stitch.dat"]) == 1
    assert "Usage" in capsys.readouterr().err


def _live_scene(d):
    """tests/test_live_runner.py's scene: two 256^2 fisheyes of the
    analytic world, 4 yuv420p frames a feed."""
    rig = two_fisheye_rig()
    for spec in rig["inputs"]:
        spec["options"]["width"] = spec["options"]["height"] = 256
    (d / "rig.json").write_text(json.dumps(rig))
    for i, f in enumerate(render_camera_frames(rig)):
        with open(d / f"in{i}.yuv", "wb") as fh:
            for _ in range(4):
                fh.write(np.asarray(f).tobytes())
    return str(d / "rig.json"), f"{d}/in0.yuv,{d}/in1.yuv"


def _live_args(rig, feeds, out, work, *extra):
    return ["--rig", rig, "--inputs", feeds, "--in_size", "256x256", "--out_size", "256x128", "--out", out,
            "--blend", "8", "--workdir", work, *extra]


def test_live_session_end_to_end_matches_jax(tmp_path):
    rig, feeds = _live_scene(tmp_path)
    env = dict(os.environ, OCTVR_PLATFORM="cpu")
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-m", f"{pkg}.cli.live",
             *_live_args(rig, feeds, str(tmp_path / f"{pkg}.yuv"), str(tmp_path / f"work_{pkg}"))],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in ("octvr_tpu", "octvr_tpu_torch")
    }
    results = {pkg: p.communicate(timeout=500) for pkg, p in procs.items()}
    for pkg, p in procs.items():
        assert p.returncode == 0, results[pkg][1][-2000:]
        assert "stream finished cleanly" in results[pkg][1]
    frame = 128 * 3 // 2 * 256
    got = np.fromfile(tmp_path / "octvr_tpu_torch.yuv", np.uint8)
    want = np.fromfile(tmp_path / "octvr_tpu.yuv", np.uint8)
    assert got.size == want.size == 4 * frame
    for g, w in zip(got.reshape(-1, 192, 256), want.reshape(-1, 192, 256)):
        d = np.abs(g.astype(np.float32) - w)
        for plane in (d[:128], d[128:]):
            assert plane.mean() < 0.2 and plane.max() <= 2, (plane.mean(), plane.max())
    assert "# device cpu" in results["octvr_tpu_torch"][1]
    # the child's template: the port's dump of the rig, equal to JAX's
    tmpl = {k: np.load(tmp_path / f"work_{k}" / "out0.npz") for k in ("octvr_tpu", "octvr_tpu_torch")}
    for k in tmpl["octvr_tpu"].files:
        assert np.array_equal(tmpl["octvr_tpu"][k], tmpl["octvr_tpu_torch"][k]), k


class _Recorder:
    """Stands in for subprocess.run and subprocess.Popen in live.main:
    records each command and exits 0 at once."""

    def __init__(self):
        self.cmds = []
        self._popen = subprocess.Popen

    def run(self, cmd, **kw):
        self.cmds.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)

    def popen(self, cmd, **kw):
        self.cmds.append(list(cmd))
        return self._popen([sys.executable, "-c", "pass"])


@pytest.mark.parametrize("encrypt", [False, True], ids=["plain", "encrypt_args"])
def test_live_children_are_the_ports(tmp_path, monkeypatch, on_cpu, encrypt):
    rec = _Recorder()
    monkeypatch.setattr(live.subprocess, "run", rec.run)
    monkeypatch.setattr(live.subprocess, "Popen", rec.popen)
    key = bytes(range(32))
    monkeypatch.setenv("OCTVR_ARG_KEY", key.hex())
    rig, feeds = str(tmp_path / "rig.json"), "a.yuv,b.yuv"
    (tmp_path / "rig.json").write_text(json.dumps(_rig(256)))
    extra = ["--encrypt_args"] if encrypt else []
    assert live.main(_live_args(rig, feeds, "o.yuv", str(tmp_path / "w"), "--frames", "3", *extra)) == 0
    dump_cmd, stream_cmd = rec.cmds
    assert dump_cmd[:3] == stream_cmd[:3][:2] + ["octvr_tpu_torch.cli.dump"]
    assert dump_cmd[0] == sys.executable and stream_cmd[2] == "octvr_tpu_torch.cli.stream"
    tmpl = str(tmp_path / "w" / "out0.npz")
    assert dump_cmd[3:] == ["-w", "256", "-h", "128", "-o", tmpl, rig]
    plain = ["--inputs", feeds, "--in_size", "256x256", "--outputs", f"{tmpl}:8:0", "--out", "o.yuv", "--timers",
             "--frames", "3"]
    if encrypt:
        assert stream_cmd[3] == "--args_enc" and len(stream_cmd) == 5
        assert argcrypt.decrypt_args(stream_cmd[4], key) == plain
        assert feeds not in " ".join(stream_cmd)
    else:
        assert stream_cmd[3:] == plain


def test_live_refuses_a_mismatched_rig(tmp_path, on_cpu, capsys):
    (tmp_path / "rig.json").write_text(json.dumps(_rig(256)))
    args = _live_args(str(tmp_path / "rig.json"), "a.yuv", "o.yuv", str(tmp_path / "w"))
    assert live.main(args) == 2
    assert "refusing to start" in capsys.readouterr().err
    rig = _rig(256)
    assert live.validate_rig(rig, 2, (256, 256)) == []
    assert live.validate_rig(rig, 3, (256, 256)) and live.validate_rig(rig, 2, (640, 480))


def test_live_help_says_what_is_encrypted(capsys, on_cpu):
    with pytest.raises(SystemExit):
        live.main(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "never appear" not in text
    assert "stream child's process listing" in text and "still holds the --sink targets" in text


# --------------------------------------------------- sinks, console, inputs


SINK_ARGS = [
    ("hls", "live/out.m3u8", {"bitrate": "8", "gop": "60"}),
    ("pipe", "tcp://127.0.0.1:9000", {"format": "nut"}),
    ("file", "out.mp4", {"codec": "libx265"}),
    ("decklink", "DeckLink 4K", {"fps": "25"}),
    ("rtmp", "rtmp://a/b", {}),
    ("null", "", {}),
]


def test_sink_builders_equal_jax():
    for kind, target, kw in SINK_ARGS:
        assert sinks.sink_output_args(kind, target, **kw) == jsinks.sink_output_args(kind, target, **kw)
    for specs in (["hls:o.m3u8", "file:o.mp4", "pipe:tcp://h:1"], [], ["rtmp:rtmp://h:1935/a/k|bitrate=6|gop=50"]):
        got = sinks.build_delivery_command(3840, 1920, 30, specs, source="/tmp/x.fifo")
        assert got == jsinks.build_delivery_command(3840, 1920, 30, specs, source="/tmp/x.fifo")
        assert sinks.format_command(got) == jsinks.format_command(got)
    assert sinks.SINK_KINDS == jsinks.SINK_KINDS


def test_sink_arg_blocks_mirror_reference():
    """tests/test_console_sinks.py's blocks (mainwindow.cpp:114-165)."""
    assert sinks.sink_output_args("hls", "live/out.m3u8", bitrate="8", gop="60") == [
        "-c:v", "libx264", "-pix_fmt", "yuv420p", "-b:v", "8M", "-g", "60", "-f", "hls", "-hls_time", "2",
        "-hls_list_size", "4", "-hls_flags", "delete_segments", "-hls_allow_cache", "0", "-y", "live/out.m3u8",
    ]
    assert sinks.sink_output_args("decklink", "DeckLink 4K", fps="25") == [
        "-pix_fmt", "uyvy422", "-f", "decklink", "-r", "25", "-vsync", "drop", "-preroll", "0.5", "DeckLink 4K",
    ]
    assert sinks.sink_output_args("null", "") == ["-c:v", "rawvideo", "-f", "null", "-"]
    kind, target, kw = sinks.parse_sink_spec("rtmp:rtmp://host:1935/app/key|bitrate=6|gop=50")
    assert (kind, target, kw) == ("rtmp", "rtmp://host:1935/app/key", {"bitrate": "6", "gop": "50"})
    for bad in ("webrtc:whatever", "hls:a.m3u8|nonsense=1"):
        with pytest.raises(ValueError):
            sinks.parse_sink_spec(bad)
    cmd = sinks.build_delivery_command(3840, 1920, 30, ["hls:o.m3u8", "file:o.mp4", "pipe:tcp://h:1"],
                                       source="/tmp/x.fifo")
    assert cmd[0] == "ffmpeg" and cmd[cmd.index("-s") + 1] == "3840x1920" and cmd.count("-map") == 3
    empty = sinks.build_delivery_command(64, 32, 30, [])
    assert empty.count("-map") == 1 and empty[-2:] == ["null", "-"]


def test_supervisor_stop_and_restart(tmp_path):
    """tests/test_console_sinks.py's case on the port's LiveSupervisor:
    an operator restart relaunches without using a failure attempt; an
    operator stop exits 0."""
    marker = tmp_path / "starts"
    cmd = [sys.executable, "-c", f"import time; open({str(marker)!r}, 'a').write('x\\n'); time.sleep(30)"]
    sup = live.LiveSupervisor(cmd, restarts=0)
    th = threading.Thread(target=lambda: setattr(sup, "_rc", sup.run()))
    th.start()

    def wait_for(n):
        deadline = time.time() + 20
        while time.time() < deadline and not (marker.exists() and len(marker.read_text().splitlines()) >= n):
            time.sleep(0.05)

    wait_for(1)
    sup.restart()
    wait_for(2)
    sup.stop()
    th.join(timeout=20)
    assert not th.is_alive() and sup._rc == 0
    assert len(marker.read_text().splitlines()) == 2 and sup.restart_count == 1


def test_supervisor_gives_up_after_retries():
    sup = live.LiveSupervisor([sys.executable, "-c", "raise SystemExit(7)"], restarts=1)
    assert sup.run() == 4
    assert sup.state == "failed" and sup.attempt == 2 and sup.returncode == 7


class _FakeSup:
    state = "running"
    attempt = 0
    restart_count = 3
    stopped = False

    def stop(self):
        self.stopped = True

    def restart(self):
        pass


def test_console_state_reads_the_ports_preview(tmp_path):
    path = str(tmp_path / "p.shm")
    wr = PreviewWriter(path, 32, 16)
    rgb = np.full((16, 32, 3), 200, np.uint8)
    rgb[:, :16] = 10
    wr.write(rgb, fps=29.5, frame_no=7)
    sup = _FakeSup()
    cs = console.ConsoleState(sup, path)
    text = "\n".join(cs.status_lines())
    assert "restarts: 3" in text and "frame 7" in text and "29.50" in text
    strip = console.ascii_preview(rgb)
    assert strip[0] != strip[-1] and len(strip) == 48
    assert cs.handle_key("q") is True and sup.stopped
    cs.close()
    wr.close()
    absent = console.ConsoleState(_FakeSup(), str(tmp_path / "absent.shm"))
    assert any("no preview" in ln for ln in absent.status_lines())


def _fake_cams(mod):
    return [
        mod.CameraInfo(
            device=dev, name="Fake SDI Capture", driver="fakedrv",
            formats={
                "MJPG": {(3840, 2160): [30.0, 25.0], (1920, 1080): [60.0, 30.0]},
                "UYVY": {(1920, 1080): [30.0, 25.0], (1280, 720): [60.0]},
            },
        )
        for dev in ("/dev/video7", "/dev/video9")
    ]


@pytest.mark.parametrize("request_", [(1280, 720, 30.0), (1920, 1080, 27.0), (3840, 2160, 30.0), (640, 480, 60.0)])
def test_capture_negotiation_equals_jax(request_):
    """negotiate_format and build_capture_args equal JAX's on the same
    cameras, and tests/test_inputs.py's expectations hold."""
    w, h, fps = request_
    got = inputs.negotiate_format(_fake_cams(inputs)[0], w, h, fps=fps)
    assert got == jinputs.negotiate_format(_fake_cams(jinputs)[0], w, h, fps=fps)
    args = inputs.build_capture_args(_fake_cams(inputs), w, h, fps=fps)
    assert args == jinputs.build_capture_args(_fake_cams(jinputs), w, h, fps=fps)
    assert args.count("v4l2") == 2 and args[args.index("/dev/video7") - 1] == "-i"
    expected = {(1280, 720): ("UYVY", (1280, 720), 60.0), (1920, 1080): ("UYVY", (1920, 1080), 25.0)}
    if (w, h) in expected:
        assert got == expected[(w, h)]
    if (w, h) == (3840, 2160):
        assert got[:2] == ("UYVY", (1920, 1080))


def test_inputs_cli_reports_no_devices():
    assert isinstance(inputs.enumerate_cameras(), list)
    res = subprocess.run([sys.executable, "-m", "octvr_tpu_torch.cli.inputs"], cwd=ROOT, capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 1 and "no capture devices" in res.stderr
