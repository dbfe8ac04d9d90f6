"""The port's host tools, observability, memory sizing, languages and
settings against the JAX package.

- ``scene_detect``: ``rgb_to_hsv_np``, ``content_score`` and
  ``detect_scenes`` equal the JAX functions on seeded frames with two hard
  cuts (the same floats, the same cuts); ``scenes --split`` writes one
  ``.y4m`` per scene (no ffmpeg) of 16 frames, byte-identical to the JAX
  CLI's, and prints the JAX CLI's lines.
- ``frames --extract`` then ``--assemble`` gives the clip's frames back
  (PNG through the port's codec); the JAX CLI reads the port's PNG folder
  into the same video.
- ``audio``: the ffmpeg command construction, and without ffmpeg the JAX
  package's RuntimeError.
- ``FpsMeter``, ``RenderControl``, ``stage_timer``, ``make_control_check``
  and ``dynamic_batch_size`` (with an explicit byte count: the port reads
  no memory off the card) as in ``tests/test_utils_config.py``, equal to
  the JAX results.
- ``i18n``: every key of every pack equals the JAX ``catalog(lang)``;
  ``--lang fr``, ``--lang=ja`` and ``VD3D_LANG`` switch the CLI's messages;
  every help string of every subcommand goes through ``th`` and is
  translated in every pack, except the port's own flags, listed below by
  name, which stay in English.
- ``settings``: a ``settings.json`` written by either package loads in the
  other.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from visiondepth3d_tpu.cli.main import main as jmain
from visiondepth3d_tpu.config import i18n as ji18n
from visiondepth3d_tpu.io import Y4MReader, Y4MWriter
from visiondepth3d_tpu.utils import scene_detect as jscene
from visiondepth3d_tpu_torch.cli.main import build_parser
from visiondepth3d_tpu_torch.cli.main import main as cli_main
from visiondepth3d_tpu_torch.config import i18n
from visiondepth3d_tpu_torch.utils import scene_detect

LANGS = ("de", "en", "es", "fr", "ja")
# the port's own help strings ((subcommand, flag)), which stay in English:
# flags the JAX CLI does not have or leaves without help, or whose JAX text
# is not true of the port
PORT_OWN_HELP = {("", "description"), ("render", "--device"), ("depth", "--device"),
                 ("tools", "--device"), ("convert", "--device"),
                 ("verify-checkpoints", "--device"), ("render", "--resume"),
                 ("render", "--mesh"), ("depth", "--mesh"), ("tools", "--mesh"),
                 ("tools", "--dtype"), ("render", "--checkpoint"), ("depth", "--checkpoint"),
                 ("render", "--dry-run"), ("depth", "--overlap"), ("preview", "--device"),
                 ("serve", "--device")}


@pytest.fixture(autouse=True)
def _english():
    yield
    i18n.set_language("en")
    ji18n.set_language("en")


def _scene_frames(n=48, h=36, w=48, cuts=(16, 32), seed=0):
    """A slow pan with hard cuts: each scene its own hue and texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames, scene = [], 0
    base = rng.integers(0, 256, (len(cuts) + 1, 3))
    for i in range(n):
        scene += i in cuts
        f = np.empty((h, w, 3), np.uint8)
        for c in range(3):
            f[..., c] = (base[scene, c] + (xx + i) * (c + 1) * (scene + 1) + yy * 3) % 256
        frames.append(f)
    return frames


def test_scene_detect_matches_jax():
    frames = _scene_frames()
    for a, b in zip(frames[:-1], frames[1:]):
        np.testing.assert_array_equal(scene_detect.rgb_to_hsv_np(a), jscene.rgb_to_hsv_np(a))
        assert scene_detect.content_score(scene_detect.rgb_to_hsv_np(a),
                                          scene_detect.rgb_to_hsv_np(b)) == \
            jscene.content_score(jscene.rgb_to_hsv_np(a), jscene.rgb_to_hsv_np(b))
    from visiondepth3d_tpu_torch.utils import detect_scenes, scenes_to_spans

    cuts = detect_scenes(iter(frames))
    assert cuts == jscene.detect_scenes(iter(frames)) == [0, 16, 32]
    assert detect_scenes(frames, threshold=1e9) == [0]
    assert detect_scenes(frames, min_scene_len=20) == jscene.detect_scenes(frames,
                                                                           min_scene_len=20)
    assert scenes_to_spans(cuts, 48) == jscene.scenes_to_spans(cuts, 48)


def test_cli_scenes_split_writes_y4m_scenes(tmp_path, capsys):
    frames = _scene_frames()
    clip = tmp_path / "clip.y4m"
    with Y4MWriter(str(clip), 48, 36, 24.0) as wr:
        for f in frames:
            wr.write(f)
    assert jmain(["scenes", "--input", str(clip)]) == 0
    want = capsys.readouterr().out
    assert cli_main(["scenes", "--input", str(clip)]) == 0
    assert capsys.readouterr().out == want
    assert cli_main(["scenes", "--input", str(clip), "--split", "--output",
                     str(tmp_path / "sc")]) == 0
    out = capsys.readouterr().out
    assert jmain(["scenes", "--input", str(clip), "--split", "--output",
                  str(tmp_path / "jsc")]) == 0
    assert capsys.readouterr().out.replace("jsc", "sc") == out
    names = sorted(os.listdir(tmp_path / "sc"))
    assert names == sorted(os.listdir(tmp_path / "jsc")) == \
        [f"clip-Scene-00{i}.y4m" for i in (1, 2, 3)]
    for name in names:
        with Y4MReader(str(tmp_path / "sc" / name)) as rd:
            assert len(list(rd)) == 16
        assert (tmp_path / "sc" / name).read_bytes() == (tmp_path / "jsc" / name).read_bytes()


def test_cli_frames_extract_then_assemble(tmp_path, capsys):
    frames = _scene_frames(n=6)
    clip = tmp_path / "clip.y4m"
    with Y4MWriter(str(clip), 48, 36, 24.0) as wr:
        for f in frames:
            wr.write(f)
    with Y4MReader(str(clip)) as rd:
        ref = np.stack(list(rd))
    assert cli_main(["frames", "--extract", str(clip), "--output", str(tmp_path / "f")]) == 0
    assert sorted(os.listdir(tmp_path / "f")) == [f"frame_{i:05d}.png" for i in range(6)]
    assert cli_main(["frames", "--assemble", str(tmp_path / "f"), "--output",
                     str(tmp_path / "back.y4m"), "--fps", "24"]) == 0
    with Y4MReader(str(tmp_path / "back.y4m")) as rd:
        back = np.stack(list(rd))
    assert back.shape == ref.shape
    # one more 4:2:0 round trip of the decoded frames: the JAX CLI's assemble
    # of the same folder gives the same bytes
    assert jmain(["frames", "--assemble", str(tmp_path / "f"), "--output",
                  str(tmp_path / "jax.y4m")]) == 0
    assert (tmp_path / "jax.y4m").read_bytes() == (tmp_path / "back.y4m").read_bytes()
    assert cli_main(["frames", "--extract", str(clip), "--output", str(tmp_path / "g"),
                     "--step", "2"]) == 0
    assert len(os.listdir(tmp_path / "g")) == 3
    capsys.readouterr()
    assert cli_main(["frames", "--output", "x"]) == 2
    assert jmain(["frames", "--output", "x"]) == 2


def test_audio_commands_and_missing_ffmpeg(monkeypatch):
    from visiondepth3d_tpu.io import audio as jaudio
    from visiondepth3d_tpu.io import ffmpeg as jff
    from visiondepth3d_tpu_torch.io import audio
    from visiondepth3d_tpu_torch.io import ffmpeg as ff

    assert audio.AUDIO_CODECS == jaudio.AUDIO_CODECS
    for mod in (ff, jff):
        monkeypatch.setattr(mod, "FFMPEG", "ffmpeg")
    assert ff.rip_audio_cmd("in.mkv", "out.aac", "aac", "192k") == \
        jff.rip_audio_cmd("in.mkv", "out.aac", "aac", "192k")
    assert ff.attach_audio_cmd("v.mp4", "a.aac", "o.mp4", 1.5, True) == \
        jff.attach_audio_cmd("v.mp4", "a.aac", "o.mp4", 1.5, True)
    monkeypatch.setattr(ff, "have_ffmpeg", lambda: False)
    with pytest.raises(RuntimeError, match="require ffmpeg"):
        audio.rip_audio("in.mkv", "out.aac")
    with pytest.raises(RuntimeError, match="require ffmpeg"):
        audio.attach_audio("v.mp4", "a.aac", "o.mp4")
    with pytest.raises(RuntimeError, match="require ffmpeg"):
        cli_main(["audio", "rip", "--input", "in.mkv", "--output", "out.aac"])
    with pytest.raises(RuntimeError, match="require ffmpeg"):
        cli_main(["audio", "attach", "--video", "v.mp4", "--audio", "a.aac", "--output", "o"])
    calls = []
    monkeypatch.setattr(ff, "have_ffmpeg", lambda: True)
    monkeypatch.setattr(ff, "probe_duration", lambda p: 10.0)
    monkeypatch.setattr(audio.subprocess, "run", lambda cmd, check: calls.append(cmd))
    audio.attach_audio("v.mp4", "a.aac", "o.mp4", offset_s=25.0)  # clamped to 10 s
    assert "10.000" in calls[-1] and calls[-1][0] == "ffmpeg"


def test_observability_matches_jax(tmp_path, capsys):
    from visiondepth3d_tpu import utils as jutils
    from visiondepth3d_tpu_torch import utils

    for mod in (utils, jutils):
        m = mod.FpsMeter(total=100)
        for _ in range(5):
            m.tick(10)
        s = m.status()
        assert m.done == 50 and "50.00%" in s and "FPS" in s and "ETA" in s
        assert m.eta_seconds is not None and m.eta_seconds > 0
        rc = mod.RenderControl()
        assert not rc.cancelled and rc.checkpoint() is False
        rc.suspend()
        rc.cancel()
        assert rc.checkpoint() is True
    assert utils.FpsMeter().status().startswith("0 | FPS: 0.00") and \
        jutils.FpsMeter().status().startswith("0 | FPS: 0.00")
    sink: dict = {}
    with utils.stage_timer("decode", sink, sync=torch.zeros(3)):
        time.sleep(0.01)
    with utils.stage_timer("decode", sink):
        pass
    assert len(sink["decode"]) == 2 and sink["decode"][0] >= 0.01
    with utils.stage_timer("print"):
        pass
    assert capsys.readouterr().out.startswith("[stage] print: ")
    ctl = tmp_path / "ctl"
    check = utils.make_control_check(ctl, poll_s=0.01)
    assert check() is False
    ctl.write_text("cancel")
    assert check() is True


def test_crash_logging_and_profiler_trace(tmp_path, monkeypatch):
    import sys
    import threading

    from visiondepth3d_tpu_torch import utils

    monkeypatch.setattr(sys, "excepthook", sys.excepthook)
    monkeypatch.setattr(threading, "excepthook", threading.excepthook)
    log = tmp_path / "crash.log"
    utils.install_crash_logging(log)
    try:
        raise ValueError("boom")
    except ValueError as e:
        sys.excepthook(type(e), e, e.__traceback__)
    assert "ValueError: boom" in log.read_text()
    with utils.profiler_trace(str(tmp_path / "trace")) as d:
        torch.ones(4).sum()
    assert d == str(tmp_path / "trace") and os.listdir(d)


def test_dynamic_batch_size_matches_jax(monkeypatch):
    from visiondepth3d_tpu.utils import memory as jmemory
    from visiondepth3d_tpu_torch.utils.memory import device_memory_bytes, dynamic_batch_size

    for total in (16e9, 80e9, 2e9):
        monkeypatch.setattr(jmemory, "device_hbm_bytes", lambda default_gb=16.0, b=total: b)
        for hw, size in (((1080, 1920), 518), ((360, 640), 256), ((2160, 3840), 1024)):
            assert dynamic_batch_size(hw, size, total_bytes=total) == \
                jmemory.dynamic_batch_size(hw, size)
    assert dynamic_batch_size((360, 640), 256, total_bytes=80e9) >= \
        dynamic_batch_size((2160, 3840), 1024, total_bytes=80e9)
    with pytest.raises(ValueError, match="total_bytes"):
        device_memory_bytes("cpu")
    with pytest.raises(ValueError, match="total_bytes"):
        dynamic_batch_size((1080, 1920), device="cpu")


def test_language_packs_equal_jax():
    assert i18n.available_languages() == ji18n.available_languages() == list(LANGS)
    for lang in LANGS:
        assert i18n.catalog(lang) == ji18n.catalog(lang)
        assert i18n.catalog(lang, ("help.",)) == ji18n.catalog(lang, ("help.",))
    i18n.set_language("fr")
    assert i18n.current_language() == "fr"
    assert "video 3D" in i18n.t("render.start")
    assert i18n.t("error.no_ffmpeg") != "error.no_ffmpeg"  # en fallback
    assert i18n.th("list the depth model catalog") != "list the depth model catalog"
    i18n.set_language("en")
    assert i18n.t("render.done", frames=10, fps=2.5, output="x.y4m") == \
        "Render complete: 10 frames at 2.50 fps -> x.y4m"


@pytest.mark.parametrize("how", ["--lang fr", "--lang=ja", "VD3D_LANG=de"])
def test_cli_lang_switches_messages(how, tmp_path, capsys, monkeypatch):
    lang = how.split("=")[-1].split()[-1]
    args = [] if how.startswith("VD3D") else how.split()
    if how.startswith("VD3D"):
        monkeypatch.setenv("VD3D_LANG", lang)
    src = tmp_path / "in.vd16"
    from visiondepth3d_tpu_torch.io.depth_io import Depth16Writer

    with Depth16Writer(src, 8, 6, 12.0) as wr:
        wr.write(np.zeros((6, 8), np.uint16))
    dst = str(tmp_path / "out.vd16")
    assert cli_main([*args, "convert", "--depth-in", str(src), "--depth-out", dst]) == 0
    out = capsys.readouterr().out
    assert out.strip() == ji18n.catalog(lang)["convert.depth_done"].format(count=1, output=dst)
    assert out.strip() != ji18n.catalog("en")["convert.depth_done"].format(count=1, output=dst)
    with pytest.raises(SystemExit):
        cli_main([*args, "models", "--help"])
    help_text = capsys.readouterr().out
    assert ji18n.catalog(lang)["help.filter by family"] in help_text


def _help_strings(parser, cmd="") -> dict:
    """{(subcommand, flag): help} of a parser and its subparsers."""
    out = {}
    if parser.description:
        out[(cmd, "description")] = parser.description
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for pseudo in action._choices_actions:
                if pseudo.help:
                    out[(cmd, pseudo.dest)] = pseudo.help
            for name, sub in action.choices.items():
                out.update(_help_strings(sub, f"{cmd} {name}".strip()))
        elif action.help and action.help is not argparse.SUPPRESS:
            out[(cmd, action.option_strings[0] if action.option_strings else action.dest)] = \
                action.help
    return out


def test_every_help_string_is_translated():
    """Built under en (``th`` is the identity there), every help string of
    every subcommand has a ``help.<english>`` entry in every other pack,
    except the port's own flags, which are listed by name; built under each
    language, the parser carries that pack's text."""
    i18n.set_language("en")
    helps = _help_strings(build_parser())
    subcommands = {"render", "depth", "tools", "models", "frames", "convert", "audio",
                   "scenes", "verify-checkpoints", "preview", "serve"}
    assert {k[1] for k in helps if k[0] == ""} >= subcommands
    assert len(helps) > 60
    own = {k for k in helps if k in PORT_OWN_HELP}
    assert own == PORT_OWN_HELP
    for lang in LANGS[:1] + LANGS[2:]:
        pack = ji18n.catalog(lang)
        missing = sorted(f"{k}: {h}" for k, h in helps.items()
                         if k not in own and "help." + h not in pack)
        assert not missing, (lang, missing)
        i18n.set_language(lang)
        translated = _help_strings(build_parser())
        for k, h in helps.items():
            assert translated[k] == (h if k in own else pack["help." + h]), (lang, k)
    i18n.set_language("en")


def test_settings_load_across_packages(tmp_path):
    from visiondepth3d_tpu.config.settings import load_settings as jload
    from visiondepth3d_tpu.config.settings import save_settings as jsave
    from visiondepth3d_tpu.pipeline import RenderConfig as JConfig
    from visiondepth3d_tpu.stereo import StereoParams as JParams
    from visiondepth3d_tpu_torch.config.settings import load_settings, save_settings
    from visiondepth3d_tpu_torch.pipeline import RenderConfig
    from visiondepth3d_tpu_torch.stereo import StereoParams

    path = tmp_path / "s" / "settings.json"
    save_settings(StereoParams(fg_shift=11.0, blur_ksize=5), RenderConfig(output_format="Half-SBS"),
                  {"language": "fr", "last_input": "a.mp4", "junk": 1}, path)
    p, cfg, extras = jload(path)
    assert abs(float(p.fg_shift) - 11.0) < 1e-6 and p.blur_ksize == 5
    assert cfg.output_format == "Half-SBS"
    assert extras == {"language": "fr", "last_input": "a.mp4"}
    jsave(JParams(mg_shift=-2.5), JConfig(output_format="VR", chunk_size=8),
          {"language": "ja"}, path)
    p, cfg, extras = load_settings(path)
    assert abs(float(p.mg_shift) + 2.5) < 1e-6 and cfg.output_format == "VR"
    assert cfg.chunk_size == 8 and extras == {"language": "ja"}
    p, cfg, extras = load_settings(tmp_path / "missing.json")
    assert p == StereoParams() and extras == {}
    assert json.loads(path.read_text())["language"] == "ja"
