"""Audio rip / attach tools (the reference's core/audio.py), gated on ffmpeg.

The port's copy of ``visiondepth3d_tpu/io/audio.py``. ``rip_audio``:
stream-copy or re-encode the audio track (codecs aac/mp3/opus/flac/wav/
ac3/eac3 + bitrate, audio.py:96-134). ``attach_audio``: mux with an
``-itsoffset`` sync offset, ``-shortest -movflags +faststart``
(audio.py:136-173). Progress parses ffmpeg's ``-progress pipe:1``
out_time_ms lines against the ffprobe duration (audio.py:21-84).
"""

from __future__ import annotations

import subprocess
from typing import Callable

from . import ffmpeg as ff

AUDIO_CODECS = {
    "copy": "copy",
    "aac": "aac",
    "mp3": "libmp3lame",
    "opus": "libopus",
    "flac": "flac",
    "wav": "pcm_s16le",
    "ac3": "ac3",
    "eac3": "eac3",
}


def _run_with_progress(cmd: list[str], duration_s: float | None,
                       progress_cb: Callable[[float], None] | None) -> None:
    if progress_cb is None or duration_s is None:
        subprocess.run(cmd, check=True)
        return
    cmd = cmd[:1] + ["-progress", "pipe:1", "-nostats"] + cmd[1:]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    for line in proc.stdout:
        if line.startswith("out_time_ms="):
            try:
                ms = int(line.split("=", 1)[1]) / 1000.0
                progress_cb(min(100.0, 100.0 * ms / (duration_s * 1000.0)))
            except ValueError:
                pass
    proc.wait()
    if proc.returncode != 0:
        raise subprocess.CalledProcessError(proc.returncode, cmd)


def rip_audio(src, dst, codec: str = "copy", bitrate: str | None = None,
              progress_cb=None) -> None:
    if not ff.have_ffmpeg():
        raise RuntimeError("audio tools require ffmpeg")
    codec = AUDIO_CODECS.get(codec, codec)
    dur = None
    try:
        dur = ff.probe_duration(str(src))
    except Exception:
        pass
    _run_with_progress(ff.rip_audio_cmd(str(src), str(dst), codec, bitrate),
                       dur, progress_cb)


def attach_audio(video, audio, dst, offset_s: float = 0.0,
                 reencode: bool = False, progress_cb=None) -> None:
    """offset_s in [-10, 10] like the GUI slider; positive delays audio."""
    if not ff.have_ffmpeg():
        raise RuntimeError("audio tools require ffmpeg")
    offset_s = max(-10.0, min(10.0, float(offset_s)))
    dur = None
    try:
        dur = ff.probe_duration(str(video))
    except Exception:
        pass
    _run_with_progress(
        ff.attach_audio_cmd(str(video), str(audio), str(dst), offset_s, reencode),
        dur, progress_cb,
    )
