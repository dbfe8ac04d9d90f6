"""FFmpeg integration, gated on binary availability.

The port's copy of ``visiondepth3d_tpu/io/ffmpeg.py``. ffmpeg/ffprobe drive
encode, metadata and audio mux where the binaries exist — all raw video
crosses the process boundary as y4m so the native reader handles both
cases — and native y4m/npz I/O takes over where they don't.
"""

from __future__ import annotations

import json
import shutil
import subprocess

FFMPEG = shutil.which("ffmpeg")
FFPROBE = shutil.which("ffprobe")


def have_ffmpeg() -> bool:
    return FFMPEG is not None


def have_ffprobe() -> bool:
    return FFPROBE is not None


def probe(path: str) -> dict:
    """ffprobe JSON for streams+format (audio.py:7-19 analog)."""
    if not FFPROBE:
        raise RuntimeError("ffprobe not available on this host")
    out = subprocess.run(
        [FFPROBE, "-v", "error", "-print_format", "json", "-show_format",
         "-show_streams", str(path)],
        capture_output=True, check=True,
    )
    return json.loads(out.stdout)


def probe_duration(path: str) -> float:
    info = probe(path)
    return float(info["format"]["duration"])


def is_av1_encoded(path: str) -> bool:
    """AV1 guard (render_depth.py:1987-2005): the reference refuses AV1 input
    because OpenCV can't decode it; we only refuse when ffmpeg is absent."""
    if not FFPROBE:
        return False
    try:
        info = probe(path)
    except Exception:
        return False
    return any(s.get("codec_name") == "av1" for s in info.get("streams", []))


def decode_to_y4m_cmd(path: str, start_s: float | None = None,
                      end_s: float | None = None) -> list[str]:
    """ffmpeg command decoding any input to y4m on stdout."""
    cmd = [FFMPEG, "-v", "error", "-nostdin"]
    if start_s:
        cmd += ["-ss", f"{start_s:.6f}"]
    cmd += ["-i", str(path)]
    if end_s is not None:
        dur = end_s - (start_s or 0.0)
        cmd += ["-t", f"{dur:.6f}"]
    cmd += ["-an", "-f", "yuv4mpegpipe", "-pix_fmt", "yuv420p", "-"]
    return cmd


def encode_from_y4m_cmd(
    out_path: str,
    codec: str = "libx264",
    crf: int = 23,
    preset: str = "slow",
    extra: list[str] | None = None,
) -> list[str]:
    """ffmpeg command encoding y4m-on-stdin to out_path
    (render_3d.py:1144-1162 analog; codec validation at the call site)."""
    cmd = [FFMPEG, "-y", "-v", "error", "-f", "yuv4mpegpipe", "-i", "-",
           "-an", "-c:v", codec, "-preset", preset, "-pix_fmt", "yuv420p"]
    if codec.startswith("libx"):
        cmd += ["-crf", str(crf)]
    elif "nvenc" in codec:
        cmd += ["-cq", str(crf), "-b:v", "0"]
    if extra:
        cmd += extra
    cmd.append(str(out_path))
    return cmd


# codec validation map (render_3d.py FFMPEG_CODEC_MAP analog)
FFMPEG_CODECS = (
    "libx264", "libx265", "libaom-av1", "libsvtav1",
    "h264_nvenc", "hevc_nvenc", "av1_nvenc",
    "h264_amf", "hevc_amf", "h264_qsv", "hevc_qsv",
)


def validate_codec(codec: str | None) -> str:
    """Fall back to libx264 for missing/unknown codecs (render_3d.py:1038-1044)."""
    if not codec or not isinstance(codec, str) or codec.strip() == "":
        return "libx264"
    if codec not in FFMPEG_CODECS:
        return "libx264"
    return codec


def rawvideo_gray16_encode_cmd(out_path: str, width: int, height: int,
                               fps: float) -> list[str]:
    """uint16-frames-on-stdin -> lossless FFV1 gray16le video, the
    reference's interoperable 16-bit depth export (render_depth.py:1704-1714)."""
    return [FFMPEG, "-y", "-v", "error", "-f", "rawvideo",
            "-pix_fmt", "gray16le", "-s", f"{width}x{height}",
            "-r", f"{fps:.6f}", "-i", "-",
            "-an", "-c:v", "ffv1", "-pix_fmt", "gray16le", str(out_path)]


def rawvideo_gray16_decode_cmd(path: str) -> list[str]:
    """Decode any gray16-pixel video to raw gray16le frames on stdout."""
    return [FFMPEG, "-v", "error", "-nostdin", "-i", str(path),
            "-f", "rawvideo", "-pix_fmt", "gray16le", "-"]


def rip_audio_cmd(src: str, dst: str, codec: str = "copy",
                  bitrate: str | None = None) -> list[str]:
    """Extract the audio track (audio.py:96-134 analog)."""
    cmd = [FFMPEG, "-y", "-v", "error", "-i", str(src), "-vn"]
    if codec == "copy":
        cmd += ["-acodec", "copy"]
    else:
        cmd += ["-acodec", codec]
        if bitrate:
            cmd += ["-b:a", bitrate]
    cmd.append(str(dst))
    return cmd


def attach_audio_cmd(video: str, audio: str, dst: str, offset_s: float = 0.0,
                     reencode: bool = False) -> list[str]:
    """Mux an audio track with optional sync offset (audio.py:136-173 analog)."""
    cmd = [FFMPEG, "-y", "-v", "error", "-i", str(video)]
    if offset_s:
        cmd += ["-itsoffset", f"{offset_s:.3f}"]
    cmd += ["-i", str(audio), "-map", "0:v:0", "-map", "1:a:0"]
    cmd += ["-c:v", "copy"]
    cmd += ["-c:a", "aac"] if reencode else ["-c:a", "copy"]
    cmd += ["-shortest", "-movflags", "+faststart", str(dst)]
    return cmd


def run(cmd: list[str]) -> None:
    subprocess.run(cmd, check=True)


def popen_reader(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE)


def popen_writer(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdin=subprocess.PIPE)
