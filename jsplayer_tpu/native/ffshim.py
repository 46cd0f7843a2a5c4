"""ctypes bindings for ffshim.cpp — the system-FFmpeg cross-validation shim.

Purpose: FFmpeg ships *independent* implementations of both reference
codecs — ``msvideo1`` (CRAM, ``MSVideo1.hx``) and ``scpr`` (ScreenPressor
v1/v2/v3, ``ScreenPressor.hx``) — plus an msvideo1 *encoder*.  This module lets the
test suite decode our encoders' streams with FFmpeg and our decoders with
genuine third-party streams, breaking the oracle↔encoder self-reference.

It also provides MP3→PCM decode for the audio path, mirroring the
reference's delegation of audio decode to the browser (WebAudio
``decodeAudioData``, AudioTrack.hx:54-65): we delegate to the system codec
library rather than hand-roll a Layer-III decoder.

Everything is gated on :func:`available`; without libavcodec the rest of
the framework is unaffected.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libffshim.so")
_SRC_PATH = os.path.join(_DIR, "ffshim.cpp")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    from . import build_if_stale

    if not build_if_stale("libffshim.so", _SRC_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.ffv_open.restype = ctypes.c_void_p
    lib.ffv_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.ffv_decode.restype = ctypes.c_int
    lib.ffv_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.ffv_close.argtypes = [ctypes.c_void_p]

    lib.ffe_open.restype = ctypes.c_void_p
    lib.ffe_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.ffe_pix_fmt_name.restype = ctypes.c_int
    lib.ffe_pix_fmt_name.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.ffe_encode.restype = ctypes.c_int
    lib.ffe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ffe_close.argtypes = [ctypes.c_void_p]

    lib.ffa_open.restype = ctypes.c_void_p
    lib.ffa_open.argtypes = []
    lib.ffa_decode.restype = ctypes.c_int
    lib.ffa_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ffa_close.argtypes = [ctypes.c_void_p]

    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _fourcc(tag: str) -> int:
    b = tag.encode()
    return b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)


class FFVideoDecoder:
    """One FFmpeg decoder instance fed raw AVI packets.

    ``decode`` returns ``(array, fmt_name, palette_or_None)`` where ``array``
    is ``[H, W]`` uint8 (pal8), uint16 (rgb555le) or ``[H, W, bpp]`` uint8
    for 3/4-byte formats, exactly as the decoder produced it (top-down rows).
    """

    def __init__(self, codec: str, width: int, height: int, bpp: int,
                 fourcc: str = "", extradata: bytes = b""):
        lib = load()
        if lib is None:
            raise RuntimeError("ffshim unavailable (no libavcodec?)")
        self._lib = lib
        self.width, self.height = width, height
        self._h = lib.ffv_open(codec.encode(), width, height, bpp,
                               _fourcc(fourcc) if fourcc else 0,
                               extradata or None, len(extradata))
        if not self._h:
            raise RuntimeError(f"ffmpeg decoder {codec!r} failed to open")

    def decode(self, packet: bytes, is_key: bool = False,
               palette_rgba: Optional[bytes] = None
               ) -> Optional[Tuple[np.ndarray, str, Optional[np.ndarray]]]:
        cap = self.width * self.height * 4 + 1024
        out = ctypes.create_string_buffer(cap)
        fmt = ctypes.create_string_buffer(32)
        n = self._lib.ffv_decode(self._h, packet, len(packet),
                                 1 if is_key else 0, palette_rgba, out, cap,
                                 fmt, 32)
        if n == 0:
            return None
        if n < 0:
            raise ValueError(f"ffmpeg decode failed (rc={n})")
        fmt_name = fmt.value.decode()
        raw = np.frombuffer(out.raw[:n], dtype=np.uint8)
        w, h = self.width, self.height
        pal = None
        if fmt_name == "pal8":
            arr = raw[: w * h].reshape(h, w).copy()
            pal = raw[w * h : w * h + 1024].view(np.uint32).copy()
        elif fmt_name in ("rgb555le", "rgb565le"):
            arr = raw[: w * h * 2].view("<u2").reshape(h, w).copy()
        elif fmt_name in ("rgb24", "bgr24"):
            arr = raw[: w * h * 3].reshape(h, w, 3).copy()
        elif fmt_name in ("rgb0", "bgr0", "rgba", "bgra", "0rgb", "0bgr"):
            arr = raw[: w * h * 4].reshape(h, w, 4).copy()
        else:
            raise ValueError(f"unexpected ffmpeg pix fmt {fmt_name!r}")
        return arr, fmt_name, pal

    def close(self) -> None:
        if self._h:
            self._lib.ffv_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def encode_msvideo1(frames_rgb555: Sequence[np.ndarray], width: int,
                    height: int) -> List[Tuple[bytes, bool]]:
    """Encode ``[H, W]`` uint16 RGB555 frames with FFmpeg's CRAM encoder.

    Returns ``[(packet_bytes, is_keyframe)]`` — genuine third-party MSVideo1
    streams for our decoder to chew on (reference decode semantics:
    MSVideo1.hx:106-209).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("ffshim unavailable")
    h = lib.ffe_open(b"msvideo1", width, height)
    if not h:
        raise RuntimeError("ffmpeg msvideo1 encoder failed to open")
    try:
        name = ctypes.create_string_buffer(32)
        lib.ffe_pix_fmt_name(h, name, 32)
        if name.value not in (b"rgb555le", b"rgb555"):
            raise RuntimeError(f"unexpected encoder pix fmt {name.value!r}")
        out: List[Tuple[bytes, bool]] = []
        cap = width * height * 4 + 4096
        buf = ctypes.create_string_buffer(cap)
        key = ctypes.c_int(0)
        for f in frames_rgb555:
            assert f.dtype == np.uint16 and f.shape == (height, width)
            data = f.astype("<u2").tobytes()
            n = lib.ffe_encode(h, data, buf, cap, ctypes.byref(key))
            if n < 0:
                raise ValueError(f"ffmpeg encode failed (rc={n})")
            if n > 0:
                out.append((buf.raw[:n], bool(key.value)))
        return out
    finally:
        lib.ffe_close(h)


class FFMp3Decoder:
    """MP3 frames → float32 PCM via the system codec (AudioTrack.hx:54-65
    analog — the reference delegates to WebAudio; we delegate to libavcodec).
    """

    def __init__(self):
        lib = load()
        if lib is None:
            raise RuntimeError("ffshim unavailable")
        self._lib = lib
        self._h = lib.ffa_open()
        if not self._h:
            raise RuntimeError("ffmpeg mp3 decoder failed to open")
        self.sample_rate = 0
        self.channels = 0

    def decode(self, mp3_bytes: bytes) -> np.ndarray:
        """Decode a run of whole MP3 frames; returns ``[n, channels]``
        float32 (possibly empty — the decoder may buffer its first frame)."""
        cap = max(len(mp3_bytes) * 32, 1152 * 2 * 64)
        out = np.empty(cap, dtype=np.float32)
        sr = ctypes.c_int(0)
        ch = ctypes.c_int(0)
        n = self._lib.ffa_decode(
            self._h, mp3_bytes, len(mp3_bytes),
            out.ctypes.data_as(ctypes.c_void_p), cap,
            ctypes.byref(sr), ctypes.byref(ch))
        if n < 0:
            raise ValueError(f"ffmpeg mp3 decode failed (rc={n})")
        if n == 0:
            return np.empty((0, max(self.channels, 1)), dtype=np.float32)
        self.sample_rate = sr.value
        self.channels = ch.value
        return out[: n * ch.value].reshape(n, ch.value).copy()

    def close(self) -> None:
        if self._h:
            self._lib.ffa_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
