"""Cross-implementation ground truth via the system FFmpeg (libavcodec).

Weakness addressed: every parity claim was
oracle ↔ native ↔ device over streams produced by this repo's *own*
encoders, so a shared misreading of the reference would be invisible.
FFmpeg is an independent implementation of both reference formats:

  * ``msvideo1`` — decoder *and* encoder for CRAM (MSVideo1.hx semantics),
  * ``scpr``     — decoder for ScreenPressor versions 1/2/3
                   (ScreenPressor.hx:117-484 semantics).

These tests close the loop in both directions:

  1. genuine third-party (FFmpeg-encoded) MSVideo1 streams decode
     bit-exactly with our decoder;
  2. our encoders' streams decode bit-exactly with FFmpeg's decoders
     (SP v2/v3 at 24 and 16 bpp, MSV1 at 16 and 8 bpp, flat frames,
     motion/subrect/data P-blocks, non-multiple-of-16 dimensions);
  3. the *golden* fixture streams (tests/test_golden.py) decode through
     FFmpeg to the same pinned frame digests — cross-implementation pins;
  4. our AVI muxer's output demuxes+decodes through a third-party stack
     (OpenCV's FFmpeg-backed VideoCapture);
  5. random-content soak chains (scroll/paint/noise/still, periodic
     keyframes) across seeds — broad opcode coverage against the
     independent implementation.

One genuine FFmpeg deviation found and pinned
(test_sp_flat_midstream_ffmpeg_deviation): scpr skips the reference's
entropy-context reset on mid-stream FLAT frames (RenewI,
ScreenPressor.hx:134) and diverges on the next P frame; our decoders
follow the reference.

Scope note: ScreenPressor **v4** is beyond FFmpeg's scpr (versions 1-3
only) and the Haxe→JS toolchain of the reference itself is not present in
this image (no haxe, no node), so v4 parity remains pinned by the oracle ↔
native ↔ device triangle plus golden digests; the entropy layer it shares
with v3 (rANS, f0=32 vs 64 — ScreenPressor.hx:66-79) IS cross-validated
here through v3.
"""

import hashlib

import numpy as np
import pytest

from jsplayer_tpu.codecs.msvideo1 import (
    MSVideo1_8bit,
    MSVideo1_16bit,
    from_rgb15,
    palette_to_u32,
)
from jsplayer_tpu.codecs.screenpressor import ScreenPressor
from jsplayer_tpu.codecs.native_sp import NativeScreenPressorCodec
from jsplayer_tpu.encode.msv1_enc import encode_frame_8, encode_frame_16
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.native import ffshim
from jsplayer_tpu import native as spnative

import test_golden as golden

pytestmark = pytest.mark.skipif(
    not ffshim.available(), reason="system libavcodec not available"
)

V15 = np.vectorize(from_rgb15, otypes=[np.uint32])


def ff_u32_24(arr: np.ndarray) -> np.ndarray:
    """FFmpeg bgr0 [H,W,4] → our packed u32 [H,W] (24bpp path).

    Empirically established mapping: byte0 == our u32 low byte (the first
    coded channel), byte2 == our high byte."""
    a = arr.astype(np.uint32)
    return (a[..., 2] << 16) | (a[..., 1] << 8) | a[..., 0]


def ff_u32_16(arr: np.ndarray) -> np.ndarray:
    """FFmpeg rgb0 [H,W,4] → our packed u32 [H,W] (16bpp path).

    FFmpeg scales the 5-bit channels <<3 on output (the same scaling the
    reference applies at display time, Manager.hx:360-387); our oracle
    keeps raw 5-bit channel values in the packed u32."""
    a = arr.astype(np.uint32)
    assert int((a[..., :3] & 7).max(initial=0)) == 0, "non-<<3 16bpp output"
    return ((a[..., 2] >> 3) << 16) | ((a[..., 1] >> 3) << 8) | (a[..., 0] >> 3)


def decode_ours_sp(pkts, W, H, bpp=24, native=False):
    dec = (NativeScreenPressorCodec(W, H, bpp) if native
           else ScreenPressor(W, H, bpp))
    dec.preinit(0)
    out = []
    for p in pkts:
        dst = np.zeros(W * H, dtype=np.uint32)
        if dec.is_key_frame(p):
            dec.decompress_i(p, dst)
            out.append(dst.copy())
        else:
            out.append(dec.decompress_p(p, dst).data.copy())
    return out


def decode_ffmpeg_sp(pkts, W, H, bpp=24):
    out = []
    with ffshim.FFVideoDecoder("scpr", W, H, bpp, "SCPR") as dec:
        for p in pkts:
            r = dec.decode(p, p[0] & 0xF in (1, 2))
            if r is None:
                # a 1-byte no-change P frame (head 0x00): ffmpeg's scpr
                # consumes it without emitting a frame — semantically the
                # previous frame repeats (ScreenPressor.hx:306-309)
                assert len(p) == 1 and p[0] == 0 and out, (len(p), p[:1])
                out.append(out[-1])
                continue
            arr, fmt, _ = r
            if bpp == 16:
                assert fmt == "rgb0"
                u32 = ff_u32_16(arr)
            else:
                assert fmt == "bgr0"
                u32 = ff_u32_24(arr)
            out.append(u32[::-1].reshape(-1))  # ffmpeg rows are top-down
    return out


def blocky_frames(rng, W, H, n, bpp=24, scroll=0):
    """Screen-like content: solid background + rectangles + optional
    vertical scroll (to elicit motion-vector P-blocks)."""
    hi = 32 if bpp == 16 else 256
    def col():
        c0, c1, c2 = (int(x) for x in rng.integers(0, hi, 3))
        return (c2 << 16) | (c1 << 8) | c0
    f = np.full((H, W), col(), dtype=np.uint32)
    for _ in range(8):
        x0, y0 = int(rng.integers(0, W - 8)), int(rng.integers(0, H - 8))
        w, h = int(rng.integers(4, 24)), int(rng.integers(4, 16))
        f[y0 : y0 + h, x0 : x0 + w] = col()
    frames = [f.reshape(-1).copy()]
    for _ in range(1, n):
        g = frames[-1].reshape(H, W).copy()
        if scroll:
            g = np.roll(g, scroll, axis=0)
        x0, y0 = int(rng.integers(0, W - 8)), int(rng.integers(0, H - 8))
        g[y0 : y0 + 6, x0 : x0 + 6] = col()
        frames.append(g.reshape(-1).copy())
    return frames


# ---------------------------------------------------------------------------
# 1. Genuine third-party streams → our decoder
# ---------------------------------------------------------------------------

def test_msv1_16_ffmpeg_encoded_stream():
    """FFmpeg's own CRAM encoder produces the stream; our decoder and
    FFmpeg's decoder must agree bit-exactly on every frame."""
    rng = np.random.default_rng(0)
    W, H = 32, 24
    frames15 = []
    for i in range(6):
        small = rng.integers(0, 1 << 15, size=(H // 4, W // 4), dtype=np.uint16)
        frames15.append(np.kron(small, np.ones((4, 4), dtype=np.uint16)))
    # a couple of partial-change frames to elicit skip-runs
    frames15.append(frames15[-1].copy())
    frames15[-1][:4, :8] = 0x1234
    pkts = ffshim.encode_msvideo1(frames15, W, H)
    assert len(pkts) == len(frames15)

    ours = MSVideo1_16bit(W, H)
    ours.preinit(0)
    with ffshim.FFVideoDecoder("msvideo1", W, H, 16, "CRAM") as ffdec:
        for p, key in pkts:
            r = ffdec.decode(p, key)
            assert r is not None
            ff_arr, fmt, _ = r
            assert fmt == "rgb555le"
            dst = np.zeros(W * H, dtype=np.uint32)
            if key:
                ours.decompress_i(p, dst)
            else:
                ours.decompress_p(p, dst)
            ff_u32 = V15(ff_arr.astype(np.uint32))
            ours_td = ours.previous_frame().reshape(H, W)[::-1]
            assert np.array_equal(ff_u32, ours_td)


# ---------------------------------------------------------------------------
# 2. Our encoders → FFmpeg decoders
# ---------------------------------------------------------------------------

def test_msv1_16_ours_vs_ffmpeg():
    rng = np.random.default_rng(1)
    W, H = 32, 24
    prev = None
    with ffshim.FFVideoDecoder("msvideo1", W, H, 16, "CRAM") as ffdec:
        for i in range(4):
            small = rng.integers(0, 1 << 15, size=(H // 2, W // 2),
                                 dtype=np.uint32)
            f = V15(np.kron(small, np.ones((2, 2), dtype=np.uint32))
                    ).reshape(-1)
            if prev is not None and i == 2:
                f = prev.copy()
                f[: W * 4] = from_rgb15(0x7FFF)
            pkt = encode_frame_16(f, prev, W, H)
            arr, fmt, _ = ffdec.decode(pkt, prev is None)
            assert np.array_equal(V15(arr.astype(np.uint32)),
                                  f.reshape(H, W)[::-1])
            prev = f


def test_msv1_8_ours_vs_ffmpeg():
    rng = np.random.default_rng(2)
    W, H = 32, 24
    pal_bytes = bytes(rng.integers(0, 256, size=1024, dtype=np.uint8))
    pal_u32 = palette_to_u32(pal_bytes)
    prev = None
    with ffshim.FFVideoDecoder("msvideo1", W, H, 8, "CRAM") as ffdec:
        for i in range(3):
            idx = np.kron(
                rng.integers(0, 256, size=(H // 4, W // 4), dtype=np.uint8),
                np.ones((4, 4), dtype=np.uint8)).reshape(-1)
            if prev is not None and i == 2:
                idx = prev.copy()
                idx[: W * 4] = 7
            pkt = encode_frame_8(idx, prev, W, H)
            arr, fmt, ffpal = ffdec.decode(pkt, prev is None,
                                           palette_rgba=pal_bytes)
            assert fmt == "pal8"
            assert np.array_equal(arr, idx.reshape(H, W)[::-1])
            assert np.array_equal(ffpal & 0xFFFFFF, pal_u32 & 0xFFFFFF)
            prev = idx


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("dims", [(64, 48), (52, 38)])  # incl. non-16-multiple
def test_sp_24bpp_crossval(version, dims):
    W, H = dims
    rng = np.random.default_rng(3 + version)
    frames = blocky_frames(rng, W, H, 4, scroll=4)  # scroll → motion blocks
    enc = ScreenPressorEncoder(version, W, H, bpp=24)
    pkts = [enc.encode_i(frames[0])]
    pkts += [enc.encode_p(f) for f in frames[1:]]

    ours = decode_ours_sp(pkts, W, H)
    ffs = decode_ffmpeg_sp(pkts, W, H)
    for i, (a, b) in enumerate(zip(ours, ffs)):
        assert np.array_equal(a, b), f"v{version} {W}x{H} frame {i}"
    # close the triangle with the native C++ decoder when built
    if spnative.load() is not None:
        nat = decode_ours_sp(pkts, W, H, native=True)
        for i, (a, b) in enumerate(zip(nat, ffs)):
            assert np.array_equal(a, b), f"native v{version} frame {i}"


@pytest.mark.parametrize("version", [2, 3])
def test_sp_16bpp_crossval(version):
    W, H = 64, 48
    rng = np.random.default_rng(13 + version)
    frames = blocky_frames(rng, W, H, 3, bpp=16)
    enc = ScreenPressorEncoder(version, W, H, bpp=16)
    pkts = [enc.encode_i(frames[0])]
    pkts += [enc.encode_p(f) for f in frames[1:]]
    ours = decode_ours_sp(pkts, W, H, bpp=16)
    ffs = decode_ffmpeg_sp(pkts, W, H, bpp=16)
    for i, (a, b) in enumerate(zip(ours, ffs)):
        assert np.array_equal(a, b), f"v{version} 16bpp frame {i}"


def test_sp_flat_frame_crossval():
    W, H = 64, 48
    enc = ScreenPressorEncoder(3, W, H, bpp=24)
    pkt = enc.encode_flat(pack_rgb(0x12, 0x34, 0x56))
    ours = decode_ours_sp([pkt], W, H)[0]
    ff = decode_ffmpeg_sp([pkt], W, H)[0]
    assert np.array_equal(ours, ff)
    assert len(set(ours.tolist())) == 1


def test_sp_v4_beyond_ffmpeg_scope():
    """FFmpeg's scpr stops at version 3; v4 streams (head 0x3*) must be
    rejected there — documents why v4 parity stays oracle/native/golden."""
    W, H = 32, 32
    enc = ScreenPressorEncoder(4, W, H, bpp=24)
    f = np.full(W * H, pack_rgb(1, 2, 3), dtype=np.uint32)
    pkt = enc.encode_i(f)
    assert pkt[0] >> 4 == 3  # version-1 == 3 ⇒ v4
    with ffshim.FFVideoDecoder("scpr", W, H, 24, "SCPR") as dec:
        with pytest.raises(ValueError):
            r = dec.decode(pkt, True)
            # some builds may return no frame instead of erroring
            assert r is None
            raise ValueError("no frame")


# ---------------------------------------------------------------------------
# 3. Golden fixture streams through FFmpeg → same pinned digests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version", [2, 3])
def test_golden_sp_streams_cross_pinned(version):
    """The exact golden streams of test_golden.py, decoded by FFmpeg,
    reproduce the pinned frame digests — the pins are no longer only our
    own opinion of the format."""
    streams = golden.build_sp(version)
    ffs = decode_ffmpeg_sp(streams, golden.X, golden.Y)
    assert golden.digest(ffs) == golden.SP_FRAME_DIGESTS[version]


def test_golden_msv1_stream_cross_pinned():
    rng = np.random.default_rng(99)
    X, Y = golden.X, golden.Y
    f = np.full((Y, X), from_rgb15(0x0421), dtype=np.uint32)
    prev = None
    streams = []
    for t in range(4):
        f = f.copy()
        x0 = (t * 8) % (X - 4) & ~3
        f[4:8, x0 : x0 + 4] = from_rgb15(int(rng.integers(0, 0x8000)))
        flat = f.reshape(-1)
        streams.append(encode_frame_16(flat, prev, X, Y))
        prev = flat
    frames = []
    with ffshim.FFVideoDecoder("msvideo1", X, Y, 16, "CRAM") as ffdec:
        for i, s in enumerate(streams):
            arr, fmt, _ = ffdec.decode(s, i == 0)
            frames.append(V15(arr.astype(np.uint32))[::-1].reshape(-1))
    assert golden.digest(frames) == golden.MSV1_DIGESTS[1]


# ---------------------------------------------------------------------------
# 4. Our AVI muxer through a third-party demux+decode stack
# ---------------------------------------------------------------------------

def test_avi_mux_third_party_stack(tmp_path):
    cv2 = pytest.importorskip("cv2")
    W, H = 32, 24
    enc = ScreenPressorEncoder(3, W, H, bpp=24)
    frames = blocky_frames(np.random.default_rng(21), W, H, 3)
    pkts = [enc.encode_i(frames[0])]
    pkts += [enc.encode_p(f) for f in frames[1:]]
    avi = mux_avi(pkts, W, H, 24, codec="SCPR",
                  keyflags=[True] + [False] * (len(pkts) - 1))
    p = tmp_path / "scpr.avi"
    p.write_bytes(avi)
    cap = cv2.VideoCapture(str(p))
    assert cap.isOpened()
    got = []
    while True:
        ok, img = cap.read()
        if not ok:
            break
        a = img.astype(np.uint32)  # BGR byte order
        got.append(((a[..., 2] << 16) | (a[..., 1] << 8) | a[..., 0])
                   [::-1].reshape(-1))
    cap.release()
    assert len(got) == len(frames)
    ours = decode_ours_sp(pkts, W, H)
    for i, (a, b) in enumerate(zip(ours, got)):
        assert np.array_equal(a, b), f"cv2 frame {i}"


# ---------------------------------------------------------------------------
# 5. Random-content soak: broad opcode coverage against the independent
#    implementation (the cross-val analogue of the native soak chains)
# ---------------------------------------------------------------------------

def _evolve(rng, f, W, H, kind):
    g = f.copy()
    if kind == 0:   # vertical scroll → motion vectors
        g = np.roll(g, int(rng.integers(1, 6)), axis=0)
    elif kind == 1:  # horizontal scroll
        g = np.roll(g, int(rng.integers(1, 6)), axis=1)
    elif kind == 2:  # paint
        y0, x0 = int(rng.integers(0, H - 6)), int(rng.integers(0, W - 6))
        h, w = int(rng.integers(2, 12)), int(rng.integers(2, 16))
        g[y0:y0 + h, x0:x0 + w] = rng.integers(0, 1 << 24)
    elif kind == 3:  # noise burst (data blocks / subrects)
        y0, x0 = int(rng.integers(0, H - 8)), int(rng.integers(0, W - 8))
        g[y0:y0 + 8, x0:x0 + 8] = rng.integers(0, 1 << 24, (8, 8))
    # kind 4: still
    return g


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sp_soak_random_chains(version, seed):
    """30-frame random evolution chains (scroll/paint/noise/still mixes,
    periodic keyframes) decode bit-exactly through FFmpeg's scpr for every
    frame.  Mid-stream FLAT frames are exercised separately
    (test_sp_flat_midstream_ffmpeg_deviation): FFmpeg diverges there."""
    W, H = 64, 48
    rng = np.random.default_rng(1000 * version + seed)
    enc = ScreenPressorEncoder(version, W, H, bpp=24)
    f = np.zeros((H, W), dtype=np.uint32)
    f[:, :] = rng.integers(0, 1 << 24)
    pkts = [enc.encode_i(f.reshape(-1).copy())]
    for t in range(29):
        f = _evolve(rng, f, W, H, int(rng.integers(0, 5)))
        if t % 7 == 6:
            pkts.append(enc.encode_i(f.reshape(-1).copy()))
        else:
            pkts.append(enc.encode_p(f.reshape(-1).copy()))
    ours = decode_ours_sp(pkts, W, H)
    ffs = decode_ffmpeg_sp(pkts, W, H)
    for i, (a, b) in enumerate(zip(ours, ffs)):
        assert np.array_equal(a, b), f"v{version} seed {seed} frame {i}"


@pytest.mark.parametrize("version", [2, 3])
def test_sp_flat_midstream_ffmpeg_deviation(version):
    """Documented divergence: the reference renews the entropy contexts on
    EVERY flat frame (RenewI in the flat path, ScreenPressor.hx:134), so a
    P frame after a mid-stream flat decodes against fresh tables.  FFmpeg's
    reverse-engineered scpr does not perform that reset: with adapted
    contexts (a noise I-frame first) the P frame after the flat is either
    rejected (AVERROR_INVALIDDATA) or decodes to different pixels.  Our
    decoders follow the reference: the full chain decodes to the expected
    pixels in both the oracle and the native C++ decoder."""
    W, H = 64, 48
    rng = np.random.default_rng(42)
    enc = ScreenPressorEncoder(version, W, H, bpp=24)
    noise = rng.integers(0, 1 << 24, (H, W)).astype(np.uint32)
    pkts = [enc.encode_i(noise.reshape(-1).copy())]
    golds = [noise.reshape(-1).copy()]
    flat = np.full((H, W), 0x778899, dtype=np.uint32)
    pkts.append(enc.encode_flat(0x778899))  # mid-stream flat
    golds.append(flat.reshape(-1).copy())
    g = flat.copy()
    g[10:14, 8:30] = 0xABCDEF
    pkts.append(enc.encode_p(g.reshape(-1).copy()))  # P after flat
    golds.append(g.reshape(-1).copy())

    # ours: exact per the reference
    for native in ([False, True] if spnative.load() is not None else [False]):
        got = decode_ours_sp(pkts, W, H, native=native)
        for i, (a, b) in enumerate(zip(got, golds)):
            assert np.array_equal(a, b), f"native={native} frame {i}"
    # ffmpeg: the P frame after the flat is rejected or wrong
    with ffshim.FFVideoDecoder("scpr", W, H, 24, "SCPR") as dec:
        assert dec.decode(pkts[0], True) is not None
        assert dec.decode(pkts[1], True) is not None  # the flat frame
        try:
            r = dec.decode(pkts[2], False)
            diverged = (r is None or not np.array_equal(
                ff_u32_24(r[0])[::-1].reshape(-1), golds[2]))
        except ValueError:
            diverged = True
        assert diverged, "ffmpeg unexpectedly matched (fixed upstream?)"


@pytest.mark.parametrize("seed", [0, 1])
def test_msv1_soak_ffmpeg_encoder_random(seed):
    """FFmpeg-encoded CRAM of random blocky video chains (all opcode mixes
    the third-party encoder emits) decodes identically in both decoders."""
    W, H = 48, 32
    rng = np.random.default_rng(50 + seed)
    frames15 = []
    small = rng.integers(0, 1 << 15, size=(H // 4, W // 4), dtype=np.uint16)
    for t in range(12):
        if t and rng.random() < 0.4:
            small = np.roll(small, 1, axis=rng.integers(0, 2))
        if rng.random() < 0.8:
            small[rng.integers(0, H // 4), rng.integers(0, W // 4)] = \
                rng.integers(0, 1 << 15)
        frames15.append(np.kron(small, np.ones((4, 4), dtype=np.uint16)))
    pkts = ffshim.encode_msvideo1(frames15, W, H)
    ours = MSVideo1_16bit(W, H)
    ours.preinit(0)
    with ffshim.FFVideoDecoder("msvideo1", W, H, 16, "CRAM") as ffdec:
        for i, (p, key) in enumerate(pkts):
            arr, fmt, _ = ffdec.decode(p, key)
            dst = np.zeros(W * H, dtype=np.uint32)
            if key:
                ours.decompress_i(p, dst)
            else:
                ours.decompress_p(p, dst)
            assert np.array_equal(
                V15(arr.astype(np.uint32)),
                ours.previous_frame().reshape(H, W)[::-1]), f"frame {i}"


@pytest.mark.parametrize("version", [2])
def test_sp_16bpp_soak_random_chains(version):
    """16bpp random chains (5-bit lattice) through FFmpeg's rgb0 output.

    v2 (range coder) only: FFmpeg's v3-16bpp path deviates — see
    test_sp_v3_16bpp_ffmpeg_deviation."""
    W, H = 64, 48
    rng = np.random.default_rng(7000 + version)
    enc = ScreenPressorEncoder(version, W, H, bpp=16)
    f = np.zeros((H, W), dtype=np.uint32)
    f[:, :] = int(rng.integers(0, 1 << 24)) & 0x1F1F1F
    pkts = [enc.encode_i(f.reshape(-1).copy())]
    for t in range(15):
        g = f.copy()
        k = int(rng.integers(0, 4))
        if k == 0:
            g = np.roll(g, 2, axis=0)
        elif k == 1:
            y0, x0 = int(rng.integers(0, H - 6)), int(rng.integers(0, W - 6))
            g[y0:y0 + 5, x0:x0 + 9] = int(rng.integers(0, 1 << 24)) & 0x1F1F1F
        elif k == 2:
            y0, x0 = int(rng.integers(0, H - 8)), int(rng.integers(0, W - 8))
            g[y0:y0 + 8, x0:x0 + 8] = rng.integers(0, 1 << 24, (8, 8)) \
                & 0x1F1F1F
        f = g
        if t % 6 == 5:
            pkts.append(enc.encode_i(f.reshape(-1).copy()))
        else:
            pkts.append(enc.encode_p(f.reshape(-1).copy()))
    ours = decode_ours_sp(pkts, W, H, bpp=16)
    ffs = decode_ffmpeg_sp(pkts, W, H, bpp=16)
    for i, (a, b) in enumerate(zip(ours, ffs)):
        assert np.array_equal(a, b), f"v{version} 16bpp frame {i}"


def test_msv1_8bit_soak_ours_vs_ffmpeg():
    """8-bit palette chains (skip runs, 1/2/8-color opcodes, palette
    churn regions) through FFmpeg's pal8 output."""
    W, H = 48, 32
    rng = np.random.default_rng(81)
    pal = bytes(rng.integers(0, 256, 1024, dtype=np.uint8))
    prev = None
    with ffshim.FFVideoDecoder("msvideo1", W, H, 8, "CRAM") as ffdec:
        idx = np.kron(rng.integers(0, 256, (H // 4, W // 4), dtype=np.uint8),
                      np.ones((4, 4), np.uint8)).reshape(-1)
        for t in range(14):
            if t:
                g = idx.reshape(H, W).copy()
                k = int(rng.integers(0, 3))
                if k == 0:
                    g[:] = np.roll(g, 4, axis=int(rng.integers(0, 2)))
                    g[:] = np.kron(  # keep 4x4 block structure after roll
                        g[::4, ::4], np.ones((4, 4), np.uint8))
                elif k == 1:
                    by, bx = int(rng.integers(0, H // 4)), int(
                        rng.integers(0, W // 4))
                    g[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = rng.integers(
                        0, 256)
                idx = g.reshape(-1)
            pkt = encode_frame_8(idx, prev, W, H)
            arr, fmt, _ = ffdec.decode(pkt, prev is None, palette_rgba=pal)
            assert fmt == "pal8"
            assert np.array_equal(arr, idx.reshape(H, W)[::-1]), f"frame {t}"
            prev = idx


def test_sp_v3_16bpp_ffmpeg_deviation():
    """Second pinned FFmpeg deviation: for the ANS coders (v3/v4) the
    reference has NO 16bpp-specific entropy constants —
    EntroCoderANS.differentConstantsFor16bbp() is false
    (EntroCoders.hx:214; only the v2 range coder returns true, :72), so a
    v3 stream's bytes are identical whether the container says 16 or 24
    bpp.  Proof below: our encoder emits byte-identical streams for both
    depths, and FFmpeg decodes those bytes fine at 24 bpp but REJECTS the
    noise-bearing P frame at 16 bpp — scpr applies 16bpp-special handling
    the reference reserves for the RC coder.  Our decoders follow the
    reference at both depths."""
    W, H = 64, 48
    rng = np.random.default_rng(7003)
    base = int(rng.integers(0, 1 << 24)) & 0x1F1F1F
    rng.integers(0, 4)
    rng.integers(0, H - 8), rng.integers(0, W - 8)
    noise = rng.integers(0, 1 << 24, (8, 8)) & 0x1F1F1F
    f = np.full((H, W), base, dtype=np.uint32)
    g = f.copy()
    g[30:38, 8:16] = noise

    def encode(bpp):
        enc = ScreenPressorEncoder(3, W, H, bpp=bpp)
        return [enc.encode_i(f.reshape(-1).copy()),
                enc.encode_p(g.reshape(-1).copy())]

    p16, p24 = encode(16), encode(24)
    assert p16 == p24  # no 16bpp constants for ANS — reference semantics
    # our oracle decodes at both depths to the expected pixels
    for bpp in (16, 24):
        got = decode_ours_sp(p16, W, H, bpp=bpp)
        np.testing.assert_array_equal(got[1], g.reshape(-1))
    # ffmpeg: fine at 24bpp, rejects the identical bytes at 16bpp
    ff24 = decode_ffmpeg_sp(p24, W, H, bpp=24)
    np.testing.assert_array_equal(ff24[1], g.reshape(-1))
    with ffshim.FFVideoDecoder("scpr", W, H, 16, "SCPR") as dec:
        assert dec.decode(p16[0], True) is not None
        try:
            r = dec.decode(p16[1], False)
            diverged = r is None or not np.array_equal(
                ff_u32_16(r[0])[::-1].reshape(-1), g.reshape(-1))
        except ValueError:
            diverged = True
        assert diverged, "ffmpeg unexpectedly matched (fixed upstream?)"
