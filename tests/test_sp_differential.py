"""ScreenPressor differential evidence.

Three holes closed against the strongest available independent
implementation (FFmpeg's scpr, versions 1-3):

  1. hand-crafted 16bpp FLAT-frame fixtures — the one decoder branch no
     encoder can emit (the head byte doubles as the color's low byte,
     ScreenPressor.hx:136) — executed across oracle ↔ native ↔ FFmpeg;
  2. a v4-delta differential: v3 and v4 decoders must produce identical
     pixels on IDENTICAL symbol streams when only the ANS f0 constant
     (64 vs 32, ScreenPressor.hx:66-79) is swapped, and must diverge when
     it is not — pinning that FFmpeg's v3 validation transfers to v4
     modulo one constant;
  3. mutation differential fuzz: randomly corrupted v2/v3 streams (24 and
     16 bpp) must either be rejected or decode BIT-EXACTLY the same by
     our decoder and FFmpeg's — a shared misreading of the format would
     surface as a systematic mismatch here.
"""

import numpy as np
import pytest

from jsplayer_tpu.codecs.native_sp import NativeScreenPressorCodec
from jsplayer_tpu.codecs.screenpressor import ScreenPressor
from jsplayer_tpu.codecs.entropy import EntroCoderANS
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder
from jsplayer_tpu.native import ffshim

import test_ffmpeg_crossval as xval

W, H = 64, 48


def _flat16_packet(version: int, hi: int) -> bytes:
    """A 16bpp flat I-frame: head nibble 1; the head byte IS the color's
    low byte (ScreenPressor.hx:136), so the representable colors are the
    256 values [head, hi]."""
    head = ((version - 1) << 4) | 1
    return bytes([head, hi])


def _flat16_color(version: int, hi: int) -> int:
    head = ((version - 1) << 4) | 1
    clr16 = head + hi * 256
    b = (clr16 & 0x1F) << 3
    g = ((clr16 >> 5) & 0x1F) << 3
    r = ((clr16 >> 10) & 0x1F) << 3
    return (r << 16) | (g << 8) | b


@pytest.mark.parametrize("version", [2, 3, 4])
def test_16bpp_flat_oracle_native(version):
    """The 16bpp flat branch (head byte participates in the color) across
    oracle and native, plus a coded P on top and a consecutive flat (the
    renew-skip path, ScreenPressor.hx:108-115)."""
    for hi in (0x00, 0x5A, 0xFF):
        for dec in (ScreenPressor(W, H, 16), NativeScreenPressorCodec(W, H, 16)):
            dec.preinit(0)
            pkt = _flat16_packet(version, hi)
            assert dec.is_key_frame(pkt)
            dst = np.zeros(W * H, dtype=np.uint32)
            dec.decompress_i(pkt, dst)
            want = _flat16_color(version, hi)
            # the 16bpp FLAT branch stores <<3-SCALED channels (unlike the
            # coded 16bpp loop) — ScreenPressor.hx:136-146
            got = np.asarray(dec.previous_frame())
            assert (got == got[0]).all(), "flat frame must be uniform"
            assert int(got[0]) == want, (hex(int(got[0])), hex(want))
            # consecutive flat: same color again (renew skipped)
            dec.decompress_i(pkt, np.zeros(W * H, dtype=np.uint32))
            got2 = np.asarray(dec.previous_frame())
            np.testing.assert_array_equal(got2, got)


@pytest.mark.parametrize("version", [2, 3])
def test_16bpp_flat_ffmpeg_deviation_pinned(version):
    """GENUINE FFmpeg deviation #2 (pinned): the reference reads the 16bpp
    flat color as ``src[0] + src[1]*256`` — the HEAD byte is the color's
    low byte (ScreenPressor.hx:136) — while FFmpeg's scpr reads bytes 1-2
    and rejects 2-byte packets outright.  Our decoders follow the
    reference; this test pins the exact disagreement so a silent FFmpeg
    behavior change would surface."""
    if not ffshim.available():
        pytest.skip("ffshim unavailable")
    # (a) the reference's minimal 2-byte packet: FFmpeg rejects it
    pkt2 = _flat16_packet(version, 0x5A)
    with ffshim.FFVideoDecoder("scpr", W, H, 16, "SCPR") as dec:
        with pytest.raises(ValueError):
            dec.decode(pkt2, True)
    # (b) padded packet [head, lo, hi, 0]: FFmpeg decodes clr16 = lo|hi<<8
    # (one byte off the reference's head-inclusive read)
    lo, hi = 0x12, 0x34
    pkt = bytes([((version - 1) << 4) | 1, lo, hi, 0])
    with ffshim.FFVideoDecoder("scpr", W, H, 16, "SCPR") as dec:
        arr, fmt, _ = dec.decode(pkt, True)
    assert fmt == "rgb0"
    ff_clr16 = lo | (hi << 8)
    px = arr.reshape(-1, 4)[0]
    assert (px[2], px[1], px[0]) == (
        (ff_clr16 & 0x1F) << 3, ((ff_clr16 >> 5) & 0x1F) << 3,
        ((ff_clr16 >> 10) & 0x1F) << 3)
    # (c) our decoders on the same padded packet follow the reference:
    # clr16 = head | lo<<8 (the trailing bytes are ignored)
    ours = xval.decode_ours_sp([pkt], W, H, bpp=16)[0]
    ref_clr16 = (((version - 1) << 4) | 1) + lo * 256
    want = ((((ref_clr16 >> 10) & 0x1F) << 3) << 16 |
            ((((ref_clr16 >> 5) & 0x1F) << 3) << 8) |
            ((ref_clr16 & 0x1F) << 3))
    assert (ours == want).all()


@pytest.mark.parametrize("version", [2, 3])
def test_24bpp_flat_ffmpeg_crossval(version):
    """24bpp flat frames (bytes 1-3 = b,g,r — no head-byte sharing) DO
    agree with FFmpeg; only the 16bpp head-shared read deviates."""
    if not ffshim.available():
        pytest.skip("ffshim unavailable")
    for clr_bytes in ((1, 2, 3), (250, 120, 7)):
        pkt = bytes([((version - 1) << 4) | 1, *clr_bytes])
        ours = xval.decode_ours_sp([pkt], W, H, bpp=24)[0]
        ff = xval.decode_ffmpeg_sp([pkt], W, H, bpp=24)[0]
        np.testing.assert_array_equal(ours, ff, err_msg=str(clr_bytes))


def test_16bpp_flat_then_coded_p():
    """P-frame on top of a flat keyframe: exercises the 16bpp constant
    switch in DecompressP (ScreenPressor.hx:315-318) with a flat prev."""
    rng = np.random.default_rng(0)
    for version in (2, 3, 4):
        enc = ScreenPressorEncoder(version, W, H, bpp=16)
        # build the encoder's prev state to the flat color so encode_p is
        # consistent with the decoder's flat frame
        hi = 0x5A
        flat = _flat16_packet(version, hi)
        clr_fields = ((_flat16_color(version, hi) >> 19) << 16 |
                      (((_flat16_color(version, hi) >> 11) & 0x1F) << 8) |
                      ((_flat16_color(version, hi) >> 3) & 0x1F))
        # oracle stores unscaled 5-bit fields; mirror that into the encoder
        dec_probe = ScreenPressor(W, H, 16)
        dec_probe.preinit(0)
        dec_probe.decompress_i(flat, np.zeros(W * H, dtype=np.uint32))
        base = np.asarray(dec_probe.previous_frame()).copy()
        enc.prev = base.copy()
        enc.ec.renew_i()
        enc.last_flat = None
        nxt = base.copy().reshape(H, W)
        nxt[4:12, 6:20] = (rng.integers(0, 32) << 16 |
                           rng.integers(0, 32) << 8 | rng.integers(0, 32))
        p = enc.encode_p(nxt.reshape(-1).copy())
        for mk in (lambda: ScreenPressor(W, H, 16),
                   lambda: NativeScreenPressorCodec(W, H, 16)):
            dec = mk()
            dec.preinit(0)
            dec.decompress_i(flat, np.zeros(W * H, dtype=np.uint32))
            res = dec.decompress_p(p, np.zeros(W * H, dtype=np.uint32))
            np.testing.assert_array_equal(np.asarray(res.data),
                                          nxt.reshape(-1))


class _PatchedF0(ScreenPressor):
    """Oracle with the version→f0 mapping overridden (the v3/v4 delta)."""

    def __init__(self, *a, f0_map=None, **kw):
        super().__init__(*a, **kw)
        self._f0_map = f0_map or {}

    def _init_entro(self, version: int) -> bool:
        if version in self._f0_map:
            self.ec = EntroCoderANS(self._f0_map[version])
            self.sc_cxshift = 2
            self.decoding_bools = self.ec.can_decode_bool()
            self.ec.preinit()
            return True
        return super()._init_entro(version)


def _decode_all(dec, pkts):
    out = []
    dec.preinit(0)
    for p in pkts:
        dst = np.zeros(W * H, dtype=np.uint32)
        if dec.is_key_frame(p):
            dec.decompress_i(p, dst)
            out.append(dst.copy())
        else:
            out.append(np.asarray(dec.decompress_p(p, dst).data).copy())
    return out


def test_v4_delta_is_f0_only():
    """v3 and v4 diverge ONLY via the ANS f0 constant: a v4 stream whose
    head nibbles are rewritten to v3 decodes IDENTICALLY under a v3
    decoder patched to f0=32, and DIVERGES under the stock v3 f0=64 —
    the delta FFmpeg's v3 crossval cannot see is exactly one constant."""
    rng = np.random.default_rng(1)
    frames = xval.blocky_frames(rng, W, H, 6, bpp=24, scroll=1)
    enc = ScreenPressorEncoder(4, W, H)
    pkts4 = [enc.encode_i(frames[0].reshape(-1).copy())]
    for f in frames[1:]:
        pkts4.append(enc.encode_p(f.reshape(-1).copy()))
    golden = _decode_all(ScreenPressor(W, H, 24), pkts4)
    # rewrite the I-frame heads' version nibble 3 (v4) → 2 (v3); P heads
    # carry no version (just a nonzero has-change byte) and the entropy
    # payload starts past the head — the SYMBOL stream is identical
    pkts3 = [bytes([(p[0] & 0x0F) | (2 << 4)]) + p[1:]
             if p[0] in (0x31, 0x32) else p
             for p in pkts4]
    as_v3_f32 = _decode_all(_PatchedF0(W, H, 24, f0_map={3: 32}), pkts3)
    for t, (a, b) in enumerate(zip(golden, as_v3_f32)):
        np.testing.assert_array_equal(a, b, err_msg=f"frame {t}")
    # stock v3 (f0=64) on the same bytes must NOT reproduce the pixels
    try:
        as_v3_stock = _decode_all(ScreenPressor(W, H, 24), pkts3)
        same = all(np.array_equal(a, b)
                   for a, b in zip(golden, as_v3_stock))
        assert not same, "f0 change must alter decode"
    except (ValueError, AssertionError, IndexError):
        pass  # divergence may surface as a decode error — equally fine


def _ff_decode_lenient(pkts, bpp):
    """FFmpeg decode that reports (frames, error_index): frames decoded
    until the first failure."""
    out = []
    try:
        with ffshim.FFVideoDecoder("scpr", W, H, bpp, "SCPR") as dec:
            for i, p in enumerate(pkts):
                try:
                    r = dec.decode(p, p[0] & 0xF in (1, 2))
                except ValueError:
                    return out, i
                if r is None:
                    if len(p) == 1 and p[0] == 0 and out:
                        out.append(out[-1])
                        continue
                    return out, i
                arr, fmt, _ = r
                if bpp == 16:
                    if fmt != "rgb0":
                        return out, i
                    u32 = xval.ff_u32_16(arr)
                else:
                    if fmt != "bgr0":
                        return out, i
                    u32 = xval.ff_u32_24(arr)
                out.append(u32[::-1].reshape(-1))
    except Exception:
        return out, len(out)
    return out, None


def _ours_decode_lenient(pkts, bpp, W=W, H=H):
    dec = NativeScreenPressorCodec(W, H, bpp)
    dec.preinit(0)
    out = []
    for i, p in enumerate(pkts):
        dst = np.zeros(W * H, dtype=np.uint32)
        try:
            if dec.is_key_frame(p):
                dec.decompress_i(p, dst)
                out.append(dst.copy())
            else:
                out.append(np.asarray(dec.decompress_p(p, dst).data).copy())
        except (ValueError, AssertionError, IndexError):
            return out, i
    return out, None


def _oracle_decode_lenient(pkts, bpp, W=W, H=H):
    dec = ScreenPressor(W, H, bpp)
    dec.preinit(0)
    out = []
    for i, p in enumerate(pkts):
        dst = np.zeros(W * H, dtype=np.uint32)
        try:
            if dec.is_key_frame(p):
                dec.decompress_i(p, dst)
                out.append(dst.copy())
            else:
                out.append(np.asarray(dec.decompress_p(p, dst).data).copy())
        except (ValueError, AssertionError, IndexError):
            return out, i
    return out, None


@pytest.mark.parametrize("version,bpp", [(2, 24), (2, 16), (3, 24), (3, 16)])
def test_sp_mutation_differential_fuzz(version, bpp):
    """Mutation differential fuzz, two layers of evidence:

    1. native ↔ oracle: BIT-EXACT on every decoded frame of every mutated
       stream — our two implementations must share the reference's exact
       semantics including out-of-range/clamp behavior (this fuzz FOUND a
       real divergence: the native decoder truncated overlong data runs at
       the rect bottom where the reference keeps writing — fixed).
    2. ours ↔ FFmpeg: frames before the mutation must agree bit-exactly;
       from the mutated packet on, agreement is counted but divergence is
       tolerated — FFmpeg's scpr is NOT bit-faithful to the reference on
       invalid data (it sanitizes; two deviations on VALID streams are
       already pinned above and in test_ffmpeg_crossval), so corrupted-
       frame behavior is not a shared spec."""
    if not ffshim.available():
        pytest.skip("ffshim unavailable")
    rng = np.random.default_rng(version * 100 + bpp)
    frames = xval.blocky_frames(rng, W, H, 5, bpp=bpp, scroll=1)
    enc = ScreenPressorEncoder(version, W, H, bpp=bpp)
    pkts = [enc.encode_i(frames[0].reshape(-1).copy())]
    for f in frames[1:]:
        pkts.append(enc.encode_p(f.reshape(-1).copy()))

    n_ff_agree = 0
    for trial in range(40):
        m = [bytearray(p) for p in pkts]
        ti = int(rng.integers(0, len(m)))
        # byte 0 is the version/kind head — identification, not entropy
        # semantics; keep it intact.  Single-bit flips keep more streams
        # decodable than byte splats (more actual comparisons).
        bi = int(rng.integers(1, len(m[ti])))
        m[ti][bi] ^= 1 << int(rng.integers(0, 8))
        mp = [bytes(p) for p in m]
        ours, our_err = _ours_decode_lenient(mp, bpp)
        orc, orc_err = _oracle_decode_lenient(mp, bpp)
        # layer 1: native == oracle wherever both decode
        for t in range(min(len(ours), len(orc))):
            np.testing.assert_array_equal(
                ours[t], orc[t],
                err_msg=f"native/oracle split, trial {trial} t={t}")
        ff, ff_err = _ff_decode_lenient(mp, bpp)
        upto = min(len(ours), len(ff), ti)
        for t in range(upto):
            np.testing.assert_array_equal(
                ours[t], ff[t], err_msg=f"trial {trial} pre-mutation t={t}")
        for t in range(ti, min(len(ours), len(ff))):
            if np.array_equal(ours[t], ff[t]):
                n_ff_agree += 1
    # the fuzz must actually exercise cross-implementation agreement on
    # mutated packets (not reject everything)
    assert n_ff_agree > 0


def test_v2_16bpp_cntab_bank_overflow_native_oracle():
    """Fresh-seed fuzz (round 4) found the native clr_guarded rejecting
    streams the oracle decodes: at v2/16bpp SC_CXSHIFT=0 a corrupt symbol
    pushes cx+cx1 past the 4096-entry channel bank, but the reference's
    cntab is ONE FLAT Uint32Array (EntroCoders.hx:55) — channel-0/1
    overflow legally reads the neighboring bank and decode proceeds.
    Pin the exact mutated stream: native and oracle must agree on every
    frame both decode."""
    rng = np.random.default_rng(7216)
    frames = xval.blocky_frames(rng, W, H, 5, bpp=16, scroll=1)
    enc = ScreenPressorEncoder(2, W, H, bpp=16)
    pkts = [enc.encode_i(frames[0].reshape(-1).copy())]
    for f in frames[1:]:
        pkts.append(enc.encode_p(f.reshape(-1).copy()))
    m = [bytearray(p) for p in pkts]
    m[0][36] ^= 1 << 5  # the fuzz trial's bit flip (seed 7216, trial 1)
    mp = [bytes(p) for p in m]
    ours, _ = _ours_decode_lenient(mp, 16)
    orc, _ = _oracle_decode_lenient(mp, 16)
    assert min(len(ours), len(orc)) > 0
    for t in range(min(len(ours), len(orc))):
        np.testing.assert_array_equal(ours[t], orc[t], err_msg=str(t))


def test_walked_blocks_stay_touched():
    """Fresh-seed fuzz (round 4), second find: a corrupt overlong run
    WALKS below its rect (reference semantics) and writes pixels in
    blocks the block map never declared; deriving the sparse pre-copy's
    `touched` from bts alone left those blocks showing t-2 content TWO
    frames later (the walk frame itself matched).  Pin the exact stream:
    native == oracle on every frame, including t+1 after the walk."""
    W2, H2 = 80, 64
    rng = np.random.default_rng(8101 + 3 * 10 + 16)
    frames = xval.blocky_frames(rng, W2, H2, 7, bpp=16, scroll=2)
    enc = ScreenPressorEncoder(3, W2, H2, bpp=16)
    pkts = [enc.encode_i(frames[0].reshape(-1).copy())]
    for f in frames[1:]:
        pkts.append(enc.encode_p(f.reshape(-1).copy()))
    # replay the fuzz rng to trial 18's mutation (ti=3, bi=35)
    mut = None
    for trial in range(19):
        ti = int(rng.integers(0, len(pkts)))
        bi = int(rng.integers(1, len(pkts[ti])))
        bit = int(rng.integers(0, 8))
        mut = (ti, bi, bit)
    ti, bi, bit = mut
    assert (ti, bi) == (3, 35), "fixture drift — regenerate the repro"
    m = [bytearray(p) for p in pkts]
    m[ti][bi] ^= 1 << bit
    mp = [bytes(p) for p in m]
    ours, _ = _ours_decode_lenient(mp, 16, W=W2, H=H2)
    orc, _ = _oracle_decode_lenient(mp, 16, W=W2, H=H2)
    assert min(len(ours), len(orc)) >= 5
    for t in range(min(len(ours), len(orc))):
        np.testing.assert_array_equal(ours[t], orc[t], err_msg=str(t))


def test_rc_zero_freq_stream_terminates():
    """A corrupt v2 stream whose code value runs decode_val_uni's bucket
    scan to x==16 used to reach RangeDecoder._decode with freq == 0 —
    range became 0 and the renormalization loop never terminated (the
    oracle hung FOREVER; fuzz seed 904718, v2 16bpp 96x64 trial 280).
    The clamp mirrors the native twin (spdec.cpp RangeDecoder::decode):
    decode garbage, raise a structural error, anything but a hang."""
    import base64
    import signal
    import zlib

    pkt = zlib.decompress(base64.b85decode(
        b"c-jGL0F?g{022}e)9)(C(dUas!~0)~H?e=J{YrEQQjCSk)g`9l0}w<j9N-FGzG2To"
        b"sXKSg{5t;!^{*(xUP|%8k#mQ@B4#B3^dz7-Ov?|jl2&!8#4#Sj;_LS^3SK0{(#o0F"
        b"O?j_yvK;^b007aHGNb"))

    class Hang(Exception):
        pass

    def on_alarm(*a):
        raise Hang("oracle RC decode did not terminate")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(60)
    try:
        dec = ScreenPressor(96, 64, 16)
        dec.preinit(0)
        dst = np.zeros(96 * 64, dtype=np.uint32)
        try:
            dec.decompress_i(pkt, dst)
        except (ValueError, IndexError, AssertionError):
            pass  # structural rejection is fine; only a hang is a bug
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
