"""MSVideo1: encoder→oracle round-trip and oracle↔device bit-exact parity."""

import numpy as np
import pytest

from jsplayer_tpu.codecs.msvideo1 import (
    MSVideo1_8bit,
    MSVideo1_16bit,
    from_rgb15,
    palette_to_u32,
    parse_commands,
)
from jsplayer_tpu.encode.msv1_enc import (
    encode_frame_8,
    encode_frame_16,
    random_stream_8,
    random_stream_16,
    to_rgb15,
)

X, Y = 32, 24
NPIX = X * Y


def rand_frame_rgb15(rng, nuniq=6):
    """Frame on the RGB555 lattice with blocks that are 8-color encodable:
    each 2x2 quadrant gets at most 2 colors."""
    palette = np.array([from_rgb15(int(c)) for c in rng.integers(0, 0x8000, nuniq)],
                       dtype=np.uint32)
    # choose 2 colors per 2x2 quadrant
    qsel = rng.integers(0, nuniq, (Y // 2, X // 2, 2))
    bit = rng.integers(0, 2, (Y, X))
    qy, qx = np.mgrid[0:Y, 0:X]
    cidx = qsel[qy // 2, qx // 2, bit]
    return palette[cidx].reshape(-1)


def rand_frame_pal8(rng, nuniq=5):
    idxpal = rng.integers(0, 256, nuniq)
    qsel = rng.integers(0, nuniq, (Y // 2, X // 2, 2))
    bit = rng.integers(0, 2, (Y, X))
    qy, qx = np.mgrid[0:Y, 0:X]
    return idxpal[qsel[qy // 2, qx // 2, bit]].reshape(-1).astype(np.uint8)


def mutate_some_blocks(rng, frame, other):
    """Copy some random 4x4 blocks from `other` into a copy of `frame`."""
    out = frame.copy().reshape(Y, X)
    o = other.reshape(Y, X)
    for _ in range(rng.integers(1, 12)):
        by = int(rng.integers(0, Y // 4)) * 4
        bx = int(rng.integers(0, X // 4)) * 4
        out[by : by + 4, bx : bx + 4] = o[by : by + 4, bx : bx + 4]
    return out.reshape(-1)


# -- 16-bit ------------------------------------------------------------------

def test_roundtrip_16_single_frames():
    rng = np.random.default_rng(1)
    for trial in range(5):
        frame = rand_frame_rgb15(rng)
        data = encode_frame_16(frame, None, X, Y)
        dec = MSVideo1_16bit(X, Y)
        dec.preinit(0)
        dst = np.zeros(NPIX, dtype=np.uint32)
        res = dec.decompress_p(bytes(data), dst)
        np.testing.assert_array_equal(res.data, frame)


def test_roundtrip_16_p_chain():
    rng = np.random.default_rng(2)
    f0 = rand_frame_rgb15(rng)
    frames = [f0]
    for _ in range(6):
        frames.append(mutate_some_blocks(rng, frames[-1], rand_frame_rgb15(rng)))
    dec = MSVideo1_16bit(X, Y)
    dec.preinit(4)
    streams = []
    prev = None
    for f in frames:
        streams.append(encode_frame_16(f, prev, X, Y))
        prev = f
    for f, s in zip(frames, streams):
        dst = np.zeros(NPIX, dtype=np.uint32)
        res = dec.decompress_p(s, dst)
        np.testing.assert_array_equal(res.data, f)


def test_unchanged_frame_returns_prev_16():
    rng = np.random.default_rng(3)
    f = rand_frame_rgb15(rng)
    dec = MSVideo1_16bit(X, Y)
    dec.preinit(0)
    dst0 = np.zeros(NPIX, dtype=np.uint32)
    dec.decompress_p(encode_frame_16(f, None, X, Y), dst0)
    # all-skip stream
    s = encode_frame_16(f, f, X, Y)
    dst1 = np.zeros(NPIX, dtype=np.uint32)
    res = dec.decompress_p(s, dst1)
    assert res.data is dst0  # prev pointer, not the new buffer
    assert res.significant_changes is False


def test_is_key_frame_16():
    rng = np.random.default_rng(4)
    f = rand_frame_rgb15(rng)
    dec = MSVideo1_16bit(X, Y)
    key_stream = encode_frame_16(f, None, X, Y)
    assert dec.is_key_frame(key_stream)
    f2 = mutate_some_blocks(rng, f, rand_frame_rgb15(rng))
    p_stream = encode_frame_16(f2, f, X, Y)
    assert not dec.is_key_frame(p_stream)
    assert not dec.is_key_frame(b"")


def test_significant_changes_16():
    rng = np.random.default_rng(5)
    f = rand_frame_rgb15(rng)
    dec = MSVideo1_16bit(X, Y)
    insign_lines = 8
    dec.preinit(insign_lines)
    dst = np.zeros(NPIX, dtype=np.uint32)
    dec.decompress_p(encode_frame_16(f, None, X, Y), dst)
    # change only inside the insignificant band (lines < 8 = block rows 0,1)
    f2 = f.copy().reshape(Y, X)
    f2[0:4, 0:4] = from_rgb15(0x1234)
    f2 = f2.reshape(-1)
    res = dec.decompress_p(encode_frame_16(f2, f, X, Y),
                           np.zeros(NPIX, dtype=np.uint32))
    assert res.significant_changes is False
    # change above the band
    f3 = f2.copy().reshape(Y, X)
    f3[12:16, 8:12] = from_rgb15(0x7FFF)
    f3 = f3.reshape(-1)
    res = dec.decompress_p(encode_frame_16(f3, f2, X, Y),
                           np.zeros(NPIX, dtype=np.uint32))
    assert res.significant_changes is True


# -- 8-bit -------------------------------------------------------------------

def make_pal8(rng):
    return rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)


def test_roundtrip_8_chain():
    rng = np.random.default_rng(6)
    pal_u32 = make_pal8(rng)
    pal_bytes = pal_u32.astype("<u4").tobytes()
    idx0 = rand_frame_pal8(rng)
    chain = [idx0]
    for _ in range(5):
        chain.append(mutate_some_blocks(rng, chain[-1].astype(np.uint32),
                                        rand_frame_pal8(rng).astype(np.uint32)).astype(np.uint8))
    dec = MSVideo1_8bit(X, Y, pal_bytes)
    dec.preinit(4)
    prev = None
    for i, idx in enumerate(chain):
        s = encode_frame_8(idx, prev, X, Y, terminator=(i % 2 == 1))
        dst = np.zeros(NPIX, dtype=np.uint32)
        res = dec.decompress_p(s, dst)
        np.testing.assert_array_equal(res.data, pal_u32[idx])
        prev = idx


def test_is_key_frame_8():
    rng = np.random.default_rng(7)
    pal_u32 = make_pal8(rng)
    pal_bytes = pal_u32.astype("<u4").tobytes()
    dec = MSVideo1_8bit(X, Y, pal_bytes)
    idx = rand_frame_pal8(rng)
    assert dec.is_key_frame(encode_frame_8(idx, None, X, Y))
    idx2 = mutate_some_blocks(rng, idx.astype(np.uint32),
                              rand_frame_pal8(rng).astype(np.uint32)).astype(np.uint8)
    assert not dec.is_key_frame(encode_frame_8(idx2, idx, X, Y))


# -- device parity ------------------------------------------------------------

def _oracle_decode_stream(streams, decoder):
    out = []
    sigs = []
    for s in streams:
        dst = np.zeros(NPIX, dtype=np.uint32)
        res = decoder.decompress_p(s, dst)
        out.append(None if res.data is None else res.data.copy())
        sigs.append(res.significant_changes)
    return out, sigs


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_parity_random_opcodes(bits, seed):
    """Fuzzed opcode streams: oracle vs device decode must be bit-exact,
    including significant-change flags."""
    from jsplayer_tpu.kernels.msv1_paint import decode_sequence
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    pal_u32 = make_pal8(rng) if bits == 8 else None
    T = 6
    streams = []
    for t in range(T):
        allow_skip = t > 0
        if bits == 16:
            streams.append(random_stream_16(rng, X, Y, allow_skip))
        else:
            streams.append(random_stream_8(rng, X, Y, allow_skip))

    if bits == 16:
        dec = MSVideo1_16bit(X, Y)
    else:
        dec = MSVideo1_8bit(X, Y, pal_u32.astype("<u4").tobytes())
    insign = 8
    dec.preinit(insign)
    oracle_frames, oracle_sigs = _oracle_decode_stream(streams, dec)

    nb = (X // 4) * (Y // 4)
    bt = np.zeros((T, nb), dtype=np.uint8)
    sel = np.zeros((T, nb, 16), dtype=np.uint8)
    col = np.zeros((T, nb, 8), dtype=np.uint32)
    chg = np.zeros(T, dtype=bool)
    for t, s in enumerate(streams):
        bt[t], sel[t], col[t], chg[t] = parse_commands(
            s, X, Y, pal=pal_u32 if bits == 8 else None
        )

    insign_blocks = (insign + 3) >> 2
    insign_lines = insign if bits == 16 else 0  # 8-bit quirk parity
    from jsplayer_tpu.kernels.msv1_paint import sel_to_plane

    frames, sigs = decode_sequence(
        jnp.zeros((Y, X), dtype=jnp.uint32),
        jnp.array(False),
        jnp.array(bt), jnp.array(sel_to_plane(sel, Y, X)), jnp.array(col),
        jnp.array(chg),
        jnp.int32(insign_blocks), jnp.int32(insign_lines), X // 4,
    )
    frames = np.asarray(frames).reshape(T, NPIX)
    sigs = np.asarray(sigs)
    for t in range(T):
        np.testing.assert_array_equal(
            frames[t], oracle_frames[t], err_msg=f"frame {t} ({bits}-bit)"
        )
        assert bool(sigs[t]) == bool(oracle_sigs[t]), f"sig {t} ({bits}-bit)"


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("parser", ["python", "native"])
def test_zero_count_skip_token_matches_oracle(bits, parser):
    """A skip token whose count is 0 (a=0, b=0x84) makes the decoder's
    countdown start at -1, so every later block of the frame is skipped and
    the tokens after it are never read.  The device's command parse must
    paint exactly what the oracle paints."""
    from jsplayer_tpu import native as _native

    if parser == "native" and not _native.available():
        pytest.skip("native unavailable")
    parse = parse_commands if parser == "python" else \
        _native.native_msv1_parse
    rng = np.random.default_rng(9)
    pal_u32 = make_pal8(rng) if bits == 8 else None
    one_color = (bytes([0x12, 0x80]) if bits == 8
                 else bytes([0x34, 0x92]))                 # b >= 0x80
    src = one_color * 5 + bytes([0x00, 0x84]) + one_color * 20
    dec = (MSVideo1_16bit(X, Y) if bits == 16 else
           MSVideo1_8bit(X, Y, pal_u32.astype("<u4").tobytes()))
    dec.preinit(0)
    prev = dec.decompress_p(random_stream_16(rng, X, Y, False) if bits == 16
                            else random_stream_8(rng, X, Y, False),
                            np.zeros(NPIX, np.uint32)).data.copy()
    want = dec.decompress_p(src, np.zeros(NPIX, np.uint32)).data
    bt, sel, col, _ = parse(src, X, Y, pal=pal_u32)
    assert list(np.nonzero(bt)[0]) == [0, 1, 2, 3, 4]
    got = prev.reshape(Y, X).copy()
    for bi in np.nonzero(bt)[0]:
        by, bx = divmod(int(bi), X // 4)
        got[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = \
            col[bi][sel[bi]].reshape(4, 4)
    np.testing.assert_array_equal(got.reshape(-1), want)


def test_device_parity_encoded_chain():
    from jsplayer_tpu.kernels.msv1_paint import decode_sequence
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    f0 = rand_frame_rgb15(rng)
    frames_px = [f0]
    for _ in range(7):
        frames_px.append(mutate_some_blocks(rng, frames_px[-1], rand_frame_rgb15(rng)))
    streams, prev = [], None
    for f in frames_px:
        streams.append(encode_frame_16(f, prev, X, Y))
        prev = f

    dec = MSVideo1_16bit(X, Y)
    dec.preinit(0)
    oracle_frames, oracle_sigs = _oracle_decode_stream(streams, dec)

    T = len(streams)
    nb = (X // 4) * (Y // 4)
    bt = np.zeros((T, nb), dtype=np.uint8)
    sel = np.zeros((T, nb, 16), dtype=np.uint8)
    col = np.zeros((T, nb, 8), dtype=np.uint32)
    chg = np.zeros(T, dtype=bool)
    for t, s in enumerate(streams):
        bt[t], sel[t], col[t], chg[t] = parse_commands(s, X, Y)

    from jsplayer_tpu.kernels.msv1_paint import sel_to_plane

    dev_frames, dev_sigs = decode_sequence(
        jnp.zeros((Y, X), dtype=jnp.uint32), jnp.array(False),
        jnp.array(bt), jnp.array(sel_to_plane(sel, Y, X)), jnp.array(col),
        jnp.array(chg),
        jnp.int32(0), jnp.int32(0), X // 4,
    )
    dev_frames = np.asarray(dev_frames).reshape(T, NPIX)
    for t in range(T):
        np.testing.assert_array_equal(dev_frames[t], frames_px[t])
        np.testing.assert_array_equal(dev_frames[t], oracle_frames[t])
        assert bool(dev_sigs[t]) == bool(oracle_sigs[t])


def test_msv1_content_soak_native():
    """Content-driven 30-frame chain through encoder → native decoder →
    device command parity (sel/colors paths under realistic skip mixes)."""
    from jsplayer_tpu import native as _native

    if not _native.available():
        pytest.skip("native unavailable")
    rng = np.random.default_rng(42)
    f = rand_frame_rgb15(rng)
    frames = [f]
    for _ in range(29):
        frames.append(mutate_some_blocks(rng, frames[-1], rand_frame_rgb15(rng)))
    nat = _native.NativeMsv1(X, Y)
    nat.preinit(8)
    dec = MSVideo1_16bit(X, Y)
    dec.preinit(8)
    prev = None
    for t, fpx in enumerate(frames):
        s = encode_frame_16(fpx, prev, X, Y)
        fr, _ = nat.decompress(s)
        got = fr if fr is not None else prev_px
        np.testing.assert_array_equal(got, fpx, err_msg=f"frame {t}")
        prev_px = np.array(got, copy=True)
        prev = fpx


def test_msv1_mutation_differential_fuzz():
    """Native ↔ oracle MSV1 on mutated streams (the SP differential-fuzz
    discipline applied to the second codec): wherever both decode, frames
    must agree bit-exactly — corrupt streams keep partial frames
    (MSVideo1.hx:186,369-370 swallows and keeps), and the two
    implementations must keep IDENTICAL partials.  A 900-trial fresh-seed
    sweep ran clean (round 4); this is the CI-sized version."""
    from jsplayer_tpu import native as _native

    if not _native.available():
        pytest.skip("native unavailable")

    def lenient_chain(mk_dec, pkts, is_native):
        dec = mk_dec()
        dec.preinit(8)
        out = []
        prev = np.zeros(X * Y, np.uint32)
        for p in pkts:
            try:
                if is_native:
                    fr, _ = dec.decompress(p)
                    prev = (np.array(fr, copy=True)
                            if fr is not None else prev)
                else:
                    dst = np.zeros(X * Y, np.uint32)
                    r = dec.decompress_p(p, dst)
                    if r.data is not None:  # no-change keeps prev
                        prev = np.asarray(r.data).copy()
                out.append(prev.copy())
            except (ValueError, AssertionError, IndexError):
                return out
        return out

    for seed in (61, 62):
        rng = np.random.default_rng(seed)
        f = rand_frame_rgb15(rng)
        frames = [f]
        for _ in range(7):
            frames.append(
                mutate_some_blocks(rng, frames[-1], rand_frame_rgb15(rng)))
        prev = None
        pkts = []
        for fpx in frames:
            pkts.append(encode_frame_16(fpx, prev, X, Y))
            prev = fpx
        for trial in range(40):
            m = [bytearray(p) for p in pkts]
            ti = int(rng.integers(0, len(m)))
            bi = int(rng.integers(0, len(m[ti])))
            m[ti][bi] ^= int(rng.integers(1, 256))
            mp = [bytes(p) for p in m]
            a = lenient_chain(lambda: _native.NativeMsv1(X, Y), mp, True)
            b = lenient_chain(lambda: MSVideo1_16bit(X, Y), mp, False)
            for t in range(min(len(a), len(b))):
                np.testing.assert_array_equal(
                    a[t], b[t],
                    err_msg=f"seed {seed} trial {trial} frame {t}")
