"""Native (C++) decoder vs Python oracle: bit-exact parity for ScreenPressor
v2/v3/v4 decode, command capture, and the MSVideo1 command parser."""

import numpy as np
import pytest

from jsplayer_tpu import native
from jsplayer_tpu.codecs.msvideo1 import parse_commands
from jsplayer_tpu.codecs.screenpressor import ScreenPressor
from jsplayer_tpu.encode.msv1_enc import random_stream_8, random_stream_16
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")

X, Y = 64, 48
NPIX = X * Y


def build_sp_streams(version, seed, nframes=10):
    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(version, X, Y)
    f = np.full((Y, X), pack_rgb(7, 7, 7), dtype=np.uint32)
    f[4:9, 4:9] = pack_rgb(1, 2, 3)
    f = f.reshape(-1)
    streams = [enc.encode_i(f)]
    for t in range(nframes - 1):
        nf = f.copy().reshape(Y, X)
        mode = t % 5
        if mode == 0:
            nf[2:, :] = nf[:-2, :].copy()  # scroll → motion
        elif mode == 1:
            nf[10:14, 40:60] = pack_rgb(*rng.integers(0, 256, 3))  # subrect
        elif mode == 2:
            pass  # unchanged
        elif mode == 3:
            nf[:, :] = rng.integers(0, 1 << 24, (Y, X), dtype=np.uint32) \
                if t == 3 else nf  # noise (raw escapes) once
        else:
            nf[20:36, 0:32] = pack_rgb(*rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        if t == 5:
            streams.append(enc.encode_i(f))  # mid-sequence I (renew)
        else:
            streams.append(enc.encode_p(f))
    return streams


@pytest.mark.parametrize("version", [2, 3, 4])
def test_sp_native_oracle_parity(version):
    streams = build_sp_streams(version, 100 + version)
    nat = native.NativeScreenPressor(X, Y, 24)
    nat.preinit(8)
    orc = ScreenPressor(X, Y, 24)
    orc.preinit(8)
    prev_native = None
    for t, s in enumerate(streams):
        isk = nat.is_key_frame(s)
        assert isk == orc.is_key_frame(s)
        cap_o: dict = {}
        orc.capture = cap_o
        dst = np.zeros(NPIX, dtype=np.uint32)
        if isk:
            orc.decompress_i(s, dst)
            ofr, osig = dst, None
        else:
            res = orc.decompress_p(s, dst)
            ofr, osig = res.data, res.significant_changes
        fr, sig, cap_n = nat.decompress(s, isk, capture=True)
        got = fr if fr is not None else prev_native
        np.testing.assert_array_equal(got, ofr, err_msg=f"v{version} frame {t}")
        if osig is not None:
            assert sig == osig
        # command capture parity
        np.testing.assert_array_equal(cap_n["bts"], cap_o["bts"])
        np.testing.assert_array_equal(cap_n["mv"], cap_o["mv"])
        np.testing.assert_array_equal(cap_n["rect"], cap_o["rect"])
        assert cap_n["changed"] == cap_o["changed"]
        prev_native = np.array(got, copy=True)


def test_sp_native_zero_copy_view():
    streams = build_sp_streams(4, 7, nframes=4)
    nat = native.NativeScreenPressor(X, Y, 24)
    nat.preinit(0)
    c = native.NativeScreenPressor(X, Y, 24)
    c.preinit(0)
    for s in streams:
        isk = nat.is_key_frame(s)
        v, _, _ = nat.decompress(s, isk, copy=False)
        w, _, _ = c.decompress(s, isk, copy=True)
        if v is None:
            v = nat.latest_view()
        if w is None:
            w = c.latest_view()
        np.testing.assert_array_equal(np.asarray(v), w)


@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_msv1_parse_native_parity(bits, seed):
    rng = np.random.default_rng(seed)
    pal = (rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
           if bits == 8 else None)
    for trial in range(4):
        if bits == 16:
            src = random_stream_16(rng, X, Y, allow_skip=trial > 0)
        else:
            src = random_stream_8(rng, X, Y, allow_skip=trial > 0)
        bt_p, sel_p, col_p, chg_p = parse_commands(src, X, Y, pal=pal)
        bt_n, sel_n, col_n, chg_n = native.native_msv1_parse(src, X, Y, pal=pal)
        np.testing.assert_array_equal(bt_n, bt_p)
        np.testing.assert_array_equal(sel_n, sel_p)
        np.testing.assert_array_equal(col_n, col_p)
        assert chg_n == chg_p


@pytest.mark.parametrize("bits", [16, 8])
def test_msv1_native_decode_parity(bits):
    from jsplayer_tpu.codecs.msvideo1 import MSVideo1_8bit, MSVideo1_16bit
    from jsplayer_tpu.encode.msv1_enc import random_stream_8, random_stream_16

    rng = np.random.default_rng(500 + bits)
    pal = (rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
           if bits == 8 else None)
    orc = (MSVideo1_8bit(X, Y, pal.astype("<u4").tobytes()) if bits == 8
           else MSVideo1_16bit(X, Y))
    orc.preinit(8)
    nat = native.NativeMsv1(X, Y, palette=pal)
    nat.preinit(8)
    prev = None
    for t in range(10):
        s = (random_stream_16(rng, X, Y, t > 0) if bits == 16
             else random_stream_8(rng, X, Y, t > 0))
        dst = np.zeros(NPIX, dtype=np.uint32)
        res = orc.decompress_p(s, dst)
        fr, sig = nat.decompress(s)
        if res.data is None:
            assert fr is None
            continue
        got = fr if fr is not None else prev
        np.testing.assert_array_equal(got, res.data, err_msg=f"frame {t}")
        assert sig == res.significant_changes
        prev = None if got is None else got.copy()


def test_sparse_copy_forward_read_regression():
    """Regression (caught by soak): a data-rect row-start at x==0 reads the
    rightmost pixel of the previous row — a block processed LATER this frame.
    The native decoder's sparse pre-copy must therefore also copy blocks that
    are fully painted this frame when the previous frame touched them,
    matching the oracle's wholesale prev pre-copy semantics."""
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder

    X2 = Y2 = 32  # 2x2 block grid
    A, B, C = pack_rgb(10, 10, 10), pack_rgb(99, 50, 25), pack_rgb(1, 2, 3)
    enc = ScreenPressorEncoder(4, X2, Y2)
    f0 = np.full((Y2, X2), A, dtype=np.uint32)
    f1 = f0.copy()
    f1[16:32, 16:32] = B  # touch block (1,1)
    f2 = f1.copy()
    f2[17:32, 0:16] = B  # block (1,0): ptype-1 runs whose row starts read
    f2[16:32, 16:32] = C  # block (1,1): fully repainted this frame
    streams = [enc.encode_i(f0.reshape(-1)), enc.encode_p(f1.reshape(-1)),
               enc.encode_p(f2.reshape(-1))]
    golds = [f0, f1, f2]
    nat = native.NativeScreenPressor(X2, Y2, 24)
    nat.preinit(0)
    prev = None
    for t, s in enumerate(streams):
        fr, _, _ = nat.decompress(s, nat.is_key_frame(s))
        got = fr if fr is not None else prev
        np.testing.assert_array_equal(got.reshape(Y2, X2), golds[t],
                                      err_msg=f"frame {t}")
        prev = np.array(got, copy=True)


@pytest.mark.parametrize("version", [2, 3, 4])
def test_soak_random_chain(version):
    """Scaled-down soak: 40-frame random evolution (scrolls both axes, noise,
    paints, row fills, stills) — native encode → native decode must be
    pixel-exact throughout (this pattern caught the sparse-copy bug)."""
    rng = np.random.default_rng(9000 + version)
    enc = native.NativeScreenPressorEncoder(version, X, Y)
    nat = native.NativeScreenPressor(X, Y, 24)
    nat.preinit(16)
    f = np.full((Y, X), pack_rgb(8, 8, 8), dtype=np.uint32).reshape(-1)
    prev = None
    for t in range(40):
        nf = f.copy().reshape(Y, X)
        op = rng.integers(0, 6)
        if op == 0:
            sh = int(rng.integers(1, 9))
            nf[sh:, :] = nf[:-sh, :].copy()
        elif op == 1:
            x0, y0 = int(rng.integers(0, X - 8)), int(rng.integers(0, Y - 8))
            nf[y0 : y0 + 6, x0 : x0 + 6] = rng.integers(
                0, 1 << 24, (6, 6), dtype=np.uint32)
        elif op == 2:
            pass
        elif op == 3:
            x0, y0 = int(rng.integers(0, X - 20)), int(rng.integers(0, Y - 12))
            nf[y0 : y0 + 10, x0 : x0 + 18] = pack_rgb(*rng.integers(0, 256, 3))
        elif op == 4:
            nf[:, 2:] = nf[:, :-2].copy()
        else:
            nf[int(rng.integers(0, Y - 2)), :] = pack_rgb(*rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        data = enc.encode_i(f) if t % 17 == 0 else enc.encode_p(f)
        fr, _, _ = nat.decompress(data, nat.is_key_frame(data))
        got = fr if fr is not None else prev
        np.testing.assert_array_equal(got, f, err_msg=f"v{version} t={t}")
        prev = np.array(got, copy=True)


@pytest.mark.parametrize("version", [3, 4])
def test_rans_B_boundary_reinit(version):
    """Noise I-frame with >131072 counted symbols crosses the rANS B-reinit
    several times (ANS.hx:10; chunked reverse encoder framing) — native and
    oracle must both round-trip it."""
    Xb, Yb = 512, 256
    rng = np.random.default_rng(version)
    f = rng.integers(0, 1 << 24, (Yb, Xb), dtype=np.uint32).reshape(-1)
    enc = native.NativeScreenPressorEncoder(version, Xb, Yb)
    data = enc.encode_i(f)
    nat = native.NativeScreenPressor(Xb, Yb, 24)
    nat.preinit(0)
    fr, _, _ = nat.decompress(data, True)
    np.testing.assert_array_equal(fr, f)
    orc = ScreenPressor(Xb, Yb, 24)
    orc.preinit(0)
    dst = np.zeros(Xb * Yb, dtype=np.uint32)
    orc.decompress_i(data, dst)
    np.testing.assert_array_equal(dst, f)


def test_rc_renorm_heavy_v2_big_noise():
    """v2 range coder under heavy adaptation: a noise I-frame large enough to
    drive many BOT-boundary halvings (RangeCoder.hx:70-77, 113-127) and table
    rescans — native and oracle must both round-trip it."""
    Xb, Yb = 256, 128
    rng = np.random.default_rng(2)
    f = rng.integers(0, 1 << 24, (Yb, Xb), dtype=np.uint32).reshape(-1)
    enc = native.NativeScreenPressorEncoder(2, Xb, Yb)
    data = enc.encode_i(f)
    nat = native.NativeScreenPressor(Xb, Yb, 24)
    nat.preinit(0)
    fr, _, _ = nat.decompress(data, True)
    np.testing.assert_array_equal(fr, f)
    orc = ScreenPressor(Xb, Yb, 24)
    orc.preinit(0)
    dst = np.zeros(Xb * Yb, dtype=np.uint32)
    orc.decompress_i(data, dst)
    np.testing.assert_array_equal(dst, f)


@pytest.mark.parametrize("X,Y", [(64, 48), (64, 40)])
def test_native_kmv_paycode_matches_numpy_prepare(X, Y):
    """sp_decompress_kmv / sp_decode_streams_kmv vs kernels.sp_recon.prepare_kmv
    (same grouping, tie-break, demotion, and plane packing) — including
    partial bottom block rows (Y=40 → 16+16+8)."""
    from jsplayer_tpu import native
    from jsplayer_tpu.kernels import sp_recon

    if not native.available():
        pytest.skip("native unavailable")
    enc = native.NativeScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(3)
    f = np.full((Y, X), 0x010203, dtype=np.uint32)
    streams = [enc.encode_i(f.reshape(-1))]
    for t in range(9):
        nf = f.copy()
        if t % 3 == 0:
            nf[2:, :] = nf[:-2, :]
        elif t % 3 == 1:
            nf[10:30, 5:40] = nf[6:26, 9:44]  # second motion region
            nf[1:4, 1:9] = int(rng.integers(0, 1 << 24))
        # t%3==2: still
        f = nf
        streams.append(enc.encode_p(f.reshape(-1)))
    # reference path: capture + numpy prepare
    ref = native.native_sp_decode_streams([streams], X, Y)
    pc_ref, mvk_ref = sp_recon.prepare_kmv(
        ref["bts"][0], ref["mv"][0], ref["rect"][0], ref["payload"][0], K=2)
    # native batch path
    got = native.native_sp_decode_streams_kmv([streams], X, Y, K=2)
    np.testing.assert_array_equal(got["changed"][0], ref["changed"][0])
    for t in range(len(streams)):
        if not got["changed"][0][t]:
            continue  # paycode undefined for unchanged frames
        np.testing.assert_array_equal(got["mvk"][0, t], mvk_ref[t],
                                      err_msg=f"mvk frame {t}")
        np.testing.assert_array_equal(got["paycode"][0, t], pc_ref[t],
                                      err_msg=f"paycode frame {t}")
    # per-frame handle path
    d = native.NativeScreenPressor(X, Y, 24)
    d.preinit(0)
    pc1 = np.zeros((Y, X), np.uint32)
    mvk1 = np.zeros((2, 2), np.int32)
    for t, s in enumerate(streams):
        chg, _sig = d.decompress_kmv(s, d.is_key_frame(s), pc1, mvk1, K=2)
        assert chg == bool(ref["changed"][0][t])
        if chg:
            np.testing.assert_array_equal(pc1, pc_ref[t])
            np.testing.assert_array_equal(mvk1, mvk_ref[t])


def test_native_kmv_sparse_matches_numpy_prepare():
    """sp_decompress_kmv_sparse per frame vs prepare_kmv_sparse (with prev0):
    same bcode, mvk, tile contents/origins, pads."""
    from jsplayer_tpu import native
    from jsplayer_tpu.kernels import sp_recon

    if not native.available():
        pytest.skip("native unavailable")
    X, Y = 64, 40  # partial bottom block row
    enc = native.NativeScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(13)
    f = np.full((Y, X), 0x0A0B0C, dtype=np.uint32)
    f[8:24, 16:48] = 0x445566
    streams = [enc.encode_i(f.reshape(-1))]
    for t in range(8):
        nf = f.copy()
        if t % 3 == 0:
            nf[2:, :] = nf[:-2, :]        # scroll (bts 3/4 motion)
        elif t % 3 == 1:
            nf[4:9, 3:17] = int(rng.integers(0, 1 << 24))  # paint
        f = nf
        streams.append(enc.encode_p(f.reshape(-1)))
    ref = native.native_sp_decode_streams([streams], X, Y)
    bc_ref, mvk_ref, tiles_ref, tyx_ref = sp_recon.prepare_kmv_sparse(
        ref["bts"][0][1:], ref["mv"][0][1:], ref["rect"][0][1:],
        ref["payload"][0][1:], K=2, prev0=ref["payload"][0][0])
    M = tiles_ref.shape[1]
    d = native.NativeScreenPressor(X, Y, 24)
    d.preinit(0)
    nb = d.nbx * d.nby
    bc = np.zeros(nb, np.uint8)
    mvk = np.zeros((2, 2), np.int32)
    tiles = np.zeros((M, 16, 16), np.uint32)
    tyx = np.zeros((M, 2), np.int32)
    for t, s in enumerate(streams):
        chg, sig, m_used = d.decompress_kmv_sparse(
            s, d.is_key_frame(s), bc, mvk, tiles, tyx, K=2)
        if t == 0:
            assert m_used == -1  # keyframe ships dense
            continue
        assert chg == bool(ref["changed"][0][t])
        if not chg:
            continue
        i = t - 1
        np.testing.assert_array_equal(bc, bc_ref[i], err_msg=f"bcode {t}")
        np.testing.assert_array_equal(mvk, mvk_ref[i], err_msg=f"mvk {t}")
        np.testing.assert_array_equal(tiles, tiles_ref[i], err_msg=f"tiles {t}")
        np.testing.assert_array_equal(tyx, tyx_ref[i], err_msg=f"tyx {t}")


def test_gop_split_kmv_decode_matches_continuous():
    """gop_split=True (single-stream core scaling) reproduces the
    continuous decode's transport exactly on changed frames."""
    from jsplayer_tpu import native

    if not native.available():
        pytest.skip("native unavailable")
    X, Y = 64, 48
    enc = native.NativeScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(17)
    streams = []
    f = np.full((Y, X), 0x030201, dtype=np.uint32)
    for t in range(14):
        if t % 5 == 0:
            enc = native.NativeScreenPressorEncoder(4, X, Y)
            f = np.full((Y, X), 0x030201 + t, dtype=np.uint32)
            f[4:20, 8:40] = int(rng.integers(0, 1 << 24))
            streams.append(enc.encode_i(f.reshape(-1)))
        else:
            nf = f.copy()
            if t % 2:
                nf[2:, :] = nf[:-2, :]
            else:
                nf[6:10, 4:30] = int(rng.integers(0, 1 << 24))
            f = nf
            streams.append(enc.encode_p(f.reshape(-1)))
    a = native.native_sp_decode_streams_kmv([streams], X, Y, K=2)
    b = native.native_sp_decode_streams_kmv([streams], X, Y, K=2,
                                            gop_split=True, nthreads=4)
    np.testing.assert_array_equal(a["changed"], b["changed"])
    np.testing.assert_array_equal(a["signif"], b["signif"])
    for t in range(len(streams)):
        if a["changed"][0][t]:
            np.testing.assert_array_equal(a["paycode"][0, t],
                                          b["paycode"][0, t],
                                          err_msg=f"frame {t}")
            np.testing.assert_array_equal(a["mvk"][0, t], b["mvk"][0, t])


def test_native_kmv_dirty_incremental_fill_matches_full():
    """Incremental paycode fills (dirty-block tracking) must leave the
    plane bitwise-identical to a stateless full fill, across plane reuse
    with DIFFERENT content, I→P transitions, and stills (spdec.cpp
    fill_paycode_p; the fill was most of the host stage at 1080p)."""
    from jsplayer_tpu import native

    if not native.available():
        pytest.skip("native unavailable")
    X, Y = 64, 48
    nb = ((X + 15) // 16) * ((Y + 15) // 16)
    rng = np.random.default_rng(11)

    def make_stream(seed):
        enc = native.NativeScreenPressorEncoder(4, X, Y)
        r = np.random.default_rng(seed)
        f = np.full((Y, X), 0x0A0B0C + seed, dtype=np.uint32)
        out = [enc.encode_i(f.reshape(-1))]
        for t in range(7):
            nf = f.copy()
            if t % 3 == 0:
                nf[2:, :] = nf[:-2, :]
            elif t % 3 == 1:
                y0, x0 = int(r.integers(0, Y - 8)), int(r.integers(0, X - 8))
                nf[y0:y0 + 6, x0:x0 + 6] = int(r.integers(0, 1 << 24))
            # t%3==2: still
            f = nf
            out.append(enc.encode_p(f.reshape(-1)))
        return out

    # ONE plane + dirty row reused across two different streams back-to-back
    plane = np.zeros((Y, X), np.uint32)
    dirty = np.zeros(nb + 1, np.int32)
    mvk = np.zeros((2, 2), np.int32)
    for seed in (1, 2):
        d_inc = native.NativeScreenPressor(X, Y, 24)
        d_inc.preinit(0)
        d_full = native.NativeScreenPressor(X, Y, 24)
        d_full.preinit(0)
        for t, s in enumerate(make_stream(seed)):
            chg, _ = d_inc.decompress_kmv(s, d_inc.is_key_frame(s), plane,
                                          mvk, K=2, dirty=dirty)
            ref_plane = np.zeros((Y, X), np.uint32)
            ref_mvk = np.zeros((2, 2), np.int32)
            chg2, _ = d_full.decompress_kmv(s, d_full.is_key_frame(s),
                                            ref_plane, ref_mvk, K=2)
            assert chg == chg2
            if chg:
                np.testing.assert_array_equal(
                    plane, ref_plane, err_msg=f"seed {seed} frame {t}")
                np.testing.assert_array_equal(mvk, ref_mvk)
