"""Host thread-pool concurrency soak.

These soaks do not measure parallel throughput — they oversubscribe the pool (threads >> cores) to force
preemption at arbitrary interleavings and flush synchronization bugs the
single-thread CI can't see (SURVEY.md §5.2: real threads need real
discipline).  Every multi-threaded result must be bit-identical to the
single-threaded one, including across repeated runs and with malformed
streams mixed into the batch (the per-stream error paths must not poison
neighbors).  Multi-core *scaling* is not measured here.
"""

import numpy as np
import pytest

from jsplayer_tpu import native as spnative
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb

W, H = 64, 48
B, T = 16, 10


def _streams(seed):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        enc = ScreenPressorEncoder(4, W, H)
        f = np.full((H, W), pack_rgb(b * 3, 50, 90), dtype=np.uint32)
        pkts = [enc.encode_i(f.reshape(-1).copy())]
        for t in range(T - 1):
            kind = int(rng.integers(0, 4))
            if kind == 0:
                f = f.copy()
                f[4:, :] = f[:-4, :].copy()  # scroll
            elif kind == 1:
                y0 = int(rng.integers(0, H - 8))
                x0 = int(rng.integers(0, W - 10))
                f = f.copy()
                f[y0 : y0 + 7, x0 : x0 + 9] = pack_rgb(
                    *rng.integers(0, 256, 3))
            elif kind == 2:  # noise burst (entropy-heavy)
                f = rng.integers(0, 1 << 24, (H, W)).astype(np.uint32)
            # kind 3: still
            pkts.append(enc.encode_p(f.reshape(-1).copy()))
        out.append(pkts)
    return out


@pytest.fixture(scope="module")
def corpus():
    if not spnative.available():
        pytest.skip("native library unavailable")
    return _streams(0)


def _poison(streams, seed):
    """Corrupt a few streams mid-batch (the quarantine/error interleaving)."""
    rng = np.random.default_rng(seed)
    out = [list(s) for s in streams]
    for b in (3, 7, 12):
        t = int(rng.integers(1, T))
        pkt = bytearray(out[b][t])
        for _ in range(4):
            pkt[int(rng.integers(1, len(pkt)))] ^= 0xFF
        out[b][t] = bytes(pkt)
    return out


def test_soak_decode_streams_oversubscribed(corpus):
    ref = spnative.native_sp_decode_streams(corpus, W, H, nthreads=1)
    for rep in range(4):
        got = spnative.native_sp_decode_streams(corpus, W, H, nthreads=B)
        for k in ("payload", "bts", "mv", "rect", "changed"):
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg=f"rep {rep} {k}")


def test_soak_kmv_oversubscribed(corpus):
    ref = spnative.native_sp_decode_streams_kmv(corpus, W, H, K=2,
                                                nthreads=1)
    for rep in range(4):
        got = spnative.native_sp_decode_streams_kmv(corpus, W, H, K=2,
                                                    nthreads=B)
        ch = ref["changed"]
        np.testing.assert_array_equal(got["changed"], ch)
        np.testing.assert_array_equal(got["mvk"], ref["mvk"])
        # paycode defined only where changed
        np.testing.assert_array_equal(got["paycode"][ch],
                                      ref["paycode"][ch],
                                      err_msg=f"rep {rep}")


def test_soak_bc_oversubscribed(corpus):
    ref = spnative.native_sp_decode_streams_bc(corpus, W, H, K=2, nthreads=1)
    for rep in range(4):
        got = spnative.native_sp_decode_streams_bc(corpus, W, H, K=2,
                                                   nthreads=B)
        np.testing.assert_array_equal(got["changed"], ref["changed"])
        np.testing.assert_array_equal(got["bcode"], ref["bcode"])
        np.testing.assert_array_equal(got["mvk"], ref["mvk"])


def test_soak_with_poisoned_streams(corpus):
    bad = _poison(corpus, 1)
    ref = spnative.native_sp_decode_streams(bad, W, H, nthreads=1)
    for rep in range(4):
        got = spnative.native_sp_decode_streams(bad, W, H, nthreads=B)
        np.testing.assert_array_equal(got["changed"], ref["changed"],
                                      err_msg=f"rep {rep}")
        np.testing.assert_array_equal(got["payload"], ref["payload"],
                                      err_msg=f"rep {rep}")
    # healthy streams must be unaffected by the poisoned neighbors
    clean = spnative.native_sp_decode_streams(corpus, W, H, nthreads=1)
    for b in range(B):
        if b in (3, 7, 12):
            continue
        np.testing.assert_array_equal(ref["payload"][b],
                                      clean["payload"][b],
                                      err_msg=f"stream {b}")


def test_soak_gop_parallel_transcode(corpus):
    """GOP-parallel transcode with an oversubscribed pool stays
    byte-identical to the serial pass."""
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.transcode import transcode_sp

    # one long stream with periodic keyframes (the GOP-split unit)
    rng = np.random.default_rng(5)
    enc = ScreenPressorEncoder(4, W, H)
    pkts, keys = [], []
    f = np.full((H, W), pack_rgb(9, 9, 9), dtype=np.uint32)
    for t in range(24):
        isk = t % 6 == 0
        if not isk:
            f = f.copy()
            f[2 : 2 + (t % 7), 3:30] = pack_rgb(*rng.integers(0, 256, 3))
        if isk:
            enc = ScreenPressorEncoder(4, W, H)
            pkts.append(enc.encode_i(f.reshape(-1).copy()))
        else:
            pkts.append(enc.encode_p(f.reshape(-1).copy()))
        keys.append(isk)
    avi = mux_avi(pkts, W, H, 24, codec="SPV4", keyflags=keys)
    ref = transcode_sp(avi, jobs=1)
    for rep in range(3):
        got = transcode_sp(avi, jobs=12)
        assert got == ref, f"rep {rep}: parallel transcode differs"
