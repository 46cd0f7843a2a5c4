"""Malformed/adversarial stream handling.

Untrusted streams must never write outside the frame buffer or crash the
batch: the subrect guard (ScreenPressor.hx:375-386 decoded values can point
outside edge blocks), the predictor no-neighbor rule (JS Int32Array OOB
reads coerce to 0), the range-coder symbol-escape clamp, the HTTP
Range-honored check, and the ingest quarantine's exception breadth."""

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from jsplayer_tpu import native
from jsplayer_tpu.codecs.screenpressor import ScreenPressor
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb


def _mk_prev(enc, X, Y, version):
    """Encode an I-frame and return (stream, pixels)."""
    f = np.full(X * Y, pack_rgb(10, 20, 30), dtype=np.uint32)
    f[: X] = pack_rgb(1, 2, 3)
    return enc.encode_i(f), f


def _evil_subrect(version):
    """P-frame whose last edge block (width 8 < 16) carries a subrect with
    x2 = x16+16 > X: without the guard the data loop writes past X*Y."""
    X, Y = 40, 16  # nbx=3, last block is 8 wide
    enc = ScreenPressorEncoder(version, X, Y)
    istream, _ = _mk_prev(enc, X, Y, version)
    ec = enc.ec
    ec.begin_frame()
    for b in (2, 0, 2, 0):  # xx1 = xx2 = 2 (LE 16-bit each)
        ec.encode_x(b)
    ec.encode_bt(2)   # data block with subrect
    ec.encode_bn(1)
    ec.encode_sxy(0, 0)
    ec.encode_sxy(1, 0)
    ec.encode_sxy(2, 15)  # x2 = 32 + 15 + 1 = 48 > X=40
    ec.encode_sxy(3, 15)
    # payload the guard should never reach: a literal run
    ec.encode_p(0, 0)
    enc._encode_rgb(pack_rgb(9, 9, 9))
    ec.encode_n(0, 16)
    evil = bytes([1]) + ec.end_frame()
    return X, Y, istream, evil


@pytest.mark.parametrize("version", [2, 3, 4])
def test_oracle_rejects_oob_subrect(version):
    X, Y, istream, evil = _evil_subrect(version)
    dec = ScreenPressor(X, Y)
    dst = np.zeros(X * Y, dtype=np.uint32)
    assert dec.decompress_i(istream, dst).name == "ZERO"
    with pytest.raises(ValueError, match="subrect"):
        dec.decompress_p(evil, np.zeros(X * Y, dtype=np.uint32))


@pytest.mark.skipif(not native.available(), reason="native unavailable")
@pytest.mark.parametrize("version", [2, 3, 4])
def test_native_rejects_oob_subrect(version):
    X, Y, istream, evil = _evil_subrect(version)
    n = native.NativeScreenPressor(X, Y)
    view, _, _ = n.decompress(istream, True)
    assert view is not None
    with pytest.raises(ValueError):
        n.decompress(evil, False)


def _row0_up_predictor(version):
    """P-frame whose first block starts with an up-predictor run at frame
    row 0 — no neighbor exists; reference JS yields 0 for those reads."""
    X, Y = 40, 16
    enc = ScreenPressorEncoder(version, X, Y)
    istream, prev = _mk_prev(enc, X, Y, version)
    ec = enc.ec
    ec.begin_frame()
    enc.cx = enc.cx1 = 0  # decoder resets color contexts at P-frame start
    for b in (0, 0, 0, 0):  # xx1 = xx2 = 0
        ec.encode_x(b)
    ec.encode_bt(1)   # full data block
    ec.encode_bn(1)
    ec.encode_p(0, 2)      # ptype 2 (up-right): reads d[di-X] at row 0
    ec.encode_n(2, 8)      # 8 pixels
    ec.encode_p(2, 0)      # literal fill for the rest of the 16x16 block
    enc._encode_rgb(pack_rgb(7, 7, 7))
    ec.encode_n(0, 248)    # 8 + 248 = 256 = the whole block, exactly
    return X, Y, istream, bytes([1]) + ec.end_frame(), prev


@pytest.mark.skipif(not native.available(), reason="native unavailable")
@pytest.mark.parametrize("version", [2, 3, 4])
def test_predictor_no_neighbor_reads_zero_and_matches_native(version):
    X, Y, istream, pstream, prev = _row0_up_predictor(version)

    dec = ScreenPressor(X, Y)
    dst = np.zeros(X * Y, dtype=np.uint32)
    dec.decompress_i(istream, dst)
    res = dec.decompress_p(pstream, np.zeros(X * Y, dtype=np.uint32))
    oracle_frame = np.asarray(res.data).reshape(-1).copy()
    # the up-predictor run at row 0 painted "missing neighbor" = 0
    assert (oracle_frame[:8] == 0).all()

    n = native.NativeScreenPressor(X, Y)
    n.decompress(istream, True)
    view, _, _ = n.decompress(pstream, False)
    np.testing.assert_array_equal(np.asarray(view).reshape(-1), oracle_frame)


@pytest.mark.skipif(not native.available(), reason="native unavailable")
@pytest.mark.parametrize("version", [2, 3, 4])
def test_native_survives_garbage_streams(version):
    """Random bytes through the native decoder: any outcome but a crash/OOB.
    Exercises the range-coder/rANS symbol-escape clamps (spdec.cpp)."""
    X, Y = 40, 24
    rng = np.random.default_rng(version)
    n = native.NativeScreenPressor(X, Y)
    enc = ScreenPressorEncoder(version, X, Y)
    istream, _ = _mk_prev(enc, X, Y, version)
    n.decompress(istream, True)
    for trial in range(50):
        blob = rng.integers(0, 256, rng.integers(2, 200)).astype(np.uint8)
        blob = bytes([1]) + blob.tobytes()
        try:
            n.decompress(blob, bool(trial % 2))
        except ValueError:
            pass  # rejected: fine


def test_guard_quarantines_oracle_style_errors():
    """The ingest per-stream guard quarantines AssertionError/IndexError too
    (the pure-Python fallback's failure modes), not just ValueError."""
    from jsplayer_tpu.pipeline.ingest import VideoIngestPipeline

    p = object.__new__(VideoIngestPipeline)
    p.quarantined = set()
    p.quarantine_errors = []

    def bad_assert():
        raise AssertionError("motion vector out of bounds")

    def bad_index():
        raise IndexError("index 960 is out of bounds")

    assert p._guard(0, bad_assert, default="D") == "D"
    assert p._guard(1, bad_index, default="D") == "D"
    assert p.quarantined == {0, 1}
    # already-quarantined slots short-circuit
    assert p._guard(0, lambda: "x", default="D") == "D"
    assert len(p.quarantine_errors) == 2


def test_http_source_rejects_range_ignoring_server():
    """A server that answers Range requests with 200 + the whole entity must
    not be treated as having served the slice (core/source.py)."""
    from jsplayer_tpu.core.source import HttpRangeSource

    payload = bytes(range(256)) * 8

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()

        def do_GET(self):  # ignores Range entirely
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/f.avi"
        src = HttpRangeSource(url)
        # full-file request: a 200 whole-entity answer IS the request
        assert src.read_range(0) == payload
        with pytest.raises(IOError):
            src.read_range(100, 199)
        with pytest.raises(IOError):
            list(src.stream_range(100, 199))
        # opt-in client-side slicing still works
        lax = HttpRangeSource(url, accept_full_body=True)
        assert lax.read_range(100, 199) == payload[100:200]
    finally:
        srv.shutdown()


def test_demux_fuzz_mutated_avi_never_hangs():
    """Adversarial container bytes: random mutations of a valid AVI must
    either load or raise ValueError — never hang, crash, or leak another
    exception class (the transport/demux analogue of the decoder
    hardening; the reference only ever logged IO errors,
    DataLoaderAVIIndexed.hx:233-247)."""
    import numpy as np

    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
    from jsplayer_tpu.player import Player, PlayerConfig

    X = Y = 32
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full(X * Y, pack_rgb(1, 2, 3), dtype=np.uint32)
    pkts = [enc.encode_i(f)]
    g = f.copy()
    g[:X] = pack_rgb(9, 9, 9)
    pkts.append(enc.encode_p(g))
    avi = bytearray(mux_avi(pkts, X, Y, 24, codec="SPV4",
                            keyflags=[True, False]))
    rng = np.random.default_rng(0)
    for trial in range(200):
        bad = bytearray(avi)
        kind = trial % 4
        if kind == 0:  # flip random bytes
            for _ in range(int(rng.integers(1, 8))):
                bad[int(rng.integers(0, len(bad)))] = int(rng.integers(256))
        elif kind == 1:  # truncate
            bad = bad[: int(rng.integers(1, len(bad)))]
        elif kind == 2:  # corrupt a size field region
            off = int(rng.integers(4, min(64, len(bad) - 4)))
            bad[off:off + 4] = rng.integers(0, 256, 4, dtype=np.uint8) \
                .tobytes()
        else:  # splice garbage into the middle
            off = int(rng.integers(0, len(bad)))
            bad = bad[:off] + bytes(rng.integers(0, 256, 16,
                                                 dtype=np.uint8)) + bad[off:]
        p = Player(PlayerConfig(indexed=False))
        try:
            p.load(MemorySource(bytes(bad)))
            for _ in range(50):  # a few playback ticks over corrupt frames
                p.tick()
        except ValueError:
            pass  # the defined failure mode
        finally:
            p.unload()


def test_ingest_fuzz_mutated_avi_never_hangs():
    """Same mutations through the batch ingest construction path."""
    import numpy as np

    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.msv1_enc import encode_frame_16
    from jsplayer_tpu.codecs.msvideo1 import from_rgb15
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline

    X = Y = 32
    f = np.full(X * Y, from_rgb15(0x0421), dtype=np.uint32)
    avi = bytearray(mux_avi([encode_frame_16(f, None, X, Y)], X, Y, 16,
                            codec="CRAM", keyflags=[True]))
    rng = np.random.default_rng(1)
    for trial in range(60):
        bad = bytearray(avi)
        if trial % 2 == 0:
            for _ in range(int(rng.integers(1, 6))):
                bad[int(rng.integers(0, len(bad)))] = int(rng.integers(256))
        else:
            bad = bad[: int(rng.integers(1, len(bad)))]
        try:
            pipe = VideoIngestPipeline([MemorySource(bytes(bad))],
                                       IngestConfig(window=2))
            list(pipe)
        except (ValueError, AssertionError):
            pass  # construction may reject headerless/garbage files
