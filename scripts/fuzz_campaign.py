"""One-command fresh-seed fuzz campaign across every input surface.

Lesson: mutation fuzz with FIXED seeds regresses to a checked set — a
fresh-seed rerun found real bugs (2 SP native/oracle splits, 1 lane parser
escape, 1 lane tiling escape).  This runner re-executes all campaign dimensions with a caller-
chosen seed block so future rounds do it in one command:

    python scripts/fuzz_campaign.py --seed 12345 --scale 1.0

Dimensions (each also has a CI-sized pin in tests/):
  sp_diff      SP bit-flip mutation, native vs oracle bit-exact
               (tests/test_sp_differential.py discipline)
  lane_mut     lane-container mutation: parse-or-ValueError + host decode
  lane_native  C lane compose vs numpy generator on hostile-valid mutants
  lane_dev     host vs device agreement on comparable lane mutants
  mp3          MP3 demux garbage/flip/truncate/resync robustness
  trunc        SP packet + lane wire + AVI truncation
  web          malformed-HTTP fuzz of the browser chrome (/control etc.)
  ingest       quarantine contract through the full batch pipeline (one
               mutated stream must never fail the batch or perturb the
               healthy stream; kmv/bc/kmv_sparse x native/pure)

Scale 1.0 ≈ 15-25 min on the 1-core host.  Exits nonzero on any finding.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import numpy as np  # noqa: E402


def _cpu_pin():
    import jax

    jax.config.update("jax_platforms", "cpu")


def run_sp_diff(seed: int, scale: float) -> int:
    import test_ffmpeg_crossval as xval
    import test_sp_differential as D
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder

    trials = 0
    per = max(1, int(60 * scale))
    for version in (2, 3, 4):
        for bpp in (24, 16):
            for (W, H) in ((64, 48), (96, 64)):
                rng = np.random.default_rng(
                    seed + version * 1000 + bpp * 10 + W)
                frames = xval.blocky_frames(rng, W, H, 5, bpp=bpp, scroll=1)
                enc = ScreenPressorEncoder(version, W, H, bpp=bpp)
                pkts = [enc.encode_i(frames[0].reshape(-1).copy())]
                for f in frames[1:]:
                    pkts.append(enc.encode_p(f.reshape(-1).copy()))
                for trial in range(per):
                    m = [bytearray(p) for p in pkts]
                    for _ in range(int(rng.integers(1, 4))):
                        ti = int(rng.integers(0, len(m)))
                        bi = int(rng.integers(1, len(m[ti])))
                        m[ti][bi] ^= 1 << int(rng.integers(0, 8))
                    mp = [bytes(p) for p in m]
                    ours, _ = D._ours_decode_lenient(mp, bpp)
                    orc, _ = D._oracle_decode_lenient(mp, bpp)
                    for t in range(min(len(ours), len(orc))):
                        assert np.array_equal(ours[t], orc[t]), (
                            f"SP native/oracle SPLIT v{version} bpp{bpp} "
                            f"{W}x{H} trial {trial} frame {t}")
                    trials += 1
    return trials


def _lane_bases(seed: int):
    from test_lane_container import make_avi

    from jsplayer_tpu.transcode import transcode_to_lane

    X, Y, T = 48, 32, 14
    bases = []
    for i, (ke, w) in enumerate(((5, 4), (4, 6), (3, 8), (0, 5))):
        avi, _ = make_avi(seed % 97 + i, X, Y, T,
                          **({"key_every": ke} if ke else {}))
        bases.append(bytes(transcode_to_lane(avi, window=w, K=2)))
    return bases, (X, Y, T)


def run_lane_mut(seed: int, scale: float) -> int:
    from jsplayer_tpu.codecs import lane_format, lane_host

    bases, (X, Y, T) = _lane_bases(seed)
    rng = np.random.default_rng(seed)
    trials = max(1, int(3000 * scale))
    for trial in range(trials):
        m = bytearray(bases[trial % len(bases)])
        for _ in range(int(rng.integers(1, 6))):
            m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
        try:
            c = lane_format.container_from_bytes(bytes(m))
            for wd in c.windows:
                _ = wd.inv_index(c.Y * (lane_format.plane_cols(c.X) // 128))
            h = list(lane_host.iter_frames(c))
            assert len(h) == c.n_frames or not c.windows, \
                f"frame-count desync trial {trial}"
        except ValueError:
            pass
    return trials


def run_lane_native(seed: int, scale: float) -> int:
    """Differential: the C lane compose vs the numpy generator on
    MUTATED containers that survive the parser.  Parse-time validation
    bounds every index the C code consumes (rows < R, refs < U,
    btype <= 1+K, rects <= 16); this dimension checks the two walks
    also stay bit-identical on hostile-but-valid inputs."""
    from jsplayer_tpu import native as _nat
    from jsplayer_tpu.codecs import lane_format
    from jsplayer_tpu.codecs.lane_host import LaneHostCodec

    if not _nat.lane_compose_available():
        return 0
    bases, (X, Y, T) = _lane_bases(seed + 3)
    rng = np.random.default_rng(seed + 3)
    want = max(1, int(150 * scale))
    compared = trial = 0
    while compared < want and trial < want * 60:
        trial += 1
        m = bytearray(bases[trial % len(bases)])
        for _ in range(int(rng.integers(1, 5))):
            m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
        try:
            c = lane_format.container_from_bytes(bytes(m))
        except ValueError:
            continue
        if not c.windows or c.n_frames == 0:
            continue
        a, b = LaneHostCodec(c), LaneHostCodec(c)
        b._use_native = False
        assert a._use_native
        # exercise the plane LRU hard: tiny checkpoint stride (fuzz
        # windows are shorter than the production 16) + a 1-3 plane
        # budget so eviction churns mid-walk
        a.CKPT_STRIDE = int(rng.integers(2, 6))
        a.CARRY_CACHE_BYTES = int(rng.integers(1, 4)) * c.Y * c.X * 4
        order = list(rng.integers(0, c.n_frames, 10))
        for t in order:
            ch = LaneHostCodec.frame_chunk(int(t))
            fa = a._frame(*a._locate(ch))
            fb = b._frame(*b._locate(ch))
            assert np.array_equal(fa, fb), \
                f"native/numpy DIVERGE trial {trial} frame {t}"
        compared += 1
    return compared


def run_lane_dev(seed: int, scale: float) -> int:
    from test_lane_container import collect_frames

    from jsplayer_tpu.codecs import lane_format, lane_host
    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline

    bases, (X, Y, T) = _lane_bases(seed + 1)
    base = bases[0]
    c0 = lane_format.container_from_bytes(base)
    shape0 = (c0.X, c0.Y, c0.n_frames, tuple(w.T for w in c0.windows),
              tuple(w.n_units for w in c0.windows))
    rng = np.random.default_rng(seed + 1)
    want = max(1, int(40 * scale))
    compared = trial = 0
    while compared < want and trial < want * 80:
        trial += 1
        m = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            m[int(rng.integers(0, len(m)))] ^= int(rng.integers(1, 256))
        try:
            c = lane_format.container_from_bytes(bytes(m))
        except ValueError:
            continue
        sh = (c.X, c.Y, c.n_frames, tuple(w.T for w in c.windows),
              tuple(w.n_units for w in c.windows))
        if sh != shape0:
            continue  # same shapes → the jit cache is reused
        host = list(lane_host.iter_frames(c))
        pipe = VideoIngestPipeline([MemorySource(bytes(m))],
                                   IngestConfig(sp_device_path="lane"))
        dev = collect_frames(pipe, 1, T, Y, X)[0]
        for t in range(T):
            assert np.array_equal(host[t].reshape(-1), dev[t]), \
                f"host/device DIVERGE trial {trial} frame {t}"
        compared += 1
    return compared


def run_mp3(seed: int, scale: float) -> int:
    from test_mp3_fuzz import run_campaign

    return run_campaign(max(1, int(2000 * scale)), seed)


def run_trunc(seed: int, scale: float) -> int:
    import test_ffmpeg_crossval as xval
    import test_sp_differential as D
    from test_lane_container import make_avi

    from jsplayer_tpu.codecs import lane_format
    from jsplayer_tpu.core.chunkbuffer import ChunkBuffer
    from jsplayer_tpu.core.riff import AviDemuxer
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder
    from jsplayer_tpu.transcode import transcode_to_lane

    rng = np.random.default_rng(seed + 2)
    trials = 0
    per = max(1, int(120 * scale))
    # SP packets
    frames = xval.blocky_frames(rng, 64, 48, 4, bpp=24, scroll=1)
    enc = ScreenPressorEncoder(4, 64, 48)
    pkts = [enc.encode_i(frames[0].reshape(-1).copy())]
    for f in frames[1:]:
        pkts.append(enc.encode_p(f.reshape(-1).copy()))
    for _ in range(per):
        m = [bytes(p) for p in pkts]
        ti = int(rng.integers(0, len(m)))
        m[ti] = m[ti][: int(rng.integers(0, len(m[ti])))]
        D._ours_decode_lenient(m, 24)
        D._oracle_decode_lenient(m, 24)
        trials += 1
    # lane wires
    avi, _ = make_avi(3, 48, 32, 8, key_every=4)
    cont = transcode_to_lane(avi, window=4, K=2)
    for _ in range(per):
        cut = int(rng.integers(0, len(cont)))
        try:
            lane_format.container_from_bytes(cont[:cut])
        except ValueError:
            pass
        trials += 1
    # AVIs
    for _ in range(per):
        cut = int(rng.integers(0, len(avi)))
        buf = ChunkBuffer()
        d = AviDemuxer(buf, on_frame=lambda *_: None,
                       on_video_info=lambda *_: None)
        d.start()
        buf.add_chunk(avi[:cut])
        try:
            d.pump()
            d.signal_eof()
            d.pump()
        except ValueError:
            pass
        trials += 1
    return trials


def run_web(seed: int, scale: float) -> int:
    """Malformed-HTTP fuzz of the browser chrome:
    junk paths/queries (incl. ?dom=... variants), hostile Host/Origin,
    Range garbage, /control JSON type confusion with a valid token,
    token-less and non-JSON POSTs, and raw-socket garbage.  Invariants:
    every request gets an HTTP answer from the expected code set (pure
    input fuzz must never 5xx or kill a request thread), hostile
    Host/Origin are 403, and the server still serves /state at the end."""
    import http.client
    import json as _json
    import socket

    from test_lane_container import make_avi

    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.player import PlayerConfig
    from jsplayer_tpu.web import PlayerServer

    rng = np.random.default_rng(seed + 7)
    avi, _ = make_avi(5, 64, 48, 10, key_every=4)
    srv = PlayerServer(MemorySource(avi), PlayerConfig(indexed=False))
    srv.start()
    trials = 0
    ok_codes = {200, 206, 400, 403, 404, 408, 414, 416, 431, 501, 505}

    def req(method, path, body=None, headers=None):
        nonlocal trials
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=15)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            r = conn.getresponse()
            r.read()
            code = r.status
        finally:
            conn.close()
        trials += 1
        assert code in ok_codes, ("unexpected status", method, path,
                                  body, code)
        return code

    def junk(n):
        return "".join(chr(int(c)) for c in rng.integers(33, 127, n))

    per = max(1, int(150 * scale))
    paths = ["/", "/index.html", "/info", "/state", "/frame.rgba",
             "/audio.wav"]
    for _ in range(per):
        base = paths[int(rng.integers(0, len(paths)))]
        q = ["", "?dom=1", "?dom=" + junk(int(rng.integers(0, 8))),
             "?" + junk(int(rng.integers(1, 24)))][int(rng.integers(0, 4))]
        p = [base + q, "/" + junk(int(rng.integers(1, 40)))][
            int(rng.integers(0, 2))]
        req("GET", p)
        if rng.integers(0, 3) == 0:  # Range garbage (audio route parses it)
            req("GET", "/audio.wav",
                headers={"Range": "bytes=" + junk(int(rng.integers(0, 10)))})
    # request-origin gates stay shut under fuzz traffic
    assert req("GET", "/state", headers={"Host": "evil.example"}) == 403
    assert req("POST", "/control",
               body=_json.dumps({"cmd": "pause",
                                 "token": srv.control_token}),
               headers={"Origin": "http://evil.example"}) == 403
    assert req("POST", "/control",
               body=_json.dumps({"cmd": "pause"})) == 403  # no token
    # /control type confusion with a VALID token: every answer is 200/400
    cmds = ["play", "pause", "seek", "seek_time", "step_frame", "step_key",
            "next_change", "resize", "load", "", junk(4)]
    args = [None, 0, -1, 0.5, 1e308, -1e308, "x", "nan", "inf", [1, 2],
            [1], [1, 2, 3], {"a": 1}, True, "Infinity", 10**40]
    for _ in range(per):
        c = cmds[int(rng.integers(0, len(cmds)))]
        a = args[int(rng.integers(0, len(args)))]
        code = req("POST", "/control",
                   body=_json.dumps({"cmd": c, "arg": a,
                                     "token": srv.control_token}))
        assert code in (200, 400), ("control 5xx/odd", c, a, code)
        if rng.integers(0, 4) == 0:  # non-JSON body
            code = req("POST", "/control",
                       body=junk(int(rng.integers(0, 60))).encode())
            assert code in (400, 403), code
    # raw-socket garbage must not take the server down
    for _ in range(max(1, per // 5)):
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        try:
            s.sendall(rng.integers(0, 256, int(rng.integers(1, 200)),
                                   dtype=np.uint8).tobytes())
        finally:
            s.close()
    assert req("GET", "/state") == 200  # still alive and serving
    srv.stop()
    return trials


def run_ingest(seed: int, scale: float) -> int:
    """Quarantine-contract fuzz through the FULL batch pipeline
    (SURVEY §5.3): one stream of a 2-stream batch carries bit-flipped /
    truncated frame payloads; iterating the pipeline must NEVER raise
    (plain corruption decodes to wrong pixels by design — structural
    errors quarantine the slot), and the healthy stream must stay
    bit-exact to its golds through the shared window machinery (pooled
    buffers, elision, carries).  Covers the fix class this round's third
    review found: unguarded host stages let one bad stream fail the
    whole batch."""
    import test_ffmpeg_crossval as xval

    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline

    X, Y, T = 48, 32, 9
    rng = np.random.default_rng(seed + 5)
    keys = [i == 0 for i in range(T)]

    def make(seed2):
        frames = xval.blocky_frames(np.random.default_rng(seed2), X, Y, T,
                                    bpp=24, scroll=1)
        enc = ScreenPressorEncoder(4, X, Y)
        pkts = [enc.encode_i(frames[0].reshape(-1).copy())]
        for f in frames[1:]:
            pkts.append(enc.encode_p(f.reshape(-1).copy()))
        return pkts, frames

    pkts_ok, golds = make(seed + 10)
    avi_ok = mux_avi(pkts_ok, X, Y, 24, codec="SPV4", keyflags=keys)
    pkts_bad, _ = make(seed + 11)
    paths = ["kmv", "bc", "kmv_sparse"]
    trials = max(1, int(45 * scale))
    for trial in range(trials):
        m = [bytearray(p) for p in pkts_bad]
        for _ in range(int(rng.integers(1, 5))):
            ti = int(rng.integers(0, len(m)))
            if not len(m[ti]):
                continue
            if rng.integers(0, 4) == 0:
                m[ti] = m[ti][: int(rng.integers(0, len(m[ti])))]
            else:
                m[ti][int(rng.integers(0, len(m[ti])))] ^= \
                    int(rng.integers(1, 256))
        avi_bad = mux_avi([bytes(p) for p in m], X, Y, 24, codec="SPV4",
                          keyflags=keys)
        path = paths[trial % len(paths)]
        elide = path == "kmv" and trial % 2 == 0
        pipe = VideoIngestPipeline(
            [MemorySource(avi_ok), MemorySource(avi_bad)],
            IngestConfig(window=4, sp_device_path=path,
                         still_elision=elide))
        # every third trial runs the PURE-PYTHON host stages (the other
        # half of the guarded-decode fix class) — flipped after pipeline
        # construction so the oracle fallback decoders get built
        from jsplayer_tpu import native as _nat

        nat_off = trial % 3 == 1
        orig_avail = _nat.available
        if nat_off:
            _nat.available = lambda: False
        outs = {}
        try:
            for batch in pipe:  # must never raise, whatever the mutation
                fr = np.asarray(batch["frames_u32"])
                om = batch.get("outmap")
                if om is not None:  # elided layout: flat stack + outmap
                    for t in range(om.shape[1]):
                        row = [fr[om[b, t]] if om[b, t] >= 0 else None
                               for b in range(2)]
                        outs[batch["start_frame"] + t] = row
                else:
                    for t in range(fr.shape[1]):
                        outs[batch["start_frame"] + t] = [fr[0, t], fr[1, t]]
        finally:
            _nat.available = orig_avail
        last = None
        for t in range(T):
            got = outs[t][0]
            if got is None:  # elided still: frame unchanged from previous
                got = last
            last = got
            assert got is not None and np.array_equal(
                got.reshape(-1), golds[t].reshape(-1)), \
                f"healthy stream diverged: path {path} trial {trial} frame {t}"
    return trials


DIMS = {"sp_diff": run_sp_diff, "lane_mut": run_lane_mut,
        "lane_native": run_lane_native, "lane_dev": run_lane_dev,
        "mp3": run_mp3, "trunc": run_trunc, "web": run_web,
        "ingest": run_ingest}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True,
                    help="fresh seed block — use a NEW one each round")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", choices=sorted(DIMS), default=None)
    args = ap.parse_args()
    _cpu_pin()
    totals = {}
    for name, fn in DIMS.items():
        if args.only and name != args.only:
            continue
        t0 = time.monotonic()
        totals[name] = fn(args.seed, args.scale)
        print(f"{name}: {totals[name]} trials clean "
              f"({time.monotonic() - t0:.0f}s)", flush=True)
    print("CAMPAIGN CLEAN", totals)
    return 0


if __name__ == "__main__":
    sys.exit(main())
