"""Seek latency on the host playback path — the reference's own logged
metric (the `performance.now` pair around seek, Main.hx:1213-1226, logged
as "seek done in t=…") measured on realistic content.

Corpus: terminal-1080p (T frames, keyframe every KEYEVERY) as an SP v4 AVI
played through both loaders (seq / indexed-windowed, DataLoaderAVISeq /
DataLoaderAVIIndexed analogs) and as a lane container (.jlv).  For each
config, N random seeks; the Player's seek drive resolves each one and the
probe is ``manager.last_seek_ms`` (the Main.hx:1220-1226 analog).  Seek cost
is dominated by decode-restart-from-keyframe (Manager.hx:244-249), so the
report splits by the target's distance past its keyframe.

Usage: python scripts/exp_seek_latency.py [T] [N] [--corpus video_call]

--corpus video_call: DENSE content (every frame changed, mid entropy) —
the corpus where the two paths diverge structurally: an AVI seek re-pays
the legacy entropy wall per replayed frame, while the
lane walk pays only rect paints (native compose).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_args = [a for a in sys.argv[1:] if a.isdigit()]
CORPUS = ("video_call" if "--corpus" in sys.argv
          and "video_call" in sys.argv else "terminal")
T = int(_args[0]) if len(_args) > 0 else (120 if CORPUS == "video_call"
                                          else 240)
N = int(_args[1]) if len(_args) > 1 else (24 if CORPUS == "video_call"
                                          else 48)
KEYEVERY = 60
Y, X = 1080, 1920


def build_avi():
    from jsplayer_tpu import native
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder
    from jsplayer_tpu.utils import corpora

    t0 = time.monotonic()
    if CORPUS == "video_call":
        frames = corpora.video_call(T=T)
    else:
        frames = corpora.terminal_session(T=T, Y=Y, X=X, seed=0)
    enc = (native.NativeScreenPressorEncoder(4, X, Y)
           if native.available() else ScreenPressorEncoder(4, X, Y))
    streams, keys = [], []
    for t, f in enumerate(frames):
        flat = f.reshape(-1)
        key = t % KEYEVERY == 0
        streams.append(enc.encode_i(flat) if key else enc.encode_p(flat))
        keys.append(key)
    avi = mux_avi(streams, X, Y, 24, codec="SPV4", fps=15.0, keyflags=keys)
    print(f"corpus+encode: {time.monotonic() - t0:.1f}s, "
          f"{len(avi) / 1e6:.2f} MB", flush=True)
    return avi


def measure(p, fps, targets):
    """→ list of (distance_past_keyframe, ms).

    Wall clock from the seek request to the TARGET FRAME DRAWN — the
    user-visible latency (a seek that resolves NOTSOON while data loads
    keeps counting until the frame is actually presented; the in-Manager
    probe `last_seek_ms` intentionally skips those)."""
    out = []
    for target in targets:
        t0 = time.monotonic()
        p.seek_time(target / fps + 0.001)
        for _ in range(200000):
            if p.manager.last_frame_drawn == target:
                break
            p.tick()
        assert p.manager.last_frame_drawn == target
        out.append((target % KEYEVERY, (time.monotonic() - t0) * 1e3))
    return out


def stats(pairs):
    ms = np.array([m for _, m in pairs])
    near = np.array([m for d, m in pairs if d < KEYEVERY // 4])
    far = np.array([m for d, m in pairs if d >= 3 * KEYEVERY // 4])
    r = {"median_ms": round(float(np.median(ms)), 2),
         "p90_ms": round(float(np.percentile(ms, 90)), 2),
         "max_ms": round(float(ms.max()), 2)}
    if near.size:
        r["near_key_median_ms"] = round(float(np.median(near)), 2)
    if far.size:
        r["far_from_key_median_ms"] = round(float(np.median(far)), 2)
    return r


def main():
    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.player import Player, PlayerConfig
    from jsplayer_tpu.transcode import transcode_to_lane

    avi = build_avi()
    t0 = time.monotonic()
    cont = transcode_to_lane(avi, window=64, K=2)
    print(f"transcode: {time.monotonic() - t0:.1f}s, "
          f"{len(cont) / 1e6:.2f} MB", flush=True)

    results = {"T": T, "N": N, "keyevery": KEYEVERY}
    for name, cfg, data in (
        ("avi_seq", PlayerConfig(indexed=False), avi),
        ("avi_indexed", PlayerConfig(indexed=True), avi),
        ("lane_jlv", PlayerConfig(), cont),
    ):
        p = Player(cfg)
        p.load(MemorySource(data))
        # warm: drive until frame 0 is actually drawn (last_frame_drawn
        # starts at -1), so the first timed seek excludes first-load cost
        for _ in range(10000):
            p.tick()
            if p.manager.last_frame_drawn >= 0:
                break
        assert p.manager.last_frame_drawn >= 0
        rng = np.random.default_rng(7)
        targets = [int(t) for t in rng.integers(0, T, N)]
        pairs = measure(p, p.manager.fps, targets)
        results[name] = stats(pairs)
        print(name, results[name], flush=True)
        # REPEAT pass: the identical seek sequence again on the same
        # player — quantifies what per-session caches buy (the lane
        # codec's plane LRU / checkpoints; the AVI paths have no plane
        # cache, so their repeat row doubles as a drift control)
        pairs = measure(p, p.manager.fps, targets)
        results[name + "_repeat"] = stats(pairs)
        print(name + "_repeat", results[name + "_repeat"], flush=True)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
