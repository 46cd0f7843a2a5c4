"""Pricing the lane migration: transcode cost vs replay savings.

The legacy SP host stage is entropy-bound on dense content (per-symbol
adaptive-context semantics, ANS.hx:785-860), so serving such archives on
the bc path caps a device's feed at the host's entropy rate forever.  `transcode_to_lane` pays that wall ONCE and
replays are then wire-parse-speed on the host.  This script measures all
three legs per corpus and prints the break-even replay count:

    N* = t_transcode / (t_legacy_replay - t_lane_replay_host)   [per frame]

Timing discipline: time.process_time (CPU seconds — a shared vCPU's
steal bursts corrupt wall clocks) with a warm-up pass and best-of-N.

GOP parallelism: transcode_to_lane(jobs=N) splits at restart units
(keyframe-led window runs) with byte-identical output — wall scales with
cores, CPU-seconds stay ~flat, so the table's core-second pricing covers
any --jobs choice.  Byte-identity is asserted here as a runtime check.

Usage: python scripts/exp_transcode_pricing.py [--frames 48]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

Y, X = 1080, 1920


def best_of(fn, n, warm=True):
    """Best (min) CPU seconds over n runs, after one warm-up call."""
    if warm:
        fn()
    best = float("inf")
    for _ in range(n):
        c0 = time.process_time()
        fn()
        best = min(best, time.process_time() - c0)
    return best


def corpus_avi(kind, T, key_every):
    from jsplayer_tpu import native
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.utils import corpora

    frames = (corpora.video_call(T=T) if kind == "video_call"
              else corpora.terminal_session(T=T, Y=Y, X=X, seed=0))
    enc = native.NativeScreenPressorEncoder(4, X, Y)
    streams, keys = [], []
    for t, f in enumerate(frames):
        key = t % key_every == 0
        if key:  # fresh encoder state per GOP lead, like a live capture
            enc = native.NativeScreenPressorEncoder(4, X, Y)
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if key else enc.encode_p(flat))
        keys.append(key)
    return streams, mux_avi(streams, X, Y, 24, codec="SPV4", fps=30.0,
                            keyflags=keys)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--key-every", type=int, default=24)
    args = ap.parse_args()
    T = args.frames

    from jsplayer_tpu import native
    from jsplayer_tpu.codecs.lane_format import container_from_bytes, \
        plane_cols
    from jsplayer_tpu.transcode import transcode_to_lane

    report = {"frames": T, "key_every": args.key_every,
              "discipline": "process_time best-of-N, warm"}
    for kind in ("video_call", "terminal"):
        streams, avi = corpus_avi(kind, T, args.key_every)
        row = {"avi_mb": round(len(avi) / 1e6, 2)}

        # 1. legacy per-replay host cost: the bc transport feed (the
        #    fastest legacy host path, bench.py's host row)
        t_legacy = best_of(lambda: native.native_sp_decode_streams_bc(
            [streams], X, Y, K=2), 3)
        row["legacy_bc_fps_per_core"] = round(T / t_legacy, 1)

        # 2. one-time transcode cost
        cont = {}

        def tr():
            cont["b"] = transcode_to_lane(avi)
        t_trans = best_of(tr, 3)
        row["transcode_fps_per_core"] = round(T / t_trans, 1)
        row["lane_mb"] = round(len(cont["b"]) / 1e6, 2)
        # jobs>1 byte-identity (the GOP-parallel contract on this corpus)
        assert transcode_to_lane(avi, jobs=4) == cont["b"], kind

        # 3. lane per-replay host cost: container parse + per-window
        #    row-index/staging (what _iter_lane does on the host before
        #    dispatch; device time is not host cost)
        ncol = plane_cols(X) // 128

        def replay():
            c = container_from_bytes(cont["b"])
            for w in c.windows:
                w.row_index(Y, ncol)
        t_lane = best_of(replay, 3)
        row["lane_host_replay_fps_per_core"] = round(T / t_lane, 1)

        # break-even: replays after which the one-time transcode pays off
        save = t_legacy / T - t_lane / T
        row["breakeven_replays"] = (round((t_trans / T) / save, 1)
                                    if save > 0 else None)
        # pricing at archive scale: one hour of 30 fps content
        row["core_hours_per_content_hour_transcode"] = round(
            (108000.0 / (T / t_trans)) / 3600, 2)
        report[kind] = row
        print(kind, row, flush=True)

    print(json.dumps(report))


if __name__ == "__main__":
    main()
