"""Benchmark: 1080p ScreenPressor decode throughput on the device pipeline.

Parity is enforced by the test suite and chip_smoke.py (oracle ↔ native ↔
device); this harness measures decode throughput on real encoded streams:

  1. encode 1080p screen content with the native C++ encoder (scrolls, window
     paints, stills — the motion/data/copy mix the codec targets);
  2. host stage: native C++ entropy decode + transport emission (timed
     separately, per core);
  3. device stage: P-chain reconstruction via lax.scan over the transport
     tensors.  Each row runs an in-program fori_loop at two rep counts and
     reports the marginal cost per rep, so the fixed per-call dispatch cost
     cancels; completion is forced by a scalar readback.

Needs a GPU and the native library: without either it exits non-zero and
prints no record.  Prints ONE JSON line naming the device (platform,
device_kind, count, and the card's name and power limit).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

# env-overridable to shrink the workload
Y = int(os.environ.get("BENCH_Y", 1080))
X = int(os.environ.get("BENCH_X", 1920))
T = int(os.environ.get("BENCH_T", 64))  # GOP-sized scan window
BASELINE = 10_000.0  # north-star target (BASELINE.md)


def cached_streams(key: str, build):
    """Disk cache for the bench's deterministic host prep (corpus render +
    native SP encode).  The encoded streams are a pure function of the
    corpus parameters and the encoder source, so the key embeds a hash of
    spdec.cpp — any encoder change invalidates the cache.  Re-encoding
    identical 1080p corpora every run would otherwise take minutes of host
    time away from the device rows."""
    import hashlib
    import pickle

    base = os.path.dirname(os.path.abspath(__file__))
    # the streams are a function of the corpus GENERATORS and the encoder
    # wrapper too, not just the C encoder — hash every source they
    # depend on so an edit to any of them invalidates the cache
    srcs = [os.path.join(base, "jsplayer_tpu", p) for p in (
        os.path.join("native", "spdec.cpp"),
        os.path.join("utils", "corpora.py"),
        os.path.join("encode", "sp_enc.py"),
        os.path.join("encode", "avi_mux.py"),
    )]
    try:
        h = hashlib.sha1()
        for s in srcs:
            h.update(open(s, "rb").read())
        tag = h.hexdigest()[:12]
    except OSError:
        return build()
    cdir = os.path.join(tempfile.gettempdir(), "jsptpu_bench_cache")
    path = os.path.join(cdir, f"{key}-{Y}x{X}-{tag}.pkl")
    try:
        with open(path, "rb") as fh:
            return pickle.load(fh)
    except (OSError, EOFError, pickle.UnpicklingError):
        pass
    v = build()
    try:
        os.makedirs(cdir, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as fh:
            pickle.dump(v, fh)
        os.replace(tmp, path)
    except OSError:
        pass
    return v


def real_stream_commands():
    """Native-encoded 1080p screen content → host-decoded command stacks."""
    from jsplayer_tpu import native
    from jsplayer_tpu.encode.sp_enc import pack_rgb

    def build():
        rng = np.random.default_rng(0)
        enc = native.NativeScreenPressorEncoder(4, X, Y)
        f = np.full((Y, X), pack_rgb(30, 30, 34), dtype=np.uint32)
        for _ in range(12):
            x0 = int(rng.integers(0, X - 200))
            y0 = int(rng.integers(0, Y - 150))
            f[y0 : y0 + 140, x0 : x0 + 190] = pack_rgb(
                *rng.integers(0, 256, 3))
        f = f.reshape(-1)
        st = [enc.encode_i(f)]
        for t in range(T - 1):
            nf = f.copy().reshape(Y, X)
            if t % 3 == 0:
                nf[8:, :] = nf[:-8, :].copy()  # scroll → motion blocks
            if t % 3 != 2:  # every third frame is a still
                x0 = int(rng.integers(0, X - 120))
                y0 = int(rng.integers(0, Y - 80))
                nf[y0 : y0 + 60, x0 : x0 + 100] = pack_rgb(
                    *rng.integers(0, 256, 3))
            f = nf.reshape(-1)
            st.append(enc.encode_p(f))
        return st

    streams = cached_streams(f"bench-mix-T{T}", build)
    got = native.native_sp_decode_streams([streams], X, Y)
    # steady-state host feed rates for the production transports (buffers
    # reused; best-of-8, because the JAX runtime shares the host cores).
    # Each rate is reported on BOTH clocks: wall (perf_counter — what a
    # co-scheduled host delivers) and CPU-seconds (process_time — the
    # dedicated-core rate).
    kmv = native.native_sp_decode_streams_kmv([streams], X, Y, K=2)
    host_fps = host_fps_cpu = 0.0
    for _ in range(8):
        t0, c0 = time.perf_counter(), time.process_time()
        kmv = native.native_sp_decode_streams_kmv([streams], X, Y, K=2,
                                                  out=kmv)
        host_fps = max(host_fps, T / (time.perf_counter() - t0))
        host_fps_cpu = max(host_fps_cpu, T / (time.process_time() - c0))
    bc = native.native_sp_decode_streams_bc([streams], X, Y, K=2)
    host_bc_fps = host_bc_fps_cpu = 0.0
    for _ in range(8):
        t0, c0 = time.perf_counter(), time.process_time()
        bc = native.native_sp_decode_streams_bc([streams], X, Y, K=2, out=bc)
        host_bc_fps = max(host_bc_fps, T / (time.perf_counter() - t0))
        host_bc_fps_cpu = max(host_bc_fps_cpu,
                              T / (time.process_time() - c0))
    return (got, kmv, host_fps, bc, host_bc_fps, streams,
            host_fps_cpu, host_bc_fps_cpu)


def main() -> None:
    t_start = time.perf_counter()
    from jsplayer_tpu.utils.compile_cache import setup_compile_cache
    from jsplayer_tpu.utils.device import (device_record,
                                           nvidia_smi_name_power,
                                           require_gpu)

    setup_compile_cache()
    devs = require_gpu()
    import jax
    import jax.numpy as jnp

    from jsplayer_tpu import native
    from jsplayer_tpu.kernels import sp_recon

    if not native.available():
        raise SystemExit("native library unavailable: "
                         "make -C jsplayer_tpu/native libjsptpu.so")
    device = {**device_record(devs), "nvidia_smi": nvidia_smi_name_power()}
    # soft deadline for the OPTIONAL rows (curve/terminal/lane/model): the
    # headline paths always run; later rows are skipped once elapsed time
    # passes this (rows not reached report null)
    SOFT_DEADLINE_S = float(os.environ.get("BENCH_SOFT_DEADLINE_S", 1250))

    def over_budget():
        return time.perf_counter() - t_start > SOFT_DEADLINE_S

    results = {}
    marks = {}
    extras = {}
    _mark_prev = [t_start]

    def mark(label):
        now = time.perf_counter()
        marks[label] = round(now - _mark_prev[0], 1)
        _mark_prev[0] = now
        print(f"[bench] {label}: +{marks[label]}s "
              f"(total {now - t_start:.0f}s)", file=sys.stderr, flush=True)

    (got, kmv_host, host_fps, bc_host, host_bc_fps, corpus_streams,
     host_fps_cpu, host_bc_fps_cpu) = real_stream_commands()
    mark("host_encode_and_transports")
    extras["host_stage_kmv_fps_per_core"] = round(host_fps, 1)
    extras["host_stage_fps_per_core"] = round(host_bc_fps, 1)
    extras["host_stage_kmv_fps_per_core_cpu"] = round(host_fps_cpu, 1)
    extras["host_stage_fps_per_core_cpu"] = round(host_bc_fps_cpu, 1)
    source = "real-encoded-1080p-screen-content"
    bts = jax.device_put(got["bts"][0])
    mv = jax.device_put(got["mv"][0])
    rect = jax.device_put(got["rect"][0])
    payload = jax.device_put(got["payload"][0])
    changed = jax.device_put(got["changed"][0])

    init = jnp.zeros((Y, X), jnp.uint32)
    dev = jax.device_put((init, bts, mv, rect, payload, changed))

    def timed(fn, *args, scale=1, frames=T, tries=6, with_spread=False):
        # nrep is a DYNAMIC fori_loop bound so every rep count shares one
        # compile.  The loop body must be (a) loop-DEPENDENT — the carry is
        # XORed into the first input, so XLA can't hoist the computation
        # out of the fori_loop — and (b) fully output-dependent — the carry
        # folds a FULL reduction of the output, so no stream/step can be
        # dead-code-eliminated.  The full-sum probe costs one extra output
        # read pass (numbers are accordingly slightly conservative).
        @jax.jit
        def loop(nrep, *a):
            def body(i, carry):
                a0 = a[0] ^ carry  # inject the loop dependence (u32 input)
                frames = fn(a0, *a[1:])
                if frames.dtype != jnp.uint32:
                    frames = jax.lax.bitcast_convert_type(
                        frames.astype(jnp.float32), jnp.uint32)
                return frames.sum(dtype=jnp.uint32) ^ jnp.uint32(i)
            return jax.lax.fori_loop(0, nrep, body, jnp.uint32(0))

        def t_at(nrep, tries=tries):
            int(loop(jnp.int32(nrep), *args))  # warm; readback = barrier
            samples = []
            for _ in range(tries):
                t0 = time.perf_counter()
                int(loop(jnp.int32(nrep), *args))
                samples.append(time.perf_counter() - t0)
            return min(samples), samples

        t_lo, _ = t_at(1, tries=2)
        # two-point marginal: cancels the fixed per-call cost
        n_lo, n_hi = (1, 3) if t_lo > 0.5 else (4, 24)
        (t1, _), (t2, s2) = t_at(n_lo), t_at(n_hi)
        # grow the rep spread until the marginal span dominates timing
        # noise (≥250 ms, or until the row gets expensive)
        while t2 - t1 < 0.25 and n_hi < 512 and t2 < 15 and not over_budget():
            n_hi *= 4
            t2, s2 = t_at(n_hi)
        fps = scale * frames * (n_hi - n_lo) / max(t2 - t1, 1e-9)
        if with_spread:
            # run-to-run spread of the dominant (n_hi) samples
            spread = (max(s2) - min(s2)) / max(min(s2), 1e-9)
            return fps, spread
        return fps

    # ---- headline paths (always run) -------------------------------------
    # K-distinct-motion-vector compose (gather-free); transport comes
    # straight from the native decoder (exact twin of prepare_kmv)
    pc, mvk = kmv_host["paycode"][0], kmv_host["mvk"][0]
    kdev = jax.device_put((init, pc, mvk, changed))
    results["kmv"] = timed(sp_recon.decode_sequence_kmv, *kdev)
    mark("kmv")
    # kmv + still-elision (production pipeline shape: stills never enter
    # the device scan; the host's `changed` flags map outputs).  Delivered-
    # frame throughput: all T frames come out (stills alias their
    # predecessor via outmap), the device only composes the changed ones.
    pcc, mvkc, _outmap = sp_recon.compact_changed(
        pc, mvk, np.asarray(changed))
    cdev = jax.device_put((init, pcc, mvkc))
    results["kmv_still_elision"] = timed(
        sp_recon.decode_sequence_kmv_compact, *cdev)
    mark("kmv_still_elision")

    def native_kmv_single(streams_s):
        return native.native_sp_decode_streams_kmv([streams_s], X, Y, K=2)

    # BASELINE config 4 end-to-end: lane-container ingest (payload decoded
    # entirely on device; the host's only per-frame work is array slicing).
    # Raw unit bytes (default) vs renorm-aligned rANS lanes, plus the wire
    # sizes of both.
    from jsplayer_tpu.codecs import lane_format
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.kernels import lane_recon
    from jsplayer_tpu.transcode import transcode_to_lane
    from jsplayer_tpu.utils import corpora

    lane_bytes = {}
    avi = mux_avi(corpus_streams, X, Y, 24, codec="SPV4",
                  keyflags=[t == 0 for t in range(T)])
    lane_bytes["avi"] = len(avi)
    cont_bytes = transcode_to_lane(avi, window=T, K=2)  # raw+deflate
    lane_bytes["raw_deflate"] = len(cont_bytes)
    ncol = lane_format.plane_cols(X) // 128
    t0 = time.perf_counter()
    cont = lane_format.container_from_bytes(cont_bytes)
    w = cont.windows[0]
    row_table, row_idx = w.row_index(Y, ncol)
    lane_prep_ms = (time.perf_counter() - t0) * 1e3
    raw_args = jax.device_put(
        (jnp.zeros((Y, X), jnp.uint32), jnp.asarray(w.payload),
         jnp.asarray(w.btype), jnp.asarray(w.rect),
         jnp.asarray(w.mvk), jnp.asarray(row_table),
         jnp.asarray(row_idx), jnp.asarray(w.changed)))
    lane_fps = timed(lane_recon.decode_window_raw, *raw_args)
    # production lane config: still-elision keeps stills out of the scan
    # (ingest's compact_arrays_batch semantics) — delivered-frame
    # convention as the kmv headline
    sel = np.nonzero(np.asarray(w.changed))[0]
    el_args = jax.device_put(
        (jnp.zeros((Y, X), jnp.uint32), jnp.asarray(w.payload),
         jnp.asarray(w.btype[sel]), jnp.asarray(w.rect[sel]),
         jnp.asarray(w.mvk[sel]), jnp.asarray(row_table),
         jnp.asarray(row_idx[sel]), jnp.ones(sel.size, bool)))
    lane_elision_fps = timed(lane_recon.decode_window_raw, *el_args, tries=3)
    lane_bytes["raw"] = len(transcode_to_lane(
        avi, window=T, K=2, compress=False))
    mark("lane_raw")

    # realistic capture-like corpus: rendered scrolling-terminal session
    terminal_fps = terminal_host_bc_fps = None
    if not over_budget():
        Tt = 240
        streams_t = cached_streams(
            f"terminal-T{Tt}",
            lambda: corpora.encode_frames(
                corpora.terminal_session(T=Tt, Y=Y, X=X, seed=0),
                native.NativeScreenPressorEncoder(4, X, Y)))
        k = native_kmv_single(streams_t)
        pcc_t, mvkc_t, _ = sp_recon.compact_changed(
            k["paycode"][0], k["mvk"][0], np.asarray(k["changed"][0]))
        tdev = jax.device_put((init, pcc_t, mvkc_t))
        terminal_fps = timed(sp_recon.decode_sequence_kmv_compact,
                             *tdev, frames=Tt)
        bct = native.native_sp_decode_streams_bc([streams_t], X, Y, K=2)
        best = float("inf")
        for _ in range(6):
            t0 = time.perf_counter()
            bct = native.native_sp_decode_streams_bc([streams_t], X, Y,
                                                     K=2, out=bct)
            best = min(best, time.perf_counter() - t0)
        terminal_host_bc_fps = Tt / best
    mark("terminal_corpus")

    # delivered-fps vs stills-ratio sensitivity curve: same event mix, only
    # the idle fraction varies
    stills_curve = {}
    stills_spread = {}
    for s in (0.0, 1 / 3, 2 / 3, 0.9):
        if over_budget():
            break
        streams_s = cached_streams(
            f"mix-s{s:.2f}-T{T}",
            lambda: corpora.encode_frames(
                corpora.screen_mix(T=T, Y=Y, X=X, stills=s, seed=3),
                native.NativeScreenPressorEncoder(4, X, Y)))
        k = native_kmv_single(streams_s)
        pcc_s, mvkc_s, _ = sp_recon.compact_changed(
            k["paycode"][0], k["mvk"][0], np.asarray(k["changed"][0]))
        sdev = jax.device_put((init, pcc_s, mvkc_s))
        v1, sp = timed(sp_recon.decode_sequence_kmv_compact, *sdev,
                       tries=4, with_spread=True)
        stills_curve[f"{s:.2f}"] = round(v1, 1)
        stills_spread[f"{s:.2f}"] = round(sp, 3)
    mark("stills_curve")

    # BATCHED kmv + still-elision, CONCAT layout (the production batch
    # shape, ingest._kmv_elided): keyframe-led streams' compacted frames
    # run back to back in ONE sequential scan — zero padding.
    Bb = 2
    pccs = mvkcs = None
    if not over_budget():
        # DISTINCT per-stream pixel bits: identical copies invite XLA CSE
        pc_np, mvk_np = np.asarray(pc), np.asarray(mvk)
        ch_np = np.asarray(changed)
        pccs, mvkcs = [], []
        for b in range(Bb):
            pcc_b, mvkc_b, _ = sp_recon.compact_changed(
                pc_np ^ np.uint32((b * 0x030507) & 0xFFFFFF), mvk_np,
                ch_np)
            pccs.append(pcc_b)
            mvkcs.append(mvkc_b)
        cat = jax.device_put((init, jnp.array(np.concatenate(pccs)),
                              jnp.array(np.concatenate(mvkcs))))
        results["kmv_batch_elision"] = timed(
            sp_recon.decode_sequence_kmv_compact, *cat, scale=Bb)
    mark("kmv_batch_elision")
    # mid-GOP PADDED fallback: the per-stream bucketed masked scans used
    # when a window is NOT keyframe-led (delivered-frame convention
    # identical to kmv_batch_elision: scale=B, frames=T)
    if pccs is not None and not over_budget():
        pstack = jnp.array(np.stack(pccs))
        mstack = jnp.array(np.stack(mvkcs))
        vstack = jnp.ones(pstack.shape[:2], bool)
        pdev = jax.device_put((jnp.zeros((Bb, Y, X), jnp.uint32),
                               pstack, mstack, vstack))
        results["kmv_padded_elision"] = timed(
            sp_recon.decode_batch_kmv, *pdev, scale=Bb, tries=3)
    mark("kmv_padded_elision")

    # rANS lane variant: the A/B partner of the raw lane rows
    lane_rans_fps = None
    if not over_budget():
        cont_rans = transcode_to_lane(avi, window=T, K=2,
                                      payload="rans", compress=False)
        lane_bytes["rans"] = len(cont_rans)
        w2 = lane_format.container_from_bytes(cont_rans).windows[0]
        init2 = (jnp.asarray(w2.init_plane)
                 if w2.init_plane is not None
                 else jnp.zeros((Y, X), jnp.uint32))
        rt2, ri2 = w2.row_index(Y, ncol)
        rans_args = jax.device_put(
            (init2, jnp.asarray(w2.refills), jnp.asarray(w2.states),
             jnp.asarray(w2.freq), jnp.asarray(w2.btype),
             jnp.asarray(w2.rect), jnp.asarray(w2.mvk),
             jnp.asarray(rt2), jnp.asarray(ri2),
             jnp.asarray(w2.changed)))
        lane_rans_fps = timed(
            lambda i, rf, st, fq, bt, rc, mk, rt, ri, ch:
            lane_recon.decode_window_lane(i, rf, st, fq, bt, rc, mk,
                                          rt, ri, ch, U=w2.n_units),
            *rans_args, tries=3)
    mark("lane_rans")

    # fused ML-ingest paths (different output contract): kmv decode -> 2x
    # box downscale -> normalized bf16 NHWC tensors
    model_fps = model_elision_fps = model_packed_fps = None
    model_packed_consumer_fps = model_consumer_fps = None
    if not over_budget():
        model_elision_fps = timed(
            lambda i, p, m: sp_recon.decode_sequence_kmv_compact_model(
                i, p, m, downscale=2)[1],
            *cdev, tries=3)
        model_packed_fps = timed(
            lambda i, p, m: sp_recon.decode_sequence_kmv_compact_model(
                i, p, m, downscale=2, packed=True)[1],
            *cdev, tries=3)
    if not over_budget():
        # packed-ds2 CONSUMER contract: delivered fps INCLUDING the
        # consuming model step (ViT-style patch embed whose first op
        # fuses the unpack) — vs the same step fed the unfused tensors
        from jsplayer_tpu.kernels import rgb_convert

        wrng = np.random.default_rng(7)
        wconv = jnp.array(wrng.normal(0, 0.05, (8, 8, 3, 128)),
                          jnp.bfloat16)

        def packed_then_consume(i, p, m, w):
            red = sp_recon.decode_sequence_kmv_compact_model(
                i, p, m, downscale=2, packed=True)[1]
            return rgb_convert.packed_consumer_step(red, w)

        def unpacked_then_consume(i, p, m, w):
            x = sp_recon.decode_sequence_kmv_compact_model(
                i, p, m, downscale=2)[1]
            return jax.lax.conv_general_dilated(
                x, w.astype(x.dtype), window_strides=(8, 8),
                padding="VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC"))

        model_packed_consumer_fps = timed(
            packed_then_consume, *cdev, wconv, tries=3)
        model_consumer_fps = timed(
            unpacked_then_consume, *cdev, wconv, tries=3)
    if not over_budget():
        model_fps = timed(
            lambda i, p, m, c: sp_recon.decode_batch_kmv_model(
                i[None], p[None], m[None], c[None], downscale=2)[1],
            *kdev, tries=3)
    mark("model_rows")

    # bc transport device scan (same traffic as kmv)
    if not over_budget():
        bc_args = (init, jax.device_put(bc_host["plane"][0]),
                   jax.device_put(bc_host["bcode"][0]),
                   jax.device_put(bc_host["rloc"][0]),
                   jax.device_put(bc_host["mvk"][0]), changed)
        results["bc"] = timed(sp_recon.decode_sequence_bc, *bc_args,
                              tries=3)
    mark("bc")

    # general XLA compose (arbitrary-gather motion)
    if not over_budget():
        results["xla"] = timed(
            lambda *a: sp_recon.decode_sequence(*a, jnp.int32(0))[0],
            *dev, tries=2)
    mark("xla")

    r1 = lambda v: None if v is None else round(v, 1)
    frames_per_sec, best_path = max((v, k) for k, v in results.items())
    print(json.dumps({
        "metric": "sp_1080p_device_decode_frames_per_sec_per_chip",
        "value": round(frames_per_sec, 1),
        "unit": "frames/s",
        "vs_baseline": round(frames_per_sec / BASELINE, 3),
        "device": device,
        "source": source,
        "path": best_path,
        "all_paths": {k: r1(v) for k, v in results.items()},
        **extras,
        "model_ingest_ds2_fps": r1(model_fps),
        "model_ingest_ds2_elision_fps": r1(model_elision_fps),
        "model_ingest_ds2_packed_fps": r1(model_packed_fps),
        "model_packed_consumer_fps": r1(model_packed_consumer_fps),
        "model_unpacked_consumer_fps": r1(model_consumer_fps),
        "stills_curve_fps": stills_curve or None,
        "stills_curve_spread": stills_spread or None,
        "terminal_corpus_fps": r1(terminal_fps),
        "terminal_host_bc_fps_per_core": r1(terminal_host_bc_fps),
        "lane_ingest_fps": r1(lane_fps),
        "lane_ingest_elision_fps": r1(lane_elision_fps),
        "lane_rans_ingest_fps": r1(lane_rans_fps),
        "lane_container_bytes": lane_bytes,
        "lane_host_prep_ms_per_window": r1(lane_prep_ms),
        "row_wall_s": marks,
    }), flush=True)


if __name__ == "__main__":
    main()
