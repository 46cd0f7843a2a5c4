"""Smoke test of the batched ingest pipeline on the GPU, at deployment size.

    python chip_smoke.py          # one card: phases A-E at 1080p
    python chip_smoke.py --four   # four cards: the (dp, gop) mesh phase only

The deployment is the README's: 1080p 24-bit ScreenPressor v4 screen
capture, four streams per batch, 64-frame windows.  Streams are generated
from seeds (utils/corpora) and encoded with the native encoder, so every
decoded frame has a known answer: the codec is lossless, and each phase
compares the device's frames bit-exactly with the generator's.

  A  main path: VideoIngestPipeline (kmv transport, still-elision, ds2 model
     epilogue) and the same ingest through the CLI, in process;
  B  every other SP device path, one window each: bc, kmv_sparse (with and
     without the lane-coded tile payload), general, lane (raw and rans
     payloads) and the packed ds2 model output;
  C  MSVideo1 16-bit and 8-bit palettized 320×240 batches vs the oracle;
  D  whether a pooled host buffer may be rewritten right after its upload,
     and that frames stay correct while windows overlap;
  E  memory of the main step and the host-clock time of the general and
     kmv composes on one window.

Every phase is a plain function with its sizes as arguments (the CPU tests
call them at tiny sizes); only main() insists on a GPU.  A failing phase
raises, so the script exits non-zero and prints no result.  The last
stdout line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the deployment (README "Quick start"): 1080p capture, 4 streams/batch
X, Y = 1920, 1080
STREAMS, FRAMES, WINDOW = 4, 128, 64
MSV1_X, MSV1_Y, MSV1_STREAMS, MSV1_FRAMES, MSV1_WINDOW = 320, 240, 8, 24, 8
MESH_WINDOW = 32  # --four: keyframe every 32 frames → 2 gop groups of 2


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------

@dataclass
class SpCorpus:
    """Generated streams with their answers: avis[b] decodes to frames[b]."""
    X: int
    Y: int
    frames: list   # per stream [T, Y, X] u32 generator frames
    streams: list  # per stream, per frame encoded bitstreams
    avis: list     # per stream muxed AVI bytes


def make_sp_corpus(X: int, Y: int, T: int, n_streams: int = 4,
                   keyframe_every: int | None = None) -> SpCorpus:
    """n-1 screen_mix streams (stills=1/3, seeds 0..) and one
    terminal_session (seed 0), native-encoded as ScreenPressor v4.
    keyframe_every=k starts a fresh GOP (I-frame) every k frames."""
    from jsplayer_tpu import native
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.utils import corpora

    def one(b):
        if b < n_streams - 1:
            fr = corpora.screen_mix(T=T, Y=Y, X=X, stills=1 / 3, seed=b)
        else:
            fr = corpora.terminal_session(T=T, Y=Y, X=X, seed=0)
        fr = np.stack(fr)
        ss, keys, enc = [], [], None
        for t in range(T):
            key = t == 0 or (keyframe_every and t % keyframe_every == 0)
            flat = np.ascontiguousarray(fr[t]).reshape(-1)
            if key:
                enc = native.NativeScreenPressorEncoder(4, X, Y)
                ss.append(enc.encode_i(flat))
            else:
                ss.append(enc.encode_p(flat))
            keys.append(bool(key))
        return fr, ss, mux_avi(ss, X, Y, 24, codec="SPV4", keyflags=keys)

    with ThreadPoolExecutor(n_streams) as ex:
        got = list(ex.map(one, range(n_streams)))
    return SpCorpus(X, Y, [g[0] for g in got], [g[1] for g in got],
                    [g[2] for g in got])


def _sources(blobs):
    from jsplayer_tpu.core.source import MemorySource

    return [MemorySource(b) for b in blobs]


# ---------------------------------------------------------------------------
# references and checks
# ---------------------------------------------------------------------------

def model_input_ref(frames: np.ndarray, downscale: int) -> np.ndarray:
    """numpy evaluation of rgb_convert.to_model_input (bf16, NHWC, flipped,
    scale 1/255, mean 0, 24-bit): integer box sums, one f32 multiply, one
    round to bf16."""
    import jax.numpy as jnp

    c = frames.astype(np.uint32)
    d = downscale
    H, W = c.shape[-2] // d * d, c.shape[-1] // d * d
    c = c[..., :H, :W]
    p0 = (c & np.uint32(0x00FF00FF)).astype(np.int64)
    p1 = ((c >> 8) & np.uint32(0xFF)).astype(np.int64)
    shape = c.shape[:-2] + (H // d, d, W // d, d)
    p0 = p0.reshape(shape).sum(axis=(-3, -1))
    p1 = p1.reshape(shape).sum(axis=(-3, -1))
    x = np.stack([p0 >> 16, p1, p0 & 0xFFFF], axis=-1)[..., ::-1, :, :]
    scale = np.float32(1.0 / 255.0 / (d * d))
    return (x.astype(np.float32) * scale).astype(jnp.bfloat16)


def ds2_packed_ref(frames: np.ndarray) -> np.ndarray:
    """numpy packed ds2 plane (b | g<<10 | r<<20 2×2 sums), rows flipped."""
    c = frames.astype(np.uint32)
    H, W = c.shape[-2] // 2 * 2, c.shape[-1] // 2 * 2
    c = c[..., :H, :W]
    f = ((c & 0xFF) | (((c >> 8) & 0xFF) << 10)
         | (((c >> 16) & 0xFF) << 20)).astype(np.int64)
    f = f.reshape(c.shape[:-2] + (H // 2, 2, W // 2, 2)).sum(axis=(-3, -1))
    return f[..., ::-1, :].astype(np.int32)


def _same(got: np.ndarray, want: np.ndarray, what: str) -> None:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape} {got.dtype} != "
                             f"{want.shape} {want.dtype}")
    if not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
        bad = np.argwhere(got != want)
        raise AssertionError(f"{what}: {len(bad)} elements differ, first "
                             f"at {tuple(bad[0])}")


def timeline(pipe, n_frames: int, mask: int = 0xFFFFFFFF,
             model: str | None = None, downscale: int = 2):
    """Drain a pipeline and rebuild each stream's decoded timeline
    [B, n_frames, Y, X] from dense windows or flat elided stacks + outmap.
    model="input" / "packed": also check each window's model output against
    the numpy reference of its own frames.  → (timeline, windows)."""
    out = None
    windows = 0
    for batch in pipe:
        windows += 1
        fr = np.asarray(batch["frames_u32"]) & np.uint32(mask)
        om = batch.get("outmap")
        start = batch["start_frame"]
        if model is not None and "model_input" in batch:
            mi = np.asarray(batch["model_input"])
            for i in range(0, len(fr.reshape((-1,) + fr.shape[-2:])), 8):
                f8 = fr.reshape((-1,) + fr.shape[-2:])[i : i + 8]
                ref = (model_input_ref(f8, downscale) if model == "input"
                       else ds2_packed_ref(f8))
                m8 = mi.reshape((-1,) + mi.shape[fr.ndim - 2:])[i : i + 8]
                _same(m8, ref, f"model {model} @{start} row {i}")
        if out is None:
            B = om.shape[0] if om is not None else fr.shape[0]
            out = np.zeros((B, n_frames) + fr.shape[-2:], np.uint32)
        for b in range(out.shape[0]):
            n = om.shape[1] if om is not None else fr.shape[1]
            for t in range(n):
                gi = start + t
                if gi >= n_frames:
                    break
                if om is None:
                    out[b, gi] = fr[b, t]
                elif om[b, t] >= 0:
                    out[b, gi] = fr[om[b, t]]
                else:  # still at the window start: the carry-in frame
                    out[b, gi] = out[b, gi - 1]
    return out, windows


def check_against(got: np.ndarray, corpus: SpCorpus, n_frames: int,
                  what: str, streams=None) -> int:
    streams = range(len(corpus.frames)) if streams is None else streams
    for i, b in enumerate(streams):
        _same(got[i], corpus.frames[b][:n_frames], f"{what} stream {b}")
    return got.shape[0] * n_frames


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_a(corpus: SpCorpus, window: int) -> dict:
    """Main path: kmv transport, still-elision, ds2 model epilogue — through
    VideoIngestPipeline and through `python -m jsplayer_tpu ingest`."""
    from jsplayer_tpu.__main__ import main as cli_main
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline

    T = corpus.frames[0].shape[0]
    cfg = IngestConfig(window=window, still_elision=True, model_downscale=2)
    pipe = VideoIngestPipeline(_sources(corpus.avis), cfg)
    got, windows = timeline(pipe, T, model="input")
    n = check_against(got, corpus, T, "A pipeline")
    del got
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for b, avi in enumerate(corpus.avis):
            paths.append(os.path.join(d, f"s{b}.avi"))
            with open(paths[-1], "wb") as f:
                f.write(avi)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["ingest", *paths, "--window", str(window),
                           "--elide", "--downscale", "2"])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or rec["frames_decoded"] != len(paths) * T:
        raise AssertionError(f"A cli: rc={rc} {rec}")
    return {"frames_bit_exact": n, "windows": windows,
            "concat_windows": pipe.stats["concat_windows"],
            "padded_windows": pipe.stats["padded_windows"],
            "model_input": "bit-exact vs numpy to_model_input",
            "cli_frames_decoded": rec["frames_decoded"]}


def phase_b(corpus: SpCorpus, window: int) -> dict:
    """Every other SP device path, one window each, bit-exact."""
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline
    from jsplayer_tpu.transcode import transcode_to_lane

    res = {}
    one = dict(window=window, frame_range=(0, window),
               emit_model_input=False)
    cases = {
        "bc": IngestConfig(sp_device_path="bc", **one),
        "kmv_sparse": IngestConfig(sp_device_path="kmv_sparse", **one),
        "kmv_sparse_lane_payload": IngestConfig(
            sp_device_path="kmv_sparse", sparse_lane_payload=True, **one),
        "general": IngestConfig(sp_device_path="general", **one),
    }
    for name, cfg in cases.items():
        got, _ = timeline(VideoIngestPipeline(_sources(corpus.avis), cfg),
                          window)
        res[name] = check_against(got, corpus, window, f"B {name}")
    cfg = IngestConfig(window=window, frame_range=(0, window),
                       model_downscale=2, model_packed=True)
    got, _ = timeline(VideoIngestPipeline(_sources(corpus.avis), cfg),
                      window, model="packed")
    res["model_packed"] = check_against(got, corpus, window,
                                        "B model_packed")
    heads = [mux_avi(s[:window], corpus.X, corpus.Y, 24, codec="SPV4")
             for s in corpus.streams]
    for payload in ("raw", "rans"):
        conts = [transcode_to_lane(a, window=window, K=2, payload=payload)
                 for a in heads]
        pipe = VideoIngestPipeline(
            _sources(conts),
            IngestConfig(sp_device_path="lane", emit_model_input=False))
        got, _ = timeline(pipe, window, mask=0x00FFFFFF)
        res[f"lane_{payload}"] = check_against(got, corpus, window,
                                               f"B lane {payload}")
    return {"frames_bit_exact": res}


def make_msv1_batch(bits: int, X: int, Y: int, B: int, T: int, seed: int):
    """B random-opcode MSVideo1 streams → (AVIs, oracle frames [B,T,Y*X])."""
    from jsplayer_tpu.codecs.msvideo1 import MSVideo1_8bit, MSVideo1_16bit
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.msv1_enc import random_stream_8, random_stream_16

    rng = np.random.default_rng(seed)
    pal = bytes(rng.integers(0, 256, 256 * 4, dtype=np.uint8)) \
        if bits == 8 else None
    gen = random_stream_16 if bits == 16 else random_stream_8
    avis, oracle = [], np.zeros((B, T, X * Y), np.uint32)
    for b in range(B):
        ss = [gen(rng, X, Y, allow_skip=t > 0) for t in range(T)]
        dec = MSVideo1_16bit(X, Y) if bits == 16 else MSVideo1_8bit(X, Y, pal)
        dec.preinit(0)
        for t, s in enumerate(ss):
            oracle[b, t] = dec.decompress_p(
                s, np.zeros(X * Y, np.uint32)).data
        avis.append(mux_avi(ss, X, Y, bits, codec="CRAM", palette=pal,
                            keyflags=[t == 0 for t in range(T)]))
    return avis, oracle


def phase_c(X: int, Y: int, B: int, T: int, window: int) -> dict:
    """MSVideo1 (BASELINE configs 1-2) through the pipeline vs the oracle."""
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline

    res = {}
    for bits in (16, 8):
        avis, oracle = make_msv1_batch(bits, X, Y, B, T, seed=bits)
        pipe = VideoIngestPipeline(_sources(avis), IngestConfig(window=window))
        got, _ = timeline(pipe, T)
        _same(got.reshape(B, T, -1), oracle, f"C msv1 {bits}-bit")
        res[f"msv1_{bits}bit"] = B * T
    return {"frames_bit_exact": res}


def phase_d(corpus: SpCorpus, window: int) -> dict:
    """The pooled-buffer question.  (1) Upload a window-sized host buffer,
    overwrite it at once, and see whether the device copy changed.  (2)
    Dense kmv windows (one pooled plane refilled per window) drained
    before any window is read: with the pipeline's barrier the frames must
    stay exact; (3) without it, count the frames that come out wrong."""
    import jax
    import jax.numpy as jnp

    from jsplayer_tpu.pipeline import ingest

    B = len(corpus.avis)
    buf = np.zeros((B, window, corpus.Y, corpus.X), np.uint32)
    dev = ingest._put(buf)
    buf[...] = 0xFFFFFFFF
    put_saw_overwrite = bool(jnp.any(dev != 0))
    del dev, buf
    T = corpus.frames[0].shape[0]
    cfg = ingest.IngestConfig(window=window, emit_model_input=False)

    def drain():
        outs = list(ingest.VideoIngestPipeline(_sources(corpus.avis), cfg))
        got, _ = timeline(iter(outs), T)
        return got

    got = drain()
    n = check_against(got, corpus, T, "D overlap")
    barrier = ingest._window_barrier
    ingest._window_barrier = lambda *a: None
    try:
        raw = drain()
    finally:
        ingest._window_barrier = barrier
    wrong = int(sum((raw[b] != corpus.frames[b][:T]).any(axis=(1, 2)).sum()
                    for b in range(B)))
    return {"put_saw_overwrite": put_saw_overwrite,
            "frames_bit_exact_with_barrier": n,
            "frames_wrong_without_barrier": wrong}


def _time(fn, *args, reps: int = 5) -> dict:
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return {"min_ms": min(ts) * 1e3, "median_ms": float(np.median(ts)) * 1e3}


def phase_e(corpus: SpCorpus, window: int) -> dict:
    """Memory of the main step at Phase A's shapes, and the host-clock
    compose time of the general (gather) and kmv paths on one window."""
    import jax
    import jax.numpy as jnp

    from jsplayer_tpu import native
    from jsplayer_tpu.kernels import sp_recon
    from jsplayer_tpu.kernels.rgb_convert import to_model_input

    B, X_, Y_ = len(corpus.avis), corpus.X, corpus.Y
    K = 2

    @jax.jit
    def main_step(init, pc, mvk, changed):
        frames = sp_recon.decode_batch_kmv(init, pc, mvk, changed)
        return frames, to_model_input(frames, downscale=2)

    sds = jax.ShapeDtypeStruct
    ma = main_step.lower(
        sds((B, Y_, X_), jnp.uint32), sds((B, window, Y_, X_), jnp.uint32),
        sds((B, window, K, 2), jnp.int32), sds((B, window), jnp.bool_),
    ).compile().memory_analysis()
    mem = {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")} \
        if ma is not None else None
    stats = jax.devices()[0].memory_stats() or {}

    s0 = [corpus.streams[0][:window]]
    g = native.native_sp_decode_streams(s0, X_, Y_)
    k = native.native_sp_decode_streams_kmv(s0, X_, Y_, K=K)
    init = jnp.zeros((Y_, X_), jnp.uint32)
    gen_args = jax.device_put((init, g["bts"][0], g["mv"][0], g["rect"][0],
                               g["payload"][0], g["changed"][0]))
    kmv_args = jax.device_put((init, k["paycode"][0], k["mvk"][0],
                               k["changed"][0]))
    general = lambda *a: sp_recon.decode_sequence(*a, jnp.int32(0))[0]
    want = corpus.frames[0][:window]
    _same(np.asarray(general(*gen_args)), want, "E general")
    _same(np.asarray(sp_recon.decode_sequence_kmv(*kmv_args)), want, "E kmv")
    times = {"general": _time(general, *gen_args),
             "kmv": _time(sp_recon.decode_sequence_kmv, *kmv_args)}
    for v in times.values():
        v["us_per_frame"] = v["min_ms"] * 1e3 / window
    return {"main_step_memory": mem,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "compose_window_frames": window, "compose_times": times}


def phase_mesh(corpus: SpCorpus, window: int, devices) -> dict:
    """(dp, gop) mesh over four devices vs the same streams on one device:
    dp=4 over kmv+elision, bc and lane; dp=2 × gop=2 over keyframe-led
    windows (the GOP-grouped path).  corpus needs a keyframe every
    `window` frames and four streams."""
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline
    from jsplayer_tpu.pipeline.mesh import make_mesh
    from jsplayer_tpu.transcode import transcode_to_lane

    T = corpus.frames[0].shape[0]
    dp4 = make_mesh(dp=4, gop=1, devices=devices[:4])
    dp2gop2 = make_mesh(dp=2, gop=2, devices=devices[:4])
    lanes = [transcode_to_lane(a, window=window, K=2) for a in corpus.avis]
    legs = {
        "kmv_elision_dp4": (corpus.avis, dp4, dict(
            window=window, still_elision=True, emit_model_input=False)),
        "bc_dp4": (corpus.avis, dp4, dict(
            window=window, sp_device_path="bc", emit_model_input=False)),
        "lane_dp4": (lanes, dp4, dict(
            sp_device_path="lane", emit_model_input=False)),
        "kmv_gop_dp2x2": (corpus.avis[:2], dp2gop2, dict(
            window=window, emit_model_input=False)),
    }
    res = {}
    for name, (blobs, mesh, kw) in legs.items():
        mask = 0x00FFFFFF if name.startswith("lane") else 0xFFFFFFFF
        used = set()

        def placed(pipe):
            # every window's output must span the mesh, not sit on one card
            for batch in pipe:
                used.update(d.id for d in batch["frames_u32"].sharding
                            .device_set)
                yield batch

        sharded, wins = timeline(placed(VideoIngestPipeline(
            _sources(blobs), IngestConfig(mesh=mesh, **kw))), T, mask=mask)
        if len(used) != mesh.devices.size:
            raise AssertionError(f"mesh {name}: output on devices {used}")
        single, _ = timeline(VideoIngestPipeline(
            _sources(blobs), IngestConfig(**kw)), T, mask=mask)
        _same(sharded, single, f"mesh {name} vs one device")
        n = check_against(sharded, corpus, T, f"mesh {name}",
                          streams=range(len(blobs)))
        res[name] = {"frames_bit_exact": n, "windows": wins,
                     "devices": len(used)}
    return res


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    print(f"[phase {name}] ok {json.dumps(out, default=str)}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    from jsplayer_tpu.utils.device import (device_record,
                                           nvidia_smi_name_power,
                                           require_gpu)

    devs = require_gpu()
    from jsplayer_tpu.utils.compile_cache import setup_compile_cache

    cache = setup_compile_cache()
    subprocess.run(["make", "-B", "-C",
                    os.path.join(REPO, "jsplayer_tpu", "native"),
                    "libjsptpu.so"], check=True, stdout=subprocess.DEVNULL)
    from jsplayer_tpu import native

    if not native.available():
        raise SystemExit("native library failed to load after the rebuild")
    dev = device_record(devs)
    print(f"device_kind: {dev['kind']}  devices: {dev['count']}  "
          f"compile cache: {cache}", flush=True)
    print(f"nvidia-smi: {nvidia_smi_name_power()}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        if len(devs) < 4:
            raise SystemExit(f"--four needs 4 devices, found {len(devs)}")
        corpus = make_sp_corpus(X, Y, FRAMES, STREAMS,
                                keyframe_every=MESH_WINDOW)
        _phase("mesh", phase_mesh, corpus, MESH_WINDOW, devs)
    else:
        corpus = make_sp_corpus(X, Y, FRAMES, STREAMS)
        print(f"[corpus] {STREAMS}x{FRAMES} frames {X}x{Y} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        _phase("A", phase_a, corpus, WINDOW)
        _phase("B", phase_b, corpus, WINDOW)
        _phase("C", phase_c, MSV1_X, MSV1_Y, MSV1_STREAMS, MSV1_FRAMES,
               MSV1_WINDOW)
        _phase("D", phase_d, corpus, WINDOW)
        _phase("E", phase_e, corpus, WINDOW)
    print(f"[total] {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
