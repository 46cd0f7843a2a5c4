"""End-to-end ingestion: batched AVI sources → windows of model tensors,
bit-exact across window boundaries (carry) for both codecs."""

import numpy as np
import pytest

from jsplayer_tpu.codecs.msvideo1 import from_rgb15
from jsplayer_tpu.core.source import MemorySource
from jsplayer_tpu.encode.avi_mux import mux_avi
from jsplayer_tpu.encode.msv1_enc import encode_frame_16
from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline

X, Y = 32, 32


def sp_avi(seed, nframes=11):
    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(seed, 5, 9), dtype=np.uint32)
    frames_px, streams = [], []
    for t in range(nframes):
        f = f.copy()
        if t % 4 == 1:
            f[2:, :] = f[:-2, :].copy()  # scroll → motion blocks (kmv path)
        if t % 4 != 3:
            f[(t % 5) * 4 : (t % 5) * 4 + 4, 8:20] = pack_rgb(
                *rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if t % 5 == 0 else enc.encode_p(flat))
        frames_px.append(flat)
    keys = [t % 5 == 0 for t in range(nframes)]
    return mux_avi(streams, X, Y, 24, codec="SPV4", keyflags=keys), frames_px


def msv1_avi(seed, nframes=11):
    rng = np.random.default_rng(seed)
    frames_px, streams = [], []
    prev = None
    f = np.full((Y, X), from_rgb15(0x2222), dtype=np.uint32)
    for t in range(nframes):
        f = f.copy()
        x0 = ((t * 4) % (X - 4)) & ~3
        f[8:12, x0 : x0 + 4] = from_rgb15(int(rng.integers(0, 0x8000)))
        flat = f.reshape(-1)
        streams.append(encode_frame_16(flat, prev, X, Y))
        frames_px.append(flat)
        prev = flat
    keys = [t == 0 for t in range(nframes)]
    return mux_avi(streams, X, Y, 16, codec="CRAM", keyflags=keys), frames_px


@pytest.mark.parametrize("maker,cfg", [
    (sp_avi, IngestConfig(window=4)),                          # kmv default
    (sp_avi, IngestConfig(window=4, sp_device_path="general")),
    (sp_avi, IngestConfig(window=4, sp_device_path="bc")),
    (sp_avi, IngestConfig(window=4, sp_device_path="kmv_sparse")),
    (msv1_avi, IngestConfig(window=4)),
])
def test_ingest_windows_bit_exact(maker, cfg):
    avis, golds = zip(*(maker(s) for s in (1, 2, 3)))
    pipe = VideoIngestPipeline([MemorySource(a) for a in avis], cfg)
    seen = 0
    for batch in pipe:
        frames = np.asarray(batch["frames_u32"])  # [B, T, Y, X]
        start = batch["start_frame"]
        for b in range(3):
            for t in range(frames.shape[1]):
                gi = min(start + t, len(golds[b]) - 1)  # padded tail repeats
                np.testing.assert_array_equal(
                    frames[b, t].reshape(-1), golds[b][gi],
                    err_msg=f"stream {b} frame {start + t}")
        mi = batch["model_input"]
        assert mi.shape == (3, frames.shape[1], Y, X, 3)
        seen += frames.shape[1]
    assert seen >= 11


def test_gop_segmentation():
    from jsplayer_tpu.pipeline.gop import pack_batch, segment_stream, split_gops

    frames = [bytes([i]) for i in range(10)]
    keys = [True, False, False, True, False, True, False, False, False, False]
    gops = split_gops(frames, keys)
    assert [g[0] for g in gops] == [0, 3, 5]
    assert [len(g[1]) for g in gops] == [3, 2, 5]

    segs = segment_stream(frames, keys, segment_len=3)
    assert [(s.start_frame, s.n_real, s.independent) for s in segs] == [
        (0, 3, True), (3, 2, True), (5, 3, True), (8, 2, False)]
    assert all(len(s.frames) == 3 for s in segs)
    assert segs[1].frames[2] == b""  # padded no-change tail

    rows = pack_batch(segs, gops_per_stream=3)
    assert len(rows) == 2 and len(rows[1]) == 3
    assert rows[1][2].n_real == 0  # padding segment


def test_gop_leading_nonkey():
    from jsplayer_tpu.pipeline.gop import split_gops

    frames = [b"a", b"b", b"c"]
    keys = [False, True, False]
    gops = split_gops(frames, keys)
    assert [g[0] for g in gops] == [0, 1]


def test_ingest_model_only_fused():
    """emit_frames=False: fused kmv→model scan matches the two-step path."""
    import jax.numpy as jnp
    from jsplayer_tpu.kernels.rgb_convert import to_model_input

    avis, golds = zip(*(sp_avi(s) for s in (1, 2)))
    cfg_full = IngestConfig(window=4)
    cfg_fused = IngestConfig(window=4, emit_frames=False)
    full = list(VideoIngestPipeline([MemorySource(a) for a in avis], cfg_full))
    fused = list(VideoIngestPipeline([MemorySource(a) for a in avis], cfg_fused))
    assert len(full) == len(fused)
    for bf, bz in zip(full, fused):
        assert "frames_u32" not in bz
        np.testing.assert_array_equal(
            np.asarray(bf["model_input"], dtype=np.float32),
            np.asarray(bz["model_input"], dtype=np.float32))


def test_ingest_sparse_path_bit_exact():
    """kmv_sparse transport matches golds (keyframe-led windows, scrolls,
    paints, stills)."""
    avis, golds = zip(*(sp_avi(s) for s in (1, 2)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=4, sp_device_path="kmv_sparse"))
    for batch in pipe:
        frames = np.asarray(batch["frames_u32"])
        start = batch["start_frame"]
        for b in range(2):
            for t in range(frames.shape[1]):
                gi = min(start + t, len(golds[b]) - 1)
                np.testing.assert_array_equal(
                    frames[b, t].reshape(-1), golds[b][gi],
                    err_msg=f"stream {b} frame {start + t}")


def test_ingest_sparse_path_oracle_fallback(monkeypatch):
    """kmv_sparse without the native library (oracle decoders + numpy
    prepare) stays bit-exact."""
    from jsplayer_tpu import native as _native

    monkeypatch.setattr(_native, "available", lambda: False)
    avis, golds = zip(*(sp_avi(s) for s in (1,)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=4, sp_device_path="kmv_sparse"))
    for batch in pipe:
        frames = np.asarray(batch["frames_u32"])
        start = batch["start_frame"]
        for t in range(frames.shape[1]):
            gi = min(start + t, len(golds[0]) - 1)
            np.testing.assert_array_equal(frames[0, t].reshape(-1),
                                          golds[0][gi],
                                          err_msg=f"frame {start + t}")


@pytest.mark.parametrize("path", ["kmv", "kmv_sparse"])
def test_ingest_quarantines_bad_stream(path):
    """A decode error freezes its stream at the last good frame; the other
    batch slot decodes to the end (SURVEY §5.3 failure model).  The error
    is injected at the decoder boundary (structural errors like invalid
    motion bounds raise ValueError; plain bit corruption decodes to wrong
    pixels by design, like the reference)."""
    (avi_ok, golds_ok), (avi_b, _g) = sp_avi(1), sp_avi(2)
    pipe = VideoIngestPipeline(
        [MemorySource(avi_ok), MemorySource(avi_b)],
        IngestConfig(window=4, sp_device_path=path))
    decs = pipe._sp_decoders()
    bad = decs[1]
    count = [0]

    class Boom:
        def __getattr__(self, name):
            orig = getattr(bad, name)
            if name.startswith("decompress"):
                def wrap(*a, **k):
                    count[0] += 1
                    if count[0] >= 6:
                        raise ValueError("injected decode failure")
                    return orig(*a, **k)
                return wrap
            return orig

    pipe._spdecs = [decs[0], Boom()]
    outs = {}
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for t in range(fr.shape[1]):
            outs[batch["start_frame"] + t] = fr[:, t]
    assert pipe.quarantined == {1}, pipe.quarantine_errors
    for t in range(len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][0].reshape(-1), golds_ok[t],
            err_msg=f"healthy stream frame {t}; qerrs={pipe.quarantine_errors}")
    # the frozen stream repeats its last good frame
    last = outs[5][1]
    np.testing.assert_array_equal(outs[len(golds_ok) - 1][1], last)


def test_ingest_sparse_quarantines_keyframe_failure():
    """A decode failure on a WINDOW-LEADING keyframe of the kmv_sparse
    path (the skip0 dense-init decode, which runs on the host thread pool)
    quarantines its slot instead of escaping the pool and failing the
    batch; the frozen stream's init row comes from its carry, not stale
    pooled pixels (SURVEY §5.3 freeze-at-last-good-frame)."""
    from jsplayer_tpu import native

    if not native.available():  # the skip0 'decompress' hook is native-only
        pytest.skip("native unavailable")
    (avi_ok, golds_ok), (avi_b, _g) = sp_avi(1), sp_avi(2)
    pipe = VideoIngestPipeline(
        [MemorySource(avi_ok), MemorySource(avi_b)],
        IngestConfig(window=5, sp_device_path="kmv_sparse"))
    decs = pipe._sp_decoders()
    bad = decs[1]
    kcount = [0]

    class Boom:
        def __getattr__(self, name):
            orig = getattr(bad, name)
            if name == "decompress":
                def wrap(*a, **k):
                    kcount[0] += 1
                    if kcount[0] >= 2:  # the window-5 leading keyframe
                        raise ValueError("injected keyframe failure")
                    return orig(*a, **k)
                return wrap
            return orig

    pipe._spdecs = [decs[0], Boom()]
    outs = {}
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for t in range(fr.shape[1]):
            outs[batch["start_frame"] + t] = fr[:, t]
    assert pipe.quarantined == {1}, pipe.quarantine_errors
    for t in range(len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][0].reshape(-1), golds_ok[t],
            err_msg=f"healthy stream frame {t}")
    # the frozen stream repeats its last pre-failure frame (t=4) through
    # every later window, including window-leading keyframe slots
    for t in range(5, len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][1], outs[4][1], err_msg=f"frozen stream frame {t}")


def test_ingest_sparse_midwindow_quarantine_keeps_keyframe():
    """A slot quarantined MID-window (after its window-leading keyframe
    decoded successfully) must keep that keyframe as the scan init: the
    pre-failure frames composed against it, and overwriting it with the
    previous window's carry would corrupt every frame of the window
    (review finding on the skip0 freeze fix)."""
    from jsplayer_tpu import native

    if not native.available():
        pytest.skip("native unavailable")
    (avi_ok, golds_ok), (avi_b, golds_b) = sp_avi(1), sp_avi(2)
    pipe = VideoIngestPipeline(
        [MemorySource(avi_ok), MemorySource(avi_b)],
        IngestConfig(window=5, sp_device_path="kmv_sparse"))
    decs = pipe._sp_decoders()
    bad = decs[1]
    pcount = [0]

    class Boom:
        def __setattr__(self, name, value):
            setattr(bad, name, value)

        def __getattr__(self, name):
            orig = getattr(bad, name)
            if name == "decompress_kmv_sparse":
                def wrap(*a, **k):
                    pcount[0] += 1
                    if pcount[0] >= 6:  # t=7: two P-frames after keyframe 5
                        raise ValueError("injected mid-window failure")
                    return orig(*a, **k)
                return wrap
            return orig

    pipe._spdecs = [decs[0], Boom()]
    outs = {}
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for t in range(fr.shape[1]):
            outs[batch["start_frame"] + t] = fr[:, t]
    assert pipe.quarantined == {1}, pipe.quarantine_errors
    for t in range(len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][0].reshape(-1), golds_ok[t],
            err_msg=f"healthy stream frame {t}")
    # pre-failure frames of the bad stream are exact: the window-5
    # keyframe (t=5) and the P-frame composed on it (t=6)
    for t in (5, 6):
        np.testing.assert_array_equal(
            outs[t][1].reshape(-1), golds_b[t],
            err_msg=f"pre-failure frame {t} corrupted")
    # from the failed frame on, the stream freezes at t=6
    for t in range(7, len(golds_b)):
        np.testing.assert_array_equal(
            outs[t][1], outs[6][1], err_msg=f"frozen stream frame {t}")


@pytest.mark.parametrize("path", ["kmv", "kmv_sparse", "bc"])
def test_ingest_quarantines_bad_stream_pure_fallback(path, monkeypatch):
    """The same freeze contract WITHOUT the native library: the pure-Python
    oracle host stages raise ValueError/AssertionError/IndexError on corrupt
    streams and must quarantine the slot, not fail the whole batch (the
    exception breadth _guard's docstring promises)."""
    from jsplayer_tpu import native as _native

    monkeypatch.setattr(_native, "available", lambda: False)
    (avi_ok, golds_ok), (avi_b, _g) = sp_avi(1), sp_avi(2)
    pipe = VideoIngestPipeline(
        [MemorySource(avi_ok), MemorySource(avi_b)],
        IngestConfig(window=4, sp_device_path=path))
    decs = pipe._sp_decoders()
    bad = decs[1]
    count = [0]

    class Boom:
        # attribute WRITES (dec.capture = {...}) must reach the wrapped
        # oracle, not land on the wrapper
        def __setattr__(self, name, value):
            setattr(bad, name, value)

        def __getattr__(self, name):
            orig = getattr(bad, name)
            if name.startswith("decompress"):
                def wrap(*a, **k):
                    count[0] += 1
                    if count[0] >= 6:
                        raise ValueError("injected decode failure")
                    return orig(*a, **k)
                return wrap
            return orig

    pipe._spdecs = [decs[0], Boom()]
    outs = {}
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for t in range(fr.shape[1]):
            outs[batch["start_frame"] + t] = fr[:, t]
    assert pipe.quarantined == {1}, pipe.quarantine_errors
    for t in range(len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][0].reshape(-1), golds_ok[t],
            err_msg=f"healthy stream frame {t}; "
                    f"qerrs={pipe.quarantine_errors}")
    # stream 1 froze at frame 4 (its 6th decompress call, frame 5, failed)
    for t in range(5, len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][1], outs[4][1], err_msg=f"frozen stream frame {t}")


def test_ingest_msv1_quarantines_bad_stream():
    """MSV1 batches quarantine too: a parse failure freezes its slot and
    the other stream decodes to the end (the SP paths' policy, applied to
    the second codec family)."""
    (avi_ok, golds_ok), (avi_b, _g) = msv1_avi(1), msv1_avi(2)
    pipe = VideoIngestPipeline(
        [MemorySource(avi_ok), MemorySource(avi_b)],
        IngestConfig(window=4))

    calls = [0]
    orig_guard = pipe._guard

    def poisoned_guard(b, fn, *a, **k):
        if b == 1:
            calls[0] += 1
            if calls[0] >= 6:
                def raiser():
                    raise ValueError("injected parse failure")

                return orig_guard(b, raiser, default=k.get("default"))
        return orig_guard(b, fn, *a, **k)

    pipe._guard = poisoned_guard
    outs = {}
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for t in range(fr.shape[1]):
            outs[batch["start_frame"] + t] = fr[:, t]
    assert pipe.quarantined == {1}, pipe.quarantine_errors
    for t in range(len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][0].reshape(-1), golds_ok[t],
            err_msg=f"healthy stream frame {t}")
    # the 6th guarded call (frame 5) failed: frozen at frame 4
    for t in range(5, len(golds_ok)):
        np.testing.assert_array_equal(
            outs[t][1], outs[4][1], err_msg=f"frozen stream frame {t}")


def test_ingest_exposes_audio_tracks():
    """A/V streams: ingest surfaces per-stream MP3 audio sections with PTS
    so consumers can align audio to the decoded frame axis."""
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.mp3_synth import make_frames
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb

    Xd = Yd = 32
    enc = ScreenPressorEncoder(4, Xd, Yd)
    f = np.full((Yd, Xd), pack_rgb(5, 5, 5), dtype=np.uint32).reshape(-1)
    streams = [enc.encode_i(f)]
    for t in range(5):
        nf = f.copy().reshape(Yd, Xd)
        nf[2:6, 2:20] = pack_rgb(t + 1, 9, 9)
        f = nf.reshape(-1)
        streams.append(enc.encode_p(f))
    mp3, nfr, rate = make_frames(40)
    half = len(mp3) // 2
    avi = mux_avi(streams, Xd, Yd, 24, codec="SPV4",
                  keyflags=[t == 0 for t in range(6)],
                  sound_chunks=[(1, mp3[:half]), (3, mp3[half:])])
    pipe = VideoIngestPipeline([MemorySource(avi)], IngestConfig(window=4))
    for _ in pipe:
        pass
    at = pipe.audio_tracks[0]
    assert at.time_loaded > 0
    total = nfr * 1152 / rate
    assert abs(at.time_loaded - total) < 0.2


@pytest.mark.parametrize("seed", [0, 1])
def test_ingest_sparse_soak_random_content(seed):
    """Randomized content soak for the sparse path: scrolls (both axes),
    paints, stills, noise bursts, and MID-WINDOW keyframes (GOP restarts
    that don't align with the window grid → full-tile keyframe handling)."""
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb

    Xs, Ys, N = 48, 48, 26
    rng = np.random.default_rng(100 + seed)
    enc = ScreenPressorEncoder(4, Xs, Ys)
    f = np.full((Ys, Xs), pack_rgb(7, 7, 7), dtype=np.uint32)
    streams, golds, keys = [], [], []
    for t in range(N):
        kind = rng.integers(0, 6)
        is_key = t == 0 or kind == 5
        if is_key:
            enc = ScreenPressorEncoder(4, Xs, Ys)
            f = np.full((Ys, Xs), pack_rgb(int(rng.integers(256)), 7, 7),
                        dtype=np.uint32)
            f[8:20, 4:40] = pack_rgb(*rng.integers(0, 256, 3))
            streams.append(enc.encode_i(f.reshape(-1)))
        else:
            nf = f.copy()
            if kind == 0:
                s8 = int(rng.integers(1, 6))
                nf[s8:, :] = nf[:-s8, :]
            elif kind == 1:
                s8 = int(rng.integers(1, 6))
                nf[:, s8:] = nf[:, :-s8]
            elif kind == 2:
                y0, x0 = rng.integers(0, Ys - 8), rng.integers(0, Xs - 8)
                nf[y0:y0+8, x0:x0+8] = pack_rgb(*rng.integers(0, 256, 3))
            elif kind == 3:
                nf[4:12, 4:20] = rng.integers(
                    0, 1 << 24, (8, 16)).astype(np.uint32)
            # kind 4: still
            f = nf
            streams.append(enc.encode_p(f.reshape(-1)))
        golds.append(f.reshape(-1).copy())
        keys.append(is_key)
    avi = mux_avi(streams, Xs, Ys, 24, codec="SPV4", keyflags=keys)
    pipe = VideoIngestPipeline(
        [MemorySource(avi)],
        IngestConfig(window=5, sp_device_path="kmv_sparse"))
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for t in range(fr.shape[1]):
            gi = min(batch["start_frame"] + t, N - 1)
            np.testing.assert_array_equal(
                fr[0, t].reshape(-1), golds[gi],
                err_msg=f"seed {seed} frame {batch['start_frame'] + t}")


def test_ingest_msv1_8bit_palette():
    """8-bit CRAM ingestion: palette resolves on host (Preinit parity,
    MSVideo1.hx:281-291), device paints resolved u32 colors."""
    from jsplayer_tpu.codecs.msvideo1 import palette_to_u32
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.msv1_enc import encode_frame_8

    Xs = Ys = 32
    rng = np.random.default_rng(21)
    pal = bytes(rng.integers(0, 256, 256 * 4, dtype=np.uint8))
    pal_u32 = palette_to_u32(pal)
    idx = np.full(Ys * Xs, 3, dtype=np.uint8)
    streams, golds, prev = [], [], None
    for t in range(9):
        idx = idx.copy()
        x0 = ((t * 4) % (Xs - 4)) & ~3
        idx.reshape(Ys, Xs)[8:12, x0:x0 + 4] = int(rng.integers(0, 256))
        streams.append(encode_frame_8(idx, prev, Xs, Ys))
        golds.append(pal_u32[idx].astype(np.uint32))
        prev = idx
    avi = mux_avi(streams, Xs, Ys, 8, codec="CRAM", palette=pal,
                  keyflags=[t == 0 for t in range(9)])
    pipe = VideoIngestPipeline([MemorySource(avi)], IngestConfig(window=4))
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for t in range(fr.shape[1]):
            gi = min(batch["start_frame"] + t, 8)
            np.testing.assert_array_equal(fr[0, t].reshape(-1), golds[gi],
                                          err_msg=f"frame {batch['start_frame']+t}")


def test_ingest_still_elision_single_stream():
    """still_elision=True: device decodes only changed frames; outmap
    reconstructs the full timeline bit-exactly."""
    avis, golds = zip(*(sp_avi(4),))
    pipe = VideoIngestPipeline(
        [MemorySource(avis[0])],
        IngestConfig(window=4, still_elision=True))
    carry_prev = None
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        outmap = batch["outmap"]
        start = batch["start_frame"]
        assert fr.shape[1] <= 4
        for t in range(len(outmap)):
            gi = min(start + t, len(golds[0]) - 1)
            if outmap[t] >= 0:
                got = fr[0, outmap[t]].reshape(-1)
            else:
                got = carry_prev  # still at window start: previous window's last
            np.testing.assert_array_equal(got, golds[0][gi],
                                          err_msg=f"frame {start + t}")
        carry_prev = (fr[0, -1].reshape(-1) if fr.shape[1] else carry_prev)


def test_ingest_mesh_sharded_dp():
    """Multi-chip ingest: 4 streams sharded over a dp=4 mesh through the
    shard_map kmv step, bit-exact vs golds across window carries."""
    import jax
    from jsplayer_tpu.pipeline.mesh import make_mesh

    nd = len(jax.devices())
    if nd < 4:
        pytest.skip("needs >=4 devices")
    mesh = make_mesh(dp=nd, gop=1)  # ingest shards streams on dp; gop=1
    avis, golds = zip(*(sp_avi(s) for s in range(1, nd + 1)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=4, mesh=mesh))
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for b in range(nd):
            for t in range(fr.shape[1]):
                gi = min(batch["start_frame"] + t, len(golds[b]) - 1)
                np.testing.assert_array_equal(
                    fr[b, t].reshape(-1), golds[b][gi],
                    err_msg=f"stream {b} frame {batch['start_frame']+t}")


def test_ingest_16bpp_sp_model_channels():
    """16bpp SP: model tensors use the 5-bit-channel scaling (<<3), parity
    with the display conversion (Manager.hx:363-370)."""
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder

    Xs = Ys = 32
    enc = ScreenPressorEncoder(4, Xs, Ys, bpp=16)
    rng = np.random.default_rng(5)
    f = np.full((Ys, Xs), 0x0A0B0C & 0x1F1F1F, dtype=np.uint32).reshape(-1)
    streams, golds = [enc.encode_i(f)], [f]
    for t in range(4):
        nf = f.copy().reshape(Ys, Xs)
        nf[4:8, 4:20] = int(rng.integers(0, 0x8000)) & 0x1F1F1F
        f = nf.reshape(-1)
        streams.append(enc.encode_p(f))
        golds.append(f)
    avi = mux_avi(streams, Xs, Ys, 16, codec="SPV4",
                  keyflags=[t == 0 for t in range(5)])
    pipe = VideoIngestPipeline([MemorySource(avi)], IngestConfig(window=5))
    batch = next(iter(pipe))
    mi = np.asarray(batch["model_input"], dtype=np.float32)
    fr = np.asarray(batch["frames_u32"])
    for t, g in enumerate(golds):
        np.testing.assert_array_equal(fr[0, t].reshape(-1), g)
        # channel 0 (R) == the high byte << 3, normalized, flipped
        want = ((((g.reshape(Ys, Xs) >> 16) & 0xFF) << 3)[::-1] / 255.0)
        np.testing.assert_allclose(mi[0, t, :, :, 0], want, atol=0.01)


def test_ingest_model_channels_are_rgb_for_both_codecs():
    """model_input channel order is true RGB for both codecs.  Ground
    truth: the u32 HIGH byte is displayed RED (the reference's canvas
    swizzle, Manager.hx:377-380, writes c>>16 into ImageData's R byte for
    neither... for BOTH codecs; FFmpeg's independent decoders agree via
    tests/test_ffmpeg_crossval.py).  Round 2 fixed an R/B swap here: the
    SP decode loop's variable names call the first coded (low) byte "r",
    but it is displayed BLUE."""
    from jsplayer_tpu.codecs.msvideo1 import from_rgb15

    # MSV1: a pure-red RGB555 pixel — fromRGB15 puts R in the HIGH byte
    red15 = 0x7C00  # r=31,g=0,b=0
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.msv1_enc import encode_frame_16

    assert from_rgb15(red15) >> 16 == 0xF8  # R lands high
    f = np.full(Y * X, from_rgb15(red15), dtype=np.uint32)
    avi = mux_avi([encode_frame_16(f, None, X, Y)], X, Y, 16, codec="CRAM",
                  keyflags=[True])
    pipe = VideoIngestPipeline([MemorySource(avi)], IngestConfig(window=1))
    mi = np.asarray(next(iter(pipe))["model_input"], dtype=np.float32)
    assert mi[0, 0, 0, 0, 0] > 0.9 and mi[0, 0, 0, 0, 2] < 0.1, \
        f"MSV1 red pixel: {mi[0, 0, 0, 0]}"
    # SP: displayed-red = u32 high byte (pack_rgb's THIRD arg lands high:
    # pack_rgb(r,g,b) = (b<<16)|(g<<8)|r follows the reference's
    # misleading variable naming, so "b" is the displayed-red slot)
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb

    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full(Y * X, pack_rgb(0, 0, 255), dtype=np.uint32)
    assert int(f[0]) >> 16 == 255
    avi = mux_avi([enc.encode_i(f)], X, Y, 24, codec="SPV4", keyflags=[True])
    pipe = VideoIngestPipeline([MemorySource(avi)], IngestConfig(window=1))
    mi = np.asarray(next(iter(pipe))["model_input"], dtype=np.float32)
    assert mi[0, 0, 0, 0, 0] > 0.9 and mi[0, 0, 0, 0, 2] < 0.1, \
        f"SP red pixel: {mi[0, 0, 0, 0]}"


@pytest.mark.parametrize("version", [2, 3])
def test_ingest_legacy_sp_versions(version):
    """SP v2 (range coder) and v3 (rANS f0=64) streams through the full
    ingest pipeline and kmv device path."""
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb

    enc = ScreenPressorEncoder(version, X, Y)
    rng = np.random.default_rng(40 + version)
    f = np.full((Y, X), pack_rgb(6, 6, 6), dtype=np.uint32).reshape(-1)
    streams, golds = [enc.encode_i(f)], [f]
    for t in range(6):
        nf = f.copy().reshape(Y, X)
        if t % 3 == 0:
            nf[2:, :] = nf[:-2, :].copy()
        elif t % 3 == 1:
            nf[4:8, 8:24] = pack_rgb(*rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        streams.append(enc.encode_p(f))
        golds.append(f)
    avi = mux_avi(streams, X, Y, 24, codec=f"SPV{version}",
                  keyflags=[t == 0 for t in range(7)])
    for path in ("kmv", "kmv_sparse"):
        pipe = VideoIngestPipeline([MemorySource(avi)],
                                   IngestConfig(window=4, sp_device_path=path))
        for batch in pipe:
            fr = np.asarray(batch["frames_u32"])
            for t in range(fr.shape[1]):
                gi = min(batch["start_frame"] + t, len(golds) - 1)
                np.testing.assert_array_equal(
                    fr[0, t].reshape(-1), golds[gi],
                    err_msg=f"v{version} {path} frame {batch['start_frame']+t}")


def sp_avi_stills(seed, nframes=12):
    """Screencast-like stream: keyframe then mostly stills, sparse changes
    at seed-dependent times — the content still-elision exists for."""
    rng = np.random.default_rng(seed)
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full((Y, X), pack_rgb(seed, 50, 90), dtype=np.uint32)
    frames_px, streams = [], []
    change_at = set(int(x) for x in rng.choice(
        np.arange(1, nframes), size=max(1, nframes // 4), replace=False))
    for t in range(nframes):
        f = f.copy()
        if t in change_at:
            f[(t % 6) * 4 : (t % 6) * 4 + 4, 4:24] = pack_rgb(
                *rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if t == 0 else enc.encode_p(flat))
        frames_px.append(flat)
    keys = [t == 0 for t in range(nframes)]
    return mux_avi(streams, X, Y, 24, codec="SPV4", keyflags=keys), frames_px


def _check_elided_stream(batches, gold, b):
    """Reconstruct stream b's full timeline from elided windows (FLAT row
    stack + outmap [B, T] contract), bit-exact."""
    carry = None
    for batch in batches:
        fr = np.asarray(batch["frames_u32"])  # [S, Y, X] flat rows
        outmap = np.asarray(batch["outmap"])
        assert outmap.ndim == 2 and fr.ndim == 3
        start = batch["start_frame"]
        last_row = -1
        for t in range(outmap.shape[1]):
            gi = start + t
            if gi >= len(gold):
                break
            if outmap[b, t] >= 0:
                assert outmap[b, t] < fr.shape[0]
                got = fr[outmap[b, t]].reshape(-1)
                last_row = max(last_row, int(outmap[b, t]))
            else:
                got = carry
            np.testing.assert_array_equal(got, gold[gi],
                                          err_msg=f"stream {b} frame {gi}")
        rows = [int(outmap[b, t]) for t in range(outmap.shape[1])
                if outmap[b, t] >= 0]
        if rows:
            carry = fr[max(rows)].reshape(-1)


def test_ingest_still_elision_batched():
    """Batched still-elision (B>1, no mesh): per-stream compaction padded to
    a power-of-two bucket; outmap/valid reconstruct every stream bit-exactly
    and stills really are elided (Cpad < window for still-heavy content)."""
    avis, golds = zip(*(sp_avi_stills(s) for s in (3, 7, 11)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=6, still_elision=True))
    batches = list(pipe)
    saw_elision = any(np.asarray(b["frames_u32"]).shape[0] < 6 * 3
                      for b in batches)
    assert saw_elision, "still-heavy content must compact below the window"
    for b in range(3):
        _check_elided_stream(batches, golds[b], b)


def test_ingest_keyframe_aligned_windows():
    """Window boundaries snap DOWN to keyframes so
    multi-GOP streams stay on the CONCAT elision layout for every window:
    keys every 5 with window=8 → snapped windows [0,5),[5,10), ... all
    keyframe-led (previously windows 1+ started mid-GOP and fell to the
    padded scans).  Timeline tiles exactly; bit-exact."""
    nf = 20
    avis, golds = zip(*(sp_avi(s, nframes=nf) for s in (31, 32)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=8, still_elision=True))
    batches = list(pipe)
    assert [(b["start_frame"], np.asarray(b["outmap"]).shape[1])
            for b in batches] == [(0, 5), (5, 5), (10, 5), (15, 8)]
    assert pipe.stats == {"concat_windows": 4, "padded_windows": 0}
    for b in range(2):
        _check_elided_stream(batches, golds[b], b)

    # control: a single-keyframe stream cannot align — fixed windows, the
    # mid-GOP ones on the padded fallback, still bit-exact
    rng = np.random.default_rng(0)
    enc = ScreenPressorEncoder(4, X, Y)
    streams, gold = [], []
    f = np.full((Y, X), pack_rgb(9, 9, 9), dtype=np.uint32)
    for t in range(nf):
        if t % 3 != 2:
            f = f.copy()
            f[(t % 6) * 4 : (t % 6) * 4 + 4, 4:20] = pack_rgb(
                *rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if t == 0 else enc.encode_p(flat))
        gold.append(flat.copy())
    avi = mux_avi(streams, X, Y, 24, codec="SPV4",
                  keyflags=[t == 0 for t in range(nf)])
    pipe2 = VideoIngestPipeline(
        [MemorySource(avi), MemorySource(avi)],
        IngestConfig(window=8, still_elision=True))
    batches2 = list(pipe2)
    assert pipe2.stats["padded_windows"] == 2, pipe2.stats
    for b in range(2):
        _check_elided_stream(batches2, gold, b)


def test_ingest_still_elision_sharded():
    """Sharded still-elision: the compacted masked scan rides the same
    shard_map kmv step over the dp mesh; bit-exact reconstruction."""
    import jax
    from jsplayer_tpu.pipeline.mesh import make_mesh

    nd = len(jax.devices())
    if nd < 4:
        pytest.skip("needs >=4 devices")
    mesh = make_mesh(dp=nd, gop=1)
    avis, golds = zip(*(sp_avi_stills(s + 20) for s in range(nd)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=6, still_elision=True, mesh=mesh))
    batches = list(pipe)
    assert any(np.asarray(b["frames_u32"]).shape[0] < 6 * nd
               for b in batches)
    for b in range(nd):
        _check_elided_stream(batches, golds[b], b)


def test_ingest_still_elision_all_stills_window():
    """A window where every stream is all-stills: Cpad == 0, nothing hits
    the device, the carry survives to the next window."""
    enc = ScreenPressorEncoder(4, X, Y)
    f = np.full(X * Y, pack_rgb(1, 2, 3), dtype=np.uint32)
    streams = [enc.encode_i(f)]
    gold = [f.copy()]
    for t in range(7):  # 7 stills
        streams.append(enc.encode_p(f))
        gold.append(f.copy())
    g = f.copy()
    g[:X] = pack_rgb(9, 9, 9)
    streams.append(enc.encode_p(g))  # change in the 3rd window
    gold.append(g.copy())
    avi = mux_avi(streams, X, Y, 24, codec="SPV4",
                  keyflags=[t == 0 for t in range(len(streams))])
    pipe = VideoIngestPipeline(
        [MemorySource(avi), MemorySource(avi)],
        IngestConfig(window=4, still_elision=True))
    batches = list(pipe)
    assert np.asarray(batches[1]["frames_u32"]).shape[0] == 0
    assert np.all(np.asarray(batches[1]["outmap"]) == -1)
    for b in range(2):
        _check_elided_stream(batches, gold, b)


def test_ingest_sparse_lane_payload_bit_exact():
    """kmv_sparse + lane-entropy-coded tile payload (device-side rANS
    decode, kernels/lane_transport) matches golds exactly — same windows
    as the raw-tile sparse test."""
    avis, golds = zip(*(sp_avi(s) for s in (1, 2)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=4, sp_device_path="kmv_sparse",
                     sparse_lane_payload=True))
    for batch in pipe:
        frames = np.asarray(batch["frames_u32"])
        start = batch["start_frame"]
        for b in range(2):
            for t in range(frames.shape[1]):
                gi = min(start + t, len(golds[b]) - 1)
                np.testing.assert_array_equal(
                    frames[b, t].reshape(-1), golds[b][gi],
                    err_msg=f"stream {b} frame {start + t}")


def test_ingest_elided_fused_model_only():
    """emit_frames=False + batched still-elision: the compacted masked scan
    emits only model tensors, matching the frames+epilogue path exactly."""
    from jsplayer_tpu.kernels.rgb_convert import to_model_input

    avis, golds = zip(*(sp_avi_stills(s) for s in (3, 7)))
    full = list(VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=6, still_elision=True)))
    fused = list(VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=6, still_elision=True, emit_frames=False)))
    assert len(full) == len(fused)
    for bf, bz in zip(full, fused):
        assert "frames_u32" not in bz
        np.testing.assert_array_equal(np.asarray(bf["outmap"]),
                                      np.asarray(bz["outmap"]))
        if "model_input" in bf:
            np.testing.assert_array_equal(
                np.asarray(bf["model_input"], dtype=np.float32),
                np.asarray(bz["model_input"], dtype=np.float32))
        else:
            assert "model_input" not in bz


def test_ingest_msv1_mesh_sharded_dp():
    """MSV1 ingest over a dp mesh: streams sharded, window carry threaded
    through the sharded step (round 2 — mesh was silently ignored for
    MSV1 before)."""
    import jax
    from jsplayer_tpu.pipeline.mesh import make_mesh

    nd = len(jax.devices())
    if nd < 4:
        pytest.skip("needs >=4 devices")
    mesh = make_mesh(dp=nd, gop=1)
    avis, golds = zip(*(msv1_avi(s) for s in range(1, nd + 1)))
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=4, mesh=mesh))
    for batch in pipe:
        fr = np.asarray(batch["frames_u32"])
        for b in range(nd):
            for t in range(fr.shape[1]):
                gi = min(batch["start_frame"] + t, len(golds[b]) - 1)
                np.testing.assert_array_equal(
                    fr[b, t].reshape(-1), golds[b][gi],
                    err_msg=f"stream {b} frame {batch['start_frame']+t}")


def test_ingest_frame_range_clip():
    """frame_range=(t0, t1): decode starts at the nearest keyframe ≤ t0
    (seek semantics, Manager.hx:244-249) and stops once t1 is covered —
    bit-exact against the full decode over the same frames."""
    avis, golds = zip(*(sp_avi(s) for s in (1, 2)))
    t0, t1 = 6, 10  # keyframes every 5 → rewind to 5
    pipe = VideoIngestPipeline(
        [MemorySource(a) for a in avis],
        IngestConfig(window=4, frame_range=(t0, t1)))
    batches = list(pipe)
    starts = [b["start_frame"] for b in batches]
    assert starts[0] == 5  # nearest keyframe ≤ 6
    seen = set()
    for batch in batches:
        fr = np.asarray(batch["frames_u32"])
        for b in range(2):
            for t in range(fr.shape[1]):
                gi = batch["start_frame"] + t
                if gi >= len(golds[b]):
                    continue
                np.testing.assert_array_equal(
                    fr[b, t].reshape(-1), golds[b][gi],
                    err_msg=f"stream {b} frame {gi}")
                seen.add(gi)
    # the requested clip is fully covered
    assert set(range(t0, t1)) <= seen


def test_ingest_frame_range_misaligned_batch_raises():
    """Streams whose keyframe cadences disagree at the rewind point are
    rejected with a clear error instead of silently mis-decoding."""
    a1, _ = sp_avi(1)  # keys every 5
    # build a stream with keys every 3
    rng = np.random.default_rng(4)
    enc = ScreenPressorEncoder(4, X, Y)
    streams = []
    f = np.full((Y, X), pack_rgb(1, 2, 3), dtype=np.uint32)
    for t in range(11):
        f = f.copy()
        f[(t % 6) * 4 : (t % 6) * 4 + 4, :8] = pack_rgb(*rng.integers(0, 256, 3))
        flat = f.reshape(-1)
        streams.append(enc.encode_i(flat) if t % 3 == 0 else enc.encode_p(flat))
    a2 = mux_avi(streams, X, Y, 24, codec="SPV4",
                 keyflags=[t % 3 == 0 for t in range(11)])
    pipe = VideoIngestPipeline(
        [MemorySource(a1), MemorySource(a2)],
        IngestConfig(window=4, frame_range=(7, 10)))
    with pytest.raises(AssertionError, match="shared keyframe"):
        list(pipe)


@pytest.mark.parametrize("path", ["pallas", "mxu", ""])
def test_unknown_sp_device_path_raises(path):
    avi, _ = sp_avi(1)
    with pytest.raises(ValueError, match="sp_device_path"):
        VideoIngestPipeline([MemorySource(avi)],
                            IngestConfig(window=4, sp_device_path=path))


def test_pooled_buffer_overwrite_after_put_keeps_frames(monkeypatch):
    """The host fills the next window into the same pooled buffer the
    previous window was uploaded from.  Overwriting that buffer as soon as
    a window has been handed out must not change any window's frames, even
    on a runtime whose upload reads the host array late (the window
    barrier runs on every backend)."""
    import jax
    import jax.numpy as jnp

    from jsplayer_tpu.pipeline import ingest

    # model such a runtime: each uploaded plane is read from host memory by
    # a callback that first waits on device work
    busy = jax.jit(lambda v: jax.lax.fori_loop(
        0, 200, lambda i, u: jnp.sin(u) * 0.5 + 1.0, v))
    real_put = ingest._put

    def late_reading_put(a):
        if a.dtype != np.uint32 or a.ndim < 3:
            return real_put(a)
        after = busy(jnp.ones((64, 64))).sum()
        return jax.pure_callback(lambda _: a.copy(),
                                 jax.ShapeDtypeStruct(a.shape, a.dtype),
                                 after)

    monkeypatch.setattr(ingest, "_put", late_reading_put)
    avis, golds = zip(*(sp_avi(s) for s in (1, 2)))
    pipe = VideoIngestPipeline([MemorySource(a) for a in avis],
                               IngestConfig(window=4, emit_model_input=False))
    windows = []
    for batch in pipe:
        # the iterator has already dispatched the NEXT window from the
        # pooled buffer: clobber its planes, let that window finish, then
        # restore them (the native fill keeps state in the buffer)
        buf = getattr(pipe, "_kmvbuf", None) or pipe._spbuf
        planes = [a for k, a in buf.items() if k in ("pc", "payload")]
        saved = [a.copy() for a in planes]
        for a in planes:
            a[...] = 0xFFFFFFFF
        jax.block_until_ready(pipe._carry)
        for a, v in zip(planes, saved):
            a[...] = v
        windows.append(batch)
    assert len(windows) == 3
    for batch in windows:
        frames = np.asarray(batch["frames_u32"])
        start = batch["start_frame"]
        for b in range(2):
            for t in range(frames.shape[1]):
                gi = min(start + t, len(golds[b]) - 1)
                np.testing.assert_array_equal(
                    frames[b, t].reshape(-1), golds[b][gi],
                    err_msg=f"stream {b} frame {start + t}")
