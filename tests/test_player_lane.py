"""Player over `.jlv` lane containers: the full interactive surface
(load/play/seek/step/skip-stills/audio) on this framework's own serving
format, bit-exact against the same content played from the source AVI.
Backed by core/lane_loader.LaneDataLoader + codecs/lane_host.LaneHostCodec
behind the unchanged Manager (Manager.hx:454-539 decode-ahead ring)."""

import numpy as np

from jsplayer_tpu.core.source import MemorySource
from jsplayer_tpu.core.types import CodecType
from jsplayer_tpu.pipeline.manager import FrameResult
from jsplayer_tpu.player import Player, PlayerConfig
from jsplayer_tpu.transcode import transcode_to_lane

from test_player import drive_until_shown, make_msv1_avi, make_sp_avi


def test_player_lane_load_and_playthrough():
    avi, frames_px = make_sp_avi(nframes=12, keyevery=4)
    cont = transcode_to_lane(avi, window=4, K=2)
    p = Player(PlayerConfig())
    vi = p.load(MemorySource(cont))
    assert vi.codec == CodecType.LANE
    assert (vi.width, vi.height, vi.nframes) == (32, 32, 12)
    assert drive_until_shown(p)
    fake_t = [0.0]
    p._clock = lambda: fake_t[0]
    p.play()
    fps = p.manager.fps
    shown = {}
    for t in range(len(frames_px)):
        fake_t[0] = t / fps + 0.001
        for _ in range(200):
            if p.tick() == FrameResult.DECOMPRESSED:
                break
            if not p.playing:
                p.play()
        m = p.manager
        if m._last_filled_buffer is not None:
            shown[m.last_frame_drawn] = m.buffers[m._last_filled_buffer].copy()
    for i, px in enumerate(frames_px):
        if i in shown:
            np.testing.assert_array_equal(shown[i] & 0xFFFFFF, px & 0xFFFFFF,
                                          err_msg=f"frame {i}")
    assert len(shown) >= len(frames_px) - 1


def test_player_lane_seek_and_step():
    avi, frames_px = make_sp_avi(nframes=16, keyevery=4)
    cont = transcode_to_lane(avi, window=4, K=2)
    p = Player(PlayerConfig())
    p.load(MemorySource(cont))
    assert drive_until_shown(p)
    fps = p.manager.fps
    target = 10
    p.seek_time(target / fps + 0.001)
    for _ in range(300):
        p.tick()
        if p.manager.last_frame_drawn == target:
            break
    assert p.manager.last_frame_drawn == target
    np.testing.assert_array_equal(
        p.manager.buffers[p.manager._last_filled_buffer] & 0xFFFFFF,
        frames_px[target] & 0xFFFFFF)
    p.step_frame(forward=True)
    for _ in range(300):
        p.tick()
        if p.manager.last_frame_drawn == target + 1:
            break
    assert p.manager.last_frame_drawn == target + 1
    # step to previous restart-window keyframe (window=4 → frame 8)
    p.step_key(forward=False)
    for _ in range(300):
        p.tick()
        if p.manager.last_frame_drawn == 8:
            break
    assert p.manager.last_frame_drawn == 8
    np.testing.assert_array_equal(
        p.manager.buffers[p.manager._last_filled_buffer] & 0xFFFFFF,
        frames_px[8] & 0xFFFFFF)


def test_player_lane_msv1_rgb_display():
    """MSV1-sourced lane containers record bpp=24 (pixels already
    RGB888-resolved at transcode) — the Player must NOT apply the RGB15
    display expansion it uses for 16bpp MSV1 AVIs; get_rgba output must
    match between the AVI-played and lane-played frames."""
    avi, frames_px = make_msv1_avi(nframes=8)
    pa = Player(PlayerConfig())
    pa.load(MemorySource(avi))
    assert drive_until_shown(pa)
    rgba_avi = pa.manager.get_rgba().copy()

    cont = transcode_to_lane(avi, window=4, K=2)
    pl = Player(PlayerConfig())
    vi = pl.load(MemorySource(cont))
    assert vi.bpp == 24 and not pl.manager.convert_from_rgb15
    assert drive_until_shown(pl)
    np.testing.assert_array_equal(pl.manager.get_rgba(), rgba_avi)


def test_player_lane_audio_and_stills():
    """MP3 passthrough reaches the Player's audio surface from a lane
    container, and skip-stills rides the container's precomputed signif
    verdicts (no decode-ahead classification needed)."""
    avi, _frames_px = make_msv1_avi(nframes=12, with_sound=True)
    cont = transcode_to_lane(avi, window=4, K=2)
    p = Player(PlayerConfig())
    p.load(MemorySource(cont))
    assert drive_until_shown(p)
    for _ in range(100):
        p.manager.loader.parse_sound()
    assert p.manager.loader.audio_track.time_loaded > 0
    # every frame's significance verdict is already present at load
    ld = p.manager.loader
    assert all(ld.get_frame_changes(i) is not None
               for i in range(ld.nframes))
    nc = p.next_change()
    assert nc is not None


def test_player_lane_over_http():
    """.jlv containers stream over HTTP too: Player sniffs the magic via
    one tiny ranged GET, then LaneDataLoader whole-blob-loads the
    container (they are meta-deflated and small) — the lane analog of
    the AVI path's progressive XHR (PostStream.hx:18-196)."""
    from test_http_source import make_server

    avi, frames_px = make_sp_avi(nframes=8, keyevery=4)
    cont = transcode_to_lane(avi, window=4, K=2)
    srv, url = make_server(cont)
    try:
        from jsplayer_tpu.core.source import open_source

        p = Player(PlayerConfig())
        vi = p.load(open_source(url))
        assert vi.codec == CodecType.LANE and vi.nframes == 8
        assert drive_until_shown(p)
        np.testing.assert_array_equal(
            p.manager.buffers[p.manager._last_filled_buffer] & 0xFFFFFF,
            frames_px[0] & 0xFFFFFF)
    finally:
        srv.shutdown()
        srv.server_close()


def test_lane_seek_jumps_to_restart_window():
    """Keyframe-aligned transcode windows make every GOP lead a restart
    point, and a far seek decodes from the TARGET's restart window — not
    from the stream head (Manager.hx:244-249 seek semantics on the lane
    path; fixed late round 4: fixed-stride windows chained the whole file
    to one carry, so every seek replayed from frame 0)."""
    avi, frames_px = make_sp_avi(nframes=16, keyevery=4)
    cont = transcode_to_lane(avi, window=6, K=2)  # snaps 6 -> keyframes @4
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    c = container_from_bytes(cont)
    assert all(w.restart for w in c.windows)  # every window keyframe-led
    assert [w.T for w in c.windows] == [4, 4, 4, 4]

    p = Player(PlayerConfig())
    p.load(MemorySource(cont))
    assert drive_until_shown(p)
    codec = p.manager.decoder
    calls = []
    orig = codec._locate
    codec._locate = lambda data: (calls.append(1), orig(data))[1]
    fps = p.manager.fps
    target = 14  # keyframe at 12: at most 3 decodes + ring slack
    p.seek_time(target / fps + 0.001)
    for _ in range(300):
        p.tick()
        if p.manager.last_frame_drawn == target:
            break
    assert p.manager.last_frame_drawn == target
    np.testing.assert_array_equal(
        p.manager.buffers[p.manager._last_filled_buffer], frames_px[target])
    assert len(calls) <= 8, f"seek decoded {len(calls)} frames, not <=8"


def test_lane_sequential_playback_composes_each_window_once(monkeypatch):
    """Sequential playback through a CHAINED container (single keyframe,
    several carry windows whose last frame is a still) must compose each
    window exactly once — a window with a still tail used to never record
    its carry, forcing an O(chain^2) rebuild at every boundary."""
    import jsplayer_tpu.codecs.lane_host as lh

    # every 3rd frame unchanged => window tails (T=4) can end on stills
    avi, frames_px = make_sp_avi(nframes=16, keyevery=100)  # one keyframe
    cont = transcode_to_lane(avi, window=4, K=2)
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    c = container_from_bytes(cont)
    assert [w.restart for w in c.windows] == [True, False, False, False]

    calls = []
    orig_open = lh.LaneHostCodec._open

    def counted_open(self, wi, carry, *a, **kw):
        calls.append(wi)
        return orig_open(self, wi, carry, *a, **kw)

    rebuilds = []
    orig_carry = lh.window_carry

    def counted_carry(w, X, Y, prev=None):
        rebuilds.append(w)
        return orig_carry(w, X, Y, prev)

    # count window WALKS (backend-agnostic: _open covers both the numpy
    # generator and the native compose) and cold carry rebuilds
    monkeypatch.setattr(lh.LaneHostCodec, "_open", counted_open)
    monkeypatch.setattr(lh, "window_carry", counted_carry)
    p = Player(PlayerConfig())
    p.load(MemorySource(cont))
    assert drive_until_shown(p)
    fake_t = [0.0]
    p._clock = lambda: fake_t[0]
    p.play()
    fps = p.manager.fps
    for t in range(16):
        fake_t[0] = t / fps + 0.001
        for _ in range(200):
            if p.tick() == FrameResult.DECOMPRESSED:
                break
            if not p.playing:
                p.play()
    assert p.manager.last_frame_drawn >= 14
    # 4 windows, each walked exactly once, and no cold carry rebuild —
    # a window with a still tail used to never record its carry, forcing
    # an O(chain^2) window_carry rebuild at every boundary
    assert len(calls) == 4, f"composed {len(calls)} times for 4 windows"
    assert not rebuilds, f"{len(rebuilds)} cold carry rebuilds"


def test_lane_cold_seek_reuses_cached_exit_carries(monkeypatch):
    """A cold mid-chain seek rebuilds the carry chain from the restart
    window ONCE; every exit plane computed on the way is parked in the
    codec's LRU, so a repeat seek into the same region does zero
    window_carry work (the dense-corpus seek table's cold
    outlier — Main.hx:1220-1226's cost model).  Also pins correctness
    under forced eviction (budget of one plane)."""
    import jsplayer_tpu.codecs.lane_host as lh

    avi, _ = make_sp_avi(nframes=24, keyevery=100)  # one keyframe
    cont = transcode_to_lane(avi, window=4, K=2)
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    c = container_from_bytes(cont)
    assert sum(w.restart for w in c.windows) == 1 and len(c.windows) == 6

    oracle = list(lh.iter_frames(c))
    rebuilds = []
    orig_carry = lh.window_carry

    def counted_carry(w, X, Y, prev=None):
        rebuilds.append(w)
        return orig_carry(w, X, Y, prev)

    monkeypatch.setattr(lh, "window_carry", counted_carry)
    codec = lh.LaneHostCodec(c)

    def frame(t):
        out = np.empty(c.Y * c.X, np.uint32)
        codec.decompress_i(lh.LaneHostCodec.frame_chunk(t), out)
        return out.reshape(c.Y, c.X)

    far = 21  # window 5: cold entry walks windows 0-4 for their carries
    np.testing.assert_array_equal(frame(far), oracle[far])
    assert len(rebuilds) == 5, f"first cold seek: {len(rebuilds)} rebuilds"
    np.testing.assert_array_equal(frame(2), oracle[2])  # hop to window 0
    np.testing.assert_array_equal(frame(far), oracle[far])
    assert len(rebuilds) == 5, "repeat seek rebuilt despite cached carries"
    np.testing.assert_array_equal(frame(13), oracle[13])  # window 3 via cache[2]
    assert len(rebuilds) == 5, "mid-chain seek rebuilt despite cached carries"

    # forced eviction: budget of ~one plane; correctness must hold
    codec2 = lh.LaneHostCodec(c)
    codec2.CARRY_CACHE_BYTES = c.Y * c.X * 4

    def frame2(t):
        out = np.empty(c.Y * c.X, np.uint32)
        codec2.decompress_i(lh.LaneHostCodec.frame_chunk(t), out)
        return out.reshape(c.Y, c.X)

    for t in (21, 2, 17, 9, 23, 0):
        np.testing.assert_array_equal(frame2(t), oracle[t])
    assert len(codec2._carry_cache) <= 1


def test_lane_backward_seek_resumes_from_intra_window_checkpoint(monkeypatch):
    """Inside a LONG window (keyframe-snapped dense windows run to
    KEYEVERY frames), the forward walk snapshots the plane every
    CKPT_STRIDE frames; a later backward seek resumes from the nearest
    checkpoint instead of replaying from the window head — bounding the
    dense-corpus repeat-seek cost to <stride paints."""
    import pytest

    import jsplayer_tpu.codecs.lane_host as lh
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    avi, _ = make_sp_avi(nframes=24, keyevery=100)  # one keyframe
    cont = transcode_to_lane(avi, window=24, K=2)   # one 24-frame window
    c = container_from_bytes(cont)
    assert [w.T for w in c.windows] == [24]

    oracle = list(lh.iter_frames(c))
    codec = lh.LaneHostCodec(c)
    if not codec._use_native:
        pytest.skip("native lane compose not built")

    composed = []
    orig = lh.native_compose_range

    def counted(w, X, Y, plane, pool, a, b):
        composed.append(b - a)
        return orig(w, X, Y, plane, pool, a, b)

    monkeypatch.setattr(lh, "native_compose_range", counted)

    def frame(t):
        out = np.empty(c.Y * c.X, np.uint32)
        codec.decompress_i(lh.LaneHostCodec.frame_chunk(t), out)
        return out.reshape(c.Y, c.X)

    np.testing.assert_array_equal(frame(23), oracle[23])  # walk 0..23
    assert (0, 15) in codec._carry_cache  # stride snapshot parked
    composed.clear()
    np.testing.assert_array_equal(frame(17), oracle[17])
    # backward seek past the checkpoint: resume at 15, compose 16..17
    assert sum(composed) == 2, f"composed {sum(composed)} frames, not 2"
    composed.clear()
    np.testing.assert_array_equal(frame(3), oracle[3])
    # before any checkpoint: replay from the entry carry (frames 0..3)
    assert sum(composed) == 4, f"composed {sum(composed)} frames, not 4"


def test_lane_forward_seek_resumes_from_checkpoint(monkeypatch):
    """A FORWARD seek that jumps past a parked checkpoint resumes from it
    instead of composing every intermediate frame (scrub-back-then-
    forward pattern; sequential playback — lt advancing by 1 — must NOT
    churn plane copies, so a resume requires skipping >1 frame)."""
    import pytest

    import jsplayer_tpu.codecs.lane_host as lh
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    avi, _ = make_sp_avi(nframes=24, keyevery=100)
    cont = transcode_to_lane(avi, window=24, K=2)
    c = container_from_bytes(cont)
    oracle = list(lh.iter_frames(c))
    codec = lh.LaneHostCodec(c)
    if not codec._use_native:
        pytest.skip("native lane compose not built")

    composed = []
    orig = lh.native_compose_range

    def counted(w, X, Y, plane, pool, a, b):
        composed.append(b - a)
        return orig(w, X, Y, plane, pool, a, b)

    monkeypatch.setattr(lh, "native_compose_range", counted)

    def frame(t):
        out = np.empty(c.Y * c.X, np.uint32)
        codec.decompress_i(lh.LaneHostCodec.frame_chunk(t), out)
        return out.reshape(c.Y, c.X)

    frame(23)  # walk 0..23, checkpoint parked at 15
    frame(3)   # scrub back (replay 0..3)
    composed.clear()
    np.testing.assert_array_equal(frame(22), oracle[22])
    # forward from lt=3 with checkpoint at 15: compose 16..22, not 4..22
    assert sum(composed) == 7, f"composed {sum(composed)} frames, not 7"
    composed.clear()
    np.testing.assert_array_equal(frame(4), oracle[4])   # replay 0..4
    np.testing.assert_array_equal(frame(5), oracle[5])   # sequential +1
    # sequential advance never takes a checkpoint resume (5 composes)
    assert composed == [5, 1], f"composed legs {composed}"


def test_lane_checkpoint_hit_skips_chain_carry_rebuild(monkeypatch):
    """Entering a CHAINED window at a checkpoint defers the entry-carry
    chain rebuild entirely (lazy); the rebuild is paid only if a later
    scrub lands below every checkpoint — and then it reuses cached chain
    exits, so window_carry never reruns."""
    import pytest

    import jsplayer_tpu.codecs.lane_host as lh
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    avi, _ = make_sp_avi(nframes=48, keyevery=100)  # one keyframe
    cont = transcode_to_lane(avi, window=24, K=2)
    c = container_from_bytes(cont)
    assert [w.restart for w in c.windows] == [True, False]
    oracle = list(lh.iter_frames(c))
    codec = lh.LaneHostCodec(c)
    if not codec._use_native:
        pytest.skip("native lane compose not built")

    rebuilds = []
    orig_carry = lh.window_carry

    def counted_carry(w, X, Y, prev=None):
        rebuilds.append(w)
        return orig_carry(w, X, Y, prev)

    monkeypatch.setattr(lh, "window_carry", counted_carry)

    def frame(t):
        out = np.empty(c.Y * c.X, np.uint32)
        codec.decompress_i(lh.LaneHostCodec.frame_chunk(t), out)
        return out.reshape(c.Y, c.X)

    np.testing.assert_array_equal(frame(47), oracle[47])  # cold: 1 rebuild
    assert len(rebuilds) == 1
    np.testing.assert_array_equal(frame(5), oracle[5])    # hop to window 0
    # re-enter window 1 at its checkpoint: NO carry rebuild (lazy entry)
    np.testing.assert_array_equal(frame(43), oracle[43])
    assert len(rebuilds) == 1, "checkpoint entry still rebuilt the chain"
    # scrub below every checkpoint of window 1: lazy carry resolves from
    # the CACHED chain exit — window_carry still never reruns
    np.testing.assert_array_equal(frame(25), oracle[25])
    assert len(rebuilds) == 1, "lazy carry resolution reran window_carry"


def test_lane_native_hostile_inverted_rect_matches_numpy():
    """Parser-valid mutated containers can carry an INVERTED block rect
    (x1 > x2 — byte validation only bounds each coord to <=16).  The
    numpy walk paints an empty slice; the native compose must clamp the
    width to zero instead of striding its motion-scratch pointer out of
    bounds (fuzz-reachable UB, found by review)."""
    import pytest

    import jsplayer_tpu.codecs.lane_host as lh
    from jsplayer_tpu import native as _nat
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    if not _nat.lane_compose_available():
        pytest.skip("native lane compose not built")

    avi, _ = make_sp_avi(nframes=6, keyevery=100)
    cont = transcode_to_lane(avi, window=6, K=2)
    c = container_from_bytes(cont)
    w = c.windows[0]
    t = next(i for i in range(1, w.T) if w.changed[i])
    # block 0 becomes a motion block with an inverted rect + a real shift
    w.btype[t, 0] = 2
    w.rect[t, 0] = (12, 3, 4, 9)   # x1 > x2
    w.mvk[t, 0] = (5, 7)
    a, b = lh.LaneHostCodec(c), lh.LaneHostCodec(c)
    b._use_native = False
    assert a._use_native
    for tt in range(w.T):
        ch = lh.LaneHostCodec.frame_chunk(tt)
        fa, fb = a._frame(*a._locate(ch)), b._frame(*b._locate(ch))
        np.testing.assert_array_equal(fa, fb, err_msg=f"frame {tt}")


def test_lane_codec_bounds_warm_window_memos():
    """An interactive scrub across many windows must not keep every
    visited window's inflated-unit memos resident (~44 MB/window on
    dense 1080p): the codec retains at most WARM_WINDOWS windows' decode
    arrays, evicting least-recently-opened (review-found unbounded
    growth).  Frames stay bit-exact across eviction and re-entry."""
    import jsplayer_tpu.codecs.lane_host as lh
    from jsplayer_tpu.codecs.lane_format import container_from_bytes

    avi, _ = make_sp_avi(nframes=32, keyevery=4)
    cont = transcode_to_lane(avi, window=4, K=2)
    c = container_from_bytes(cont)
    assert len(c.windows) == 8
    oracle = list(lh.iter_frames(c))
    # the one-shot batch walk above must leave nothing warm either
    assert not any(hasattr(w, "_units_cache") for w in c.windows)
    codec = lh.LaneHostCodec(c)

    def frame(t):
        out = np.empty(c.Y * c.X, np.uint32)
        codec.decompress_i(lh.LaneHostCodec.frame_chunk(t), out)
        return out.reshape(c.Y, c.X)

    for t in (2, 6, 10, 14, 18, 22, 26, 30, 5, 29, 13):  # scrub all 8
        np.testing.assert_array_equal(frame(t), oracle[t])
        warm = sum(hasattr(w, "_units_cache")
                   or hasattr(w, "_native_arrays_cache")
                   for w in c.windows)
        assert warm <= codec.WARM_WINDOWS, (t, warm)
