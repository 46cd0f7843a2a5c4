"""End-to-end batched video ingestion: AVI sources → model-input tensors.

The flagship serving API (BASELINE.json config 5): N AVI streams are
demuxed on host, entropy-decoded straight into the kmv device transport
(native thread pool; dense paycode plane for co-located hosts or the
ragged sparse tile transport for link-fed serving), and reconstructed on
device in windows — optionally fused into normalized model tensors
(emit_frames=False), with still-elision (still_elision=True) and
multi-chip stream sharding (mesh=...).  Decoded pixels never round-trip
to host.  Failures quarantine per stream (frozen at the last good frame).

GOP alignment: windows start at keyframes (the only independent decode
points, DataLoader.GetNearestKeyframe ≙ core/loader.py); short windows pad
with empty frames, which both codecs define as "no change"
(ScreenPressor.hx:308-309, MSVideo1.hx:109) — the device scan then carries
the last frame forward, mirroring the reference's identical-frame buffer
ranges (Manager.hx:568-578).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.loader import DataLoaderAVISeq
from ..core.source import ByteSource
from ..core.types import CodecType, VideoInfo
from ..kernels import msv1_paint, sp_recon
from ..codecs.msvideo1 import palette_to_u32, parse_commands
from ..kernels.rgb_convert import to_model_input

#: IngestConfig.sp_device_path values (see the comment on that field)
SP_DEVICE_PATHS = ("kmv", "bc", "kmv_sparse", "lane", "general")

# Process-wide host-buffer pool: window buffers are hundreds of MB and
# faulting in fresh pages on every new pipeline can cost more than the
# decode itself.  Buffers are checked out exclusively (popped) while a
# pipeline iterates and returned when its iterator finishes.
_BUFFER_POOL: dict = {}


def _pool_acquire(key, builder):
    buf = _BUFFER_POOL.pop(key, None)
    return buf if buf is not None else builder()


def _pool_release(key, buf):
    if buf is not None:
        _BUFFER_POOL[key] = buf


def _put(a):
    """Host→device upload: jax.device_put of a contiguous array (jnp.array
    would detour through a host-side conversion first)."""
    return jax.device_put(np.ascontiguousarray(a))


def _trim_window(out: dict, n: int) -> dict:
    """Trim a window dict's per-timeline-slot arrays to its true length
    (keyframe-snapped windows are shorter than cfg.window; the chunk's
    no-change padding must not be emitted — the next window owns those
    timeline positions).  Flat elided stacks stay whole: the trimmed
    outmap governs which rows are read."""
    if out.get("significant") is not None:
        out["significant"] = out["significant"][:, :n]
    om = out.get("outmap")
    if om is not None:
        # [B, T] batched elision; [T] single-stream elision (frames are a
        # compacted stack there — outmap alone governs timeline access)
        out["outmap"] = om[:, :n] if om.ndim == 2 else om[:n]
    else:  # dense emission: [B, T, ...] per-timeline arrays
        for k in ("frames_u32", "model_input"):
            if out.get(k) is not None and out[k].ndim >= 3:
                out[k] = out[k][:, :n]
    return out


def _pow2ceil(n: int) -> int:
    """Smallest power of two >= max(n, 1) — the jit-key bucketing unit."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _oracle_decode_step(dec, src: bytes, isk: bool, X: int, Y: int):
    """One pure-Python host-stage decode step (shared by the dense, sparse,
    and bc fallback paths so their guard/capture contract can't drift):
    run the oracle with command capture → (significant, capture dict).
    Raises like the oracle does on corrupt streams — call through
    VideoIngestPipeline._guard."""
    cap: dict = {}
    dec.capture = cap
    dst = np.zeros(X * Y, dtype=np.uint32)
    if isk:
        dec.decompress_i(src, dst)
        s = True
    else:
        res = dec.decompress_p(src, dst)
        s = bool(res.significant_changes)
    return s, cap


def _window_barrier(*arrays):
    """Wait for a window's outputs before its pooled host buffers are
    rewritten.  jax.device_put may return before it has read the host
    array, on every backend: the CPU client reads it lazily until the
    consuming computation runs (without this barrier the next window's
    fill showed up as FUTURE frames), and on the GPU the copy from host
    memory is still in flight when the put returns (chip_smoke.py Phase D
    overwrites a buffer right after its put and sees the device copy
    change).  Waiting for the computations that consumed the window's
    transfers covers both."""
    jax.block_until_ready(arrays)


@dataclass
class IngestConfig:
    window: int = 16  # frames per emitted window (device scan length)
    emit_model_input: bool = True
    # False → kmv windows emit ONLY model tensors (fused into the decode
    # scan; the full-res frame stack is never written, saving its HBM write
    # + re-read).  frames_u32 is then absent from the yielded dict.
    emit_frames: bool = True
    model_dtype: str = "bfloat16"
    model_downscale: int = 1  # power-of-two box downsample in the epilogue
    # downscale==2 only: emit the PACKED ds2 plane ([.., H/2, W/2] i32 of
    # r/g/b 10-bit field sums, rgb_convert.ds2_pack) instead of unpacked
    # NHWC tensors; consumers fuse rgb_convert.unpack_ds2 into their
    # first model op (rgb_convert.packed_consumer_step).  Its value is
    # the ~1.5x smaller intermediate (i32 plane vs bf16 NHWC); it stays
    # opt-in.
    model_packed: bool = False
    insignificant_lines: int = 0
    # SP device compose (SP_DEVICE_PATHS; anything else is a ValueError):
    #   "kmv"        dense paycode plane (K-distinct-mv roll + selects, no
    #                gather) — for co-located hosts;
    #   "bc"         block-command transport: per-block types/rects + a
    #                pixel-only plane (motion/copy blocks cost the host
    #                nothing to fill; same device traffic,
    #                sp_recon.compose_frame_bc);
    #   "kmv_sparse" block codes + payload tiles (tens of KB per typical
    #                frame vs 8.3 MB dense) — for PCIe/network-fed serving
    #                where the host->device link dominates;
    #   "lane"       lane-container sources (transcode.transcode_to_lane):
    #                payload entropy is decoded ON DEVICE by the multi-lane
    #                rANS and fused into the recon scan — after demux the
    #                host never touches entropy (BASELINE config 4 e2e;
    #                codecs/lane_format + kernels/lane_recon).  Sources
    #                must be lane containers, not AVIs;
    #   "general"    arbitrary-gather XLA compose (any command mix).
    sp_device_path: str = "kmv"
    kmv_k: int = 2
    # kmv_sparse only: entropy-code the tile payload with multi-lane rANS
    # and decode it ON DEVICE (kernels/lane_transport, packed layout) — the
    # link carries ~compressed-size tiles instead of raw 1 KB rows.
    sparse_lane_payload: bool = False
    # True (kmv paths): unchanged frames never enter the device scan.  The
    # yielded dict gains "outmap" mapping original frame t to a row of the decoded
    # stack (stills alias their predecessor; -1 = the window's carry-in
    # frame).  Single stream without a mesh: frames_u32 is [1, C, Y, X]
    # and outmap is [T] (the round-1 contract).  Batched (B>1) or sharded
    # (mesh set): frames_u32/model_input is a FLAT row stack and outmap is
    # [B, T] indexing its first axis — fed by either the zero-padding
    # concat scan (keyframe-led windows) or the bucketed per-stream scans
    # flattened with offsets (see _kmv_elided).
    still_elision: bool = False
    # Multi-chip: a jax.sharding.Mesh with a "dp" axis shards the stream
    # batch across devices through the shard_map kmv step (pipeline/batch);
    # B must be divisible by the dp size.  None = single-device unrolled.
    mesh: object = None
    # Long-stream mode (SURVEY.md §5.7): demux windows on demand and EVICT
    # consumed compressed bytes, keeping host residency O(window) instead
    # of whole-file.  Window count is then discovered at EOF.
    streaming: bool = False
    # Clip decode [t0, t1): windows start at the nearest keyframe ≤ t0 (the
    # reference's seek unit, Manager.hx:244-249 / GetNearestKeyframe) and
    # stop once t1 is covered.  Leading warm-up frames (keyframe..t0) ride
    # in the first window's output — start_frame tells the consumer where
    # it is.  Every stream must share a keyframe at the chosen start
    # (asserted); not supported with streaming=True (no random access in
    # the forward-only reader).
    frame_range: Optional[tuple] = None


class StreamReader:
    """Demux one AVI source into frame bytes (host).

    Default mode demuxes the whole file up front (simple, right for short
    clips).  ``streaming=True`` is the long-stream mode (SURVEY.md §5.7):
    the demuxer is pumped only as far as the pipeline's current window,
    and consumed compressed bytes are EVICTED — frame slots are nulled and
    both chunk buffers drop everything below their readers' positions
    (the batch analogue of the reference's 50 MB window + clear_memory,
    DataLoaderAVIIndexed.hx:41, :656-673) — so residency stays
    O(window), independent of stream length."""

    def __init__(self, source: ByteSource, streaming: bool = False):
        self.loader = DataLoaderAVISeq()
        self.loader.open(source)
        self.streaming = streaming
        self.eof = False
        self._released = 0
        if streaming:
            # pump only until the header yields the geometry
            while self.loader.video_info is None:
                if not self.loader.pump():
                    self.eof = True
                    break
            if self.loader.video_info is None:
                raise ValueError(
                    "no video header found (file truncated before avih/strf?)")
            self.info: VideoInfo = self.loader.video_info
            self.frames = _StreamingFrames(self)
            self.audio_track = self.loader.audio_track
            return
        self.loader.pump_all()
        self.eof = True
        # drain the MP3 side (the Player drives this from its worker tick,
        # Manager.hx:478-481; batch ingest drains it once up front)
        for _ in range(100000):
            before = self.loader.mp3_parser.frames_processed
            self.loader.parse_sound()
            if self.loader.mp3_parser.frames_processed == before:
                break
        self.loader.mp3_parser.on_data_end()
        self.loader.parse_sound()
        if self.loader.video_info is None:
            raise ValueError(
                "no video header found (file truncated before avih/strf?)")
        self.info: VideoInfo = self.loader.video_info
        self.frames: list[bytes] = [
            (f.data if f is not None and f.data is not None else b"")
            for f in self.loader.frames
        ]
        # MP3 audio rides along: sections with PTS + raw bytes, ready for a
        # downstream audio model or A/V alignment (AudioTrack parity)
        self.audio_track = self.loader.audio_track

    # -- streaming mode ------------------------------------------------------

    def fetch_upto(self, hi: int) -> None:
        """Pump the demuxer until frame `hi` (exclusive) is parsed or EOF;
        the MP3 scanner rides along so audio sections keep materializing.
        Progress is the PARSE watermark (loaded_frames_end): the loader
        pre-sizes the frames list from the avih header, so len(frames) says
        nothing about how far demux has actually gotten."""
        while not self.eof and self.loader.loaded_frames_end() < hi:
            if not self.loader.pump():
                self.eof = True
            self.loader.parse_sound()
        if self.eof and not self.loader.mp3_parser.parsing_complete:
            self.loader.parse_sound()

    def available(self) -> int:
        return self.loader.loaded_frames_end()

    def window_bytes(self, lo: int, hi: int) -> list[bytes]:
        self.fetch_upto(hi)
        assert lo >= self._released, "window re-read after eviction"
        out = []
        for i in range(lo, hi):
            f = (self.loader.frames[i]
                 if i < len(self.loader.frames) else None)
            out.append(f.data if f is not None and f.data is not None
                       else b"")
        return out

    def release_upto(self, lo: int) -> None:
        """Evict everything below frame `lo`: null the frame slots and drop
        chunk-buffer bytes below the demuxer's / MP3 scanner's read floors."""
        ld = self.loader
        for i in range(self._released, min(lo, len(ld.frames))):
            if ld.frames[i] is not None:
                ld.frames[i].data = None
        self._released = max(self._released, lo)
        if ld.demuxer is not None:
            ld.buffer.drop_before(ld.demuxer._pos)
        mp = ld.mp3_parser
        floor = mp.position
        for lst in (mp.frames, mp.long_frames):
            if lst:
                floor = min(floor, lst[0][0])
        ld.sound_buffer.drop_before(floor)

    def resident_bytes(self) -> int:
        """Compressed bytes currently held (observability for the window)."""
        ld = self.loader
        frames_b = sum(
            len(f.data) for f in ld.frames
            if f is not None and f.data is not None)
        return (ld.buffer.bytes_available(getattr(ld.buffer, "_base", 0))
                + ld.sound_buffer.bytes_available(
                    getattr(ld.sound_buffer, "_base", 0)) + frames_b)


class _StreamingFrames:
    """Minimal sequence facade over a streaming reader (len = frames parsed
    so far) — keeps non-streaming call sites (`len(r.frames)`) working."""

    def __init__(self, reader: StreamReader):
        self._r = reader

    def __len__(self) -> int:
        return self._r.loader.loaded_frames_end()


class VideoIngestPipeline:
    """Iterate model-tensor windows over a batch of same-geometry streams."""

    def __init__(self, sources: Sequence[ByteSource],
                 config: Optional[IngestConfig] = None):
        self.cfg = config or IngestConfig()
        if self.cfg.sp_device_path not in SP_DEVICE_PATHS:
            raise ValueError(
                f"unknown sp_device_path {self.cfg.sp_device_path!r}; "
                f"expected one of {SP_DEVICE_PATHS}")
        # auto-detect lane-container sources (4-byte magic) so CLI render/
        # ingest work on .jlv files without an explicit --path lane
        if self.cfg.sp_device_path != "lane" and sources:
            from ..codecs import lane_format

            try:
                heads = [lane_format.is_lane_container(s.read_range(0, 4))
                         for s in sources]
            except Exception:
                heads = [False]
            if all(heads):
                self.cfg = replace(self.cfg, sp_device_path="lane")
            elif any(heads):
                raise ValueError(
                    "batch mixes lane containers and AVIs — transcode or "
                    "split the batch")
        if self.cfg.sp_device_path == "lane":
            self._init_lane(sources)
            return
        self.readers = [StreamReader(s, streaming=self.cfg.streaming)
                        for s in sources]
        info0 = self.readers[0].info
        for r in self.readers:
            assert (r.info.width, r.info.height, r.info.codec) == (
                info0.width, info0.height, info0.codec
            ), "streams in a batch must share geometry and codec"
        self.info = info0
        # streaming mode: a lower bound that grows as windows demux
        self.nframes = max(len(r.frames) for r in self.readers)
        # 16bpp ScreenPressor decodes to 5-bit channels in the byte slots
        # (scaled <<3 for display/model, Manager.hx:363-370); MSV1 16-bit
        # already resolves to 8-bit channels at parse (fromRGB15)
        self._bpp16 = (info0.bpp == 16
                       and info0.codec == CodecType.SCREENPRESSOR)
        # channel order: BOTH codecs pack displayed-RED in the u32 high
        # byte (reference canvas swizzle, Manager.hx:377-380; the SP
        # decode-loop variable names are misleading) — to_model_input
        # extracts true RGB directly, no per-codec flip
        #: per-stream AudioTrack (MP3 sections, PTS, time_loaded watermark)
        self.audio_tracks = [r.audio_track for r in self.readers]
        self._pcm_cache = None
        # per-stream failure quarantine (SURVEY.md §5.3: a malformed frame
        # freezes that stream at its last good frame for the rest of the
        # run; other batch slots continue — DataLoaderAVIIndexed's
        # keyframe-restart model collapsed to freeze-at-error for batch
        # serving).  Indexed by reader position.
        self.quarantined: set[int] = set()
        self.quarantine_errors: list[tuple[int, str]] = []
        #: per-run observability: which elision layout each window used
        #: (CONCAT = keyframe-led single scan; PADDED = mid-GOP fallback
        #: of B masked scans — keyframe-aligned scheduling keeps windows on
        #: CONCAT when the stream's keyframe cadence allows)
        self.stats = {"concat_windows": 0, "padded_windows": 0}

    def _window_starts(self) -> list[int]:
        if self.cfg.frame_range is not None:
            assert not self.cfg.streaming, \
                "frame_range needs random access (streaming=False)"
            t0, t1 = self.cfg.frame_range
            t0 = max(0, min(int(t0), self.nframes))
            t1 = max(t0, min(int(t1), self.nframes))
            k0 = self._range_keyframe(t0)
            return list(range(k0, t1, self.cfg.window))
        starts = list(range(0, self.nframes, self.cfg.window))
        if (self.cfg.still_elision and not self.cfg.streaming
                and self._gop_group == 1
                and self.info.codec == CodecType.SCREENPRESSOR):
            # Keyframe-aligned scheduling: a window
            # that starts mid-GOP falls off the CONCAT elision layout onto
            # the padded scans, so snap each boundary DOWN to
            # the latest keyframe within reach (the reference's seek logic
            # already thinks in keyframe units, Manager.hx:244-249).
            # Windows shorten (≤ cfg.window); chunks pad with no-change
            # frames and the emitted slot arrays are trimmed to the true
            # length, so the timeline tiles exactly.
            keys = self._keyframe_positions()
            if len(keys) > 1:  # >1 keyframe: alignment has something to do
                from .gop import snap_window_starts

                starts = snap_window_starts(keys, self.nframes,
                                            self.cfg.window)
        return starts

    def _keyframe_positions(self) -> list[int]:
        """Keyframe indices shared by EVERY stream in the batch (probed
        from frame bytes like _range_keyframe; alignment must hold for all
        streams or the concat invariant breaks for the others)."""
        vi = self.info
        from ..codecs.screenpressor import ScreenPressor

        prober = ScreenPressor(vi.width, vi.height, vi.bpp)
        keys = None
        for r in self.readers:
            ks = {t for t, f in enumerate(r.frames)
                  if f and prober.is_key_frame(f)}
            keys = ks if keys is None else (keys & ks)
        return sorted(keys or ())

    def _range_keyframe(self, t0: int) -> int:
        """Nearest common keyframe ≤ t0 across the batch (the seek reset
        point, DataLoader.GetNearestKeyframe ≙ Manager.hx:244-249).
        Probed from the frame BYTES (decoder IsKeyFrame, the seq loader's
        no-index path, DataLoaderAVISeq.hx:32-49) — ingest demux does not
        populate index key flags."""
        vi = self.info
        if vi.codec == CodecType.SCREENPRESSOR:
            from ..codecs.screenpressor import ScreenPressor

            prober = ScreenPressor(vi.width, vi.height, vi.bpp)
        elif vi.codec == CodecType.MSVC8:
            from ..codecs.msvideo1 import MSVideo1_8bit

            prober = MSVideo1_8bit(vi.width, vi.height, vi.palette or b"")
        else:
            from ..codecs.msvideo1 import MSVideo1_16bit

            prober = MSVideo1_16bit(vi.width, vi.height)

        def nearest(frames, n):
            n = min(n, len(frames) - 1)
            while n > 0 and not (frames[n]
                                 and prober.is_key_frame(frames[n])):
                n -= 1
            return n

        k0 = nearest(self.readers[0].frames, t0)
        for b, r in enumerate(self.readers[1:], 1):
            kb = nearest(r.frames, t0)
            assert kb == k0, (
                f"frame_range needs a shared keyframe at the window start: "
                f"stream 0 rewinds to {k0}, stream {b} to {kb} — align the "
                f"batch's keyframe cadence or decode streams separately")
        return k0

    def audio_pcm(self):
        """Per-stream time-aligned PCM tensors (or None where the stream has
        no audio) — the decoded counterpart of :attr:`audio_tracks`, so A/V
        consumers get ``[n_samples, ch]`` float32 next to the video model
        tensors (SURVEY.md §7 step 9; the reference's WebAudio decode,
        AudioTrack.hx:54-65, delegated here to the system codec backend).
        Decoded once and cached; requires av.pcm.available()."""
        if self._pcm_cache is None:
            from ..av import pcm as _pcm
            self._pcm_cache = _pcm.decode_tracks(self.audio_tracks)
        return self._pcm_cache

    # -- lane containers -------------------------------------------------------

    def _init_lane(self, sources) -> None:
        """Lane-container batch: parse headers, check shared geometry."""
        from ..codecs import lane_format

        if self.cfg.streaming:
            # containers are meta-deflated and small (bench 79 KB, terminal
            # 490 KB); whole-blob load IS the residency model — reject the
            # flag instead of silently ignoring it
            raise ValueError("sp_device_path='lane' loads whole containers; "
                             "streaming=True is the long-AVI mode")
        self.containers = []
        for s in sources:
            data = s.read_range(0)
            if not lane_format.is_lane_container(data):
                raise ValueError(
                    "sp_device_path='lane' needs lane-container sources "
                    "(transcode.transcode_to_lane), not AVIs")
            self.containers.append(lane_format.container_from_bytes(data))
        c0 = self.containers[0]
        for c in self.containers:
            assert (c.X, c.Y, c.K, c.n_lanes, c.window) == (
                c0.X, c0.Y, c0.K, c0.n_lanes, c0.window), \
                "lane batch must share geometry, K, lanes, and window size"
        self.info = VideoInfo(width=c0.X, height=c0.Y, bpp=c0.bpp,
                              fps=c0.fps, nframes=c0.n_frames,
                              codec=CodecType.SCREENPRESSOR)
        self.nframes = max(c.n_frames for c in self.containers)
        self._bpp16 = c0.bpp == 16
        # MP3 audio passthrough: rebuild AudioTracks from the containers'
        # raw sound streams (the same Mp3Parser → sections → AudioTrack
        # wiring the AVI loader uses), so lane consumers keep audio_pcm()
        self.audio_tracks = [self._lane_audio(c) for c in self.containers]
        self._pcm_cache = None
        self.quarantined = set()
        self.quarantine_errors = []

    @staticmethod
    def _lane_audio(container):
        if not container.audio:
            return None
        from ..av.audio_track import AudioTrack
        from ..av.mp3 import Mp3Parser
        from ..core.chunkbuffer import ChunkBuffer

        track = AudioTrack()
        buf = ChunkBuffer()
        parser = Mp3Parser(
            buf, lambda start, data, last: track.add_section(
                parser.sections[-1]))
        buf.add_chunk(container.audio)
        parser.parse()
        parser.on_data_end()
        parser.parse()
        return track

    def _iter_lane(self) -> Iterator[dict]:
        """Device-entropy ingest: per window GROUP, pad streams to shared
        buckets and run the fused lane program per stream window
        (kernels/lane_recon), sharded over the mesh when configured.
        The host's only per-frame work is array slicing.

        GOP axis: when the mesh has a gop axis (>1), up to `gop` CONSECUTIVE
        windows join one device dispatch — valid because every non-leading
        window in a group is RESTART (frame 0 fully paints the plane, so
        its decode is carry-independent; lane_format.LaneWindow.restart).
        Entries are laid out stream-major ([B, G] flattened), so the group
        emits as ONE dict covering G*T frames via a free reshape — the
        same consumer contract (start_frame + flat outmap), just a bigger
        window.  This is the time-axis sharding of SURVEY §2's GOP row for
        the lane path; round 3's was dp-only."""
        from ..codecs.lane_format import plane_cols
        from ..kernels import lane_recon, rans_lanes as _rl

        c0 = self.containers[0]
        B = len(self.containers)
        Y, X, K, N = c0.Y, c0.X, c0.K, c0.n_lanes
        ncol = plane_cols(X) // 128
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        Tw = c0.window
        n_windows = max(len(c.windows) for c in self.containers)
        mesh = self.cfg.mesh
        raw_mode = any(w.raw_mode for c in self.containers for w in c.windows)
        if raw_mode and not all(w.raw_mode for c in self.containers
                                for w in c.windows):
            raise ValueError("lane batch mixes raw and rans payload windows")
        # window lengths may vary (the transcoder snaps boundaries to
        # keyframes); all streams in a batch must share boundaries so the
        # [B, T] batching keeps one timeline
        Ts: list[int] = []
        for wj in range(n_windows):
            tlen = None
            for c in self.containers:
                if wj < len(c.windows):
                    if tlen is None:
                        tlen = c.windows[wj].T
                    elif c.windows[wj].T != tlen:
                        raise ValueError(
                            "lane batch streams have mismatched window "
                            f"boundaries at window {wj}")
            Ts.append(Tw if tlen is None else tlen)
        bases = np.concatenate([[0], np.cumsum(Ts)]).astype(int)
        wi0, wi_end = 0, n_windows
        if self.cfg.frame_range is not None:
            # clip decode: start at the latest RESTART window ≤ t0 (the
            # container's keyframe-restart unit — the seek semantics of
            # Manager.hx:244-249 at window granularity); leading warm-up
            # frames ride in the first window like the AVI path
            t0, t1 = self.cfg.frame_range
            tt0 = max(0, min(int(t0), self.nframes - 1))
            want = max(0, int(np.searchsorted(bases, tt0, side="right")) - 1)
            wi0 = 0
            for wi in range(want, -1, -1):
                if all(wi < len(c.windows) and c.windows[wi].restart
                       for c in self.containers):
                    wi0 = wi
                    break
            else:
                assert wi0 == 0
            tt1 = max(t0 + 1, int(t1))
            wi_end = min(n_windows,
                         int(np.searchsorted(bases, tt1, side="left")))
        gop_size = 1
        if mesh is not None and "gop" in mesh.axis_names:
            gop_size = int(mesh.shape["gop"])

        def all_restart(wi):
            return all(c.windows[wi].restart for c in self.containers
                       if wi < len(c.windows))

        carry = None
        pending = None
        wi = wi0
        while wi < wi_end:
            # greedy group: extend while the next window is carry-free
            G = 1
            while (G < gop_size and wi + G < wi_end
                   and all_restart(wi + G)):
                G += 1
            BG = B * G
            ts = Ts[wi : wi + G]          # true per-window lengths
            offs = np.concatenate([[0], np.cumsum(ts)]).astype(int)
            total_real = int(offs[-1])
            # batch pad within the group, bucketed to a power of two so
            # ragged (keyframe-snapped) window lengths don't mint one XLA
            # compile per distinct length (pad frames are changed=False
            # stills: the scan passes carry through and they are never
            # emitted — same invariant u_pad/ur_pad bucketing keeps)
            Tpad = _pow2ceil(max(ts))
            btype = np.zeros((BG, Tpad, nb), dtype=np.uint8)
            rect = np.zeros((BG, Tpad, nb, 4), dtype=np.uint8)
            mvk = np.zeros((BG, Tpad, K, 2), dtype=np.int32)
            row_idx = np.zeros((BG, Tpad, Y), dtype=np.int32)
            changed = np.zeros((BG, Tpad), dtype=bool)
            sig = np.zeros((B, total_real), dtype=bool)
            u_real = [0] * BG
            rtabs = [None] * BG
            wins = []
            for b, c in enumerate(self.containers):
                for g in range(G):
                    e = b * G + g
                    w = (c.windows[wi + g] if wi + g < len(c.windows)
                         else None)
                    wins.append(w)
                    if w is None:
                        continue
                    btype[e, : w.T] = w.btype
                    rect[e, : w.T] = w.rect
                    mvk[e, : w.T] = w.mvk
                    rt, ri = w.row_index(Y, ncol)
                    rtabs[e] = rt
                    row_idx[e, : w.T] = ri
                    changed[e, : w.T] = w.changed
                    sig[b, offs[g] : offs[g] + w.T] = w.signif
                    u_real[e] = w.n_units
            # shared buckets: U and Ur to powers of two (and steps to
            # cover 3*U*128 symbols in rans mode) — derived
            # deterministically so jit keys stay bounded; padded payload
            # decodes into unit rows nothing references, padded row-table
            # rows are all-zero tuples no frame's row_idx points at
            ur_pad = _pow2ceil(max((rt.shape[0] for rt in rtabs
                                    if rt is not None), default=1))
            row_table = np.zeros((BG, ur_pad, ncol), dtype=np.int32)
            for e, rt in enumerate(rtabs):
                if rt is not None:
                    row_table[e, : rt.shape[0]] = rt
            u_pad = _pow2ceil(max(u_real))
            if raw_mode:
                payload = np.zeros((BG, u_pad, 3, 128), dtype=np.uint8)
                for e, w in enumerate(wins):
                    if w is not None and w.n_units:
                        payload[e, : w.n_units] = w.payload
            else:
                need_steps = -(-3 * u_pad * 128 // N)
                steps = max(_pow2ceil(need_steps),
                            max((w.refills.shape[0] for w in wins
                                 if w is not None), default=1))
                refills = np.zeros((BG, steps, N, 2), dtype=np.uint8)
                states = np.zeros((BG, N), dtype=np.uint32)
                freq = np.ones((BG, 256), dtype=np.int32)
                freq[:, 0] += _rl.PROB_SCALE - 256  # valid for absent rows
                for e, w in enumerate(wins):
                    if w is None:
                        continue
                    refills[e, : w.refills.shape[0]] = w.refills
                    states[e] = w.states
                    freq[e] = w.freq
            if carry is None:
                carry = jnp.zeros((B, Y, X), dtype=jnp.uint32)
            # entry inits: every entry starts from its stream's carry
            # (restart entries ignore it — frame 0 fully paints; None
            # entries pass it through, preserving ragged-batch semantics)
            init_e = (carry if G == 1
                      else jnp.repeat(carry, G, axis=0))
            # rans mode: window-leading keyframes ride as raw init planes
            # (the scan's frame 0 is an all-copy passthrough) — override
            # those entries' inits on device, no host round-trip
            if any(w is not None and w.init_plane is not None for w in wins):
                init_np = np.zeros((BG, Y, X), dtype=np.uint32)
                mask = np.zeros(BG, dtype=bool)
                for e, w in enumerate(wins):
                    if w is not None and w.init_plane is not None:
                        init_np[e] = w.init_plane
                        mask[e] = True
                if mesh is not None:
                    from jax.sharding import NamedSharding, PartitionSpec as P

                    sh = NamedSharding(mesh, self._lane_spec(G))
                    init_e = jnp.where(
                        jax.device_put(mask, sh)[:, None, None],
                        jax.device_put(init_np, sh), init_e)
                else:
                    init_e = jnp.where(_put(mask)[:, None, None],
                                       _put(init_np), init_e)
            # still-elision: stills never enter the lane scan (the same
            # outmap contract as _kmv_elided — flat row stack; -1 = the
            # window's carry-in frame)
            outmap = None
            if self.cfg.still_elision:
                (btype, rect, mvk, row_idx), valid, outmap = \
                    sp_recon.compact_arrays_batch(
                        (btype, rect, mvk, row_idx), changed)
                cpad = btype.shape[1]
                changed = valid
                om = np.where(
                    outmap >= 0,
                    outmap + (np.arange(BG, dtype=np.int32) * cpad)[:, None],
                    -1).astype(np.int32)  # [BG, Tpad]
                # ragged windows: keep only each window's real frames
                outmap = np.stack([
                    np.concatenate([om[b * G + g, : ts[g]]
                                    for g in range(G)])
                    for b in range(B)])
            if changed.shape[1] == 0:  # all streams all-stills
                out = {"start_frame": int(bases[wi]),
                       "significant": jnp.array(sig),
                       "outmap": outmap,
                       "frames_u32": jnp.zeros((0, Y, X), jnp.uint32)}
                if pending is not None:
                    yield pending
                pending = out
                wi += G
                continue
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                spec = self._lane_spec(G)
                key = (u_pad, ur_pad, raw_mode or steps,
                       changed.shape[1], G)
                steps_cache = getattr(self, "_lane_steps", None)
                if steps_cache is None:
                    steps_cache = self._lane_steps = {}
                if key not in steps_cache:
                    axes = (("dp", "gop") if G > 1 else ("dp",))
                    steps_cache[key] = lane_recon.make_lane_decode_step(
                        mesh, u_pad, axes=axes, raw=raw_mode)
                put = lambda a: jax.device_put(
                    np.ascontiguousarray(a), NamedSharding(mesh, spec))
                init_dev = jax.device_put(init_e, NamedSharding(mesh, spec))
                if raw_mode:
                    frames = steps_cache[key](
                        init_dev, put(payload), put(btype), put(rect),
                        put(mvk), put(row_table), put(row_idx),
                        put(changed))
                else:
                    frames = steps_cache[key](
                        init_dev, put(refills), put(states), put(freq),
                        put(btype), put(rect), put(mvk), put(row_table),
                        put(row_idx), put(changed))
            elif raw_mode:
                frames = lane_recon.decode_batch_raw(
                    init_e, _put(payload), _put(btype), _put(rect),
                    _put(mvk), _put(row_table), _put(row_idx),
                    _put(changed))
            else:
                frames = lane_recon.decode_batch_lane(
                    init_e, _put(refills), _put(states), _put(freq),
                    _put(btype), _put(rect), _put(mvk), _put(row_table),
                    _put(row_idx), _put(changed), u_pad)
            # per-stream carry = the last entry's last frame (stream-major
            # layout; None tails pass the carry through unchanged)
            carry = (frames[:, -1] if G == 1
                     else frames[G - 1 :: G, -1])
            _window_barrier(frames)
            out = {"start_frame": int(bases[wi]),
                   "significant": jnp.array(sig)}
            if outmap is not None:
                out["outmap"] = outmap
                flat = frames.reshape((-1,) + frames.shape[2:])
                if self.cfg.emit_frames:
                    out["frames_u32"] = flat
                if self.cfg.emit_model_input:
                    out["model_input"] = self._model_tensors(flat)
            else:
                # [B*G, T, ...] → [B, G*T, ...]: stream-major layout makes
                # the group read as one window of G*T frames; ragged
                # (keyframe-snapped) windows keep only their real frames
                if total_real == G * Tpad:
                    frames = frames.reshape((B, G * Tpad) + frames.shape[2:])
                else:
                    frames = jnp.stack([
                        jnp.concatenate([frames[b * G + g, : ts[g]]
                                         for g in range(G)])
                        for b in range(B)])
                out["frames_u32"] = frames
                if self.cfg.emit_model_input:
                    out["model_input"] = self._model_tensors(frames)
            if pending is not None:
                yield pending
            pending = out
            wi += G
        if pending is not None:
            yield pending

    @staticmethod
    def _lane_spec(G: int):
        from jax.sharding import PartitionSpec as P

        return P(("dp", "gop")) if G > 1 else P("dp")

    def __iter__(self) -> Iterator[dict]:
        """Host→device pipeline parallelism (SURVEY.md §2 PP row): the device
        step for window t is dispatched asynchronously (jax dispatch), then
        the host stage for window t+1 runs while the device is busy; the
        consumer's read of window t's tensors is the synchronization point.
        The scan carry stays a device array — decoded pixels never round-trip
        to host between windows."""
        if self.cfg.sp_device_path == "lane":
            yield from self._iter_lane()
            return
        vi = self.info
        W = self.cfg.window
        pending = None
        try:
            if self.cfg.streaming:
                start = 0
                while True:
                    chunk = []
                    got_any = False
                    for r in self.readers:
                        frames = r.window_bytes(start, start + W)
                        got_any |= any(len(f) > 0 for f in frames) or \
                            r.available() > start
                        chunk.append(frames)
                    if not got_any:
                        break
                    if vi.codec == CodecType.SCREENPRESSOR:
                        out = self._decode_sp_window(chunk, start)
                    else:
                        out = self._decode_msv1_window(chunk, start)
                    for r in self.readers:
                        r.release_upto(start + W)  # O(window) residency
                    self.nframes = max(self.nframes,
                                       *(r.available() for r in self.readers))
                    if pending is not None:
                        yield pending
                    pending = out
                    start += W
                if pending is not None:
                    yield pending
                return
            G = self._gop_group
            from .. import native as _nat
            if (G > 1 and vi.codec == CodecType.SCREENPRESSOR
                    and self.cfg.sp_device_path in ("kmv", "bc")
                    and _nat.available()):
                # gop-axis grouping: G keyframe-led windows per sharded
                # [B, G, T] dispatch (sequence-parallel, SURVEY §2 SP row)
                starts_all = self._window_starts()
                for i in range(0, len(starts_all), G):
                    grp = starts_all[i : i + G]
                    chunks = []
                    for st in grp:
                        chunk = []
                        for r in self.readers:
                            frames = r.frames[st : st + W]
                            frames += [b""] * (W - len(frames))
                            chunk.append(frames)
                        chunks.append(chunk)
                    while len(chunks) < G:  # stream-end padding (discarded)
                        chunks.append([[b""] * W for _ in self.readers])
                    for out in self._decode_sp_window_group(chunks, grp):
                        yield out
                return
            starts = self._window_starts()
            for i, start in enumerate(starts):
                # keyframe-aligned windows may be shorter than W (snapped
                # boundaries, _window_starts): decode [start, end), pad the
                # chunk to W with no-change frames, trim the emission
                end = starts[i + 1] if i + 1 < len(starts) else start + W
                chunk = []
                for r in self.readers:
                    frames = r.frames[start : end]
                    frames += [b""] * (W - len(frames))  # empty = no change
                    chunk.append(frames)
                if vi.codec == CodecType.SCREENPRESSOR:
                    out = self._decode_sp_window(chunk, start)
                else:
                    out = self._decode_msv1_window(chunk, start)
                if end - start < W:
                    out = _trim_window(out, end - start)
                if pending is not None:
                    yield pending
                pending = out
            if pending is not None:
                yield pending
        finally:
            self._release_buffers()

    def _release_buffers(self):
        import jax as _jax

        for attr, key in (("_spbuf", ("sp",)), ("_kmvbuf", ("kmv",)),
                          ("_kmvgbuf", ("kmvg", self._gop_group)),
                          ("_sparsebuf", ("sparse",)), ("_bcbuf", ("bc",)),
                          ("_bcgbuf", ("bcg", self._gop_group))):
            buf = getattr(self, attr, None)
            if buf is not None:
                # the last window's device computation may still be reading
                # transfers staged from these pages
                if getattr(self, "_carry", None) is not None:
                    _jax.block_until_ready(self._carry)
                _pool_release(key + self._buf_key, buf)
                setattr(self, attr, None)

    @property
    def _buf_key(self):
        vi = self.info
        return (len(self.readers), self.cfg.window, vi.height, vi.width,
                self.cfg.kmv_k)

    def _guard(self, b: int, fn, *args, default=None):
        """Run a per-frame decode step; on a malformed stream quarantine
        slot b (frozen at the last good frame) instead of failing the
        batch."""
        if b in self.quarantined:
            return default
        try:
            return fn(*args)
        except (ValueError, AssertionError, IndexError) as e:
            # malformed streams surface as ValueError from the native
            # decoders, but the pure-Python fallback can also raise
            # AssertionError/IndexError on corrupt data — quarantine all of
            # them rather than failing the whole batch
            self.quarantined.add(b)
            self.quarantine_errors.append((b, repr(e)))
            return default

    # -- ScreenPressor ---------------------------------------------------------

    def _sp_decoders(self):
        """Persistent per-stream host decoders: SP entropy/context state spans
        windows (P-frames condition on everything since the last keyframe),
        so window boundaries must not reset the host stage."""
        if getattr(self, "_spdecs", None) is None:
            vi = self.info
            from .. import native as _native

            self._spdecs = []
            self._sp_native = _native.available()
            for _ in self.readers:
                if self._sp_native:
                    d = _native.NativeScreenPressor(vi.width, vi.height, vi.bpp)
                else:
                    from ..codecs.screenpressor import ScreenPressor

                    d = ScreenPressor(vi.width, vi.height, vi.bpp)
                d.preinit(self.cfg.insignificant_lines)
                self._spdecs.append(d)
        return self._spdecs

    def _decode_sp_window(self, chunk, start) -> dict:
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nbx, nby = (X + 15) // 16, (Y + 15) // 16
        nb = nbx * nby
        decs = self._sp_decoders()
        if self.cfg.sp_device_path == "kmv_sparse":
            return self._decode_sp_window_sparse(chunk, start)
        if self.cfg.sp_device_path == "bc":
            return self._decode_sp_window_bc(chunk, start, decs)
        if self.cfg.sp_device_path == "kmv" and self._sp_native:
            # fast path: the native decoder emits kmv transport directly
            # (paycode plane + mvk) during decode — no payload capture, no
            # numpy re-pack (prepare_kmv is a per-pixel numpy pass)
            K = self.cfg.kmv_k
            if getattr(self, "_kmvbuf", None) is None:
                # dirty rows carry each pooled plane's incremental-fill
                # state across windows AND pipelines (they live with the
                # buffer): P-frames only clear+write changed blocks
                self._kmvbuf = _pool_acquire(
                    ("kmv",) + self._buf_key, lambda: dict(
                        pc=np.zeros((B, T, Y, X), dtype=np.uint32),
                        mvk=np.zeros((B, T, K, 2), dtype=np.int32),
                        dirty=np.zeros((B, T, nb + 1), dtype=np.int32)))
            if "dirty" not in self._kmvbuf:  # pooled buffer from older shape
                self._kmvbuf["dirty"] = np.full((B, T, nb + 1), -1,
                                                dtype=np.int32)
            pc, mvk = self._kmvbuf["pc"], self._kmvbuf["mvk"]
            dirty = self._kmvbuf["dirty"]
            changed = np.zeros((B, T), dtype=bool)
            sig = np.zeros((B, T), dtype=bool)
            for b, frames in enumerate(chunk):
                dec = decs[b]
                for t, src in enumerate(frames):
                    changed[b, t], sig[b, t] = self._guard(
                        b, lambda: dec.decompress_kmv(
                            src, dec.is_key_frame(src), pc[b, t], mvk[b, t],
                            K=K, dirty=dirty[b, t]), default=(False, False))
            return self._kmv_route(pc, mvk, changed, sig, start)
        # window-sized host buffers are reused across iterations: fresh
        # multi-hundred-MB allocations pay a page fault per 4KB on first
        # write
        if getattr(self, "_spbuf", None) is None:
            self._spbuf = _pool_acquire(("sp",) + self._buf_key, lambda: dict(
                bts=np.zeros((B, T, nb), dtype=np.int32),
                mv=np.zeros((B, T, nb, 2), dtype=np.int32),
                rect=np.zeros((B, T, nb, 4), dtype=np.int32),
                payload=np.zeros((B, T, Y, X), dtype=np.uint32),
            ))
        buf = self._spbuf
        bts, mv, rect, payload = buf["bts"], buf["mv"], buf["rect"], buf["payload"]
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        for b, frames in enumerate(chunk):
            dec = decs[b]
            for t, src in enumerate(frames):
                if self._sp_native:
                    isk = dec.is_key_frame(src)
                    got = self._guard(
                        b, lambda: dec.decompress(src, isk, capture=True,
                                                  copy=False))
                    if got is None:  # quarantined: frozen at last good frame
                        continue
                    view, _sig, cap = got
                    sig[b, t] = bool(_sig)
                    if view is None:
                        view = dec.latest_view()
                    payload[b, t] = np.asarray(view).reshape(Y, X)
                else:
                    # guarded like the native path: the oracle decoders
                    # raise ValueError/AssertionError/IndexError on corrupt
                    # streams and one bad stream must not fail the batch
                    got = self._guard(b, lambda: _oracle_decode_step(
                        dec, src, dec.is_key_frame(src), X, Y))
                    if got is None:  # quarantined: frozen, changed stays False
                        continue
                    sig[b, t], cap = got
                    data = dec.previous_frame()
                    if data is not None:
                        payload[b, t] = data.reshape(Y, X)
                bts[b, t] = cap["bts"]
                mv[b, t] = cap["mv"]
                rect[b, t] = cap["rect"]
                changed[b, t] = cap["changed"]
        init = self._carry_init(B)
        if self.cfg.sp_device_path == "kmv":
            # significance comes from the host stage (it decoded everything
            # anyway); the device only reconstructs pixels
            pcs, mvks = [], []
            for b in range(B):
                if b in self.quarantined:
                    # frozen slot: its pooled command rows are stale and
                    # changed[b] is all-False — skip the per-pixel prep
                    pcs.append(np.zeros((T, Y, X), dtype=np.uint32))
                    mvks.append(np.zeros((T, self.cfg.kmv_k, 2),
                                         dtype=np.int32))
                    continue
                pc_b, mvk_b = sp_recon.prepare_kmv(
                    bts[b], mv[b], rect[b], payload[b], K=self.cfg.kmv_k)
                pcs.append(pc_b)
                mvks.append(mvk_b)
            return self._kmv_route(np.stack(pcs), np.stack(mvks), changed,
                                   sig, start)
        else:
            frames, signif = sp_recon.decode_batch(
                init, _put(bts), _put(mv), _put(rect),
                _put(payload), _put(changed), jnp.int32(0),
            )
        self._carry = frames[:, -1]  # device-resident carry
        _window_barrier(frames)
        return self._emit(frames, signif, start)

    def _decode_sp_window_sparse(self, chunk, start) -> dict:
        """Sparse kmv transport: host captures commands + decoded frames,
        ships per-block codes, K motion vectors, and final-content payload
        tiles.  GOP alignment makes the I-frame the scan INIT (one dense
        frame per GOP) instead of an M≈NB tile burst; tile counts are
        padded to power-of-two buckets to bound recompiles."""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nbx, nby = (X + 15) // 16, (Y + 15) // 16
        nb = nbx * nby
        decs = self._sp_decoders()
        if self._sp_native:
            return self._decode_sp_window_sparse_native(chunk, start, decs)
        if getattr(self, "_spbuf", None) is None:
            self._spbuf = _pool_acquire(("sp",) + self._buf_key, lambda: dict(
                bts=np.zeros((B, T, nb), dtype=np.int32),
                mv=np.zeros((B, T, nb, 2), dtype=np.int32),
                rect=np.zeros((B, T, nb, 4), dtype=np.int32),
                payload=np.zeros((B, T, Y, X), dtype=np.uint32),
            ))
        buf = self._spbuf
        bts, mv, rect, payload = (buf["bts"], buf["mv"], buf["rect"],
                                  buf["payload"])
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        is_key0 = np.zeros(B, dtype=bool)
        for b, frames in enumerate(chunk):
            dec = decs[b]
            for t, src in enumerate(frames):
                if self._sp_native:
                    isk = dec.is_key_frame(src)
                    got = self._guard(
                        b, lambda: dec.decompress(src, isk, capture=True,
                                                  copy=False))
                    if got is None:  # quarantined: frozen at last good frame
                        continue
                    view, _sig, cap = got
                    sig[b, t] = bool(_sig)
                    if view is None:
                        view = dec.latest_view()
                    payload[b, t] = np.asarray(view).reshape(Y, X)
                else:
                    isk = dec.is_key_frame(src)  # safe byte peek
                    got = self._guard(b, lambda: _oracle_decode_step(
                        dec, src, isk, X, Y))
                    if got is None:  # quarantined: changed stays False
                        continue
                    sig[b, t], cap = got
                    data = dec.previous_frame()
                    if data is not None:
                        payload[b, t] = data.reshape(Y, X)
                if t == 0:
                    is_key0[b] = bool(isk)
                bts[b, t] = cap["bts"]
                mv[b, t] = cap["mv"]
                rect[b, t] = cap["rect"]
                changed[b, t] = cap["changed"]
        K = self.cfg.kmv_k
        # GOP-aligned init: a window-leading keyframe ships as the dense
        # scan init (its tiles would be the whole frame anyway)
        skip0 = bool(is_key0.all())
        t0 = 1 if skip0 else 0
        def prep(b):
            if b in self.quarantined:
                # frozen slot: stale pooled commands would cost full prep
                # and could inflate the sticky m_pad bucket — emit the
                # minimal all-copy prep instead (changed[b] is all-False)
                Tq = T - t0
                return (np.zeros((Tq, nb), np.uint8),
                        np.zeros((Tq, K, 2), np.int32),
                        np.zeros((Tq, 1, 16, 16), np.uint32),
                        np.zeros((Tq, 1, 2), np.int32))
            return sp_recon.prepare_kmv_sparse(
                bts[b, t0:], mv[b, t0:], rect[b, t0:],
                (payload[b, t0:] & np.uint32(0x00FFFFFF)), K=K)

        preps = [prep(b) for b in range(B)]
        m_max = max(1, max(p[2].shape[1] for p in preps))
        m_pad = 1 << (m_max - 1).bit_length()
        def padM(tiles, tyx):
            # prepare_kmv_sparse guarantees M >= 1 with final-content pad
            # tiles, so repeating column 0 is always a correct no-op rewrite
            m = tiles.shape[1]
            if m == m_pad:
                return tiles, tyx
            reps = m_pad - m
            return (np.concatenate([tiles, np.repeat(tiles[:, :1], reps, 1)], 1),
                    np.concatenate([tyx, np.repeat(tyx[:, :1], reps, 1)], 1))
        bc = np.stack([p[0] for p in preps])
        mvk = np.stack([p[1] for p in preps])
        padded = [padM(p[2], p[3]) for p in preps]
        tiles = np.stack([q[0] for q in padded])
        tyx = np.stack([q[1] for q in padded])
        if skip0:
            init = _put(payload[:, 0] & np.uint32(0x00FFFFFF))
        else:
            init = self._carry_init(B)
        frames = sp_recon.decode_batch_kmv_sparse(
            init, _put(bc), _put(mvk), _put(tiles),
            _put(tyx), _put(changed[:, t0:]))
        _window_barrier(frames)
        if skip0:
            frames = jnp.concatenate([init[:, None], frames], axis=1)
        self._carry = frames[:, -1]
        return self._emit(frames, jnp.array(sig), start)

    def _decode_sp_window_sparse_native(self, chunk, start, decs) -> dict:
        """Native sparse emission: the C++ decoder fills bcode/mvk/tiles
        directly (sp_decompress_kmv_sparse — no payload capture, no numpy
        re-pack).  Window-leading keyframes (all streams) ship as the dense
        scan init; other keyframes arrive as full-tile frames."""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nbx, nby = (X + 15) // 16, (Y + 15) // 16
        nb = nbx * nby
        K = self.cfg.kmv_k
        if getattr(self, "_sparsebuf", None) is None:
            self._sparsebuf = _pool_acquire(
                ("sparse",) + self._buf_key, lambda: dict(
                    bc=np.zeros((B, T, nb), dtype=np.uint8),
                    mvk=np.zeros((B, T, K, 2), dtype=np.int32),
                    tiles=np.zeros((B, T, nb, 16, 16), dtype=np.uint32),
                    tyx=np.zeros((B, T, nb, 2), dtype=np.int32),
                    init=np.zeros((B, Y, X), dtype=np.uint32),
                ))
        buf = self._sparsebuf
        bc, mvk, tiles, tyx = buf["bc"], buf["mvk"], buf["tiles"], buf["tyx"]
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        skip0 = all(len(fr) > 0 and decs[b].is_key_frame(fr[0])
                    for b, fr in enumerate(chunk))
        t0 = 1 if skip0 else 0
        m_used_arr = np.zeros((B, T), dtype=np.int32)

        def host_decode_stream(b):
            dec = decs[b]
            for t, src in enumerate(chunk[b]):
                if t == 0 and skip0:
                    # guarded like every other decode step: a malformed
                    # keyframe must quarantine slot b, not escape the thread
                    # pool and fail the whole batch (SURVEY.md §5.3)
                    got = self._guard(
                        b, lambda: dec.decompress(src, True, copy=False))
                    if got is None:  # quarantined: init filled from carry
                        continue
                    view, s0, _ = got
                    if view is None:
                        view = dec.latest_view()
                    buf["init"][b] = np.asarray(view).reshape(Y, X)
                    buf["init"][b] &= np.uint32(0x00FFFFFF)
                    changed[b, 0] = True
                    sig[b, 0] = True
                    continue
                chg, sg, m_used = self._guard(
                    b, lambda: dec.decompress_kmv_sparse(
                        src, dec.is_key_frame(src), bc[b, t], mvk[b, t],
                        tiles[b, t], tyx[b, t], K=K),
                    default=(False, False, 0))
                changed[b, t] = chg
                sig[b, t] = sg
                if chg:
                    m_used_arr[b, t] = max(1, m_used)

        if B > 1:
            # streams decode in parallel on real threads (the native calls
            # release the GIL); each thread owns disjoint buffer rows
            from concurrent.futures import ThreadPoolExecutor
            import os as _os

            with ThreadPoolExecutor(min(B, _os.cpu_count() or 1)) as ex:
                list(ex.map(host_decode_stream, range(B)))
        else:
            host_decode_stream(0)
        if skip0 and self.quarantined:
            # frozen streams whose window-leading KEYFRAME failed (or that
            # were quarantined before this window): the pooled init row may
            # hold a previous window's pixels — overwrite it with the
            # stream's carry (the last good frame) so the emitted frame
            # honors the freeze.  A slot quarantined MID-window keeps its
            # successfully decoded keyframe (changed[b, 0] is True): its
            # pre-failure commands composed against that keyframe, and
            # overwriting it would corrupt every frame of the window.
            prev = (np.asarray(self._carry)
                    if getattr(self, "_carry", None) is not None
                    else np.zeros((B, Y, X), dtype=np.uint32))
            for b in self.quarantined:
                if b < B and not changed[b, 0]:
                    buf["init"][b] = prev[b]
        m_max = max(1, int(m_used_arr.max()))
        m_pad = 1 << (m_max - 1).bit_length()
        # sticky bucket: growing windows would otherwise recompile the scan
        # per distinct tile count
        m_pad = min(max(m_pad, getattr(self, "_m_bucket", 1)), nb)
        self._m_bucket = m_pad
        init = (_put(buf["init"]) if skip0 else self._carry_init(B))
        # ragged tile transfer: ship only real tiles (+1 pad row per
        # changed frame) and repack on device — the padded layout pads
        # every frame to the window max on mixed content
        flat_rows = []
        tile_idx = np.zeros((B, T - t0, m_pad), dtype=np.int32)
        off = 0
        for b in range(B):
            for t in range(t0, T):
                if not changed[b, t]:
                    continue
                take = min(int(m_used_arr[b, t]) + 1, nb)  # +1 = pad row
                flat_rows.append(tiles[b, t, :take].reshape(take, 256))
                j = np.minimum(np.arange(m_pad), take - 1)
                tile_idx[b, t - t0] = off + j
                off += take
        flat = (np.concatenate(flat_rows, axis=0) if flat_rows
                else np.zeros((1, 256), np.uint32))
        if self.cfg.sparse_lane_payload and flat.shape[0] > 1:
            # tile pixels cross the link entropy-coded and are lane-decoded
            # ON DEVICE (kernels/lane_transport) — stacks on the ragged
            # transport's size win for link-fed serving
            from ..kernels import lane_transport as _lt

            pack = _lt.encode_tiles(flat & np.uint32(0x00FFFFFF))
            flat_dev = _lt.decode_tiles_device(pack)
        else:
            flat_dev = _put(flat)
        frames = sp_recon.decode_batch_kmv_sparse_ragged(
            init, _put(bc[:, t0:]), _put(mvk[:, t0:]),
            flat_dev, _put(tile_idx),
            _put(tyx[:, t0:, :m_pad]),
            _put(changed[:, t0:]))
        if skip0:
            frames = jnp.concatenate([init[:, None], frames], axis=1)
        self._carry = frames[:, -1]
        _window_barrier(frames)
        return self._emit(frames, jnp.array(sig), start)

    def _decode_sp_window_bc(self, chunk, start, decs) -> dict:
        """bc transport host stage: the decoder fills ONLY data-rect plane
        pixels (no motion fills, no clears, no dirty state — the fastest
        host feed, kernels/sp_recon.compose_frame_bc contract); block
        structure rides bcode/rloc arrays the device broadcasts."""
        vi = self.info
        X, Y = vi.width, vi.height
        B, T = len(chunk), self.cfg.window
        nbx, nby = (X + 15) // 16, (Y + 15) // 16
        nb = nbx * nby
        K = self.cfg.kmv_k
        if getattr(self, "_bcbuf", None) is None:
            self._bcbuf = _pool_acquire(
                ("bc",) + self._buf_key, lambda: dict(
                    plane=np.zeros((B, T, Y, X), dtype=np.uint32),
                    mvk=np.zeros((B, T, K, 2), dtype=np.int32),
                    bcode=np.zeros((B, T, nb), dtype=np.uint8),
                    rloc=np.zeros((B, T, nb, 4), dtype=np.uint8)))
        buf = self._bcbuf
        plane, mvk = buf["plane"], buf["mvk"]
        bcode, rloc = buf["bcode"], buf["rloc"]
        changed = np.zeros((B, T), dtype=bool)
        sig = np.zeros((B, T), dtype=bool)
        if self._sp_native:
            for b, frames in enumerate(chunk):
                dec = decs[b]
                for t, src in enumerate(frames):
                    changed[b, t], sig[b, t] = self._guard(
                        b, lambda: dec.decompress_bc(
                            src, dec.is_key_frame(src), plane[b, t],
                            mvk[b, t], bcode[b, t], rloc[b, t], K=K),
                        default=(False, False))
        else:
            for b, frames in enumerate(chunk):
                dec = decs[b]
                bts = np.zeros((T, nb), dtype=np.int32)
                mv = np.zeros((T, nb, 2), dtype=np.int32)
                rect = np.zeros((T, nb, 4), dtype=np.int32)
                payload = np.zeros((T, Y, X), dtype=np.uint32)
                for t, src in enumerate(frames):
                    got = self._guard(b, lambda: _oracle_decode_step(
                        dec, src, dec.is_key_frame(src), X, Y))
                    if got is None:  # quarantined: changed stays False
                        continue
                    sig[b, t], cap = got
                    # None until the stream's first real frame (e.g. a
                    # leading no-change P-frame): leave the pooled plane
                    # row alone — changed gating never reads it
                    # (fuzz seed 904715: .reshape on None killed the batch)
                    data = dec.previous_frame()
                    if data is not None:
                        payload[t] = data.reshape(Y, X)
                    bts[t], mv[t], rect[t] = (cap["bts"], cap["mv"],
                                              cap["rect"])
                    changed[b, t] = cap["changed"]
                (plane[b], bcode[b], rloc[b], mvk[b]) = sp_recon.prepare_bc(
                    bts, mv, rect, payload, K=K)
        return self._bc_route(plane, bcode, rloc, mvk, changed, sig, start)

    def _bc_route(self, plane, bcode, rloc, mvk, changed, sig, start) -> dict:
        """Dispatch an assembled bc window to the right device path
        (mirrors _kmv_route: elision, mesh sharding, fused model, batch)."""
        B = plane.shape[0]
        init = self._carry_init(B)
        if self.cfg.still_elision:
            return self._bc_elided(plane, bcode, rloc, mvk, changed, sig,
                                   init, start)
        if self.cfg.mesh is not None:
            frames = self._sharded_bc_step(plane, bcode, rloc, mvk, changed)
            self._carry = frames[:, -1]
            _window_barrier(frames)
            return self._emit(frames, jnp.array(sig), start)
        if not self.cfg.emit_frames and self.cfg.emit_model_input:
            carry, model = sp_recon.decode_batch_bc_model(
                init, _put(plane), _put(bcode), _put(rloc), _put(mvk),
                _put(changed), dtype=jnp.dtype(self.cfg.model_dtype),
                downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                packed=self.cfg.model_packed)
            self._carry = carry
            _window_barrier(carry, model)
            return {"start_frame": start, "significant": jnp.array(sig),
                    "model_input": model}
        frames = sp_recon.decode_batch_bc(
            init, _put(plane), _put(bcode), _put(rloc), _put(mvk),
            _put(changed))
        self._carry = frames[:, -1]
        _window_barrier(frames)
        return self._emit(frames, jnp.array(sig), start)

    def _bc_elided(self, plane, bcode, rloc, mvk, changed, sig, init,
                   start) -> dict:
        """Still-elision for the bc transport: same output contract as
        _kmv_elided (flat row stack + outmap), CONCAT layout when every
        stream's first compacted slot fully overwrites the frame."""
        B = plane.shape[0]
        vi = self.info
        (plc, bcc, rlc, mvkc), valid, outmap = sp_recon.compact_arrays_batch(
            (plane, bcode, rloc, mvk), changed)
        cpad = plc.shape[1]
        counts = valid.sum(axis=1).astype(np.int64)
        out = {"start_frame": start, "significant": jnp.array(sig)}
        if cpad == 0:
            out["outmap"] = outmap
            if self.cfg.emit_frames:
                out["frames_u32"] = jnp.zeros(
                    (0, vi.height, vi.width), dtype=jnp.uint32)
            return out
        full_first = self.cfg.mesh is None and all(
            counts[b] == 0
            or (bool((bcc[b, 0] == 1).all())
                and bool((rlc[b, 0] == (0, 0, 16, 16)).all()))
            for b in range(B))
        self.stats["concat_windows" if full_first else "padded_windows"] += 1
        if full_first:
            offsets = np.zeros(B, dtype=np.int64)
            np.cumsum(counts[:-1], out=offsets[1:])
            cat = lambda a: np.concatenate(
                [a[b, : counts[b]] for b in range(B)] or
                [np.zeros((0,) + a.shape[2:], a.dtype)])
            outmap_flat = np.where(
                outmap >= 0, outmap + offsets[:, None], -1).astype(np.int32)
            frames = sp_recon.decode_sequence_bc_compact(
                init[0], _put(cat(plc)), _put(cat(bcc)), _put(cat(rlc)),
                _put(cat(mvkc)))
            ends = offsets + counts
            self._carry = jnp.stack([
                frames[int(ends[b]) - 1] if counts[b] else init[b]
                for b in range(B)])
            _window_barrier(frames)
            out["outmap"] = outmap_flat
            if self.cfg.emit_frames:
                out["frames_u32"] = frames
            if self.cfg.emit_model_input:
                out["model_input"] = self._model_tensors(frames)
            return out
        outmap_flat = np.where(
            outmap >= 0,
            outmap + (np.arange(B, dtype=np.int32) * cpad)[:, None],
            -1).astype(np.int32)
        out["outmap"] = outmap_flat
        if self.cfg.mesh is not None:
            frames = self._sharded_bc_step(plc, bcc, rlc, mvkc, valid)
        else:
            frames = sp_recon.decode_batch_bc(
                init, _put(plc), _put(bcc), _put(rlc), _put(mvkc),
                _put(valid))
        self._carry = frames[:, -1]
        _window_barrier(frames)
        flat = frames.reshape((B * cpad,) + frames.shape[2:])
        if self.cfg.emit_frames:
            out["frames_u32"] = flat
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(flat)
        return out

    def _sharded_bc_step(self, plane, bcode, rloc, mvk, changed):
        """bc windows over the mesh's dp axis."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .batch import DecodeConfig, make_sp_decode_step_bc

        mesh = self.cfg.mesh
        assert self._gop_group == 1, \
            "gop>1 grouping rides the kmv path; bc shards dp only"
        vi = self.info
        if getattr(self, "_sharded_bc", None) is None:
            cfg = DecodeConfig(height=vi.height, width=vi.width,
                               emit_model_input=False)
            self._sharded_bc = make_sp_decode_step_bc(mesh, cfg)
        put = lambda a, spec: jax.device_put(
            np.ascontiguousarray(a), NamedSharding(mesh, spec))
        init = self._carry_init(plane.shape[0])
        frames = self._sharded_bc(
            jax.device_put(init[:, None],
                           NamedSharding(mesh, P("dp", "gop"))),
            put(plane[:, None], P("dp", "gop")),
            put(bcode[:, None], P("dp", "gop")),
            put(rloc[:, None], P("dp", "gop")),
            put(mvk[:, None], P("dp", "gop")),
            put(changed[:, None], P("dp", "gop")))
        _window_barrier(frames)
        return frames[:, 0]

    def _kmv_route(self, pc, mvk, changed, sig, start) -> dict:
        """Dispatch an assembled kmv window (pc [B,T,Y,X], mvk [B,T,K,2],
        changed/sig [B,T]) to the right device path: sharded mesh step,
        still-elided scans, fused model emission, or the dense batch scan.
        Shared by the native fast path and the pure-Python host stage so the
        two can never drift."""
        B = pc.shape[0]
        init = self._carry_init(B)
        if self.cfg.still_elision and (self.cfg.mesh is not None or B > 1):
            return self._kmv_elided(pc, mvk, changed, sig, init, start)
        if self.cfg.mesh is not None:
            frames = self._sharded_kmv_step(pc, mvk, changed)
            self._carry = frames[:, -1]
            _window_barrier(frames)
            return self._emit(frames, jnp.array(sig), start)
        if self.cfg.still_elision:  # single stream: exact compact scan
            pcc, mvkc, outmap = sp_recon.compact_changed(
                pc[0], mvk[0], changed[0])
            frames = sp_recon.decode_sequence_kmv_compact(
                init[0], _put(pcc), _put(mvkc))[None]
            self._carry = (frames[:, -1] if pcc.shape[0] else init)
            _window_barrier(frames)
            out = {"start_frame": start, "significant": jnp.array(sig),
                   "frames_u32": frames, "outmap": outmap}
            if self.cfg.emit_model_input:
                out["model_input"] = self._model_tensors(frames)
            return out
        if not self.cfg.emit_frames and self.cfg.emit_model_input:
            carry, model = sp_recon.decode_batch_kmv_model(
                init, _put(pc), _put(mvk), _put(changed),
                dtype=jnp.dtype(self.cfg.model_dtype),
                downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                packed=self.cfg.model_packed)
            self._carry = carry
            _window_barrier(carry, model)
            return {"start_frame": start, "significant": jnp.array(sig),
                    "model_input": model}
        frames = sp_recon.decode_batch_kmv(
            init, _put(pc), _put(mvk), _put(changed))
        self._carry = frames[:, -1]
        _window_barrier(frames)
        return self._emit(frames, jnp.array(sig), start)

    def _kmv_elided(self, pc, mvk, changed, sig, init, start) -> dict:
        """Batched/sharded still-elision: stills never
        enter the device scan, at batch scale (the reference's
        identical-frame buffer ranges, Manager.hx:568-578).

        Output contract: "frames_u32" (or "model_input" when fused) is a
        FLAT stack of decoded rows and "outmap" [B, T] indexes its first
        axis (-1 = the window's carry-in frame).  Two device layouts feed
        it, chosen per window:

          * CONCAT — when every stream's first compacted slot fully
            overwrites the frame (keyframe/flat-led windows, checked on
            the paycode ptype plane), all streams' compacted frames
            concatenate into ONE sequential scan: zero padding, and one
            scan instead of B unrolled scans through the same memory;
          * PADDED — otherwise, the per-stream masked scans of bucketed
            length Cpad run unrolled (or shard over the dp mesh) and the
            [B, Cpad] result is flattened with per-stream offsets."""
        B = pc.shape[0]
        vi = self.info
        pcc, mvkc, valid, outmap = sp_recon.compact_changed_batch(
            pc, mvk, changed)
        cpad = pcc.shape[1]
        counts = valid.sum(axis=1).astype(np.int64)
        out = {"start_frame": start, "significant": jnp.array(sig)}
        if cpad == 0:  # all streams all-stills: nothing to decode
            out["outmap"] = outmap  # all -1
            if self.cfg.emit_frames:
                out["frames_u32"] = jnp.zeros(
                    (0, vi.height, vi.width), dtype=jnp.uint32)
            return out

        full_first = self.cfg.mesh is None and all(
            counts[b] == 0
            or bool((((pcc[b, 0] >> 24) & 3) == 1).all())
            for b in range(B))
        self.stats["concat_windows" if full_first else "padded_windows"] += 1
        if full_first:
            # concat layout: per-stream compacted runs back to back
            offsets = np.zeros(B, dtype=np.int64)
            np.cumsum(counts[:-1], out=offsets[1:])
            cat_pc = np.concatenate(
                [pcc[b, : counts[b]] for b in range(B)] or
                [np.zeros((0,) + pcc.shape[2:], pcc.dtype)])
            cat_mv = np.concatenate(
                [mvkc[b, : counts[b]] for b in range(B)])
            outmap_flat = np.where(
                outmap >= 0, outmap + offsets[:, None], -1).astype(np.int32)
            # (fused model-only emission still decodes the frame stack here:
            # the per-stream pixel carries come from frame rows, and the
            # concat layout's throughput win dwarfs the saved stack write)
            frames = sp_recon.decode_sequence_kmv_compact(
                init[0], _put(cat_pc), _put(cat_mv))
            ends = offsets + counts  # exclusive
            carry_rows = jnp.stack([
                frames[int(ends[b]) - 1] if counts[b] else init[b]
                for b in range(B)])
            self._carry = carry_rows
            _window_barrier(frames)
            out["outmap"] = outmap_flat
            if self.cfg.emit_frames:
                out["frames_u32"] = frames
            if self.cfg.emit_model_input:
                out["model_input"] = self._model_tensors(frames)
            return out

        # padded layout (mid-GOP windows or mesh): [B, Cpad] → flat
        outmap_flat = np.where(
            outmap >= 0,
            outmap + (np.arange(B, dtype=np.int32) * cpad)[:, None],
            -1).astype(np.int32)
        out["outmap"] = outmap_flat
        if (self.cfg.mesh is None and not self.cfg.emit_frames
                and self.cfg.emit_model_input):
            # fused: the compacted masked scan emits ONLY model tensors —
            # the full-res frame stack is never written
            carry, model = sp_recon.decode_batch_kmv_model(
                init, _put(pcc), _put(mvkc), _put(valid),
                dtype=jnp.dtype(self.cfg.model_dtype),
                downscale=self.cfg.model_downscale, bpp16=self._bpp16,
                packed=self.cfg.model_packed)
            self._carry = carry
            _window_barrier(carry, model)
            out["model_input"] = model.reshape((B * cpad,) + model.shape[2:])
            return out
        if self.cfg.mesh is not None:
            frames = self._sharded_kmv_step(pcc, mvkc, valid)
        else:
            frames = sp_recon.decode_batch_kmv(
                init, _put(pcc), _put(mvkc), _put(valid))
        self._carry = frames[:, -1]
        _window_barrier(frames)
        flat = frames.reshape((B * cpad,) + frames.shape[2:])
        if self.cfg.emit_frames:
            out["frames_u32"] = flat
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(flat)
        return out

    @property
    def _gop_group(self) -> int:
        """Windows per device dispatch = the mesh's gop-axis size.  >1 turns
        keyframe-led windows into the sequence-parallel unit (SURVEY.md §2
        SP/CP row): G windows of one stream decode CONCURRENTLY on G
        devices — the scaling axis for a single long stream."""
        mesh = self.cfg.mesh
        if mesh is None:
            return 1
        return dict(zip(mesh.axis_names, mesh.devices.shape)).get("gop", 1)

    def _decode_sp_window_group(self, chunks, starts) -> list[dict]:
        """Decode G keyframe-led windows in ONE sharded [B, G, T] dispatch
        over the (dp, gop) mesh.  Every window after the first must start
        with a keyframe (or be stream-end padding): keyframes make windows
        independent decode chains, so the gop axis carries no cross-device
        dependency.  → one output dict per real window."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .batch import (DecodeConfig, make_sp_decode_step_bc,
                            make_sp_decode_step_kmv)

        vi = self.info
        X, Y = vi.width, vi.height
        mesh = self.cfg.mesh
        G = self._gop_group
        B, T = len(chunks[0]), self.cfg.window
        K = self.cfg.kmv_k
        decs = self._sp_decoders()
        assert self._sp_native, "gop-grouped ingest needs the native decoder"
        assert not self.cfg.still_elision, \
            "still_elision with a gop>1 mesh is not supported yet"
        use_bc = self.cfg.sp_device_path == "bc"
        nb = ((X + 15) // 16) * ((Y + 15) // 16)
        if use_bc:
            if getattr(self, "_bcgbuf", None) is None:
                self._bcgbuf = _pool_acquire(
                    ("bcg", G) + self._buf_key, lambda: dict(
                        pc=np.zeros((B, G, T, Y, X), dtype=np.uint32),
                        mvk=np.zeros((B, G, T, K, 2), dtype=np.int32),
                        bcode=np.zeros((B, G, T, nb), dtype=np.uint8),
                        rloc=np.zeros((B, G, T, nb, 4), dtype=np.uint8)))
            buf = self._bcgbuf
        else:
            if getattr(self, "_kmvgbuf", None) is None:
                self._kmvgbuf = _pool_acquire(
                    ("kmvg", G) + self._buf_key, lambda: dict(
                        pc=np.zeros((B, G, T, Y, X), dtype=np.uint32),
                        mvk=np.zeros((B, G, T, K, 2), dtype=np.int32),
                        dirty=np.zeros((B, G, T, nb + 1), dtype=np.int32)))
            buf = self._kmvgbuf
        pc, mvk = buf["pc"], buf["mvk"]
        changed = np.zeros((B, G, T), dtype=bool)
        sig = np.zeros((B, G, T), dtype=bool)
        n_real = len(starts)
        for g, chunk in enumerate(chunks):
            for b, frames in enumerate(chunk):
                dec = decs[b]
                if g > 0 and frames[0]:
                    assert dec.is_key_frame(frames[0]), (
                        "gop>1 mesh requires keyframe-led windows "
                        f"(window @{starts[g]} stream {b} starts mid-GOP); "
                        "align IngestConfig.window with the keyframe cadence")
                for t, src in enumerate(frames):
                    if use_bc:
                        step = lambda: dec.decompress_bc(
                            src, dec.is_key_frame(src), pc[b, g, t],
                            mvk[b, g, t], buf["bcode"][b, g, t],
                            buf["rloc"][b, g, t], K=K)
                    else:
                        step = lambda: dec.decompress_kmv(
                            src, dec.is_key_frame(src), pc[b, g, t],
                            mvk[b, g, t], K=K, dirty=buf["dirty"][b, g, t])
                    changed[b, g, t], sig[b, g, t] = self._guard(
                        b, step, default=(False, False))
        cache_attr = "_sharded_gstep_bc" if use_bc else "_sharded_gstep"
        if getattr(self, cache_attr, None) is None:
            cfg = DecodeConfig(height=Y, width=X, emit_model_input=False)
            mk = make_sp_decode_step_bc if use_bc else make_sp_decode_step_kmv
            setattr(self, cache_attr, mk(mesh, cfg))
        gstep = getattr(self, cache_attr)
        put = lambda a, spec: jax.device_put(
            np.ascontiguousarray(a), NamedSharding(mesh, spec))
        # g=0 continues the previous group's carry; g>0 windows are
        # keyframe-led, so zeros are exact (the I-frame paints every pixel)
        init = np.zeros((B, G, Y, X), dtype=np.uint32)
        if getattr(self, "_carry", None) is not None:
            init[:, 0] = np.asarray(self._carry)
        if use_bc:
            frames = gstep(
                put(init, P("dp", "gop")), put(pc, P("dp", "gop")),
                put(buf["bcode"], P("dp", "gop")),
                put(buf["rloc"], P("dp", "gop")),
                put(mvk, P("dp", "gop")), put(changed, P("dp", "gop")))
        else:
            frames = gstep(
                put(init, P("dp", "gop")), put(pc, P("dp", "gop")),
                put(mvk, P("dp", "gop")), put(changed, P("dp", "gop")))
        self._carry = frames[:, n_real - 1, -1]
        _window_barrier(frames)
        outs = []
        for g in range(n_real):
            outs.append(self._emit(frames[:, g], jnp.array(sig[:, g]),
                                   starts[g]))
        return outs

    def _sharded_kmv_step(self, pc, mvk, changed):
        """Multi-chip window decode: streams shard over the mesh's dp axis
        (each device scans its own P-chains; no cross-device traffic —
        GOPs/streams are independent, SURVEY.md §2 DP row)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .batch import DecodeConfig, make_sp_decode_step_kmv

        mesh = self.cfg.mesh
        assert dict(zip(mesh.axis_names, mesh.devices.shape)).get("gop", 1) \
            == 1, ("gop>1 meshes route through the window-grouping path "
                   "(kmv + native host stage); this transport shards dp only")
        vi = self.info
        if getattr(self, "_sharded_step", None) is None:
            cfg = DecodeConfig(height=vi.height, width=vi.width,
                               emit_model_input=False)
            self._sharded_step = make_sp_decode_step_kmv(mesh, cfg)
        # [B, T, ...] → [B, G=1, T, ...] rows on the (dp, gop) mesh
        put = lambda a, spec: jax.device_put(
            np.ascontiguousarray(a), NamedSharding(mesh, spec))
        init = self._carry_init(pc.shape[0])
        frames = self._sharded_step(
            jax.device_put(init[:, None],
                           NamedSharding(mesh, P("dp", "gop"))),
            put(pc[:, None], P("dp", "gop")),
            put(mvk[:, None], P("dp", "gop")),
            put(changed[:, None], P("dp", "gop")))
        _window_barrier(frames)
        return frames[:, 0]

    # -- MSVideo1 --------------------------------------------------------------

    def _decode_msv1_window(self, chunk, start) -> dict:
        vi = self.info
        X, Y = vi.width, vi.height
        pal = palette_to_u32(vi.palette) if vi.codec == CodecType.MSVC8 else None
        B, T = len(chunk), self.cfg.window
        nb = (X >> 2) * (Y >> 2)
        bt = np.zeros((B, T, nb), dtype=np.uint8)
        sel = np.zeros((B, T, nb, 16), dtype=np.uint8)
        col = np.zeros((B, T, nb, 8), dtype=np.uint32)
        chg = np.zeros((B, T), dtype=bool)
        from .. import native as _native

        parse = (_native.native_msv1_parse if _native.available()
                 else parse_commands)
        for b, frames in enumerate(chunk):
            for t, src in enumerate(frames):
                # guarded: a malformed MSV1 stream quarantines its slot
                # (frozen at the last good frame) instead of failing the
                # batch — same policy as the SP paths (SURVEY.md §5.3)
                got = self._guard(b, lambda: parse(src, X, Y, pal=pal))
                if got is None:
                    continue
                bt[b, t], sel[b, t], col[b, t], chg[b, t] = got
        init = self._carry_init(B)
        valid = jnp.array([start > 0] * B)
        sel = msv1_paint.sel_to_plane(sel, Y, X)  # device wants plane order
        if self.cfg.mesh is not None:
            frames, signif = self._sharded_msv1_window(
                init, valid, bt, sel, col, chg)
        else:
            frames, signif = msv1_paint.decode_batch(
                init, valid, _put(bt), _put(sel), _put(col),
                _put(chg),
                jnp.int32((self.cfg.insignificant_lines + 3) >> 2),
                jnp.int32(self.cfg.insignificant_lines), X // 4,
            )
        self._carry = frames[:, -1]  # device-resident carry
        _window_barrier(frames)
        return self._emit(frames, signif, start)

    def _sharded_msv1_window(self, init, valid, bt, sel, col, chg):
        """MSV1 windows over the mesh's dp axis (streams sharded), with the
        per-window carry threaded through the sharded step."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .batch import DecodeConfig, make_msv1_decode_step

        mesh = self.cfg.mesh
        assert self._gop_group == 1, \
            "gop>1 grouping is implemented for the SP kmv path only"
        vi = self.info
        if getattr(self, "_sharded_msv1_step", None) is None:
            cfg = DecodeConfig(
                height=vi.height, width=vi.width, emit_model_input=False,
                insignificant_blocks=(self.cfg.insignificant_lines + 3) >> 2,
                insignificant_lines=self.cfg.insignificant_lines)
            self._sharded_msv1_step = make_msv1_decode_step(
                mesh, cfg, with_carry=True)
        put = lambda a, spec: jax.device_put(
            np.ascontiguousarray(a), NamedSharding(mesh, spec))
        frames, signif = self._sharded_msv1_step(
            put(np.asarray(init)[:, None], P("dp", "gop")),
            put(np.asarray(valid)[:, None], P("dp", "gop")),
            put(bt[:, None], P("dp", "gop")),
            put(np.asarray(sel)[:, None], P("dp", "gop")),
            put(col[:, None], P("dp", "gop")),
            put(chg[:, None], P("dp", "gop")))
        _window_barrier(frames, signif)
        return frames[:, 0], signif[:, 0]

    # -- shared ----------------------------------------------------------------

    def _carry_init(self, B) -> jax.Array:
        vi = self.info
        if getattr(self, "_carry", None) is None:
            return jnp.zeros((B, vi.height, vi.width), dtype=jnp.uint32)
        return self._carry

    def _model_tensors(self, frames):
        """Frames → the configured model product (unpacked tensors or the
        packed-ds2 plane, rgb_convert.ds2_packed_output contract)."""
        if self.cfg.model_packed:
            assert self.cfg.model_downscale == 2, \
                "model_packed requires model_downscale == 2"
            from ..kernels.rgb_convert import ds2_packed_output

            return ds2_packed_output(frames)
        return to_model_input(
            frames, dtype=jnp.dtype(self.cfg.model_dtype),
            downscale=self.cfg.model_downscale, bpp16=self._bpp16)

    def _emit(self, frames, signif, start) -> dict:
        out = {"start_frame": start, "frames_u32": frames,
               "significant": signif}
        if self.cfg.emit_model_input:
            out["model_input"] = self._model_tensors(frames)
        return out
