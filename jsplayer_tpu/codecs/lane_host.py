"""Host (numpy) decode of lane containers — the Player/oracle path.

The lane container is the batch serving format whose production decode
runs on device (kernels/lane_recon); the interactive Player needs frames
on the HOST (the Manager.fill_bitmap_data analog for `.jlv` sources),
and tests want a parity oracle independent of the device path.  This
module mirrors the device semantics exactly — units → data-plane row
scatter, block rects, K motion rolls (the ScreenPressor.hx:302-484
block model as captured by lane_format.derive_window) — and
tests/test_lane_container.py pins host == device bit-exactly.
"""

from __future__ import annotations

import bisect
import struct
from collections import OrderedDict
from typing import Iterator, Optional

import numpy as np

from ..kernels.rans_lanes import PROB_BITS, PROB_SCALE, RANS_L
from .base import DecoderState, PFrameResult, VideoCodec
from .lane_format import LaneContainer, LaneWindow, plane_cols

# sentinel for a deferred window entry carry: a checkpoint hit makes the
# carry unnecessary unless a LATER backward scrub lands below every
# checkpoint of the window — only then is the (possibly chain-long)
# rebuild actually paid (LaneHostCodec._carry_in)
_LAZY = object()


def decode_lanes_aligned_host(refills: np.ndarray, states: np.ndarray,
                              freq: np.ndarray) -> np.ndarray:
    """numpy twin of kernels/rans_lanes.decode_lanes_aligned:
    refills [steps, N, 2] u8 + states [N] u32 + freq [256] i32
    → symbols [steps, N] u8 (vectorized over lanes, looped over steps)."""
    cumv = np.zeros(256, dtype=np.int64)
    np.cumsum(freq.astype(np.int64)[:255], out=cumv[1:])
    x = states.astype(np.uint64).copy()
    steps = refills.shape[0]
    syms = np.empty((steps, x.size), dtype=np.uint8)
    fq = freq.astype(np.uint64)
    cf = cumv.astype(np.uint64)
    for t in range(steps):
        sf = x & np.uint64(PROB_SCALE - 1)
        s = np.searchsorted(cumv, sf.astype(np.int64), side="right") - 1
        syms[t] = s
        x = fq[s] * (x >> np.uint64(PROB_BITS)) + sf - cf[s]
        r = refills[t].astype(np.uint64)
        x = np.where(x < RANS_L, (x << np.uint64(8)) | r[:, 0], x)
        x = np.where(x < RANS_L, (x << np.uint64(8)) | r[:, 1], x)
    return syms


def units_host(w: LaneWindow) -> np.ndarray:
    """Payload units as [U, 128] u32 (raw bytes, or host rans decode).

    Memoized on the window: interactive seek re-enters the same window
    repeatedly (scrubbing), and the u8→u24 combine — or worse, the rans
    lane decode — was paid on every entry (a large share of lane seek
    latency on the terminal corpus)."""
    cached = getattr(w, "_units_cache", None)
    if cached is not None:
        return cached
    U = w.n_units
    if w.raw_mode:
        m = w.payload.astype(np.uint32)
    else:
        syms = decode_lanes_aligned_host(w.refills, w.states, w.freq)
        m = syms.reshape(-1)[: U * 384].reshape(U, 3, 128).astype(np.uint32)
    units = m[:, 0] | (m[:, 1] << 8) | (m[:, 2] << 16)
    units.flags.writeable = False
    w._units_cache = units
    return units


def _native_window_arrays(w: LaneWindow):
    """Contiguous per-window arrays for the native compose, cached on the
    window (same lifecycle as _units_cache)."""
    cached = getattr(w, "_native_arrays_cache", None)
    if cached is not None:
        return cached
    units = units_host(w)
    row_ptr = np.zeros(w.T + 1, np.int64)
    np.cumsum([r.size for r in w.unit_rows], out=row_ptr[1:])
    n = int(row_ptr[-1])
    rows_cat = (np.concatenate(w.unit_rows).astype(np.int64)
                if n else np.zeros(0, np.int64))
    if w.unit_idx is not None:
        refs_cat = (np.concatenate(w.unit_idx).astype(np.int64)
                    if n else np.zeros(0, np.int64))
    else:
        refs_cat = np.arange(n, dtype=np.int64)
    arrs = (np.ascontiguousarray(units),
            row_ptr, rows_cat, refs_cat,
            np.ascontiguousarray(w.changed, np.uint8),
            np.ascontiguousarray(w.btype),
            np.ascontiguousarray(w.rect),
            np.ascontiguousarray(w.mvk, np.int32))
    w._native_arrays_cache = arrs
    return arrs


def native_compose_range(w: LaneWindow, X: int, Y: int, plane: np.ndarray,
                         pool: np.ndarray, t0: int, t1: int) -> None:
    """Advance `plane` ([Y, X] u32, C-contiguous) through frames [t0, t1)
    of `w` with the C compose (native.lane_compose_range — bit-exact twin
    of compose_steps' changed-frame body; the interactive-seek hot path).
    `pool` is a zeroed [Y * plane_cols(X)] u32 scratch whose zero
    invariant the call preserves."""
    from .. import native as _native

    units, row_ptr, rows_cat, refs_cat, chg, bt, rc, mv = \
        _native_window_arrays(w)
    if t0 == 0 and t1 > 0 and w.changed[0] and w.init_plane is not None:
        # rans-mode keyframe rides as a raw plane (compose_steps t==0)
        plane[:] = w.init_plane
        t0 = 1
    if t0 < t1:
        _native.native_lane_compose_range(
            plane.reshape(-1), pool, units.reshape(-1), Y, X, plane_cols(X),
            int(w.mvk.shape[1]), int(w.btype.shape[1]), w.T, t0, t1,
            chg, bt.reshape(-1), rc.reshape(-1), mv.reshape(-1),
            row_ptr, rows_cat, refs_cat)


def compose_steps(w: LaneWindow, X: int, Y: int,
                  prev: Optional[np.ndarray] = None,
                  start: int = 0) -> Iterator[np.ndarray]:
    """Incremental host decode of one window: yields frame t's plane
    ([Y, X] u32) per step.  Still frames yield the SAME object as the
    previous frame (no copy — yielded planes are never mutated later), so
    consumers pay only for changed frames; this is what makes lane seek
    latency proportional to changed-frames-to-target instead of window
    length (the host analog of device still-elision).

    prev: carry-in plane for mid-stream windows; None for restart
    (keyframe-led) windows or stream start.

    start: frames before this index are composed IN PLACE in one scratch
    plane — their yields alias it and MUST NOT be retained by the caller.
    A seek to frame lt passes start=lt: the walk from the keyframe to the
    target then writes only each frame's painted rects instead of paying
    a full-plane copy per changed frame (at 1080p that copy was the bulk
    of lane seek latency — the Main.hx:1220-1226 metric).  From `start`
    on, the usual copy-on-change semantics resume, so retained frames are
    never aliased by later mutation."""
    Xp = plane_cols(X)
    units = units_host(w)
    nbx = (X + 15) // 16
    cur = (np.zeros((Y, X), dtype=np.uint32) if prev is None
           else prev.astype(np.uint32).copy())
    # pooled scatter plane: zeroed once, then only the rows each frame
    # touched are re-zeroed (a full-frame np.zeros per changed frame was
    # ~20% of seek-replay time)
    pool = np.zeros((Y * Xp // 128, 128), dtype=np.uint32)
    seq_off = 0
    for t in range(w.T):
        rows = w.unit_rows[t]
        if w.unit_idx is not None:
            refs = w.unit_idx[t]
        else:
            refs = seq_off + np.arange(rows.size, dtype=np.int64)
            seq_off += rows.size
        if w.changed[t]:
            if t == 0 and w.init_plane is not None:
                # rans-mode keyframe rides as a raw plane (all-copy frame)
                cur = w.init_plane.astype(np.uint32).copy()
            else:
                if rows.size:
                    pool[rows] = units[refs]
                tp = pool.reshape(Y, Xp)[:, :X]
                inplace = t < start
                nxt = cur if inplace else cur.copy()
                shifted = {}

                def _shift(k: int) -> np.ndarray:
                    if k not in shifted:
                        dx, dy = int(w.mvk[t, k, 0]), int(w.mvk[t, k, 1])
                        shifted[k] = np.roll(cur, (-dy, -dx), axis=(0, 1))
                    return shifted[k]

                idx = np.nonzero(w.btype[t])[0]
                bts = w.btype[t, idx].astype(np.int64)
                rects = w.rect[t, idx].astype(np.int64)  # [n, (x1,y1,x2,y2)]
                if inplace:
                    # motion sources must be materialized from the pristine
                    # t-1 plane BEFORE any in-place paint lands on it
                    for bt in np.unique(bts):
                        if bt >= 2:
                            _shift(int(bt) - 2)
                bxs, bys = idx % nbx, idx // nbx
                ax1 = bxs * 16 + rects[:, 0]
                ay1 = bys * 16 + rects[:, 1]
                ax2 = np.minimum(bxs * 16 + rects[:, 2], X)
                ay2 = np.minimum(bys * 16 + rects[:, 3], Y)
                # full 16x16 cells inside the grid-viewable region go through
                # ONE fancy-indexed block-grid assignment per source (blocks
                # own disjoint cells, so order is irrelevant); only partial
                # edge rects fall back to the per-block loop
                gy, gx = (Y // 16) * 16, (X // 16) * 16
                full = ((rects[:, 0] == 0) & (rects[:, 1] == 0)
                        & (ax2 - ax1 == 16) & (ay2 - ay1 == 16)
                        & (ay1 + 16 <= gy) & (ax1 + 16 <= gx))
                if full.any():
                    nv = nxt[:gy, :gx].reshape(gy // 16, 16, gx // 16, 16)
                    for bt in np.unique(bts[full]):
                        m = full & (bts == bt)
                        src = tp if bt == 1 else _shift(int(bt) - 2)
                        sv = src[:gy, :gx].reshape(gy // 16, 16, gx // 16, 16)
                        nv[bys[m], :, bxs[m], :] = sv[bys[m], :, bxs[m], :]
                part = np.nonzero(~full)[0]
                for j in part:
                    bt = int(bts[j])
                    src = tp if bt == 1 else _shift(bt - 2)
                    nxt[ay1[j]:ay2[j], ax1[j]:ax2[j]] = \
                        src[ay1[j]:ay2[j], ax1[j]:ax2[j]]
                cur = nxt
                if rows.size:
                    pool[rows] = 0  # restore the pooled plane's zeros
        yield cur


def window_carry(w: LaneWindow, X: int, Y: int,
                 prev: Optional[np.ndarray] = None) -> np.ndarray:
    """Final plane of a window without materializing its frames — the
    cheap way to rebuild a mid-chain carry (stills cost nothing, changed
    frames paint in place; native compose when built, else
    compose_steps(start=w.T))."""
    from .. import native as _native

    if _native.lane_compose_available():
        # astype always copies (copy=True default) — one copy, not two
        plane = (prev.astype(np.uint32) if prev is not None
                 else np.zeros((Y, X), np.uint32))
        pool = np.zeros(Y * plane_cols(X), np.uint32)
        native_compose_range(w, X, Y, plane, pool, 0, w.T)
        return plane
    cur = None
    for cur in compose_steps(w, X, Y, prev, start=w.T):
        pass
    assert cur is not None
    return cur  # the generator's scratch — exhausted, so never mutated again


def clear_window_caches(w: LaneWindow) -> None:
    """Drop a window's memoized decode arrays (inflated units + native
    index concatenations) — pure memo, recomputed on re-entry.  On dense
    1080p content the units alone are ~44 MB/window, so anything that
    walks many windows must bound how many stay warm."""
    for attr in ("_units_cache", "_native_arrays_cache"):
        if hasattr(w, attr):
            delattr(w, attr)


def compose_window_host(w: LaneWindow, X: int, Y: int,
                        prev: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode one window on the host → frames [T, Y, X] u32.

    prev: carry-in plane ([Y, X] u32) for mid-stream windows; None for
    restart (keyframe-led) windows or stream start."""
    out = np.empty((w.T, Y, X), dtype=np.uint32)
    for t, cur in enumerate(compose_steps(w, X, Y, prev)):
        out[t] = cur
    return out


def iter_frames(cont: LaneContainer,
                frame_range: Optional[tuple] = None
                ) -> Iterator[np.ndarray]:
    """Decode a container on the host, yielding [Y, X] u32 frames.

    frame_range=(t0, t1) clips the output; decode starts at the last
    restart (keyframe-led) window at or before t0 — the lane analog of
    seek-from-nearest-keyframe (Manager.hx:244-249) — and carries chain
    through any non-restart windows in between."""
    t0, t1 = frame_range if frame_range is not None else (0, cont.n_frames)
    bases = cont.window_bases()
    start_wi = 0
    for wi, w in enumerate(cont.windows):
        if w.restart and bases[wi] <= t0:
            start_wi = wi
    carry = None
    for wi in range(start_wi, len(cont.windows)):
        w = cont.windows[wi]
        if bases[wi] >= t1:
            break
        cur = None
        # frames before t0 are walked in place (start=...) — they are
        # never yielded, so the scratch aliasing is invisible to callers
        for i, cur in enumerate(compose_steps(
                w, cont.X, cont.Y, None if w.restart else carry,
                start=max(0, t0 - bases[wi]))):
            if t0 <= bases[wi] + i < t1:
                yield cur
        carry = cur
        # batch walk is one-shot per window: drop its memoized decode
        # arrays so a long container doesn't accumulate them all
        clear_window_caches(w)


class LaneHostCodec(VideoCodec):
    """VideoCodec facade over the host lane decode — what lets the full
    Manager/Player surface (decode-ahead ring, seek, skip-stills,
    thumbnails; Manager.hx:454-539) play `.jlv` lane containers
    unchanged.  Frame "chunks" are 4-byte little-endian frame indices
    minted by core.lane_loader.LaneDataLoader.

    Like the native SP decoder, the codec composes into ONE persistent
    plane (compose_steps with start=T — every changed frame writes only
    its painted rects in place) and copies it into the Manager's ring
    buffer per decompress call.  The previous design cached a fresh copy
    of every changed frame per window; at 1080p those full-plane copies
    dominated lane seek latency (Main.hx:1220-1226 probe).  Backward scrubs inside a window re-enter
    it from its retained entry carry; stills cost nothing."""

    # plane-LRU budget: ~6 planes at 1080p, same order as the loader's
    # 50 MB window budget (DataLoaderAVIIndexed.hx memory cap)
    CARRY_CACHE_BYTES = 48 << 20
    # intra-window checkpoint stride (local frames).  Long dense windows
    # (keyframe-snapped: up to KEYEVERY frames of near-full-frame paints)
    # make far-from-key seeks pay up to stride*paint per REPEAT visit;
    # one ~8 MB plane copy per 16 frames during the forward walk bounds
    # that replay to <stride paints (the dense-corpus seek max).
    CKPT_STRIDE = 16
    # windows whose memoized decode arrays (inflated units, native index
    # concatenations) stay resident — ~44 MB/window on dense 1080p, so a
    # long interactive scrub must not keep every visited window warm
    WARM_WINDOWS = 4

    def __init__(self, cont: LaneContainer):
        from .. import native as _native

        self.cont = cont
        self._bases: list[int] = cont.window_bases()
        self._prev: Optional[np.ndarray] = None
        # in-place compose state: one live generator + its scratch plane
        self._wi = -2                 # window of the open generator
        self._lt = -1                 # last composed local frame in _wi
        self._gen: Optional[Iterator[np.ndarray]] = None
        self._plane: Optional[np.ndarray] = None
        self._entry_carry = None  # _wi's carry-in (plane, None, or _LAZY)
        self._carry: Optional[np.ndarray] = None  # last COMPLETED window's
        self._carry_wi = -2                       # final plane
        # native walk: the C compose replaces the per-frame numpy body
        # (a full-plane numpy pass per changed frame → rect memcpy); one
        # pooled scatter
        # scratch per codec (zero invariant preserved by the native call)
        self._use_native = _native.lane_compose_available()
        self._pool: Optional[np.ndarray] = None
        # LRU of composed planes keyed (wi, local_frame): window EXIT
        # carries at (wi, T-1) plus intra-window CHECKPOINTS every
        # CKPT_STRIDE frames.  A cold mid-chain seek rebuilds the carry
        # chain from the restart window once, parking every exit plane on
        # the way; a far-from-key seek into a long dense window parks
        # stride snapshots on its forward walk.  Repeat seeks then start
        # from the nearest cached plane instead of replaying the chain or
        # the window head (the dense-corpus seek max).  Both kinds are deterministic: a window's
        # entry state is a pure function of the container, so a cached
        # plane is valid for every future entry.  Exit carries are stable
        # references (every _open/window_carry copies its carry-in; a
        # completed window's plane is never mutated again); checkpoints
        # are copies (the open window's plane keeps mutating in place).
        self._carry_cache: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._warm: OrderedDict[int, None] = OrderedDict()  # wi → caches live

    # -- chunk helpers ---------------------------------------------------------

    @staticmethod
    def frame_chunk(t: int) -> bytes:
        """The loader-side mint for frame t's CompressedFrame.data."""
        return struct.pack("<I", t)

    def _cache_plane(self, wi: int, lt: int, plane: np.ndarray) -> None:
        """Park window wi's composed plane AT local frame lt in the LRU.
        lt == T-1 is the window's exit carry (a stable reference);
        lt < T-1 is an intra-window checkpoint (caller passes a copy)."""
        key = (wi, lt)
        self._carry_cache[key] = plane
        self._carry_cache.move_to_end(key)
        budget = self.CARRY_CACHE_BYTES
        while (len(self._carry_cache) > 1
               and len(self._carry_cache) * plane.nbytes > budget):
            self._carry_cache.popitem(last=False)

    def _mark_warm(self, wi: int) -> None:
        """Window wi's decode memos are live; evict the least-recent
        warm window's memos beyond the budget (never the open window)."""
        self._warm[wi] = None
        self._warm.move_to_end(wi)
        while len(self._warm) > self.WARM_WINDOWS:
            old = next((k for k in self._warm if k != self._wi), None)
            if old is None:
                break
            del self._warm[old]
            clear_window_caches(self.cont.windows[old])

    def _best_ckpt(self, wi: int, lt: int):
        """Latest cached plane of window wi at or before local frame lt
        → (local_frame, plane) or None.  O(cache) scan — the LRU holds a
        handful of planes by budget."""
        best = None
        for (cwi, clt), plane in self._carry_cache.items():
            if cwi == wi and clt <= lt and (best is None or clt > best[0]):
                best = (clt, plane)
        if best is not None:
            self._carry_cache.move_to_end((wi, best[0]))
        return best

    def _locate(self, data: bytes) -> tuple[int, int]:
        t = struct.unpack("<I", data)[0]
        wi = bisect.bisect_right(self._bases, t) - 1
        return wi, t - self._bases[wi]

    def _open(self, wi: int, carry, ckpt: Optional[tuple] = None) -> None:
        w = self.cont.windows[wi]
        self._wi, self._lt = wi, -1
        self._mark_warm(wi)
        # stable: both walks copy their carry-in.  May be the _LAZY
        # sentinel when opening at a checkpoint (resolved by _frame via
        # _carry_in only if a scrub later lands below every checkpoint).
        self._entry_carry = carry
        if self._use_native:
            self._gen = None
            if ckpt is not None:  # resume at a cached (local_frame, plane)
                self._lt, plane = ckpt
                self._plane = plane.astype(np.uint32)  # astype copies
            else:
                assert carry is not _LAZY
                self._plane = (carry.astype(np.uint32)
                               if carry is not None
                               else np.zeros((self.cont.Y, self.cont.X),
                                             np.uint32))
            if self._pool is None:
                self._pool = np.zeros(
                    self.cont.Y * plane_cols(self.cont.X), np.uint32)
        else:
            assert ckpt is None and carry is not _LAZY
            self._gen = compose_steps(w, self.cont.X, self.cont.Y, carry,
                                      start=w.T)

    def _advance_to(self, lt: int) -> None:
        """Compose forward through local frame lt (inclusive)."""
        if self._lt >= lt:
            return
        if self._use_native:
            w = self.cont.windows[self._wi]
            assert self._plane is not None and self._pool is not None
            # walk in stride-sized legs, snapshotting the plane at each
            # stride boundary (cheap vs the paints it saves on repeat
            # far-from-key seeks; exit plane is cached by reference below)
            S = self.CKPT_STRIDE
            nxt = self._lt + 1
            while nxt <= lt:
                b = min(lt, (nxt // S + 1) * S - 1)
                native_compose_range(w, self.cont.X, self.cont.Y,
                                     self._plane, self._pool, nxt, b + 1)
                self._lt = b
                if (b + 1) % S == 0 and b + 1 < w.T:
                    self._cache_plane(self._wi, b, self._plane.copy())
                nxt = b + 1
        else:
            while self._lt < lt:
                self._advance()
        if self._lt + 1 == self.cont.windows[self._wi].T:
            # window complete → the plane is never mutated again (a new
            # _open allocates/copies fresh); record it as the next
            # window's carry-in
            self._carry = self._plane
            self._carry_wi = self._wi
            self._cache_plane(self._wi, self._lt, self._plane)

    def _advance(self) -> None:
        assert self._gen is not None
        self._plane = next(self._gen)
        self._lt += 1
        if self._lt + 1 == self.cont.windows[self._wi].T:
            # generator exhausted → its scratch is never mutated again;
            # record it as the next window's carry-in
            self._carry = self._plane
            self._carry_wi = self._wi
            self._cache_plane(self._wi, self._lt, self._plane)

    def _carry_in(self, wi: int) -> Optional[np.ndarray]:
        """Window wi's entry carry: None for restart windows; else the
        previous window's exit plane — drained from the open window,
        taken from the LRU, or rebuilt from the chain's restart window
        (parking every exit computed on the way)."""
        w = self.cont.windows[wi]
        if w.restart:
            return None
        if self._wi == wi - 1:
            # drain the open window for its carry: remaining stills are
            # free, changed frames paint in place
            self._advance_to(self.cont.windows[self._wi].T - 1)
        if self._carry_wi == wi - 1:
            return self._carry
        # cold mid-chain entry: rebuild from the nearest cached exit
        # carry at or after the chain's restart
        j = wi
        while j > 0 and not self.cont.windows[j].restart:
            j -= 1
        k0, carry = j, None
        for k in range(wi - 1, j - 1, -1):
            hit = self._carry_cache.get((k, self.cont.windows[k].T - 1))
            if hit is not None:
                self._carry_cache.move_to_end(
                    (k, self.cont.windows[k].T - 1))
                k0, carry = k + 1, hit
                break
        for k in range(k0, wi):
            wk = self.cont.windows[k]
            carry = window_carry(wk, self.cont.X, self.cont.Y,
                                 None if wk.restart else carry)
            self._cache_plane(k, wk.T - 1, carry)
            self._mark_warm(k)
        return carry

    def _frame(self, wi: int, lt: int) -> np.ndarray:
        """Frame lt of window wi, composed in place up to it.  Seek
        latency is proportional to the painted rects of the CHANGED
        frames between the NEAREST cached plane (checkpoint/exit carry)
        and lt — not to window length, and not to full planes
        (Main.hx:1220-1226's cost model on the lane path)."""
        # nearest cached plane of the TARGET window at/before lt — skips
        # the within-window replay (native walk only; the generator
        # can't resume mid-window)
        ck = self._best_ckpt(wi, lt) if self._use_native else None
        if wi == self._wi and lt >= self._lt:
            # forward: a checkpoint must skip >1 frame to beat composing
            # (a resume costs one full-plane copy ≈ one dense paint)
            if ck is not None and ck[0] > self._lt + 1:
                self._open(wi, self._entry_carry, ck)
        elif ck is not None:
            # the checkpoint supersedes the entry carry for this open;
            # defer the (possibly chain-long) carry rebuild until a scrub
            # actually lands below every checkpoint
            self._open(wi, self._entry_carry if wi == self._wi else _LAZY,
                       ck)
        elif wi == self._wi:  # backward scrub below every checkpoint
            carry = self._entry_carry
            if carry is _LAZY:
                carry = self._carry_in(wi)
            self._open(wi, carry)
        else:
            self._open(wi, self._carry_in(wi))
        self._advance_to(lt)
        assert self._plane is not None
        return self._plane

    # -- VideoCodec contract (IVideoCodec.hx:16-29) ----------------------------

    def preinit(self, insignificant_lines: int) -> None:
        pass  # signif verdicts are precomputed in the container

    def previous_frame(self) -> Optional[np.ndarray]:
        return self._prev

    def is_key_frame(self, data: bytes) -> bool:
        wi, lt = self._locate(data)
        return bool(self.cont.windows[wi].restart and lt == 0)

    def needs_index(self) -> bool:
        return False

    def decompress_i(self, src: bytes, dst: np.ndarray) -> DecoderState:
        wi, lt = self._locate(src)
        dst[:] = self._frame(wi, lt).reshape(-1)
        self._prev = dst
        return DecoderState.ZERO

    def decompress_p(self, src: bytes, dst: np.ndarray) -> PFrameResult:
        wi, lt = self._locate(src)
        w = self.cont.windows[wi]
        sig = bool(w.signif[lt])
        if not w.changed[lt] and self._prev is not None:
            return PFrameResult(self._prev, sig)  # still: extend prev buffer
        dst[:] = self._frame(wi, lt).reshape(-1)
        self._prev = dst
        return PFrameResult(dst, sig)
