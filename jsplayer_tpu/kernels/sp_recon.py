"""ScreenPressor frame reconstruction — device kernels.

Host/device split of the reference's DecompressP (ScreenPressor.hx:302-484):
the *serial* entropy + predictor stage runs on host (codecs/screenpressor.py
or the native decoder) and emits per-frame command tensors; the *memory-heavy*
frame composition runs on device:

    out[y,x] = prev[y+my, x+mx]   if pixel in a motion block's rect
             = payload[y,x]       if pixel in a data block's rect
             = prev[y,x]          otherwise (copy / outside subrect)

Implementations (none has been timed on the GPU yet; chip_smoke.py's
Phase E times the first two composes on one 1080p window):
  * **kmv** (production): the host groups motion blocks by distinct vector
    into K slots; the device composes with `jnp.roll` + selects over a
    single packed u32 paycode plane (pixel|type|kslot) — gather-free;
    still-elision (`compact_changed`) keeps unchanged frames out of the
    scan.  `prepare_kmv`/`prepare_kmv_sparse` have native C++ twins that
    emit the transport during decode (native/spdec.cpp sp_decompress_kmv*).
  * **kmv-sparse**: per-block codes + final-content payload tiles — same
    compose plus a dynamic_update_slice tile pass; built for link-fed
    serving (tens of KB per typical frame instead of the 8.3 MB plane).
  * the general XLA path here (`compose_frame`): per-block commands expand
    to per-pixel maps via *structured broadcasts* (16×16 tiles); the motion
    read is a per-pixel gather — fully general.

The P-chain's true data dependency (prev-frame reads, ScreenPressor.hx:379,
404,442,472) is a `lax.scan` carry.  Batching over streams UNROLLS in
Python — never vmap the kmv scan (batched-dynamic roll shifts lower to
gathers).  Arbitrary frame sizes work (1080p runs unpadded); block maps
are ceil-divided and broadcasts crop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def block_broadcast(vals: jax.Array, nby: int, nbx: int, Y: int, X: int) -> jax.Array:
    """Per-block values [NB, ...] → per-pixel [Y, X, ...] via structured
    broadcast over 16×16 tiles (no gather)."""
    tail = vals.shape[1:]
    v = vals.reshape(nby, 1, nbx, 1, *tail)
    v = jnp.broadcast_to(v, (nby, 16, nbx, 16, *tail))
    v = v.reshape(nby * 16, nbx * 16, *tail)
    return v[:Y, :X]


def compose_frame(
    prev: jax.Array,  # [Y, X] uint32
    bts: jax.Array,  # [NB] int32
    mv: jax.Array,  # [NB, 2] int32
    rect: jax.Array,  # [NB, 4] int32
    payload: jax.Array,  # [Y, X] uint32
) -> jax.Array:
    Y, X = prev.shape
    nbx = (X + 15) // 16
    nby = (Y + 15) // 16
    yy = jax.lax.broadcasted_iota(jnp.int32, (Y, X), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (Y, X), 1)

    b = block_broadcast(bts, nby, nbx, Y, X)  # [Y, X]
    r = block_broadcast(rect, nby, nbx, Y, X)  # [Y, X, 4]
    in_rect = (
        (xx >= r[..., 0]) & (xx < r[..., 2]) & (yy >= r[..., 1]) & (yy < r[..., 3])
    )
    active = (b > 0) & in_rect
    is_motion = active & (((b - 1) & 2) > 0)
    is_data = active & (((b - 1) & 2) == 0)

    m = block_broadcast(mv, nby, nbx, Y, X)  # [Y, X, 2]
    src_y = jnp.clip(yy + m[..., 1], 0, Y - 1)
    src_x = jnp.clip(xx + m[..., 0], 0, X - 1)
    moved = prev.reshape(-1)[(src_y * X + src_x).reshape(-1)].reshape(Y, X)

    return jnp.where(is_motion, moved, jnp.where(is_data, payload, prev))


def _scan_decode(init_frame, bts, mv, rect, payload, changed,
                 insignificant_blocks):
    def step(prev, inp):
        b, m, r, pay, chg = inp
        composed = compose_frame(prev, b, m, r, pay)
        out = jnp.where(chg, composed, prev)
        sig_mask = jnp.arange(b.shape[0]) >= insignificant_blocks
        signif = jnp.logical_and(chg, ((b > 0) & sig_mask).any())
        return out, (out, signif)

    _, (frames, signif) = jax.lax.scan(
        step, init_frame, (bts, mv, rect, payload, changed)
    )
    return frames, signif


@jax.jit
def decode_sequence(
    init_frame: jax.Array,  # [Y, X] uint32
    bts: jax.Array,  # [T, NB] int32
    mv: jax.Array,  # [T, NB, 2] int32
    rect: jax.Array,  # [T, NB, 4] int32
    payload: jax.Array,  # [T, Y, X] uint32
    changed: jax.Array,  # [T] bool
    insignificant_blocks: jax.Array,  # scalar int32
) -> tuple[jax.Array, jax.Array]:
    """Decode T consecutive frames of one stream → (frames [T,Y,X], signif [T]).

    The significant-change verdict mirrors ScreenPressor.hx:346-352
    (block-map scan above the insignificant band)."""
    return _scan_decode(init_frame, bts, mv, rect, payload, changed,
                        insignificant_blocks)


@jax.jit
def decode_batch(
    init_frames: jax.Array,  # [B, Y, X] uint32
    bts: jax.Array,  # [B, T, NB]
    mv: jax.Array,  # [B, T, NB, 2]
    rect: jax.Array,  # [B, T, NB, 4]
    payload: jax.Array,  # [B, T, Y, X]
    changed: jax.Array,  # [B, T]
    insignificant_blocks: jax.Array,  # scalar int32
) -> tuple[jax.Array, jax.Array]:
    """Batched multi-stream decode (DP axis via vmap)."""
    return jax.vmap(_scan_decode, in_axes=(0, 0, 0, 0, 0, 0, None))(
        init_frames, bts, mv, rect, payload, changed, insignificant_blocks
    )


# ---------------------------------------------------------------------------
# K-distinct-motion-vector compose (gather-free XLA path)
# ---------------------------------------------------------------------------
#
# Screen content typically reuses one or two motion vectors per frame (the
# reference encodes a repeat-last-vector flag for exactly this reason,
# ScreenPressor.hx:392-394).  The host groups full-block motion commands by
# distinct vector into K slots (overflow blocks are demoted to data blocks —
# the payload always carries the decoded pixels); the device then composes
# with K structured rolls + selects, no arbitrary gather anywhere.

def derive_kmv_commands(bts, mv, rect, K: int = 4):
    """numpy host step: [T,...] commands → (mvk [T,K,2], group [T,NB] int32
    in [-1, K), data_mask_extra: blocks demoted to data).  group == -1 means
    not motion.  Motion blocks are bts 3 (full block) AND 4 (subrect motion,
    (bts-1)&2 — the encoder's common shape for scrolls over flat regions);
    for bts 4 the roll applies only inside the captured rect."""
    import numpy as _np

    T, NB = bts.shape
    mvk = _np.zeros((T, K, 2), dtype=_np.int32)
    group = _np.full((T, NB), -1, dtype=_np.int32)
    demoted = _np.zeros((T, NB), dtype=bool)
    for t in range(T):
        motion = _np.nonzero((bts[t] == 3) | (bts[t] == 4))[0]
        if motion.size == 0:
            continue
        vecs, inv, counts = _np.unique(
            mv[t, motion], axis=0, return_inverse=True, return_counts=True)
        order = _np.argsort(-counts)[:K]
        remap = _np.full(len(vecs), -1, dtype=_np.int32)
        for slot, vi in enumerate(order):
            remap[vi] = slot
            mvk[t, slot] = vecs[vi]
        g = remap[inv]
        group[t, motion] = g
        demoted[t, motion[g < 0]] = True
    return mvk, group, demoted


def compose_frame_kmv(prev, paycode, mvk):
    """Single-input compose: paycode packs pixel (24b) | type (2b: 0 copy,
    1 data, 2 motion) | k-slot (3b) into one u32 — one streamed read per
    source instead of separate mask/group planes (the select masks are
    register-resident bit tests, so per-frame memory traffic is paycode + prev
    + out ≈ 3 planes)."""
    ptype = (paycode >> 24) & 3
    payload = paycode & jnp.uint32(0x00FFFFFF)
    out = jnp.where(ptype == 1, payload, prev)
    K = mvk.shape[0]
    kslot = (paycode >> 26) & 7
    is_motion = ptype == 2
    for k in range(K):
        shifted = jnp.roll(prev, shift=(-mvk[k, 1], -mvk[k, 0]), axis=(0, 1))
        out = jnp.where(is_motion & (kslot == k), shifted, out)
    return out


def _scan_decode_kmv(init_frame, paycode, mvk, changed):
    """signif computed by the host."""

    def step(prev, inp):
        pc, mk, chg = inp
        # the still-reuse is a select, not a lax.cond skip branch: stills
        # that matter are elided before the scan (compact_changed), and a
        # cond inside the scan body costs a control-flow round trip per step
        out = jnp.where(chg, compose_frame_kmv(prev, pc, mk), prev)
        return out, out

    _, frames = jax.lax.scan(step, init_frame, (paycode, mvk, changed))
    return frames


def prepare_kmv(bts, mv, rect, payload, K: int = 4):
    """Host prep (numpy): → (paycode [T,Y,X] u32, mvk [T,K,2]).  Demoted-
    motion and subrect/data blocks all read from payload; rect masks and the
    motion k-slot are packed into paycode's top byte."""
    import numpy as _np

    T, NB = bts.shape
    Y, X = payload.shape[-2:]
    # ceil-divided like the capture's block grid (ScreenPressor.hx:361:
    # edge blocks exist whenever 16 doesn't divide the frame) — floor
    # division misindexed every command at/below the partial edge band
    nby, nbx = (Y + 15) // 16, (X + 15) // 16
    assert K <= 8, "k-slot field is 3 bits"
    mvk, group, demoted = derive_kmv_commands(bts, mv, rect, K)
    yy, xx = _np.mgrid[0:Y, 0:X]
    bi = (yy >> 4) * nbx + (xx >> 4)
    out_pc = _np.empty((T, Y, X), dtype=_np.uint32)
    for t in range(T):
        b = bts[t][bi]
        r = rect[t][bi]
        in_rect = ((xx >= r[..., 0]) & (xx < r[..., 2])
                   & (yy >= r[..., 1]) & (yy < r[..., 3]))
        is_mot_block = (b == 3) | (b == 4)
        is_data = (b > 0) & ~is_mot_block & in_rect
        is_data |= demoted[t][bi]
        gp = _np.where(demoted[t][bi], -1, group[t][bi])
        is_motion = (gp >= 0) & in_rect  # bts 4: roll only inside the rect
        ptype = _np.where(is_data, 1, _np.where(is_motion, 2, 0)).astype(_np.uint32)
        kbits = _np.where(is_motion, gp, 0).astype(_np.uint32)
        # pixel bits only where ptype==1 — compose_frame_kmv never reads
        # them elsewhere, and the zero convention is what lets the native
        # twin fill planes incrementally (spdec.cpp fill_paycode_p)
        pix = _np.where(is_data, payload[t] & 0x00FFFFFF, 0).astype(_np.uint32)
        out_pc[t] = pix | (ptype << 24) | (kbits << 26)
    return out_pc, mvk


@jax.jit
def decode_sequence_kmv(init_frame, paycode, mvk, changed):
    return _scan_decode_kmv(init_frame, paycode, mvk, changed)


# ---------------------------------------------------------------------------
# Block-command ("bc") compose: per-block types/rects instead of per-pixel
# ptype bits.
#
# The kmv paycode packs ptype/kslot into every PIXEL, so the host must fill
# motion blocks (constant words) and clear stale blocks (dirty tracking).
# Here the block structure rides two small arrays — bcode [NB] u8
# (0 copy / 1 data / 2+k motion-slot) and block-local rects [NB, 4] u8 —
# broadcast to pixels on device (structured broadcasts are ~free), and the
# u32 plane carries ONLY data-rect pixels: bytes outside data rects are
# never read, so the host fill writes just the data pixels — no clears, no
# motion fills, no dirty state (fill_paycode_p's cost collapses on
# motion/scroll content).  Same per-frame device traffic as kmv (one
# plane read).

def prepare_bc(bts, mv, rect, payload, K: int = 4):
    """Host prep (numpy reference): → (plane [T,Y,X] u32, bcode [T,NB] u8,
    rloc [T,NB,4] u8, mvk [T,K,2]).  The plane here is simply the decoded
    frame (data pixels are a subset); the native twin writes only data-rect
    pixels — both are valid bc transports because non-data plane bytes are
    never read."""
    import numpy as _np

    T, NB = bts.shape
    Y, X = payload.shape[-2:]
    nbx = (X + 15) // 16
    mvk, group, demoted = derive_kmv_commands(bts, mv, rect, K)
    bcode = _np.zeros((T, NB), dtype=_np.uint8)
    rloc = _np.zeros((T, NB, 4), dtype=_np.uint8)
    bxy = _np.empty((NB, 4), dtype=_np.int64)
    bxy[:, 0] = bxy[:, 2] = (_np.arange(NB) % nbx) * 16
    bxy[:, 1] = bxy[:, 3] = (_np.arange(NB) // nbx) * 16
    for t in range(T):
        loc = _np.clip(rect[t] - bxy, 0, 16).astype(_np.uint8)
        is_mot = (bts[t] == 3) | (bts[t] == 4)
        data_blk = (bts[t] > 0) & ~is_mot & ~demoted[t]
        bcode[t, data_blk] = 1
        rloc[t, data_blk] = loc[data_blk]
        bcode[t, demoted[t]] = 1
        rloc[t, demoted[t]] = (0, 0, 16, 16)
        mot = (group[t] >= 0) & ~demoted[t]
        bcode[t, mot] = (2 + group[t, mot]).astype(_np.uint8)
        rloc[t, mot] = loc[mot]
    plane = (payload & _np.uint32(0x00FFFFFF)).astype(_np.uint32)
    return plane, bcode, rloc, mvk


def bc_row_map(bcode, rect, nby: int, nbx: int, X: int):
    """Per-block commands → a packed [nby, X] u32 ROW MAP:
    ``btype | y1<<8 | y2<<16`` per column, with the x-rect folded in
    (columns outside a block's x-rect read 0 = copy).

    Built ON DEVICE from the tiny [NB] arrays — all ops touch ≤NBx16
    elements.  The per-pixel expansion is then rows-only (see
    row_expand): it never splits the minor (X) dimension the way
    block_broadcast's (nbx,16) split does, and never builds a [Y,X,4]
    rect broadcast with a tiny trailing dim."""
    bt = bcode.reshape(nby, nbx).astype(jnp.uint32)
    r = rect.reshape(nby, nbx, 4).astype(jnp.uint32)
    lx = jax.lax.broadcasted_iota(jnp.uint32, (nby, nbx, 16), 2)
    act = (lx >= r[..., 0, None]) & (lx < r[..., 2, None])
    packed = jnp.where(
        act, bt[..., None] | (r[..., 1, None] << 8) | (r[..., 3, None] << 16),
        0)
    return packed.reshape(nby, nbx * 16)[:, :X]


def row_expand(rows, Y: int, X: int):
    """[nby, X] → [Y, X]: repeat each row 16x (a reshape that merges major
    dims — contiguous, cheap; never splits the minor dim)."""
    nby = rows.shape[0]
    v = jnp.broadcast_to(rows[:, None, :], (nby, 16, X))
    return v.reshape(nby * 16, X)[:Y]


def compose_frame_bc(prev, plane, bcode, rect, mvk):
    """plane [Y,X] u32 (data pixels only), bcode [NB] u8, rect [NB,4] u8
    block-local, mvk [K,2] i32 — pixel semantics identical to
    compose_frame_kmv (ScreenPressor.hx:302-484 block model).  The block
    structure reaches pixels through ONE packed row map + a rows-only
    expansion (see bc_row_map)."""
    Y, X = prev.shape
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    rowv = row_expand(bc_row_map(bcode, rect, nby, nbx, X), Y, X)
    bt = rowv & 0xFF
    y1 = (rowv >> 8) & 0xFF
    y2 = (rowv >> 16) & 0xFF
    ly = (jax.lax.broadcasted_iota(jnp.uint32, (Y, X), 0)) & 15
    in_y = (ly >= y1) & (ly < y2)
    out = jnp.where((bt == 1) & in_y, plane & jnp.uint32(0x00FFFFFF), prev)
    K = mvk.shape[0]
    for k in range(K):
        shifted = jnp.roll(prev, shift=(-mvk[k, 1], -mvk[k, 0]), axis=(0, 1))
        out = jnp.where((bt == 2 + k) & in_y, shifted, out)
    return out


@jax.jit
def decode_sequence_bc_compact(init_frame, plane, bcode, rect, mvk):
    """bc scan over changed frames only (still-elision layout)."""

    def step(prev, inp):
        pl_, bc, r, mk = inp
        out = compose_frame_bc(prev, pl_, bc, r, mk)
        return out, out

    _, frames = jax.lax.scan(step, init_frame, (plane, bcode, rect, mvk))
    return frames


@jax.jit
def decode_sequence_bc(init_frame, plane, bcode, rect, mvk, changed):
    def step(prev, inp):
        pl_, bc, r, mk, chg = inp
        out = jnp.where(chg, compose_frame_bc(prev, pl_, bc, r, mk), prev)
        return out, out

    _, frames = jax.lax.scan(step, init_frame,
                             (plane, bcode, rect, mvk, changed))
    return frames


@jax.jit
def decode_batch_bc(init_frames, plane, bcode, rect, mvk, changed):
    """Batched bc scan (unrolled over B — see decode_batch_kmv)."""
    outs = [decode_sequence_bc(init_frames[b], plane[b], bcode[b], rect[b],
                               mvk[b], changed[b])
            for b in range(plane.shape[0])]
    return jnp.stack(outs)


def _scan_decode_bc_model(init_frame, plane, bcode, rect, mvk, changed,
                          model_kw):
    emit, finish = _model_emit(model_kw)

    def step(prev, inp):
        pl_, bc, r, mk, chg = inp
        out = jnp.where(chg, compose_frame_bc(prev, pl_, bc, r, mk), prev)
        return out, emit(out)

    last, model = jax.lax.scan(step, init_frame,
                               (plane, bcode, rect, mvk, changed))
    return last, finish(model)


@functools.partial(jax.jit,
                   static_argnames=("dtype", "layout", "downscale", "bpp16",
                                    "packed"))
def decode_batch_bc_model(init_frames, plane, bcode, rect, mvk, changed,
                          dtype=jnp.bfloat16, layout="NHWC", downscale=1,
                          bpp16=False, packed=False):
    """Batched bc decode fused straight into model tensors."""
    kw = dict(dtype=dtype, layout=layout, downscale=downscale, bpp16=bpp16,
              packed=packed)
    res = [_scan_decode_bc_model(init_frames[b], plane[b], bcode[b], rect[b],
                                 mvk[b], changed[b], kw)
           for b in range(plane.shape[0])]
    return (jnp.stack([r[0] for r in res]),
            jnp.stack([r[1] for r in res]))


def compact_arrays_batch(arrays, changed):
    """Batched still-elision over an arbitrary tuple of [B, T, ...] arrays
    (the generalization of compact_changed_batch for transports with more
    than two per-frame inputs).  → (compacted tuple, valid [B,Cpad],
    outmap [B,T])."""
    import numpy as _np

    changed = _np.asarray(changed, dtype=bool)
    B, T = changed.shape
    counts = changed.sum(axis=1)
    cpad = _elision_bucket(int(counts.max(initial=0)), T)
    outs = [_np.zeros((B, cpad) + a.shape[2:], dtype=a.dtype) for a in arrays]
    valid = _np.zeros((B, cpad), dtype=bool)
    outmap = _np.empty((B, T), dtype=_np.int32)
    for b in range(B):
        idx = _np.nonzero(changed[b])[0]
        c = len(idx)
        for o, a in zip(outs, arrays):
            o[b, :c] = a[b, idx]
        valid[b, :c] = True
        outmap[b] = _np.cumsum(changed[b]).astype(_np.int32) - 1
    return tuple(outs), valid, outmap


def compact_changed(paycode, mvk, changed):
    """Still-elision (host, numpy): drop unchanged frames from the device
    scan — stills don't alter the P-chain carry, so decoding only changed
    frames is exact.  Returns (paycode', mvk', outmap) where outmap[t] is
    the compacted index holding original frame t's pixels (-1 → the init
    frame).  This is the device-side analogue of the reference's SkipStills
    (Manager.hx:383-441): screen content is mostly stills, and the player
    never re-decodes them."""
    import numpy as _np

    changed = _np.asarray(changed, dtype=bool)
    idx = _np.nonzero(changed)[0]
    outmap = _np.cumsum(changed).astype(_np.int32) - 1
    return paycode[idx], mvk[idx], outmap


def _elision_bucket(n: int, cap: int, nbuckets: int = 8) -> int:
    """Round n up to one of `nbuckets` linear bucket sizes (0 stays 0),
    capped at `cap` — bounds the set of compacted scan lengths, and
    therefore jit recompiles, to nbuckets+1 shapes per geometry while
    wasting at most cap/nbuckets pad slots (power-of-two buckets would
    waste up to 2x, erasing the elision win for half-changed windows)."""
    if n <= 0:
        return 0
    step = -(-cap // nbuckets)
    return min(-(-n // step) * step, cap)


def compact_changed_batch(paycode, mvk, changed):
    """Batched still-elision (host, numpy): per-stream compaction of the
    changed frames, padded to a shared bucketed length so ONE masked scan
    program serves the whole batch (and, under shard_map, every
    device).  Returns (paycode' [B,Cpad,...], mvk' [B,Cpad,...],
    valid [B,Cpad] bool, outmap [B,T] i32) where outmap[b,t] is the
    compacted index holding stream b's original frame t (-1 → the window's
    carry-in frame).  Pad slots have valid=False: the kmv scan's changed
    mask passes the carry through them, so frames[:, -1] stays the correct
    next-window carry for every stream, including all-stills ones.

    This is the batch-scale analogue of the reference's identical-frame
    buffer ranges (Manager.hx:568-578): stills never enter the device scan.
    """
    import numpy as _np

    changed = _np.asarray(changed, dtype=bool)
    B, T = changed.shape
    counts = changed.sum(axis=1)
    cpad = _elision_bucket(int(counts.max(initial=0)), T)
    pcc = _np.zeros((B, cpad) + paycode.shape[2:], dtype=paycode.dtype)
    mvkc = _np.zeros((B, cpad) + mvk.shape[2:], dtype=mvk.dtype)
    valid = _np.zeros((B, cpad), dtype=bool)
    outmap = _np.empty((B, T), dtype=_np.int32)
    for b in range(B):
        idx = _np.nonzero(changed[b])[0]
        c = len(idx)
        pcc[b, :c] = paycode[b, idx]
        mvkc[b, :c] = mvk[b, idx]
        valid[b, :c] = True
        outmap[b] = _np.cumsum(changed[b]).astype(_np.int32) - 1
    return pcc, mvkc, valid, outmap


def _model_emit(model_kw):
    """(in-scan emit fn, post-scan finish fn) for the fused model path.

    downscale == 2 rides the packed-plane split: the scan emits ONE packed
    [H/2, W/2] i32 plane per frame (rgb_convert.ds2_pack, plain XLA)
    with the vertical flip applied as a ROW GATHER on the small plane
    inside the scan, and the unpack/normalize/NHWC runs once on the small
    stack outside behind an optimization_barrier, which keeps XLA from
    co-scheduling the unpack into the scan body.  The scan thus carries
    the smallest per-frame product.  Other downscale factors keep the
    original in-scan to_model_input."""
    from .rgb_convert import ds2_pack, to_model_input, unpack_ds2

    packed = model_kw.pop("packed", False) if isinstance(model_kw, dict) \
        else False
    if model_kw.get("downscale") == 2:
        kw = {k: v for k, v in model_kw.items() if k != "downscale"}
        flip = kw.pop("flip_vertical", True)

        def emit(out):
            red = ds2_pack(out)
            if flip:
                idx = jnp.arange(red.shape[-2] - 1, -1, -1)
                red = jnp.take(red, idx, axis=-2)
            return red

        if packed:
            # the packed plane IS the product (rgb_convert.ds2_packed_output
            # contract): the consumer fuses unpack_ds2 into its model
            return emit, (lambda red: red)

        def finish(red):
            red = jax.lax.optimization_barrier(red)
            return unpack_ds2(red, flip_vertical=False, **kw)

        return emit, finish
    assert not packed, "model_packed requires downscale == 2"
    return (lambda out: to_model_input(out, **model_kw)), (lambda m: m)


def _scan_decode_kmv_model(init_frame, paycode, mvk, changed, model_kw):
    """kmv scan emitting ONLY fused model tensors (no full-res frame stack):
    the scan's ys are the downstream tensors, so per-frame HBM traffic drops
    by the 4-byte full-res output write + its later re-read (the ML-ingestion
    shape: SURVEY.md §7 step 8 — decoded pixels never leave the device)."""
    emit, finish = _model_emit(model_kw)

    def step(prev, inp):
        pc, mk, chg = inp
        out = jnp.where(chg, compose_frame_kmv(prev, pc, mk), prev)
        return out, emit(out)

    last, model = jax.lax.scan(step, init_frame, (paycode, mvk, changed))
    return last, finish(model)


@functools.partial(jax.jit,
                   static_argnames=("dtype", "layout", "downscale", "bpp16",
                                    "packed"))
def decode_batch_kmv_model(init_frames, paycode, mvk, changed,
                           dtype=jnp.bfloat16, layout="NHWC", downscale=1,
                           bpp16=False, packed=False):
    """Batched kmv decode fused straight into model tensors.
    → (carry [B,Y,X] u32 for the next window, model [B,T,...])."""
    kw = dict(dtype=dtype, layout=layout, downscale=downscale, bpp16=bpp16,
              packed=packed)
    # unrolled over B (see decode_batch_kmv: vmapped dynamic rolls gather)
    res = [_scan_decode_kmv_model(init_frames[b], paycode[b], mvk[b],
                                  changed[b], kw)
           for b in range(paycode.shape[0])]
    return (jnp.stack([r[0] for r in res]),
            jnp.stack([r[1] for r in res]))


@jax.jit
def decode_batch_kmv(init_frames, paycode, mvk, changed):
    """Batched kmv scan: init [B,Y,X], paycode [B,T,Y,X], mvk [B,T,K,2],
    changed [B,T] → frames [B,T,Y,X].

    Unrolled over B, NOT vmapped: under vmap the per-stream roll shifts
    become batched-dynamic and XLA lowers them to gathers.  Unrolled scans
    also overlap across streams within one dispatch."""
    outs = [_scan_decode_kmv(init_frames[b], paycode[b], mvk[b], changed[b])
            for b in range(paycode.shape[0])]
    return jnp.stack(outs)


@functools.partial(jax.jit, static_argnames=("dtype", "layout", "downscale",
                                              "packed"))
def decode_sequence_kmv_compact_model(init_frame, paycode, mvk,
                                      dtype=jnp.bfloat16, layout="NHWC",
                                      downscale=1, packed=False):
    """Still-elision + fused model emission: decode only changed frames,
    emit ONLY their model tensors (full ML-serving shape; pair with
    compact_changed's outmap to reconstruct the timeline).
    → (carry [Y,X] u32, model [T', ...])."""
    kw = dict(dtype=dtype, layout=layout, downscale=downscale,
              packed=packed)
    emit, finish = _model_emit(kw)

    def step(prev, inp):
        pc, mk = inp
        out = compose_frame_kmv(prev, pc, mk)
        return out, emit(out)

    last, model = jax.lax.scan(step, init_frame, (paycode, mvk))
    return last, finish(model)


@jax.jit
def decode_sequence_kmv_compact(init_frame, paycode, mvk):
    """kmv scan over changed frames only (every input frame composes)."""

    def step(prev, inp):
        pc, mk = inp
        out = compose_frame_kmv(prev, pc, mk)
        return out, out

    _, frames = jax.lax.scan(step, init_frame, (paycode, mvk))
    return frames


@functools.partial(jax.jit, static_argnames=("unroll",))
def decode_sequence_kmv_compact_unrolled(init_frame, paycode, mvk,
                                         unroll: int = 4):
    """Compact kmv scan with `unroll` composes per scan step.

    An experiment, not the production path: chaining U composes per step
    could keep intermediate frames on chip and drop traffic from 3
    planes/frame toward 2 + 1/U, but an 8.3 MB frame plus the K-roll
    temporaries outgrows on-chip memory, so the intermediates go back to
    device memory and the grouped ys writes only add work.  The
    1-frame-per-step scan (decode_sequence_kmv_compact) is the production
    path.  T must divide by `unroll`; zero paycode pads are exact
    pass-throughs (ptype==copy everywhere)."""
    T = paycode.shape[0]
    assert T % unroll == 0, (T, unroll)

    def step(prev, inp):
        pcs, mks = inp  # [U, Y, X], [U, K, 2]
        outs = []
        cur = prev
        for u in range(unroll):
            cur = compose_frame_kmv(cur, pcs[u], mks[u])
            outs.append(cur)
        return cur, jnp.stack(outs)

    _, frames = jax.lax.scan(
        step, init_frame,
        (paycode.reshape(T // unroll, unroll, *paycode.shape[1:]),
         mvk.reshape(T // unroll, unroll, *mvk.shape[1:])))
    return frames.reshape(T, *paycode.shape[1:])


# ---------------------------------------------------------------------------
# kmv-sparse: kmv motion + sparse payload tiles.
#
# The dense kmv path reads a full (Y,X) u32 paycode plane per frame even
# when only a handful of blocks carry data.  Here the per-block codes stay
# per-block ([NB] broadcast on device — structured broadcasts fuse into
# their consumer) and payload travels as M final-content 16x16 tiles applied
# with dynamic_update_slice, so per-frame traffic drops to prev + out + eps.
# Correctness hinges on `payload` being the fully decoded frame (the host
# decoder's output): a tile is the block's FINAL pixels, so overwriting the
# whole block is exact even for subrect blocks (outside-rect pixels in the
# decoded frame equal prev) and for padding tiles (block 0's final content).

def prepare_kmv_sparse(bts, mv, rect, payload, K: int = 4, M: int | None = None,
                       prev0=None):
    """Host prep (numpy): → (bcode [T,NB] u8: 0 copy / 2+k motion-slot,
    mvk [T,K,2], tiles [T,M,16,16] u32, tile_yx [T,M,2] i32).  Blocks with
    data content (bts 1/2 subrect/gradient fills, ScreenPressor.hx:317-353)
    and motion blocks demoted from the K slots become tiles; padding tiles
    re-write block 0's final content (a no-op).

    prev0: the decoded frame preceding payload[0] (the previous window's
    last frame); without it frame 0's motion blocks can't pass the slot-
    safety check and all ride as tiles."""
    import numpy as _np

    T, NB = bts.shape
    Y, X = payload.shape[-2:]
    nbx = (X + 15) // 16
    assert K <= 8
    mvk, group, demoted = derive_kmv_commands(bts, mv, rect, K)
    # The sparse compose rolls WHOLE blocks (bcode is per block), but bts 4
    # motion is rect-limited: a slot is safe iff the full-block roll
    # reproduces the decoded block (256-pixel compare vs payload[t-1] per
    # motion block — much cheaper than rolling and comparing whole frames)
    pay = payload & _np.uint32(0x00FFFFFF)
    safe = _np.zeros((T, NB), dtype=bool)
    prev0 = None if prev0 is None else (prev0 & _np.uint32(0x00FFFFFF))
    for t in range(T):
        prev = pay[t - 1] if t > 0 else prev0
        if prev is None:
            continue
        for bi in _np.nonzero(group[t] >= 0)[0]:
            by, bx = divmod(int(bi), nbx)
            y1, y2 = by * 16, min(by * 16 + 16, Y)
            x1, x2 = bx * 16, min(bx * 16 + 16, X)
            mx, my = mv[t, bi]
            if (y1 + my < 0 or y2 + my > Y or x1 + mx < 0 or x2 + mx > X):
                continue
            safe[t, bi] = bool(
                (prev[y1 + my:y2 + my, x1 + mx:x2 + mx]
                 == pay[t, y1:y2, x1:x2]).all())
    mot = group >= 0
    need_tile = (((bts > 0) & (bts != 3) & (bts != 4)) | demoted
                 | (mot & ~safe))
    counts = need_tile.sum(axis=1)
    if M is None:
        M = max(1, int(counts.max()))
    if int(counts.max()) > M:
        raise ValueError(f"M={M} < max tiles/frame {int(counts.max())}")
    bcode = _np.zeros((T, NB), dtype=_np.uint8)
    g = _np.where(demoted | ~safe, -1, group)
    bcode[g >= 0] = (2 + g[g >= 0]).astype(_np.uint8)
    tiles = _np.zeros((T, M, 16, 16), dtype=_np.uint32)
    tile_yx = _np.zeros((T, M, 2), dtype=_np.int32)
    for t in range(T):
        blocks = _np.nonzero(need_tile[t])[0]
        for m, bi in enumerate(blocks):
            by, bx = divmod(int(bi), nbx)
            # edge blocks: clamp the 16x16 window into the frame; the
            # extra rows/cols re-write the neighbor's FINAL content
            # (exact, since payload is the fully decoded frame)
            y0, x0 = min(by * 16, Y - 16), min(bx * 16, X - 16)
            tiles[t, m] = pay[t, y0:y0 + 16, x0:x0 + 16]
            tile_yx[t, m] = (y0, x0)
        # pad with block (0,0)'s final content — a no-op rewrite
        if len(blocks) < M:
            tiles[t, len(blocks):] = pay[t, :16, :16]
            tile_yx[t, len(blocks):] = 0
    return bcode, mvk, _np.ascontiguousarray(tiles), tile_yx


def compose_frame_kmv_sparse(prev, bcode, mvk, tiles, tile_yx):
    Y, X = prev.shape
    nbx = (X + 15) // 16
    nby = bcode.shape[0] // nbx
    bmap = block_broadcast(bcode.astype(jnp.int32), nby, nbx, Y, X)
    out = prev
    K = mvk.shape[0]
    for k in range(K):
        shifted = jnp.roll(prev, shift=(-mvk[k, 1], -mvk[k, 0]), axis=(0, 1))
        out = jnp.where(bmap == 2 + k, shifted, out)

    def put(frame, inp):
        tile, yx = inp
        return jax.lax.dynamic_update_slice(frame, tile, (yx[0], yx[1])), None

    out, _ = jax.lax.scan(put, out, (tiles, tile_yx))
    return out


@jax.jit
def decode_batch_kmv_sparse_ragged(init_frames, bcode, mvk, tiles_flat,
                                   tile_idx, tile_yx, changed):
    """Ragged tile transport: tiles ship as ONE flat [S,256] u32 array of
    real tiles (plus per-frame pad rows) and tile_idx [B,T,M] maps each
    scan slot to its row — the padded-per-frame layout pads every frame to
    the window max, which multiplies the transfer on mixed content.  The
    device repack is a row gather of 1 KB rows."""
    B, T, M = tile_idx.shape
    Y, X = init_frames.shape[-2:]
    tiles = jnp.take(tiles_flat, tile_idx.reshape(-1), axis=0)
    tiles = tiles.reshape(B, T, M, 16, 16)
    return decode_batch_kmv_sparse(init_frames, bcode, mvk, tiles, tile_yx,
                                   changed)


@jax.jit
def decode_batch_kmv_sparse(init_frames, bcode, mvk, tiles, tile_yx, changed):
    """Batched sparse-kmv scan (unrolled over B — see decode_batch_kmv).

    The sparse transport exists for the HOST->DEVICE link, not for device
    memory: the dense paycode plane is 8.3 MB/frame at 1080p while typical
    screen content needs tens of KB of tiles + block codes — on a PCIe- or
    network-fed serving host the transfer dominates end-to-end throughput."""
    outs = [_scan_decode_kmv_sparse(init_frames[b], bcode[b], mvk[b],
                                    tiles[b], tile_yx[b], changed[b])
            for b in range(bcode.shape[0])]
    return jnp.stack(outs)


def _scan_decode_kmv_sparse(init_frame, bcode, mvk, tiles, tile_yx, changed):
    def step(prev, inp):
        bc, mk, tl, yx, chg = inp
        out = jnp.where(chg, compose_frame_kmv_sparse(prev, bc, mk, tl, yx),
                        prev)
        return out, out

    _, frames = jax.lax.scan(step, init_frame,
                             (bcode, mvk, tiles, tile_yx, changed))
    return frames


@jax.jit
def decode_sequence_kmv_sparse(init_frame, bcode, mvk, tiles, tile_yx, changed):
    return _scan_decode_kmv_sparse(init_frame, bcode, mvk, tiles, tile_yx,
                                   changed)
