"""Device-side lane-container decode: payload units + kmv recon, one program.

BASELINE config 4 end-to-end: ONE jitted program per window does
  1. the payload-unit build, by mode (codecs/lane_format):
     - raw (the default): [U, 3, 128] u8 wire bytes → a free
       reshape + elementwise combine — zero entropy work;
     - rans: renorm-aligned multi-lane rANS decode of the symbols
       (rans_lanes.decode_lanes_aligned), then the same combine
       (byte-triplet symbol order),
  2. rows_from_units: assemble the window's UNIQUE data rows
     rows_unique [Ur, X] from the 128-px units (lane_format's
     row_index dedups each plane row's ncol-unit id tuple) — the ONE
     relayout into the minor (X) dimension the whole window pays,
  3. a lax.scan over frames where each step does a PURE ROW GATHER
     tp = take(rows_unique, row_idx[t]) and composes with
     block-broadcast types/rects and K motion rolls — the same pixel
     semantics as sp_recon's dense-paycode compose
     (ScreenPressor.hx:302-484 block model).

Why rows, not unit slots: gathering [R, 128] unit rows per frame and
reshaping to [Y, X] merges 15 rows of 128 into the minor dim — a
RELAYOUT that adds about two extra 8.3 MB plane passes per frame.  A
gather of whole rows reads contiguous memory, so the window pays the
relayout once and each frame pays one row gather.

Sharding: make_lane_decode_step shards the leading window axis over the
mesh's dp axis, and — for RESTART (carry-independent) windows — over the
gop axis too (SURVEY §2 GOP/context row).

No dynamic_update_slice chains (serial, one tile per step) and no 16x16
block relayouts — the two costs the sparse transport pays.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import rans_lanes
from .sp_recon import bc_row_map, row_expand


def units_from_pack(refills: jax.Array, states: jax.Array, freq: jax.Array,
                    U: int) -> jax.Array:
    """Lane decode + per-unit byte-triplet unpack → [U, 128] u32 units.

    Symbol order (lane_format.derive_window): [U, 3, 128] byte planes per
    unit — a middle-dim reshape/slice here (lane dim intact), and correct
    for any padded U because unit u's bytes always live at flat[384*u:]."""
    syms = rans_lanes.decode_lanes_aligned(refills, states, freq)
    flat = syms.reshape(-1)
    m = flat[: U * 384].reshape(U, 3, 128).astype(jnp.uint32)
    return m[:, 0] | (m[:, 1] << 8) | (m[:, 2] << 16)


def rows_from_units(units: jax.Array, row_table: jax.Array,
                    X: int) -> jax.Array:
    """units [U, 128] u32 + row_table [Ur, ncol] i32 → rows_unique [Ur, X]
    u32: the window's unique full-width data rows, assembled once (the
    single relayout the window pays — see module docstring)."""
    Ur, ncol = row_table.shape
    rows = jnp.take(units, row_table.reshape(-1), axis=0)
    return rows.reshape(Ur, ncol * 128)[:, :X]


def compose_frame_lane(prev: jax.Array, rows_unique: jax.Array,
                       row_idx: jax.Array, btype: jax.Array,
                       rect: jax.Array, mvk: jax.Array) -> jax.Array:
    """One frame: block types/rects broadcast to pixels + a pure row gather.

    prev [Y, X] u32, rows_unique [Ur, X] u32, row_idx [Y] i32,
    btype [NB] u8 (0 copy / 1 data / 2+k motion), rect [NB, 4] u8 in
    block-local coords, mvk [K, 2] i32."""
    Y, X = prev.shape
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    tp = jnp.take(rows_unique, row_idx, axis=0)      # [Y, X] row gather

    # block structure via the packed row map + rows-only expansion
    # (sp_recon.bc_row_map: unlike block_broadcast, it never splits the
    # minor dim)
    rowv = row_expand(bc_row_map(btype, rect, nby, nbx, X), Y, X)
    bt = rowv & 0xFF
    y1 = (rowv >> 8) & 0xFF
    y2 = (rowv >> 16) & 0xFF
    ly = (jax.lax.broadcasted_iota(jnp.uint32, (Y, X), 0)) & 15
    in_y = (ly >= y1) & (ly < y2)
    out = jnp.where((bt == 1) & in_y, tp, prev)
    K = mvk.shape[0]
    for k in range(K):
        shifted = jnp.roll(prev, shift=(-mvk[k, 1], -mvk[k, 0]), axis=(0, 1))
        out = jnp.where((bt == 2 + k) & in_y, shifted, out)
    return out


def _scan_frames(init, rows_unique, btype, rect, mvk, row_idx, changed):
    """The recon scan shared by both payload modes: P-chain over frames,
    each changed frame composed by a row gather + block commands."""
    def step(prev, inp):
        bt, r, mk, ri, chg = inp
        out = jnp.where(chg,
                        compose_frame_lane(prev, rows_unique, ri, bt, r, mk),
                        prev)
        return out, out

    _, frames = jax.lax.scan(step, init, (btype, rect, mvk, row_idx, changed))
    return frames


def units_from_raw(payload: jax.Array) -> jax.Array:
    """Raw payload mode: [U, 3, 128] u8 byte planes → [U, 128] u32 units.
    No entropy stage at all — the combine fuses into the first gather."""
    m = payload.astype(jnp.uint32)
    return m[:, 0] | (m[:, 1] << 8) | (m[:, 2] << 16)


@functools.partial(jax.jit, static_argnames=("U",))
def decode_window_lane(init, refills, states, freq, btype, rect, mvk,
                       row_table, row_idx, changed, U: int):
    """One stream window, rans payload mode: entropy + recon in one program.

    init [Y, X] u32; refills [steps, N, 2] u8; states [N] u32;
    freq [256] i32; btype [T, NB]; rect [T, NB, 4]; mvk [T, K, 2];
    row_table [Ur, ncol] i32; row_idx [T, Y] i32; changed [T] bool
    → frames [T, Y, X] u32."""
    units = units_from_pack(refills, states, freq, U)
    rows_unique = rows_from_units(units, row_table, init.shape[1])
    return _scan_frames(init, rows_unique, btype, rect, mvk, row_idx, changed)


@jax.jit
def decode_window_raw(init, payload, btype, rect, mvk, row_table, row_idx,
                      changed):
    """One stream window, raw payload mode: recon only (payload [U, 3, 128]
    u8 uncoded unit bytes; everything else as decode_window_lane)."""
    units = units_from_raw(payload)
    rows_unique = rows_from_units(units, row_table, init.shape[1])
    return _scan_frames(init, rows_unique, btype, rect, mvk, row_idx, changed)


@functools.partial(jax.jit, static_argnames=("U",))
def decode_batch_lane(init, refills, states, freq, btype, rect, mvk,
                      row_table, row_idx, changed, U: int):
    """Batched lane decode, leading [B] axis on every input (same U/Ur
    buckets per stream).  Unrolled over B like every kmv scan (vmapped
    dynamic rolls lower to gathers — sp_recon.decode_batch_kmv's lesson)."""
    outs = [decode_window_lane(init[b], refills[b], states[b], freq[b],
                               btype[b], rect[b], mvk[b], row_table[b],
                               row_idx[b], changed[b], U)
            for b in range(btype.shape[0])]
    return jnp.stack(outs)


@jax.jit
def decode_batch_raw(init, payload, btype, rect, mvk, row_table, row_idx,
                     changed):
    """Batched raw-mode decode; same unrolled-leading-axis contract."""
    outs = [decode_window_raw(init[b], payload[b], btype[b], rect[b],
                              mvk[b], row_table[b], row_idx[b], changed[b])
            for b in range(btype.shape[0])]
    return jnp.stack(outs)


def make_lane_decode_step(mesh, U: int, axes=("dp",), raw: bool = False):
    """Sharded lane decode over the mesh.

    `axes` names the mesh axes the leading batch dimension shards over:
    ("dp",) = independent streams only; ("dp", "gop") additionally spreads
    RESTART windows (carry-independent, lane_format.LaneWindow.restart)
    of the same stream across the gop axis — the time-axis analog of the
    kmv path's GOP parallelism (SURVEY.md §2 GOP/context row).  Entries
    are laid out stream-major: index = b * G + g for mesh (dp=B, gop=G).
    No cross-device traffic either way — every window decodes locally."""
    from jax.sharding import PartitionSpec as P

    spec = P(axes if len(axes) > 1 else axes[0])

    if raw:
        def per_shard(init, payload, btype, rect, mvk, row_table, row_idx,
                      changed):
            outs = [decode_window_raw(init[b], payload[b], btype[b],
                                      rect[b], mvk[b], row_table[b],
                                      row_idx[b], changed[b])
                    for b in range(btype.shape[0])]
            return jnp.stack(outs)

        n_in = 8
    else:
        def per_shard(init, refills, states, freq, btype, rect, mvk,
                      row_table, row_idx, changed):
            outs = [decode_window_lane(init[b], refills[b], states[b],
                                       freq[b], btype[b], rect[b], mvk[b],
                                       row_table[b], row_idx[b],
                                       changed[b], U)
                    for b in range(btype.shape[0])]
            return jnp.stack(outs)

        n_in = 10

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(spec,) * n_in,
        out_specs=spec,
    )
    return jax.jit(sharded)
