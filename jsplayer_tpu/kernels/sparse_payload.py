"""Sparse payload transport: data-rect tiles + an integer block scatter.

The dense command layout ships a full [Y, X] u32 payload plane per frame even
though only data-block rects carry information.  This module packs only the
painted blocks:

  host:   payload [Y, X] + bts → tiles [M, 256] u32 (one 16×16 tile per
          active block, M padded to a bucket size) + tile_block [M] i32
  device: dense[NB, 256] = zeros.at[tile_block].set(tiles) — an integer
          scatter, exact for any u32 pixel — then the usual reshape to
          [Y, X].

Per-frame traffic becomes activity-proportional: tiles (M·1KB) + indices
instead of the full plane (8.3 MB at 1080p).

Status: the production sparse serving path is kernels/sp_recon's kmv-sparse
transport (ragged flat tiles + dynamic_update_slice, fed by the native
decoder — see pipeline/ingest).  This module remains the scatter
alternative for payload-only workloads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_tiles(payload: np.ndarray, bts: np.ndarray, m_max: int
               ) -> tuple[np.ndarray, np.ndarray]:
    """[Y,X] payload + [NB] bts → (tiles [m_max,256] u32, tile_block [m_max]
    i32, -1 padding).  Active = any block that paints payload pixels (bts 1,
    2, 4 — data variants; full-motion blocks need no payload)."""
    Y, X = payload.shape
    nbx = X // 16
    active = np.nonzero((bts > 0) & (bts != 3))[0]
    if len(active) > m_max:
        raise ValueError(f"m_max={m_max} < active blocks {len(active)}")
    tiles = np.zeros((m_max, 256), dtype=np.uint32)
    tile_block = np.full(m_max, -1, dtype=np.int32)
    p4 = payload.reshape(Y // 16, 16, nbx, 16).transpose(0, 2, 1, 3)
    for k, bi in enumerate(active):
        by, bx = divmod(int(bi), nbx)
        tiles[k] = p4[by, bx].reshape(256)
        tile_block[k] = bi
    return tiles, tile_block


def pack_sequence(payload: np.ndarray, bts: np.ndarray, m_max: int):
    """[T,Y,X], [T,NB] → stacked (tiles [T,m_max,256], tile_block [T,m_max])."""
    T = payload.shape[0]
    tiles = np.zeros((T, m_max, 256), dtype=np.uint32)
    blocks = np.full((T, m_max), -1, dtype=np.int32)
    for t in range(T):
        tiles[t], blocks[t] = pack_tiles(payload[t], bts[t], m_max)
    return tiles, blocks


def unpack_payload(tiles: jax.Array, tile_block: jax.Array, nb: int,
                   Y: int, X: int) -> jax.Array:
    """Device reconstruct: → dense payload [Y, X] u32 (zeros outside data
    blocks).  Padding entries (tile_block < 0) are routed out of range and
    dropped; no float arithmetic touches the pixels."""
    rows = jnp.where(tile_block < 0, nb, tile_block)
    dense = jnp.zeros((nb, 256), dtype=jnp.uint32).at[rows].set(
        tiles.astype(jnp.uint32), mode="drop")
    nbx = X // 16
    return (dense.reshape(Y // 16, nbx, 16, 16)
            .transpose(0, 2, 1, 3).reshape(Y, X))


def decode_sequence_sparse(init_frame, bts, mv, rect, tiles, tile_block,
                           changed, insignificant_blocks):
    """sp_recon.decode_sequence with sparse payload transport."""
    from .sp_recon import compose_frame

    T, NB = bts.shape
    Y, X = init_frame.shape

    def step(prev, inp):
        b, m, r, tl, tb, chg = inp
        payload = unpack_payload(tl, tb, NB, Y, X)
        composed = compose_frame(prev, b, m, r, payload)
        out = jnp.where(chg, composed, prev)
        sig_mask = jnp.arange(NB) >= insignificant_blocks
        signif = jnp.logical_and(chg, ((b > 0) & sig_mask).any())
        return out, (out, signif)

    _, (frames, signif) = jax.lax.scan(
        step, init_frame, (bts, mv, rect, tiles, tile_block, changed))
    return frames, signif
