"""Lane-entropy-coded tile payloads — device entropy decode in the ingest path.

The sparse kmv transport (kernels/sp_recon.prepare_kmv_sparse, ingest's
``kmv_sparse`` path) ships per-block codes + K motion vectors + raw
final-content payload TILES.  This module entropy-codes the tile pixel
bytes with the multi-lane rANS of kernels/rans_lanes, so the payload
crosses the host→device link compressed and is entropy-decoded ON DEVICE
(SURVEY.md §2 "Ulysses-style lane parallelism" carried into the serving
pipeline).

Two wire layouts, different economics:

* ``packed``  — the lanes' own byte rows, ≈ true compressed size
  (screen-content tiles compress far below 1 B/symbol).  Decode uses the
  gather-based lockstep — the right trade when the LINK is the wall
  (network/PCIe-fed serving), stacking on the sparse transport's own
  transfer saving.
* ``aligned`` — the pre-simulated refill schedule (rans_lanes.
  layout_refills), exactly 2 B/lane/step shipped regardless of entropy,
  decoded gather-free (2-level search) — the right trade when the pack
  is resident in device memory (re-encoded streams staged to device
  once).

Both decode to identical tiles; parity is pinned against the raw-tile
path.  Pixels are serialized as 3 little-endian bytes (24-bit content;
the paycode/tile top byte is transport metadata, not pixel data).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import rans_lanes


def _pick_lanes(n_bytes: int) -> int:
    """Lane count: enough parallel width to fill the vector units, small enough
    that short payloads don't drown in padding."""
    if n_bytes >= 1 << 20:
        return 2048
    if n_bytes >= 1 << 16:
        return 512
    return 128


def _bucket_steps(n: int) -> int:
    """Round scan lengths to powers of two — bounds jit recompiles."""
    b = 1
    while b < n:
        b <<= 1
    return b


@dataclass
class LanePack:
    """One window's entropy-coded tile payload."""

    n_tiles: int                    # S — rows of the [S, 256] tile array
    n_lanes: int
    freq: np.ndarray                # [256] i32 static table
    init_states: np.ndarray         # [N] u32
    lane_bytes: Optional[np.ndarray] = None   # [N, L] u8 (packed layout)
    refills: Optional[np.ndarray] = None      # [steps, N, 2] u8 (aligned)

    @property
    def n_symbols(self) -> int:
        return self.n_tiles * 256 * 3

    def wire_bytes(self) -> int:
        """Payload size crossing the link (excluding the small table/state)."""
        if self.refills is not None:
            return int(self.refills.size)
        return int(self.lane_bytes.size)


def encode_tiles(flat_tiles: np.ndarray, layout: str = "packed",
                 n_lanes: Optional[int] = None) -> LanePack:
    """[S, 256] u32 tile rows → LanePack (host side)."""
    S = int(flat_tiles.shape[0])
    u32 = np.ascontiguousarray(flat_tiles.reshape(-1), dtype=np.uint32)
    b = np.empty((u32.size, 3), dtype=np.uint8)
    b[:, 0] = u32 & 0xFF
    b[:, 1] = (u32 >> 8) & 0xFF
    b[:, 2] = (u32 >> 16) & 0xFF
    syms = b.reshape(-1)
    if n_lanes is None:
        n_lanes = _pick_lanes(syms.size)
    freq = rans_lanes.build_freq_table(syms)
    lane_bytes, states, ns = rans_lanes.encode_lanes(syms, freq, n_lanes)
    pack = LanePack(S, n_lanes, freq, states, lane_bytes=lane_bytes)
    if layout == "aligned":
        n_steps = _bucket_steps(-(-ns // n_lanes))
        pack.refills = rans_lanes.layout_refills(lane_bytes, states, freq,
                                                 n_steps)
        pack.lane_bytes = None
    return pack


@functools.partial(jax.jit, static_argnames=("S",))
def _syms_to_tiles(syms: jax.Array, S: int) -> jax.Array:
    """[steps, N] u8 interleaved symbols → [S, 256] u32 tiles."""
    b = syms.reshape(-1)[: S * 256 * 3].astype(jnp.uint32)
    b = b.reshape(S, 256, 3)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)


def decode_tiles_device(pack: LanePack) -> jax.Array:
    """LanePack → [S, 256] u32 tiles, entropy decode ON DEVICE."""
    if pack.n_tiles == 0:
        return jnp.zeros((0, 256), jnp.uint32)
    freq = jnp.asarray(pack.freq)
    states = jnp.asarray(pack.init_states)
    if pack.refills is not None:
        syms = rans_lanes.decode_lanes_aligned(
            jnp.asarray(pack.refills), states, freq)
    else:
        n_steps = _bucket_steps(-(-pack.n_symbols // pack.n_lanes))
        syms = rans_lanes.decode_lanes(
            jnp.asarray(pack.lane_bytes), states, freq, n_steps)
    return _syms_to_tiles(syms, pack.n_tiles)


# ---------------------------------------------------------------------------
# Serialization — the persistent "re-encoded" artifact (lane-pack container)
# ---------------------------------------------------------------------------

_MAGIC = b"JTLP"


def pack_to_bytes(pack: LanePack) -> bytes:
    """Serialize for storage/wire.  Layout: magic, header ints, freq table,
    states, payload (refills or lane rows)."""
    import struct

    aligned = pack.refills is not None
    payload = (pack.refills if aligned else pack.lane_bytes)
    head = struct.pack(
        "<4sBIII", _MAGIC, 1 if aligned else 0, pack.n_tiles, pack.n_lanes,
        payload.shape[0] if aligned else payload.shape[1])
    return (head + pack.freq.astype("<i4").tobytes()
            + pack.init_states.astype("<u4").tobytes()
            + payload.tobytes())


def pack_from_bytes(data: bytes) -> LanePack:
    """Parse a serialized pack.  Untrusted input: every size field is
    validated against the actual payload length before any allocation, so
    a malformed blob raises ValueError instead of allocating gigabytes or
    over-reading (same adversarial-stream discipline as the codecs)."""
    import struct

    head_sz = struct.calcsize("<4sBIII")
    if len(data) < head_sz:
        raise ValueError("lane pack truncated (header)")
    magic, aligned, S, N, dim = struct.unpack_from("<4sBIII", data, 0)
    if magic != _MAGIC:
        raise ValueError("not a lane pack")
    if not (0 < N <= 1 << 16) or S > 1 << 24 or dim > 1 << 28:
        raise ValueError(f"implausible lane pack header S={S} N={N} d={dim}")
    payload = (dim * N * 2) if aligned else (N * dim)
    need = head_sz + 256 * 4 + N * 4 + payload
    if len(data) < need:
        raise ValueError(f"lane pack truncated ({len(data)} < {need})")
    off = head_sz
    freq = np.frombuffer(data, dtype="<i4", count=256, offset=off).copy()
    off += 256 * 4
    states = np.frombuffer(data, dtype="<u4", count=N, offset=off).copy()
    off += N * 4
    if aligned:
        refills = np.frombuffer(data, dtype=np.uint8, count=dim * N * 2,
                                offset=off).reshape(dim, N, 2).copy()
        return LanePack(S, N, freq, states, refills=refills)
    lane_bytes = np.frombuffer(data, dtype=np.uint8, count=N * dim,
                               offset=off).reshape(N, dim).copy()
    return LanePack(S, N, freq, states, lane_bytes=lane_bytes)
