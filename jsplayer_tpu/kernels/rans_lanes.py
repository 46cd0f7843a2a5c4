"""Interleaved multi-lane rANS — device entropy decode for re-chunked streams.

The reference's entropy stage is inherently serial: every symbol's context
depends on all prior symbols (ANS.hx adaptive models; SURVEY.md §7 "hard
parts").  For *legacy* streams the framework therefore decodes entropy on the
host (native/spdec.cpp).  This module is the lane-parallel alternative for
streams we re-encode ourselves: symbols are distributed round-robin over N
independent rANS lanes with a *static* (per-chunk) frequency table, so all N
states advance in lockstep as one vector — the SURVEY §2 "Ulysses-style lane
parallelism" build target (the reference's analog is the B=131072-symbol
stream reinit, ANS.hx:10, which already marks entropy-state boundaries).

Decode math matches the byte-wise rANS of the reference (12-bit
probabilities, L=2^23 renorm, ANS.hx:33-48); the lane layout and the static
table are the re-encode's freedom — parity is defined on decoded symbols.

Two layouts exist:

* **packed** (:func:`decode_lanes`): each lane owns a contiguous byte row
  and refills at its own divergent position — two ``take_along_axis``
  gathers per step, so each scan step waits on two dependent gathers.
* **renorm-aligned** (:func:`decode_lanes_aligned`): the refill pattern
  is a deterministic function of the stream, so the host lays the refill
  bytes out per lockstep step (:func:`layout_refills`) and the scan
  consumes them as contiguous inputs; the symbol search is a TWO-LEVEL
  form (16-bucket compare + one-hot [N,16]@[16,16] f32 dot at
  ``precision=HIGHEST`` + 16-wide resolve).  Zero gathers.  Cost: a
  fixed ~2 B/lane/step regardless of entropy — many times the true
  entropy size on highly compressible screen content (see
  codecs/lane_format's size-trade note).  This is the production
  device-entropy path for re-encoded streams; packed remains the
  minimal-transfer variant.  Whether a table gather beats the one-hot
  dot on the GPU is not measured yet.

Legacy adaptive-context streams (the reference format) still decode on
host — their symbol-serial context chain is not lane-decomposable — and
ride the kmv transport to the device recon kernels.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
RANS_L = 1 << 23


def build_freq_table(symbols: np.ndarray, nsym: int = 256) -> np.ndarray:
    """Static per-chunk frequency table summing to PROB_SCALE, every symbol
    given at least 1 slot (so any byte remains decodable)."""
    hist = np.bincount(symbols, minlength=nsym).astype(np.float64)
    freq = np.maximum(1, np.round(hist / max(1, hist.sum()) * (PROB_SCALE - nsym))
                      ).astype(np.int64)
    # exact normalization: trim/boost the most frequent symbols
    while freq.sum() > PROB_SCALE:
        i = int(np.argmax(freq))
        freq[i] -= min(freq[i] - 1, freq.sum() - PROB_SCALE)
    freq[int(np.argmax(freq))] += PROB_SCALE - freq.sum()
    assert freq.sum() == PROB_SCALE and (freq > 0).all()
    return freq.astype(np.int32)


def encode_lanes(symbols: np.ndarray, freq: np.ndarray, n_lanes: int
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """Encode symbols round-robin over n_lanes reverse-order rANS encoders.

    → (lane_bytes u8 [N, L] zero-padded, init_states u32 [N], n_symbols).
    Lane j owns symbols j, j+N, j+2N, ... (interleaved layout: adjacent
    symbols decode in the same lockstep step across lanes)."""
    cum = np.zeros(len(freq) + 1, dtype=np.int64)
    cum[1:] = np.cumsum(freq)
    n = len(symbols)
    lanes_out: list[bytearray] = [bytearray() for _ in range(n_lanes)]
    states = np.zeros(n_lanes, dtype=np.uint64)
    for j in range(n_lanes):
        x = RANS_L
        out = lanes_out[j]
        for idx in range(((n - 1 - j) // n_lanes) * n_lanes + j, -1, -n_lanes):
            s = int(symbols[idx])
            f = int(freq[s])
            x_max = ((RANS_L >> PROB_BITS) << 8) * f
            while x >= x_max:
                out.append(x & 0xFF)
                x >>= 8
            x = ((x // f) << PROB_BITS) + (x % f) + int(cum[s])
        out.reverse()
        states[j] = x
    L = max((len(o) for o in lanes_out), default=0)
    lane_bytes = np.zeros((n_lanes, L), dtype=np.uint8)
    for j, o in enumerate(lanes_out):
        lane_bytes[j, : len(o)] = np.frombuffer(bytes(o), dtype=np.uint8)
    return lane_bytes, states.astype(np.uint32), n


@functools.partial(jax.jit, static_argnames=("n_steps",))
def decode_lanes(
    lane_bytes: jax.Array,  # [N, L] uint8
    init_states: jax.Array,  # [N] uint32
    freq: jax.Array,  # [256] int32 (static table, sums to 4096)
    n_steps: int,  # ceil(n_symbols / N)
) -> jax.Array:
    """Lockstep decode: → symbols [n_steps, N] uint8 (interleaved layout;
    flatten + trim to recover the original order)."""
    cumfreq = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(freq)])[:256]  # [256]

    def step(carry, _):
        x, pos = carry  # [N] u32, [N] i32
        sf = (x & (PROB_SCALE - 1)).astype(jnp.int32)  # [N]
        # symbol = searchsorted(cumfreq, sf, 'right') - 1 via compare+sum
        sym = (cumfreq[None, :] <= sf[:, None]).sum(axis=1) - 1  # [N]
        f = freq[sym].astype(jnp.uint32)
        c = cumfreq[sym].astype(jnp.uint32)
        x = f * (x >> PROB_BITS) + (x & (PROB_SCALE - 1)) - c
        # ≤2 byte refills for 12-bit probabilities (x ≥ 2^11 post-update)
        for _ in range(2):
            need = x < RANS_L
            b = jnp.take_along_axis(lane_bytes, pos[:, None], axis=1)[:, 0]
            x = jnp.where(need, (x << 8) | b.astype(jnp.uint32), x)
            pos = jnp.where(need, pos + 1, pos)
        return (x, pos), sym.astype(jnp.uint8)

    n = lane_bytes.shape[0]
    (x, pos), syms = jax.lax.scan(
        step, (init_states, jnp.zeros(n, jnp.int32)), None, length=n_steps
    )
    return syms


def roundtrip_decode(lane_bytes, init_states, freq, n_symbols, n_lanes):
    """Host helper: device decode + trim to the original order.  Position
    (step s, lane j) holds symbol s*N + j, so the row-major flatten of the
    [steps, N] lockstep output IS the original order."""
    n_steps = -(-n_symbols // n_lanes)
    syms = np.asarray(decode_lanes(jnp.array(lane_bytes),
                                   jnp.array(init_states),
                                   jnp.array(freq), n_steps))
    return syms.reshape(-1)[:n_symbols]


# ---------------------------------------------------------------------------
# Renorm-aligned layout: zero-gather lockstep decode
# ---------------------------------------------------------------------------

def layout_refills(lane_bytes: np.ndarray, init_states: np.ndarray,
                   freq: np.ndarray, n_steps: int) -> np.ndarray:
    """Re-layout lane bytes into the REFILL SCHEDULE [n_steps, N, 2] u8.

    The rANS refill pattern is a deterministic function of the stream, so
    the host (or the encoder itself) can pre-simulate the decode and place
    each step's refill bytes in a dense row.  The device scan then consumes
    them as scan inputs — contiguous [N, 2]-byte reads per step — instead
    of per-lane ``take_along_axis`` gathers at divergent positions, which
    leave each step waiting on dependent loads.  Unused slots are 0 (the
    decoder's ``need`` masks skip them in lockstep with this simulation).
    Cost: a fixed ~2 B/lane/step shipped regardless of entropy — cheap vs
    ~1 B/sym incompressible data, many times the entropy size on highly
    compressible screen content (codecs/lane_format size note); the buy is
    a gather-free decode.
    """
    cum = np.zeros(257, dtype=np.uint64)
    cum[1:] = np.cumsum(freq.astype(np.uint64))
    n_lanes = lane_bytes.shape[0]
    x = init_states.astype(np.uint64)
    pos = np.zeros(n_lanes, dtype=np.int64)
    lanes = np.arange(n_lanes)
    refills = np.zeros((n_steps, n_lanes, 2), dtype=np.uint8)
    L = lane_bytes.shape[1]
    freq_u = freq.astype(np.uint64)
    for s in range(n_steps):
        sf = x & np.uint64(PROB_SCALE - 1)
        sym = np.searchsorted(cum[1:257], sf, side="right")
        x = freq_u[sym] * (x >> np.uint64(PROB_BITS)) + sf - cum[sym]
        for k in range(2):
            need = x < RANS_L
            if L == 0:  # zero-payload window: nothing to refill from
                b = np.zeros(n_lanes, dtype=np.uint64)
            else:
                b = np.where(need & (pos < L),
                             lane_bytes[lanes, np.minimum(pos, L - 1)],
                             0).astype(np.uint64)
            refills[s, :, k] = np.where(need, b, 0)
            x = np.where(need, (x << np.uint64(8)) | b, x)
            pos = pos + need
    return refills


@jax.jit
def decode_lanes_aligned(
    refills: jax.Array,  # [n_steps, N, 2] uint8 (layout_refills)
    init_states: jax.Array,  # [N] uint32
    freq: jax.Array,  # [256] int32
) -> jax.Array:
    """Gather-free lockstep decode over the renorm-aligned layout.

    Structural moves:

      * refill bytes arrive as scan inputs (contiguous rows) instead of two
        per-lane byte gathers at divergent stream positions;
      * TWO-LEVEL symbol search: a [N,16] compare picks the 16-symbol
        bucket, a one-hot [N,16] @ [16,16] f32 matmul (precision=HIGHEST
        — values ≤ 2^12, exact; a TF32 product would round them) fetches
        the bucket's cumfreq/freq rows, and a second [N,16] compare +
        one-hot reduce resolves the symbol.  Replaces the [N,256] compare
        matrix + two 256-wide masked reductions.  A per-lane row gather of
        the bucket is the alternative; which one is faster on the GPU is
        not measured.

    → symbols [n_steps, N] uint8."""
    cumfreq = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(freq)])[:256]      # [256]
    cf_rows = cumfreq.reshape(16, 16).astype(jnp.float32)    # [16,16]
    fr_rows = freq.reshape(16, 16).astype(jnp.float32)
    cb = cumfreq[::16]                                       # [16] bucket lows

    def step(x, inp):
        sf = (x & (PROB_SCALE - 1)).astype(jnp.int32)        # [N]
        le1 = cb[None, :] <= sf[:, None]                     # [N,16]
        b = le1.sum(axis=1) - 1                              # [N]
        oh_b = (le1 ^ jnp.pad(le1[:, 1:], ((0, 0), (0, 1)))
                ).astype(jnp.float32)
        rows_c = jax.lax.dot(oh_b, cf_rows,
                             precision=jax.lax.Precision.HIGHEST
                             ).astype(jnp.int32)             # [N,16]
        rows_f = jax.lax.dot(oh_b, fr_rows,
                             precision=jax.lax.Precision.HIGHEST
                             ).astype(jnp.int32)
        le2 = rows_c <= sf[:, None]                          # [N,16]
        i = le2.sum(axis=1) - 1
        oh2 = le2 ^ jnp.pad(le2[:, 1:], ((0, 0), (0, 1)))
        c = (rows_c * oh2).sum(axis=1).astype(jnp.uint32)
        f = (rows_f * oh2).sum(axis=1).astype(jnp.uint32)
        sym = (b * 16 + i).astype(jnp.uint8)
        x = f * (x >> PROB_BITS) + (x & (PROB_SCALE - 1)) - c
        r0 = inp[:, 0].astype(jnp.uint32)
        r1 = inp[:, 1].astype(jnp.uint32)
        need0 = x < RANS_L
        x = jnp.where(need0, (x << 8) | r0, x)
        need1 = x < RANS_L
        x = jnp.where(need1, (x << 8) | r1, x)
        return x, sym

    _, syms = jax.lax.scan(step, init_states, refills)
    return syms


def roundtrip_decode_aligned(lane_bytes, init_states, freq, n_symbols,
                             n_lanes):
    """Host helper: aligned re-layout + gather-free device decode + trim."""
    n_steps = -(-n_symbols // n_lanes)
    refills = layout_refills(np.asarray(lane_bytes), np.asarray(init_states),
                             np.asarray(freq), n_steps)
    syms = np.asarray(decode_lanes_aligned(jnp.array(refills),
                                           jnp.array(init_states),
                                           jnp.array(freq)))
    return syms.reshape(-1)[:n_symbols]
