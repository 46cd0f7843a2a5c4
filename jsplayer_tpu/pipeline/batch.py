"""Batched multi-stream decode: host command assembly + sharded device decode.

This is the throughput pipeline the reference's single-stream Manager becomes
on the device (SURVEY.md §2 parallelism table):

  host:   demux → entropy/commands per stream  (codecs/*, loaders)
  device: shard_map over a (dp, gop) mesh — dp = independent streams,
          gop = keyframe-delimited segments of the time axis; each program
          scans its GOP's frames with the paint/recon kernels and fuses the
          ingestion epilogue (kernels/rgb_convert.to_model_input).

Shapes: command stacks are [B, G, T, ...] — B streams, G GOPs per stream,
T frames per GOP (fixed per batch; loaders pad short GOPs with no-change
frames, the moral equivalent of the reference's identical-frame buffer runs,
Manager.hx:568-578).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..codecs import msvideo1 as msv1
from ..codecs.screenpressor import ScreenPressor
from ..kernels import msv1_paint, sp_recon
from ..kernels.rgb_convert import to_model_input


# ---------------------------------------------------------------------------
# Host command assembly
# ---------------------------------------------------------------------------

def stack_msv1_commands(
    streams: list[list[bytes]], X: int, Y: int,
    pal: Optional[np.ndarray] = None, gops: int = 1,
) -> dict[str, np.ndarray]:
    """Parse per-frame MSV1 opcode streams into [B, G, T, ...] command stacks.
    Every stream must have the same frame count, divisible by `gops`."""
    B = len(streams)
    T_total = len(streams[0])
    assert all(len(s) == T_total for s in streams)
    assert T_total % gops == 0
    Tg = T_total // gops
    nb = (X >> 2) * (Y >> 2)
    bt = np.zeros((B, T_total, nb), dtype=np.uint8)
    sel = np.zeros((B, T_total, nb, 16), dtype=np.uint8)
    col = np.zeros((B, T_total, nb, 8), dtype=np.uint32)
    chg = np.zeros((B, T_total), dtype=bool)
    from .. import native as _native

    nat_parse = _native.native_msv1_parse if _native.available() else None
    for b, frames in enumerate(streams):
        for t, src in enumerate(frames):
            parse = nat_parse or msv1.parse_commands
            bt[b, t], sel[b, t], col[b, t], chg[b, t] = parse(
                src, X, Y, pal=pal
            )
    rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
    # sel ships plane-ordered [.., Y, X] (a device-side 4x4 relayout costs
    # more than the paint itself — msv1_paint.sel_to_plane)
    return dict(btype=rs(bt), sel=rs(msv1_paint.sel_to_plane(sel, Y, X)),
                colors=rs(col), changes=rs(chg))


def stack_sp_commands(
    streams: list[list[bytes]], X: int, Y: int, bpp: int = 24, gops: int = 1,
    insignificant_lines: int = 0,
) -> dict[str, np.ndarray]:
    """Run the SP host stage (entropy decode + command capture) over per-frame
    streams → [B, G, T, ...] stacks for kernels/sp_recon.  When gops > 1,
    each GOP must start with an I-frame (keyframe-delimited segments)."""
    B = len(streams)
    T_total = len(streams[0])
    assert T_total % gops == 0
    Tg = T_total // gops
    nbx, nby = (X + 15) // 16, (Y + 15) // 16
    nb = nbx * nby
    bts = np.zeros((B, T_total, nb), dtype=np.int32)
    mv = np.zeros((B, T_total, nb, 2), dtype=np.int32)
    rect = np.zeros((B, T_total, nb, 4), dtype=np.int32)
    payload = np.zeros((B, T_total, Y, X), dtype=np.uint32)
    changed = np.zeros((B, T_total), dtype=bool)
    from .. import native as _native

    if _native.available():
        # one parallel native call decodes all streams (thread pool = the
        # host-side DP axis)
        got = _native.native_sp_decode_streams(
            streams, X, Y, bpp=bpp, insignificant_lines=insignificant_lines)
        rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
        return dict(bts=rs(got["bts"]), mv=rs(got["mv"]), rect=rs(got["rect"]),
                    payload=rs(got["payload"]), changed=rs(got["changed"]))

    for b, frames in enumerate(streams):
        dec = ScreenPressor(X, Y, bpp)
        dec.preinit(insignificant_lines)
        for t, src in enumerate(frames):
            cap: dict = {}
            dec.capture = cap
            dst = np.zeros(X * Y, dtype=np.uint32)
            if dec.is_key_frame(src):
                dec.decompress_i(src, dst)
            else:
                dec.decompress_p(src, dst)
            bts[b, t] = cap["bts"]
            mv[b, t] = cap["mv"]
            rect[b, t] = cap["rect"]
            changed[b, t] = cap["changed"]
            data = dec.previous_frame()
            if data is not None:
                payload[b, t] = data.reshape(Y, X)
    rs = lambda a: a.reshape(B, gops, Tg, *a.shape[2:])
    return dict(bts=rs(bts), mv=rs(mv), rect=rs(rect), payload=rs(payload),
                changed=rs(changed))


# ---------------------------------------------------------------------------
# Sharded device decode
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecodeConfig:
    height: int
    width: int
    insignificant_blocks: int = 0
    insignificant_lines: int = 0
    emit_model_input: bool = False
    model_dtype: str = "bfloat16"
    bpp16: bool = False


def _epilogue(frames: jax.Array, cfg: DecodeConfig):
    if not cfg.emit_model_input:
        return frames
    return to_model_input(frames, dtype=jnp.dtype(cfg.model_dtype),
                          bpp16=cfg.bpp16)


def make_msv1_decode_step(mesh: Mesh, cfg: DecodeConfig,
                          with_carry: bool = False):
    """Build the jitted sharded decode step for MSV1 command stacks.

    Inputs [B, G, T, ...] sharded (dp, gop); per-program lax.scan over its
    GOP slice.  Default: init = zeros / invalid (every row starts at a
    keyframe).  with_carry=True adds leading (init [B,G,Y,X] u32,
    valid [B,G] bool) inputs so window pipelines can thread the previous
    window's last frame through (ingest's per-window carry)."""
    nbx = cfg.width // 4

    def decode(init, valid, btype, sel, colors, changes):
        fn = functools.partial(msv1_paint._decode_sequence_novmap, nbx=nbx)
        fn = jax.vmap(jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, 0, None, None)),
                      in_axes=(0, 0, 0, 0, 0, 0, None, None))
        frames, signif = fn(
            init, valid, btype, sel, colors, changes,
            jnp.int32(cfg.insignificant_blocks),
            jnp.int32(cfg.insignificant_lines),
        )
        return _epilogue(frames, cfg), signif

    if with_carry:
        sharded = jax.shard_map(
            decode, mesh=mesh,
            in_specs=(P("dp", "gop"),) * 6,
            out_specs=(P("dp", "gop"), P("dp", "gop")),
        )
        return jax.jit(sharded)

    def per_shard(btype, sel, colors, changes):
        # shapes: [b, g, T, ...] local shards
        b, g = btype.shape[0], btype.shape[1]
        # derive init from an input so it carries the shard_map varying axes
        init = jnp.zeros((b, g, cfg.height, cfg.width), dtype=jnp.uint32) + (
            changes[:, :, :1] * 0
        ).astype(jnp.uint32).reshape(b, g, 1, 1)
        valid = (changes[:, :, 0] & False)
        return decode(init, valid, btype, sel, colors, changes)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("dp", "gop"),) * 4,
        out_specs=(P("dp", "gop"), P("dp", "gop")),
    )
    return jax.jit(sharded)


def make_sp_decode_step_kmv(mesh: Mesh, cfg: DecodeConfig):
    """Production sharded SP step: kmv transport (init [B,G,Y,X] carry-in
    — zeros when every row starts at a keyframe — plus paycode
    [B,G,T,Y,X] u32, mvk [B,G,T,K,2], changed [B,G,T]) over the (dp, gop)
    mesh.  Significance comes from the host stage alongside the
    transport."""

    def per_shard(init, paycode, mvk, changed):
        # unroll local (b, g) dims — vmapped dynamic rolls lower to gathers
        b_n, g_n = paycode.shape[0], paycode.shape[1]
        frames = jnp.stack([
            jnp.stack([
                sp_recon._scan_decode_kmv(init[b, g], paycode[b, g],
                                          mvk[b, g], changed[b, g])
                for g in range(g_n)])
            for b in range(b_n)])
        return _epilogue(frames, cfg)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("dp", "gop"),) * 4,
        out_specs=P("dp", "gop"),
    )
    return jax.jit(sharded)


def make_sp_decode_step_bc(mesh: Mesh, cfg: DecodeConfig):
    """Sharded SP step for the bc transport (block-command arrays + pixel-
    only plane, kernels/sp_recon.compose_frame_bc): init [B,G,Y,X] u32,
    plane [B,G,T,Y,X] u32, bcode [B,G,T,NB] u8, rloc [B,G,T,NB,4] u8,
    mvk [B,G,T,K,2], changed [B,G,T] over the (dp, gop) mesh."""

    def per_shard(init, plane, bcode, rloc, mvk, changed):
        b_n, g_n = plane.shape[0], plane.shape[1]
        frames = jnp.stack([
            jnp.stack([
                sp_recon.decode_sequence_bc(
                    init[b, g], plane[b, g], bcode[b, g], rloc[b, g],
                    mvk[b, g], changed[b, g])
                for g in range(g_n)])
            for b in range(b_n)])
        return _epilogue(frames, cfg)

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("dp", "gop"),) * 6,
        out_specs=P("dp", "gop"),
    )
    return jax.jit(sharded)


def make_sp_decode_step(mesh: Mesh, cfg: DecodeConfig):
    """Build the jitted sharded decode step for SP command stacks."""

    def per_shard(bts, mv, rect, payload, changed):
        init = jnp.zeros_like(payload[:, :, 0])
        fn = functools.partial(sp_recon._scan_decode)
        fn = jax.vmap(jax.vmap(fn, in_axes=(0, 0, 0, 0, 0, 0, None)),
                      in_axes=(0, 0, 0, 0, 0, 0, None))
        frames, signif = fn(init, bts, mv, rect, payload, changed,
                            jnp.int32(cfg.insignificant_blocks))
        return _epilogue(frames, cfg), signif

    sharded = jax.shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("dp", "gop"),) * 5,
        out_specs=(P("dp", "gop"), P("dp", "gop")),
    )
    return jax.jit(sharded)
