"""Pixel-format conversion + ML-ingestion transforms — device epilogues.

Parity surface: the per-pixel conversion loops of Manager.fill_bitmap_data
(Manager.hx:325-390) — RGB15→ARGB (`0xFF000000 | (src<<3)`, :369) and the
RGB→ABGR swizzle (`0xFF000000 | ((c&0xFF)<<16) | (c&0xFF00) | ((c>>16)&0xFF)`,
:379) — plus the conversion-buffer variants (:337-354).

Device additions (the reference stops at canvas pixels): fused
channel-split → float/bfloat16 normalize → NHWC/NCHW tensor emit, resize by
integer factors, and bottom-up→top-down flip (frames are stored bottom-up;
the reference compensates with a negative-Y display matrix, Main.hx:318).
These are jnp-level ops so XLA fuses them into the decode epilogue — decoded
frames never round-trip to host for model ingestion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rgb15_to_argb(frame: jax.Array) -> jax.Array:
    """16bpp ScreenPressor output → ARGB u32 (Manager.hx:363-370)."""
    return (jnp.uint32(0xFF000000) | (frame << 3)).astype(jnp.uint32)


def rgb_to_abgr(frame: jax.Array) -> jax.Array:
    """Packed (b<<16)|(g<<8)|r → 0xFF000000|(r<<16)|(g<<8)|b
    (Manager.hx:371-381)."""
    c = frame
    return (
        jnp.uint32(0xFF000000)
        | ((c & 0xFF) << 16)
        | (c & 0xFF00)
        | ((c >> 16) & 0xFF)
    ).astype(jnp.uint32)


def rgb15_to_argb_conv_buffer(frame: jax.Array) -> jax.Array:
    """The conversion-buffer 16bpp path (`conv_buffer[i] = src[i] << 11`,
    Manager.hx:337-343)."""
    return (frame << 11).astype(jnp.uint32)


def rgb_to_opaque(frame: jax.Array) -> jax.Array:
    """`conv_buffer[i] = 0xFF000000 | c` (Manager.hx:345-355)."""
    return (jnp.uint32(0xFF000000) | frame).astype(jnp.uint32)


def split_channels(frame: jax.Array, bpp16: bool = False) -> jax.Array:
    """u32-packed [..., H, W] → [..., H, W, 3] uint8 in TRUE (R, G, B).

    Ground truth for the channel order (round 2): the reference's canvas
    blit writes dst = 0xFF000000 | ((c&0xFF)<<16) | (c&0xFF00) |
    ((c>>16)&0xFF) into an ImageData whose little-endian u32 layout is
    A<<24|B<<16|G<<8|R (Manager.hx:377-380) — i.e. the u32's HIGH byte is
    displayed RED and the LOW byte BLUE, for BOTH codecs (MSVideo1's
    fromRGB15 packs the RGB555 R field high too, MSVideo1.hx:211-214).
    FFmpeg's independent scpr/msvideo1 decoders agree
    (tests/test_ffmpeg_crossval.py byte mappings).  The reference's
    *variable names* in the SP decode loop call the first coded channel
    "r" — misleading; it lands in the blue display channel.  For 16bpp SP
    content the 5-bit values are scaled <<3 like the display path.
    """
    c = frame
    r = ((c >> 16) & 0xFF).astype(jnp.uint8)
    g = ((c >> 8) & 0xFF).astype(jnp.uint8)
    b = (c & 0xFF).astype(jnp.uint8)
    out = jnp.stack([r, g, b], axis=-1)
    if bpp16:
        out = out << 3
    return out


def _flip_rows(x: jax.Array, axis: int) -> jax.Array:
    """Vertical flip via a reversed-row gather (whole rows move, so the
    gather reads contiguous memory)."""
    idx = jnp.arange(x.shape[axis] - 1, -1, -1)
    return jnp.take(x, idx, axis=axis)


def to_model_input(
    frame: jax.Array,
    dtype=jnp.bfloat16,
    layout: str = "NHWC",
    mean: float = 0.0,
    scale: float = 1.0 / 255.0,
    flip_vertical: bool = True,
    bpp16: bool = False,
    downscale: int = 1,
) -> jax.Array:
    """Fused decode→model-tensor epilogue: u32 [..., H, W] → normalized
    [..., H/d, W/d, 3] (NHWC) or [..., 3, H/d, W/d] (NCHW) in `dtype`.

    downscale: power-of-two box downsample applied in exact integer math
    before normalization (full-res bf16 NHWC is larger than the packed u32
    frame — downscaling is what makes the fused emit cheaper than frames).
    """
    d = downscale
    assert 1 <= d <= 16 and (d & (d - 1)) == 0, \
        "downscale must be a power of two <= 16 (field-sum bound)"
    # Layout rules:
    #  - keep channels out of the minor dimension while full-res H/W math
    #    runs (a trailing dim of 3 wastes most of each vector);
    #  - box-window the PACKED word: r and b ride one u32 as two 16-bit
    #    fields (2x2..16x16 sums of u8 stay < 2^16), g rides another —
    #    two [..., H, W] reduce_windows instead of a [..., 3, H, W]
    #    materialization;
    #  - flip commutes with the box window -> flip the small tensor;
    #  - NHWC emerges only at the very end.
    c = frame
    p0 = (c & jnp.uint32(0x00FF00FF)).astype(jnp.int32)  # r | b<<16
    p1 = ((c >> 8) & jnp.uint32(0xFF)).astype(jnp.int32)  # g
    denom = 1
    while d > 1:
        nd = p0.ndim
        win = [1] * nd
        win[-2] = win[-1] = 2
        p0 = jax.lax.reduce_window(p0, 0, jax.lax.add, tuple(win), tuple(win),
                                   "VALID")
        p1 = jax.lax.reduce_window(p1, 0, jax.lax.add, tuple(win), tuple(win),
                                   "VALID")
        denom *= 4
        d >>= 1
    # channel order (R, G, B): the u32 HIGH byte is displayed red — see
    # split_channels' ground-truth note (Manager.hx canvas swizzle; both
    # codecs pack R high, so no per-codec flip exists downstream)
    x = jnp.stack([p0 >> 16, p1, p0 & 0xFFFF], axis=-3)
    if bpp16:
        x = x << 3
    if flip_vertical:
        x = _flip_rows(x, -2)  # bottom-up storage → top-down tensor
    x = (x.astype(jnp.float32) * (scale / denom) - mean).astype(dtype)
    if layout == "NHWC":
        x = jnp.moveaxis(x, -3, -1)
    return x


# ---------------------------------------------------------------------------
# Packed ds2 epilogue
# ---------------------------------------------------------------------------
#
# The fused model path can emit ONE packed [H/2, W/2] i32 plane per frame
# (r/g/b 2x2 box sums as 10-bit fields, max 1020 < 1024) from inside the
# decode scan, and run the unpack/normalize once on the small stack outside
# (sp_recon._model_emit).  The packing is plain integer XLA: a mask/shift
# into one word and a 2x2 reduce_window, which XLA fuses into the scan.


def ds2_pack(frame: jax.Array) -> jax.Array:
    """[..., Y, X] u32 → [..., Y//2, X//2] i32 packed 10-bit field sums
    (b | g<<10 | r<<20); odd trailing rows/columns are dropped."""
    c = frame
    f = ((c & 0xFF) | (((c >> 8) & 0xFF) << 10)
         | (((c >> 16) & 0xFF) << 20)).astype(jnp.int32)
    nd = f.ndim
    win = [1] * nd
    win[-2] = win[-1] = 2
    return jax.lax.reduce_window(f, 0, jax.lax.add, tuple(win), tuple(win),
                                 "VALID")


def ds2_packed_output(frames: jax.Array, flip_vertical: bool = True
                      ) -> jax.Array:
    """The packed-ds2 model product: [.., H/2, W/2] i32 field-sum planes
    with the vertical flip already applied (rows top-down).  Consumers
    unpack with unpack_ds2(red, flip_vertical=False, ...) — typically
    fused into their first model op, so the pipeline never writes the
    unpacked tensors."""
    red = ds2_pack(frames)
    if flip_vertical:
        red = _flip_rows(red, -2)
    return red


def unpack_ds2(
    red: jax.Array,
    dtype=jnp.bfloat16,
    layout: str = "NHWC",
    mean: float = 0.0,
    scale: float = 1.0 / 255.0,
    flip_vertical: bool = True,
    bpp16: bool = False,
) -> jax.Array:
    """Packed ds2 plane stack → normalized model tensors (the same math as
    to_model_input(downscale=2): integer sums then one f32 multiply, so the
    result is bit-exact vs the unfused epilogue)."""
    x = jnp.stack([(red >> 20) & 1023, (red >> 10) & 1023, red & 1023],
                  axis=-3)
    if bpp16:
        x = x << 3
    if flip_vertical:
        x = _flip_rows(x, -2)
    x = (x.astype(jnp.float32) * (scale / 4.0) - mean).astype(dtype)
    if layout == "NHWC":
        x = jnp.moveaxis(x, -3, -1)
    return x


def packed_consumer_step(red: jax.Array, w: jax.Array,
                         **unpack_kw) -> jax.Array:
    """The consuming side of the packed-ds2 contract: a ViT-style
    patch-embed conv whose FIRST op takes unpack_ds2's output, so XLA fuses
    the unpack arithmetic into the conv's input pipeline (the epilogue
    analog of Manager.fill_bitmap_data feeding the canvas,
    Manager.hx:325-390).

    red: [.., H, W] i32 packed planes (ds2_packed_output contract — flip
    already applied).  w: [ph, pw, 3, D] patch-embed weights.  Returns
    [.., H', W', D] embeddings in w/unpack dtype (bf16 default)."""
    unpack_kw.setdefault("flip_vertical", False)
    x = unpack_ds2(red, **unpack_kw)            # [.., H, W, 3]
    ph, pw = w.shape[0], w.shape[1]
    return jax.lax.conv_general_dilated(
        x, w.astype(x.dtype), window_strides=(ph, pw), padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def resize_half(frame_u8: jax.Array) -> jax.Array:
    """2x box downsample on [..., H, W, C] uint8 (ingestion resize).

    Implemented as lax.reduce_window, which keeps W as the minor
    dimension instead of splitting it with a reshape."""
    x = frame_u8.astype(jnp.int32)
    nd = x.ndim
    win = [1] * nd
    win[-3] = win[-2] = 2
    x = jax.lax.reduce_window(x, 0, jax.lax.add, tuple(win), tuple(win),
                              "VALID")
    return (x // 4).astype(jnp.uint8)
