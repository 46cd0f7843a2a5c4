"""Display/ingestion conversions: parity with the Manager's per-pixel loops
(fill_bitmap_data, Manager.hx:325-390) + model-tensor epilogue shapes."""

import numpy as np
import jax.numpy as jnp
import pytest

from jsplayer_tpu.kernels.rgb_convert import (
    resize_half,
    rgb15_to_argb,
    rgb15_to_argb_conv_buffer,
    rgb_to_abgr,
    rgb_to_opaque,
    split_channels,
    to_model_input,
)


def host_abgr(src):
    # Manager.hx:379 reference loop
    return (0xFF000000 | ((src & 0xFF) << 16) | (src & 0xFF00)
            | ((src >> 16) & 0xFF)).astype(np.uint32)


def test_abgr_parity_with_manager_loop():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 1 << 24, (16, 16), dtype=np.uint32)
    got = np.asarray(rgb_to_abgr(jnp.array(src)))
    np.testing.assert_array_equal(got, host_abgr(src))


def test_rgb15_paths():
    rng = np.random.default_rng(1)
    src = rng.integers(0, 1 << 15, (8, 8), dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(rgb15_to_argb(jnp.array(src))),
        (0xFF000000 | (src << 3)).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(rgb15_to_argb_conv_buffer(jnp.array(src))),
        (src << 11).astype(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(rgb_to_opaque(jnp.array(src))),
        (0xFF000000 | src).astype(np.uint32))


def test_split_channels_and_model_input():
    # u32 HIGH byte = displayed RED for both codecs (Manager.hx:377-380
    # canvas swizzle; FFmpeg crossval agrees) — split order is true RGB
    src = np.array([[(3 << 16) | (2 << 8) | 1, (255 << 16) | (128 << 8) | 0]],
                   dtype=np.uint32)
    ch = np.asarray(split_channels(jnp.array(src)))
    np.testing.assert_array_equal(ch[0, 0], [3, 2, 1])
    np.testing.assert_array_equal(ch[0, 1], [255, 128, 0])
    # 16bpp scaling <<3
    ch16 = np.asarray(split_channels(jnp.array(src), bpp16=True))
    np.testing.assert_array_equal(ch16[0, 0], [24, 16, 8])

    mi = to_model_input(jnp.array(np.tile(src, (4, 2))), dtype=jnp.float32,
                        layout="NCHW", flip_vertical=False)
    assert mi.shape == (3, 4, 4)
    assert float(mi[0, 0, 0]) == pytest.approx(3 / 255.0)

    # vertical flip maps stored bottom-up rows to top-down tensors
    two = np.zeros((2, 1), dtype=np.uint32)
    two[0, 0] = 10  # stored bottom row
    mi = to_model_input(jnp.array(two), dtype=jnp.float32)
    assert float(mi[1, 0, 2]) == pytest.approx(10 / 255.0)  # low byte = B
    assert float(mi[0, 0, 2]) == 0.0


def test_resize_half():
    x = np.arange(4 * 4 * 3, dtype=np.uint8).reshape(4, 4, 3)
    y = np.asarray(resize_half(jnp.array(x)))
    assert y.shape == (2, 2, 3)
    assert int(y[0, 0, 0]) == (int(x[0, 0, 0]) + int(x[0, 1, 0])
                               + int(x[1, 0, 0]) + int(x[1, 1, 0])) // 4


def test_manager_get_rgba_parity():
    """Manager.get_rgba (host) vs device rgb_to_abgr on the same buffer."""
    from jsplayer_tpu.pipeline.manager import Manager
    from jsplayer_tpu.core.loader import DataLoaderAVISeq

    m = Manager(DataLoaderAVISeq(), num_buffers=2)
    rng = np.random.default_rng(2)
    buf = rng.integers(0, 1 << 24, 64, dtype=np.uint32)
    m.buffers = [buf]
    m._last_filled_buffer = 0
    m.convert_from_rgb15 = False
    np.testing.assert_array_equal(m.get_rgba(), host_abgr(buf))
    m.convert_from_rgb15 = True
    np.testing.assert_array_equal(
        m.get_rgba(), (0xFF000000 | (buf << 3)).astype(np.uint32))


def test_to_model_input_downscale_exact():
    import numpy as np
    import jax.numpy as jnp
    from jsplayer_tpu.kernels.rgb_convert import to_model_input

    rng = np.random.default_rng(0)
    f = rng.integers(0, 1 << 24, (8, 16)).astype(np.uint32)
    out = np.asarray(to_model_input(jnp.array(f), downscale=2,
                                    dtype=jnp.float32))
    assert out.shape == (4, 8, 3)
    # exact box mean (integer window sum, single float divide) of the
    # flipped u8 channels
    ch = np.stack([(f >> 16) & 0xFF, (f >> 8) & 0xFF, (f & 0xFF)], -1)
    ch = ch[::-1]  # flip_vertical
    want = ch.reshape(4, 2, 8, 2, 3).sum(axis=(1, 3)).astype(np.float32)
    np.testing.assert_allclose(out, want * (1.0 / 255.0 / 4), rtol=1e-6)


def test_packed_consumer_step_matches_unfused():
    """The packed-ds2 consumer contract: a patch-embed
    step fed the packed planes (ds2_packed_output + in-step unpack) must
    equal the same conv fed the unfused model tensors — proving consumers
    lose nothing by taking the packed product."""
    import jax
    from jsplayer_tpu.kernels.rgb_convert import (
        ds2_packed_output, packed_consumer_step, to_model_input)

    rng = np.random.default_rng(3)
    frames = jnp.array(rng.integers(0, 1 << 24, (3, 32, 64)).astype(np.uint32))
    w = jnp.array(rng.normal(0, 0.05, (8, 8, 3, 16)), jnp.bfloat16)

    red = ds2_packed_output(frames)           # [3, 16, 32] i32, flipped
    got = packed_consumer_step(red, w)

    dense = to_model_input(frames, downscale=2)  # [3, 16, 32, 3] bf16 NHWC
    want = jax.lax.conv_general_dilated(
        dense, w.astype(dense.dtype), window_strides=(8, 8),
        padding="VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert got.shape == want.shape == (3, 2, 4, 16)
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))


def test_packed_consumer_through_pipeline():
    """End-to-end: IngestConfig(model_packed=True) windows feed
    packed_consumer_step; embeddings equal the unpacked pipeline's fed to
    the same conv."""
    import jax
    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
    from jsplayer_tpu.kernels.rgb_convert import packed_consumer_step
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline

    X, Y, T = 64, 48, 6
    rng = np.random.default_rng(11)
    enc = ScreenPressorEncoder(4, X, Y)
    streams, keys = [], []
    f = np.full((Y, X), pack_rgb(10, 20, 30), dtype=np.uint32)
    for t in range(T):
        if t:
            f = f.copy()
            f[4 * t : 4 * t + 4, 8:40] = pack_rgb(*rng.integers(0, 256, 3))
        streams.append(enc.encode_i(f.reshape(-1)) if t == 0
                       else enc.encode_p(f.reshape(-1)))
        keys.append(t == 0)
    avi = mux_avi(streams, X, Y, 24, codec="SPV4", keyflags=keys)
    w = jnp.array(rng.normal(0, 0.05, (4, 4, 3, 8)), jnp.bfloat16)

    def run(packed):
        pipe = VideoIngestPipeline(
            [MemorySource(avi)],
            IngestConfig(window=T, emit_frames=False, emit_model_input=True,
                         model_downscale=2, model_packed=packed))
        (batch,) = list(pipe)
        mi = batch["model_input"]
        mi = mi.reshape((-1,) + mi.shape[2:])  # [B, T, ...] -> [B*T, ...]
        if packed:
            return packed_consumer_step(mi, w)
        return jax.lax.conv_general_dilated(
            mi, w.astype(mi.dtype), window_strides=(4, 4), padding="VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    np.testing.assert_array_equal(np.asarray(run(True), np.float32),
                                  np.asarray(run(False), np.float32))


@pytest.mark.parametrize("shape", [(2, 16, 32), (1080, 1920), (3, 18, 37)])
def test_ds2_pack_xla_matches_box_sum(shape):
    """ds2_pack is one plain XLA program on every backend (no Pallas call):
    packed 10-bit 2×2 field sums b | g<<10 | r<<20, odd trailing rows and
    columns dropped."""
    import jax
    from jsplayer_tpu.kernels.rgb_convert import ds2_pack

    rng = np.random.default_rng(sum(shape))
    f = rng.integers(0, 1 << 24, shape).astype(np.uint32)
    assert "pallas" not in str(jax.make_jaxpr(ds2_pack)(jnp.array(f)))
    got = np.asarray(jax.jit(ds2_pack)(jnp.array(f)))
    H, W = shape[-2] // 2 * 2, shape[-1] // 2 * 2
    c = f[..., :H, :W].astype(np.int64)

    def box(ch):
        return ch.reshape(shape[:-2] + (H // 2, 2, W // 2, 2)).sum(
            axis=(-3, -1))

    want = (box(c & 0xFF) | (box((c >> 8) & 0xFF) << 10)
            | (box((c >> 16) & 0xFF) << 20))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
