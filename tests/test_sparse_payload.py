"""Sparse payload transport: pack → integer block scatter → bit-exact frames."""

import numpy as np
import jax.numpy as jnp
import pytest

from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
from jsplayer_tpu.kernels.sparse_payload import (
    decode_sequence_sparse,
    pack_sequence,
    pack_tiles,
    unpack_payload,
)
from jsplayer_tpu.pipeline.batch import stack_sp_commands

X, Y = 128, 64


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 1 << 24, (Y, X)).astype(np.uint32)
    nb = (Y // 16) * (X // 16)
    bts = np.zeros(nb, np.int32)
    bts[[1, 5, 7, 12]] = [1, 2, 4, 1]
    bts[3] = 3  # motion: not packed
    tiles, blocks = pack_tiles(payload, bts, m_max=8)
    assert (blocks >= 0).sum() == 4
    dense = np.asarray(unpack_payload(jnp.array(tiles), jnp.array(blocks),
                                      nb, Y, X))
    p4 = payload.reshape(Y // 16, 16, X // 16, 16)
    d4 = dense.reshape(Y // 16, 16, X // 16, 16)
    for bi in (1, 5, 7, 12):
        by, bx = divmod(bi, X // 16)
        np.testing.assert_array_equal(d4[by, :, bx, :], p4[by, :, bx, :])
    by, bx = divmod(3, X // 16)
    assert (d4[by, :, bx, :] == 0).all()  # motion block not transported


def test_sparse_decode_bit_exact():
    enc = ScreenPressorEncoder(4, X, Y)
    rng = np.random.default_rng(1)
    f = np.full((Y, X), pack_rgb(7, 7, 7), dtype=np.uint32).reshape(-1)
    streams, golds = [enc.encode_i(f)], [f]
    for t in range(5):
        nf = f.copy().reshape(Y, X)
        if t % 2 == 0:
            nf[2:, :] = nf[:-2, :].copy()
        else:
            nf[10:14, 40:60] = pack_rgb(*rng.integers(0, 256, 3))
        f = nf.reshape(-1)
        streams.append(enc.encode_p(f))
        golds.append(f)
    cmds = stack_sp_commands([streams], X, Y)
    bts = cmds["bts"][0, 0]
    m_max = int(((bts > 0) & (bts != 3)).sum(axis=1).max())
    tiles, blocks = pack_sequence(cmds["payload"][0, 0], bts, m_max)
    # transport shrinks for P frames (the I-frame is inherently dense; real
    # pipelines bucket I-frames separately or keep them dense)
    p_active = ((bts[1:] > 0) & (bts[1:] != 3)).sum(axis=1)
    assert p_active.max() < bts.shape[1] // 2
    frames, signif = decode_sequence_sparse(
        jnp.zeros((Y, X), jnp.uint32), jnp.array(bts),
        jnp.array(cmds["mv"][0, 0]), jnp.array(cmds["rect"][0, 0]),
        jnp.array(tiles), jnp.array(blocks),
        jnp.array(cmds["changed"][0, 0]), jnp.int32(0))
    frames = np.asarray(frames)
    for t, g in enumerate(golds):
        np.testing.assert_array_equal(frames[t].reshape(-1), g,
                                      err_msg=f"frame {t}")


def test_unpack_payload_exact_for_wide_pixels():
    """Every 24-bit pixel, including values ≥ 2^11 that a float product in
    reduced precision would round, comes back bit-exact; padding entries
    (-1) touch no block and no float op is involved."""
    import jax

    nb = (Y // 16) * (X // 16)
    rng = np.random.default_rng(5)
    tiles = rng.integers(1 << 11, 1 << 24, (6, 256)).astype(np.uint32)
    tiles[0, :3] = [(1 << 24) - 1, (1 << 11) + 1, (1 << 23) + 1]
    blocks = np.array([0, 3, nb - 1, 9, -1, -1], np.int32)
    jaxpr = str(jax.make_jaxpr(lambda t, b: unpack_payload(t, b, nb, Y, X))(
        jnp.array(tiles), jnp.array(blocks)))
    assert "f32" not in jaxpr and "dot_general" not in jaxpr
    dense = np.asarray(unpack_payload(jnp.array(tiles), jnp.array(blocks),
                                      nb, Y, X))
    d4 = dense.reshape(Y // 16, 16, X // 16, 16).transpose(0, 2, 1, 3)
    d4 = d4.reshape(nb, 256)
    for k, bi in enumerate(blocks[:4]):
        np.testing.assert_array_equal(d4[bi], tiles[k])
    others = np.setdiff1d(np.arange(nb), blocks[:4])
    assert (d4[others] == 0).all()
