"""chip_smoke.py's phases at tiny sizes on the CPU: the same functions the
GPU run calls at 1080p, so a broken phase shows here before it costs a
card."""

import os
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

# screen_mix needs X > 200 and Y > 150
X, Y, T, W = 256, 176, 8, 4


@pytest.fixture(scope="module")
def corpus():
    return chip_smoke.make_sp_corpus(X, Y, T, n_streams=4)


def test_main_exits_nonzero_on_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_corpus_is_lossless(corpus):
    from jsplayer_tpu.codecs.screenpressor import ScreenPressor

    assert len(corpus.avis) == 4 and corpus.frames[3].shape == (T, Y, X)
    dec = ScreenPressor(X, Y, 24)
    dec.preinit(0)
    for t, src in enumerate(corpus.streams[3]):
        dst = np.zeros(X * Y, np.uint32)
        if t == 0:
            dec.decompress_i(src, dst)
        else:
            dec.decompress_p(src, dst)
        np.testing.assert_array_equal(dec.previous_frame().reshape(Y, X),
                                      corpus.frames[3][t])


def test_phase_a(corpus, capsys):
    res = chip_smoke.phase_a(corpus, W)
    assert res["frames_bit_exact"] == 4 * T
    assert res["cli_frames_decoded"] == 4 * T
    assert res["concat_windows"] + res["padded_windows"] == T // W


def test_phase_b(corpus):
    res = chip_smoke.phase_b(corpus, W)["frames_bit_exact"]
    assert set(res) == {"bc", "kmv_sparse", "kmv_sparse_lane_payload",
                        "general", "model_packed", "lane_raw", "lane_rans"}
    assert all(n == 4 * W for n in res.values())


def test_phase_c():
    res = chip_smoke.phase_c(32, 24, 2, 6, 3)["frames_bit_exact"]
    assert res == {"msv1_16bit": 12, "msv1_8bit": 12}


def test_phase_d(corpus):
    res = chip_smoke.phase_d(corpus, W)
    assert res["frames_bit_exact_with_barrier"] == 4 * T
    assert isinstance(res["put_saw_overwrite"], bool)
    assert 0 <= res["frames_wrong_without_barrier"] <= 4 * T


def test_phase_e(corpus):
    res = chip_smoke.phase_e(corpus, W)
    assert set(res["compose_times"]) == {"general", "kmv"}
    for v in res["compose_times"].values():
        assert v["min_ms"] > 0 and v["median_ms"] >= v["min_ms"]
    mem = res["main_step_memory"]
    assert mem is None or mem["argument_size_in_bytes"] >= 4 * W * X * Y * 4


def test_phase_mesh_on_four_virtual_devices():
    devs = jax.devices()
    assert len(devs) >= 4
    keyed = chip_smoke.make_sp_corpus(X, Y, 4 * W, n_streams=4,
                                      keyframe_every=W)
    res = chip_smoke.phase_mesh(keyed, W, devs[:4])
    assert set(res) == {"kmv_elision_dp4", "bc_dp4", "lane_dp4",
                        "kmv_gop_dp2x2"}
    assert res["kmv_gop_dp2x2"]["frames_bit_exact"] == 2 * 4 * W
    assert res["bc_dp4"]["frames_bit_exact"] == 4 * 4 * W
    assert all(leg["devices"] == 4 for leg in res.values())


def test_model_input_ref_matches_device_epilogue():
    import jax.numpy as jnp

    from jsplayer_tpu.kernels.rgb_convert import ds2_packed_output, \
        to_model_input

    rng = np.random.default_rng(2)
    f = rng.integers(0, 1 << 24, (3, 10, 14)).astype(np.uint32)
    got = np.asarray(to_model_input(jnp.array(f), downscale=2))
    ref = chip_smoke.model_input_ref(f, 2)
    np.testing.assert_array_equal(got.view(np.uint16), ref.view(np.uint16))
    np.testing.assert_array_equal(np.asarray(ds2_packed_output(jnp.array(f))),
                                  chip_smoke.ds2_packed_ref(f))
