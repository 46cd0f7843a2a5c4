"""Child process for tests/test_multihost.py — one jax.distributed worker.

Run as: python -u tests/_multihost_child.py <coordinator> <nprocs> <pid>

Exercises pipeline.mesh.init_multihost (the cross-host path, SURVEY.md §5.8) with
a REAL 2-process jax.distributed cluster on the CPU backend: the (dp, gop)
mesh spans both processes (2 local devices each), the sharded kmv decode
step runs over it, and each process verifies ITS addressable output shards
bit-exactly against the host oracle.  Cross-process collectives ride Gloo
(the CPU stand-in for the cross-host network).
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # also pin it past the env

import numpy as np


def main() -> None:
    coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    from jsplayer_tpu.pipeline.mesh import init_multihost, make_mesh

    init_multihost(coordinator=coordinator, num_processes=nprocs,
                   process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()
    ndev = len(jax.devices())
    assert ndev == 2 * nprocs, ndev

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jsplayer_tpu.encode.sp_enc import ScreenPressorEncoder, pack_rgb
    from jsplayer_tpu.kernels import sp_recon
    from jsplayer_tpu.pipeline.batch import (DecodeConfig,
                                             make_sp_decode_step_kmv,
                                             stack_sp_commands)

    X = Y = 32
    B, T = ndev, 4  # one stream per global device on the dp axis
    mesh = make_mesh(dp=B, gop=1)

    # identical deterministic content on every process (SPMD input contract)
    streams, golds = [], []
    for b in range(B):
        enc = ScreenPressorEncoder(4, X, Y)
        rng = np.random.default_rng(100 + b)
        f = np.full((Y, X), pack_rgb(b, 3, 5), dtype=np.uint32).reshape(-1)
        ss = [enc.encode_i(f)]
        gg = [f]
        for t in range(T - 1):
            g = f.copy().reshape(Y, X)
            g[2:, :] = g[:-2, :]  # scroll → motion
            g[4:8, 4:12] = pack_rgb(*rng.integers(0, 256, 3))
            f = g.reshape(-1)
            ss.append(enc.encode_p(f))
            gg.append(f)
        streams.append(ss)
        golds.append(gg)

    cmds = stack_sp_commands(streams, X, Y, gops=1)
    pcs = np.zeros((B, 1, T, Y, X), dtype=np.uint32)
    mvks = np.zeros((B, 1, T, 2, 2), dtype=np.int32)
    for b in range(B):
        pcs[b, 0], mvks[b, 0] = sp_recon.prepare_kmv(
            cmds["bts"][b, 0], cmds["mv"][b, 0], cmds["rect"][b, 0],
            cmds["payload"][b, 0], K=2)

    sh = NamedSharding(mesh, P("dp", "gop"))

    def dist(arr):
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx])

    step = make_sp_decode_step_kmv(
        mesh, DecodeConfig(height=Y, width=X, emit_model_input=False))
    out = step(dist(np.zeros((B, 1, Y, X), np.uint32)), dist(pcs),
               dist(mvks), dist(cmds["changed"]))
    jax.block_until_ready(out)

    # every process checks the shards IT holds against the oracle
    checked = 0
    for shard in out.addressable_shards:
        b = shard.index[0].start
        local = np.asarray(shard.data)  # [1, 1, T, Y, X]
        for t in range(T):
            np.testing.assert_array_equal(
                local[0, 0, t].reshape(-1), golds[b][t],
                err_msg=f"proc {pid} stream {b} frame {t}")
        checked += 1
    assert checked == 2, checked  # 2 local devices → 2 dp rows here

    # bc transport over the same cross-process mesh (round-3 host feed)
    from jsplayer_tpu.pipeline.batch import make_sp_decode_step_bc

    nb = ((X + 15) // 16) * ((Y + 15) // 16)
    planes = np.zeros((B, 1, T, Y, X), dtype=np.uint32)
    bcodes = np.zeros((B, 1, T, nb), dtype=np.uint8)
    rlocs = np.zeros((B, 1, T, nb, 4), dtype=np.uint8)
    mvks_bc = np.zeros((B, 1, T, 2, 2), dtype=np.int32)
    for b in range(B):
        (planes[b, 0], bcodes[b, 0], rlocs[b, 0],
         mvks_bc[b, 0]) = sp_recon.prepare_bc(
            cmds["bts"][b, 0], cmds["mv"][b, 0], cmds["rect"][b, 0],
            cmds["payload"][b, 0], K=2)
    bstep = make_sp_decode_step_bc(
        mesh, DecodeConfig(height=Y, width=X, emit_model_input=False))
    bout = bstep(dist(np.zeros((B, 1, Y, X), np.uint32)), dist(planes),
                 dist(bcodes), dist(rlocs), dist(mvks_bc),
                 dist(cmds["changed"]))
    jax.block_until_ready(bout)
    for shard in bout.addressable_shards:
        b = shard.index[0].start
        local = np.asarray(shard.data)
        for t in range(T):
            np.testing.assert_array_equal(
                local[0, 0, t].reshape(-1), golds[b][t] & 0x00FFFFFF,
                err_msg=f"bc proc {pid} stream {b} frame {t}")

    # lane-container leg: the serving format's device decode through the
    # SAME cross-process mesh (round 4) — full pipeline, host prep on
    # every process (SPMD input contract), each process verifying only
    # the dp shards it holds
    from jsplayer_tpu.core.source import MemorySource
    from jsplayer_tpu.encode.avi_mux import mux_avi
    from jsplayer_tpu.pipeline.ingest import IngestConfig, VideoIngestPipeline
    from jsplayer_tpu.transcode import transcode_to_lane

    keys = [t == 0 for t in range(T)]
    conts = [transcode_to_lane(
        mux_avi(streams[b], X, Y, 24, codec="SPV4", keyflags=keys),
        window=T, K=2) for b in range(B)]
    pipe = VideoIngestPipeline(
        [MemorySource(c) for c in conts],
        IngestConfig(sp_device_path="lane", mesh=mesh,
                     emit_model_input=False))
    lane_checked = 0
    for batch in pipe:
        for shard in batch["frames_u32"].addressable_shards:
            b = shard.index[0].start
            local = np.asarray(shard.data)  # [1, T, Y, X]
            for t in range(local.shape[1]):
                gi = batch["start_frame"] + t
                if gi < T:
                    np.testing.assert_array_equal(
                        local[0, t].reshape(-1) & 0x00FFFFFF,
                        golds[b][gi] & 0x00FFFFFF,
                        err_msg=f"lane proc {pid} stream {b} frame {gi}")
            lane_checked += 1
    assert lane_checked == 2, lane_checked

    # a cross-process collective through the mesh (the cross-host psum path)
    total = jax.jit(
        jax.shard_map(lambda c: jax.lax.psum(c.sum(), ("dp", "gop")),
                      mesh=mesh, in_specs=P("dp", "gop"), out_specs=P()),
    )(dist(cmds["changed"].astype(np.int32)))
    assert int(total) == int(cmds["changed"].sum()), int(total)

    print(f"MULTIHOST_OK proc={pid} devices={ndev} checked={checked}",
          flush=True)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
