"""Multi-host path: a REAL 2-process jax.distributed cluster.

Why: ``pipeline.mesh.init_multihost`` was
an untested wrapper.  This test spawns two worker processes that each
initialize through it (CPU backend, 2 virtual devices per process), build
one (dp=4, gop=1) mesh SPANNING both processes, run the sharded kmv decode
step, verify their addressable output shards bit-exactly against the host
oracle, and run a cross-process psum — Gloo over localhost standing in for
the cross-host network.  The reference's only transport was XHR (SURVEY.md §5.8); this is the
framework's cross-host substrate actually exercised end-to-end.
"""

import os
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_decode():
    child = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_multihost_child.py")
    coordinator = f"127.0.0.1:{_free_port()}"
    # children must not inherit this pytest process's JAX/XLA env (conftest
    # pins an 8-device mesh; the child pins its own 2-device one)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", child, coordinator, "2", str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} rc={p.returncode}:\n{out[-3000:]}"
        assert f"MULTIHOST_OK proc={i} devices=4 checked=2" in out, out[-3000:]
