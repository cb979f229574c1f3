"""Two-process jax.distributed dryrun of the multi-host encode mesh.

BASELINE config 5's fleet story: two OS processes (standing in for two
hosts) each contribute 4 virtual CPU devices to one 8-device global
mesh via ``jax.distributed`` + gloo collectives, shard a FLAC
analysis batch across it with ``sharded_packed_encode_step``, and the
decisions must equal the single-host NumPy backend bit for bit (the
contraction-immune numeric spec).  The replicated total-bits output
is the one cross-host collective — both processes must agree with the
host value.

Each worker pins itself to the CPU platform with 4 virtual devices.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    os.environ.get("ATPU_SKIP_MULTICHIP") == "1",
    reason="multichip tests disabled")


WORKER = r"""
import os, sys
proc_id = int(sys.argv[1])
port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np
from audiotools_tpu.parallel import mesh as mesh_mod
from audiotools_tpu.ops import flac_frames, lpc as lpc_ops

mesh_mod.init_distributed("127.0.0.1:" + port, 2, proc_id)

import jax
devs = jax.devices()
assert len(devs) == 8, "expected 8 global devices, got %d" % len(devs)
assert len(jax.local_devices()) == 4

n, K = 512, 6
porders = flac_frames.valid_partition_orders(n, 3, max(K, 4))
rng = np.random.default_rng(11)
t = np.arange(32 * n)
base = 8000.0 * np.sin(t * 0.013)
blocks = np.clip(np.stack([base + rng.integers(-200, 200, 32 * n),
                           0.7 * base], axis=1),
                 -32768, 32767).astype(np.int32).reshape(32, n, 2)
window = lpc_ops.tukey_window_df(n)

mesh = mesh_mod.make_mesh(8)
step = mesh_mod.sharded_packed_encode_step(
    mesh, n, K, 12, porders, 14, True, bps=16, mid_side=True)

# each "host" holds its contiguous half of the batch
local_blocks = blocks.reshape(2, 16, n, 2)[proc_id]
global_blocks = mesh_mod.host_local_to_global(mesh, local_blocks)
(packed, total_bits) = step(global_blocks, window)
local_packed = np.asarray(
    mesh_mod.global_to_host_local(mesh, packed))

host = np.asarray(flac_frames.analyze_frames_packed(
    np, blocks, True, 16, n, K, 12, porders, 14, True, True, window))
host_local = host.reshape(2, 16, host.shape[1])[proc_id]
assert np.array_equal(local_packed, host_local), \
    "proc %d decisions diverge from host backend" % proc_id

W = flac_frames.packed_width(K, 1 << porders[-1])
host_bits = sum(host[:, 1 + s * W + 5].astype(np.float64).sum()
                for s in range(2))
assert float(total_bits) == float(host_bits), \
    (float(total_bits), float(host_bits))
print("OK proc %d total_bits %.1f" % (proc_id, float(total_bits)),
     flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_mesh(tmp_path):
    port = str(_free_port())
    env = dict(os.environ)
    # the workers import the package from the checkout and pick
    # their own platform
    env["PYTHONPATH"] = REPO
    env.pop("JAX_PLATFORMS", None)

    workers = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(proc_id), port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=str(tmp_path))
        for proc_id in range(2)]
    outs = []
    for (proc_id, worker) in enumerate(workers):
        try:
            (out, err) = worker.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for w in workers:
                w.kill()
            raise
        outs.append((worker.returncode, out, err))
    for (proc_id, (rc, out, err)) in enumerate(outs):
        assert rc == 0, "proc %d failed:\n%s" % (proc_id, err[-3000:])
        assert ("OK proc %d" % proc_id) in out
    # both processes agreed on the replicated cross-host reduction
    bits = {line.split()[-1] for (_rc, out, _err) in outs
            for line in out.splitlines() if line.startswith("OK")}
    assert len(bits) == 1
