"""Device-mesh sharding for batch codec work.

The device replacement for the reference's fork-based job queue
(``/root/reference/audiotools/__init__.py:5263`` ExecProgressQueue):
independent codec blocks — the (track, FLAC-frame) work units — are
data-parallel by construction, so they shard across a 1-D
``jax.sharding.Mesh`` along a ``blocks`` axis, with XLA inserting any
collectives.  A multi-host transcode farm extends the same mesh over
hosts via ``jax.distributed``; single-card encode uses the degenerate
1-device mesh.
"""

from __future__ import annotations

import os

import numpy as np


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """joins this process into a multi-host mesh

    the device analog of the reference farm spanning machines:
    every host runs the same program, ``jax.distributed`` stitches
    their devices into one global mesh, and the sharded encode steps
    below work unchanged (XLA routes the one replicated reduction
    between hosts).  Arguments default to the ATPU_COORDINATOR /
    ATPU_NUM_PROCESSES / ATPU_PROCESS_ID environment variables so CLI
    tools can join a fleet without code changes.

    On CPU backends the gloo collectives implementation is selected
    (required for cross-process CPU collectives; it is also how the
    2-process dryrun in tests/test_multihost.py runs without a GPU)."""
    import jax

    if coordinator_address is None:
        coordinator_address = os.environ.get("ATPU_COORDINATOR")
    if coordinator_address is None:
        raise ValueError("no coordinator address configured")
    if num_processes is None:
        num_processes = int(os.environ["ATPU_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["ATPU_PROCESS_ID"])

    try:
        jax.config.update("jax_cpu_collectives_implementation",
                          "gloo")
    except Exception:
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def host_local_to_global(mesh, local_array, axis_name="blocks"):
    """assembles per-host block shards into one global sharded array

    local_array is this host's contiguous slice along the leading
    axis; hosts are laid out in mesh order."""
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    return multihost_utils.host_local_array_to_global_array(
        local_array, mesh, P(axis_name))


def global_to_host_local(mesh, global_array, axis_name="blocks"):
    """fetches this host's slice of a globally sharded array"""
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    return multihost_utils.global_array_to_host_local_array(
        global_array, mesh, P(axis_name))


def jax_devices(platform=None, max_devices=None):
    """returns the JAX devices to use, honoring ATPU_JAX_PLATFORM"""
    import jax
    if platform is None:
        platform = os.environ.get("ATPU_JAX_PLATFORM") or None
    devices = jax.devices(platform) if platform else jax.devices()
    if max_devices is not None:
        devices = devices[:max_devices]
    return devices


def make_mesh(n_devices=None, platform=None, axis_name="blocks"):
    """builds a 1-D Mesh over the first n_devices devices of the
    platform (ATPU_JAX_PLATFORM, else JAX's default); raises when the
    platform has fewer — the mesh never falls back to another one"""
    from jax.sharding import Mesh
    devices = jax_devices(platform)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError("requested %d %s devices but only %d "
                             "available" % (n_devices,
                                            devices[0].platform,
                                            len(devices)))
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def sharded_analyze(mesh, n, max_lpc_order, qlp_precision, porders,
                    max_rice, exhaustive, axis_name="blocks"):
    """returns a jitted FLAC subframe analysis sharded over the mesh

    the returned function takes (X [S, n] int32, bps [S] int32,
    window [n] f64) with S divisible by the mesh size; the subframe
    axis is sharded, the window is replicated, and every output is
    sharded the same way — blocks never communicate (the codec's
    blockwise independence), so this scales linearly with devices
    """
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import flac_frames

    data_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())

    def run(X, bps, window):
        return flac_frames.analyze_subframes(
            jnp, X, bps, n, max_lpc_order, qlp_precision,
            list(porders), max_rice, exhaustive, window)

    return jax.jit(
        run,
        in_shardings=(data_sharding, data_sharding, replicated),
        out_shardings=data_sharding)


def sharded_packed_encode_step(mesh, n, max_lpc_order, qlp_precision,
                               porders, max_rice, exhaustive, bps=16,
                               mid_side=True, stereo_trial=True,
                               axis_name="blocks"):
    """the production multi-chip encode step over packed decisions

    takes (blocks [B, n, ch] int, window [n]) with B divisible by the
    mesh size; the frame axis is sharded, the window replicated, and
    the packed decision output is sharded the same way — frames never
    communicate (the codec's blockwise independence).  The replicated
    total-bits statistic is the one cross-shard reduction (XLA inserts
    the psum)."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import flac_frames

    data_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())
    W = flac_frames.packed_width(max_lpc_order, 1 << porders[-1])

    def run(blocks, window):
        packed = flac_frames.analyze_frames_packed(
            jnp, blocks, stereo_trial, bps, n, max_lpc_order,
            qlp_precision, list(porders), max_rice, exhaustive,
            mid_side, window)
        max_subframes = 2 if stereo_trial else blocks.shape[2]
        sub_bits_cols = [packed[:, 1 + s * W + 5]
                         for s in range(max_subframes)]
        total_bits = sum(jnp.sum(c.astype(jnp.float64))
                         for c in sub_bits_cols)
        return (packed, total_bits)

    return jax.jit(
        run,
        in_shardings=(data_sharding, replicated),
        out_shardings=(data_sharding, replicated))


def sharded_encode_step(mesh, n, max_lpc_order, qlp_precision, porders,
                        max_rice, exhaustive, axis_name="blocks"):
    """the full multi-chip encode step: sharded analysis plus the
    replicated stream statistics (bit totals) the serializer needs

    statistics reduce across the mesh (the one collective in the
    pipeline); everything else stays device-local
    """
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops import flac_frames

    data_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())

    def run(X, bps, window):
        out = flac_frames.analyze_subframes(
            jnp, X, bps, n, max_lpc_order, qlp_precision,
            list(porders), max_rice, exhaustive, window)
        # stream-level statistics: total coded bits across all shards
        # (reduces over the mesh; XLA inserts the psum)
        total_bits = jnp.sum(out["sub_bits"])
        return (out, total_bits)

    out_shardings = ({key: data_sharding for key in
                      ["choice", "wasted", "const_val", "order",
                       "porder", "rice_params", "residual", "qlp",
                       "shift", "samples", "sub_bits"]},
                     replicated)
    return jax.jit(
        run,
        in_shardings=(data_sharding, data_sharding, replicated),
        out_shardings=out_shardings)
