"""Multi-host initialization: jax.distributed plumbing + global meshes.

A single host needs nothing — ``jax.devices()`` sees every GPU on the host
and the Mesh collectives ride the host's interconnect (NVLink). Several
processes (several hosts, or CPU clusters) must call :func:`initialize`
once per process before any other jax use; afterwards ``jax.devices()`` is
the GLOBAL device list and :func:`global_mesh` builds the (dp, sp) mesh over
it, with hosts laid out along dp.

The reference has no distributed backend at all (SURVEY.md P6: its only
inter-process channel is a multiprocessing pipe); this module is the
device-side replacement for scaling BASELINE config 5 beyond one host.
"""

import os

import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               local_device_ids=None):
    """Initialize jax.distributed for a multi-host run (idempotent).

    Arguments default from the environment (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID); nothing is auto-detected, so a
    cluster is always named explicitly. Call before any other jax API.
    Returns False, and does nothing, when no coordinator is configured
    (single-process mode).
    """
    try:
        if jax.distributed.is_initialized():
            return True  # idempotent: already connected
    except AttributeError:  # older jax
        if getattr(initialize, "_done", False):
            return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if (coordinator_address is None) != (num_processes is None):
        raise ValueError(
            "incomplete cluster config: set BOTH JAX_COORDINATOR_ADDRESS "
            "and JAX_NUM_PROCESSES (got only one)")

    if coordinator_address is None:
        return False  # no cluster configured: single-process mode
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    initialize._done = True
    return True


def is_multi_process():
    return jax.process_count() > 1


def global_mesh(dp=None, sp=None):
    """(dp, sp) mesh over the GLOBAL device list.

    The default global device order groups a host's devices together and
    dp is the leading mesh axis, so frame batches shard across hosts.
    NOTE the mosaic step's partial-grid reduce-scatter runs over the
    FLATTENED (dp, sp) mesh: combining every host's partials into the
    band owners is a global reduction, so with multiple hosts that
    traffic necessarily crosses DCN regardless of the (dp, sp) split —
    the mesh shape controls band ownership and batch sharding, not
    whether DCN is used. Size the per-burst batch to amortize it (the
    reduction is once per burst, not per frame).
    """
    from auromat_tpu.parallel.sharding import make_mesh

    return make_mesh(jax.devices(), dp=dp, sp=sp)


def process_local_batch(global_batch_size):
    """This process's slice of a globally sharded frame batch.

    :returns: (start, count) frame indices this process should feed into a
        dp-sharded step via jax.make_array_from_process_local_data
    """
    n = jax.process_count()
    i = jax.process_index()
    if global_batch_size % n != 0:
        # not an assert: stripped under python -O, frames would silently
        # be dropped by the floor division below
        raise ValueError(
            f"global_batch_size {global_batch_size} not divisible by "
            f"{n} processes")
    per = global_batch_size // n
    return i * per, per
