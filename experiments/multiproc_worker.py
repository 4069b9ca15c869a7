"""One process of an N-process qnx bring-up (VERDICT r3 #3).

    python experiments/multiproc_worker.py PORT PROCESS_ID NUM_PROCESSES \
        [LOCAL_DEVICES]

Initializes ``jax.distributed`` against a local TCP coordinator
(process 0 hosts it), builds the GLOBAL (data, model) mesh over all
processes' CPU devices, runs the sharded train-step + TP-serving
workloads, and prints one JSON line with replicated scalars.  The test
harness (tests/test_multiprocess.py) spawns two of these and checks the
scalars match each other AND a single-process run bit-for-bit.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    port, pid, nprocs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    local = int(sys.argv[4]) if len(sys.argv) > 4 else 4

    import jax

    # must precede any backend use
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", local)

    from qnx.parallel.bringup import bringup_workloads
    from qnx.parallel.mesh import initialize_distributed, make_mesh

    idx = initialize_distributed(f"127.0.0.1:{port}", num_processes=nprocs,
                                 process_id=pid)
    assert idx == pid, (idx, pid)
    assert jax.process_count() == nprocs
    assert len(jax.local_devices()) == local
    assert len(jax.devices()) == nprocs * local  # the global device list

    result = bringup_workloads(make_mesh())
    result.update(process_index=idx, process_count=nprocs,
                  n_global_devices=len(jax.devices()))
    print("BRINGUP " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
