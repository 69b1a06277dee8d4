"""Worker process for the real multi-process jax.distributed harness.

Launched (typically twice) by tests/test_distributed.py or by hand:

    python scripts/distributed_worker.py --coordinator 127.0.0.1:9911 \
        --num-processes 2 --process-id 0 --local-devices 4 &
    python scripts/distributed_worker.py --coordinator 127.0.0.1:9911 \
        --num-processes 2 --process-id 1 --local-devices 4

Each process exposes ``--local-devices`` virtual CPU devices, joins the
coordination service, builds the global (num_processes × local) 'data'
mesh, and runs the deterministic SVGP problem of
``gpsig.parallel.distributed_check`` — the sharded ELBO/natgrad/Adam
step whose psums now genuinely cross process boundaries. Prints one JSON
line with the final ELBO and a model checksum (replicated values,
identical across processes and equal to a single-process run).

The same flow on real hardware: one process per host, default device
discovery (drop the XLA_FLAGS override), same mesh/step code.
"""

import argparse
import json
import os
import sys

parser = argparse.ArgumentParser()
parser.add_argument("--coordinator", required=True)
parser.add_argument("--num-processes", type=int, required=True)
parser.add_argument("--process-id", type=int, required=True)
parser.add_argument("--local-devices", type=int, default=4)
parser.add_argument("--iters", type=int, default=5)
args = parser.parse_args()

# Virtual CPU devices must be configured before the backend initialises.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + f" --xla_force_host_platform_device_count={args.local_devices}"
)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from gpsig.parallel import mesh as meshlib  # noqa: E402
from gpsig.parallel import distributed_check as dc  # noqa: E402

meshlib.init_distributed(
    coordinator=args.coordinator,
    num_processes=args.num_processes,
    process_id=args.process_id,
)
n_global = args.num_processes * args.local_devices
assert len(jax.devices()) == n_global, (
    f"expected {n_global} global devices, got {len(jax.devices())}"
)
mesh = meshlib.make_mesh(data=n_global, tile=1)
elbo, checksum = dc.run_steps(mesh, num_iters=args.iters)
print(json.dumps({
    "process_id": args.process_id,
    "num_processes": args.num_processes,
    "global_devices": n_global,
    "elbo": elbo,
    "checksum": checksum,
}), flush=True)
