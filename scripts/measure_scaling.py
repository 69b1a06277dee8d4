"""Scaling-efficiency measurement for the sharded SVGP training step.

BASELINE.md target: >= 80% scaling efficiency (ELBO-steps/s, samples/s)
from 1 device to N devices / 1 host to N hosts. This script measures it
with *weak scaling* (constant per-device minibatch — the regime the
reference's M≈500 benchmark maps to when the dataset is sharded):

  efficiency(k) = steps_per_s(k devices) / steps_per_s(1 device)

(with k× the global batch per step, so ideal weak scaling keeps steps/s
flat and multiplies samples/s by k).

Single process (virtual devices or one GPU host):
    python scripts/measure_scaling.py --devices 1 2 4 8 --cpu

Multi-host (one process per host; run on every host, process 0 reports):
    python scripts/measure_scaling.py --coordinator host0:9911 \
        --num-processes 2 --process-id <i>

On GPU hosts, drop --cpu and the XLA device-count override: the same
mesh/step code shards over NVLink within a host and the network across
hosts via jax.distributed.
"""

import argparse
import json
import os
import sys
import time

parser = argparse.ArgumentParser()
parser.add_argument("--devices", type=int, nargs="*", default=None,
                    help="device counts to measure (single-process mode); "
                         "default: 1,2,...,all")
parser.add_argument("--cpu", action="store_true",
                    help="force CPU backend with 8 virtual devices")
parser.add_argument("--coordinator", default=None)
parser.add_argument("--num-processes", type=int, default=None)
parser.add_argument("--process-id", type=int, default=None)
parser.add_argument("--local-devices", type=int, default=4,
                    help="virtual CPU devices per process (multi-process "
                         "CPU mode)")
parser.add_argument("--batch-per-device", type=int, default=32)
parser.add_argument("--num-data", type=int, default=4096)
parser.add_argument("--num-tensors", type=int, default=64)
parser.add_argument("--num-levels", type=int, default=4)
parser.add_argument("--seq-len", type=int, default=50)
parser.add_argument("--steps", type=int, default=20)
parser.add_argument("--emit", default=None,
                    help="also write the result JSON to this path "
                         "(CI artifact; process 0 only in multiproc mode)")
args = parser.parse_args()

multiproc = args.coordinator is not None
if args.cpu or multiproc:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count="
          f"{args.local_devices if multiproc else 8}"
    )
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np  # noqa: E402
import jax  # noqa: E402

if args.cpu or multiproc:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from gpsig import likelihoods as liks  # noqa: E402
from gpsig.inducing import make_inducing_tensors_from_data  # noqa: E402
from gpsig.kernels.signature import SignatureRBF  # noqa: E402
from gpsig.models.svgp import SVGP  # noqa: E402
from gpsig.parallel import mesh as meshlib  # noqa: E402
from gpsig.parallel.train import make_sharded_step_fn  # noqa: E402
from gpsig.training.loop import init_state  # noqa: E402


def build(dtype, d=2, C=4):
    rng = np.random.default_rng(0)
    kern = SignatureRBF(d, args.num_levels, lengthscales=float(np.sqrt(d)),
                        order=1, dtype=dtype)
    Xinit = jnp.asarray(
        (0.3 * rng.standard_normal((256, args.seq_len, d))).cumsum(1), dtype
    )
    feat = make_inducing_tensors_from_data(
        jax.random.PRNGKey(0), Xinit, num_tensors=args.num_tensors,
        num_levels=args.num_levels, num_features=d, increments=True,
    )
    model = SVGP.create(kern, liks.MultiClass(num_classes=C), feat,
                        num_latent=C, dtype=dtype)
    return model


def measure(mesh, n_dev, dtype=jnp.float32, d=2, C=4):
    rng = np.random.default_rng(1)
    B = args.batch_per_device * n_dev
    model = build(dtype, d, C)
    opt = optax.adam(1e-3)
    state = init_state(model, opt)
    step = make_sharded_step_fn(opt, num_data=args.num_data, mesh=mesh,
                                gamma=0.1)
    sh = meshlib.batch_sharding(mesh)
    Xh = (0.3 * rng.standard_normal((B, args.seq_len, d))).cumsum(1)
    Yh = rng.integers(0, C, B)
    X = jax.make_array_from_callback(
        Xh.shape, sh, lambda idx: jnp.asarray(Xh[idx], dtype))
    Y = jax.make_array_from_callback(
        Yh.shape, sh, lambda idx: jnp.asarray(Yh[idx]))
    # warmup/compile
    state, e = step(state, X, Y, jax.random.PRNGKey(2))
    jax.block_until_ready(e)
    t0 = time.time()
    for i in range(args.steps):
        state, e = step(state, X, Y, jax.random.PRNGKey(3 + i))
    jax.block_until_ready(e)
    dt = time.time() - t0
    return dict(devices=n_dev, batch=B, steps_per_s=args.steps / dt,
                samples_per_s=args.steps * B / dt, elbo=float(e))


def main():
    if multiproc:
        meshlib.init_distributed(args.coordinator, args.num_processes,
                                 args.process_id)
        n = len(jax.devices())
        mesh = meshlib.make_mesh(data=n, tile=1)
        row = measure(mesh, n)
        if jax.process_index() == 0:
            row["num_processes"] = args.num_processes
            print(json.dumps(row), flush=True)
            if args.emit:
                json.dump(row, open(args.emit, "w"), indent=1)
        return

    all_dev = jax.devices()
    counts = args.devices or [
        k for k in (1, 2, 4, 8, 16, 32) if k <= len(all_dev)
    ]
    rows = []
    for k in counts:
        mesh = meshlib.make_mesh(data=k, tile=1, devices=all_dev[:k])
        rows.append(measure(mesh, k))
        print(json.dumps(rows[-1]), flush=True)
    base = rows[0]["steps_per_s"]
    for r in rows:
        r["efficiency"] = r["steps_per_s"] / base
    summary = {
        "rows": rows,
        "summary": [
            {"devices": r["devices"],
             "efficiency": round(r["efficiency"], 3)} for r in rows
        ],
        "target": ">=0.8 weak-scaling efficiency (BASELINE.md)",
        # virtual CPU devices oversubscribing physical cores measure the
        # sharding plumbing, not real efficiency — the env block makes a
        # committed artifact self-describing about that
        "environment": {
            "backend": jax.default_backend(),
            "devices_are_virtual_cpu": bool(args.cpu or multiproc),
            "physical_cpus": os.cpu_count(),
            "shapes": {
                "batch_per_device": args.batch_per_device,
                "num_tensors": args.num_tensors,
                "num_levels": args.num_levels,
                "seq_len": args.seq_len,
                "steps": args.steps,
            },
        },
    }
    print(json.dumps({k: summary[k] for k in ("summary", "target")}),
          flush=True)
    if args.emit:
        json.dump(summary, open(args.emit, "w"), indent=1)


if __name__ == "__main__":
    main()
