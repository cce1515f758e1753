#!/usr/bin/env python
"""Two-process ``torch.distributed`` smoke of the port's multihost plan
build — ``scripts/multihost_smoke.py`` over spfft_tpu_torch, the
real-wire analogue of the stub-world tests of the collective protocol
(the reference's equivalent is running its MPI tests under real ranks,
reference: tests/run_mpi_tests.cpp:14-20).

Parent mode (no ``--worker``): spawns two worker processes on a localhost
store (a free port, or ``SPFFT_SMOKE_PORT`` where set) and reports their
combined verdict. Worker mode (``--worker <pid>``): brings up the process
group, builds the distributed plan collectively from its own shard's
triplets (stick-list allgather, fingerprint cross-check), runs one
backward + forward(FULL) on its shard, and prints ``worker <pid>: ok``.

Both workers use the card (``cuda:0`` on one card, over gloo: NCCL refuses
two ranks on one device; a card each over NCCL where there are two);
``--device cpu`` runs them on the host over gloo with the kernels' plain
PyTorch versions. Without a card and without ``--device cpu`` it exits 1
with the port's ``DeviceError``.

Usage:  python scripts/torch_multihost_smoke.py [--device cpu]
Exit 0 = both workers completed the collective plan build and a transform.
Any failure prints the worker logs.
"""
import argparse
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NPROC = 2
TIMEOUT_S = 300


def worker_device(device, pid: int):
    """Worker ``pid``'s device: ``device`` where given, else the card
    ``pid % device_count``."""
    import torch
    from spfft_tpu_torch.plan import resolve_device
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", pid % torch.cuda.device_count())
    return resolve_device(device)


def worker(pid: int, port: int, device) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from spfft_tpu_torch import (DistributedTransformPlan, Scaling,
                                 TransformType, initialize_multihost,
                                 make_mesh)
    from spfft_tpu_torch.parallel.multihost import \
        build_distributed_plan_multihost
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition,
                                                 spherical_cutoff_triplets)

    device = worker_device(device, pid)
    shared = device.type != "cuda" or torch.cuda.device_count() < NPROC
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=NPROC, process_id=pid,
                         backend="gloo" if shared else None)
    if dist.get_world_size() != NPROC:
        raise RuntimeError(f"world size {dist.get_world_size()}, expected "
                           f"{NPROC}")
    n_shards = NPROC  # one shard a process
    print(f"worker {pid}: process group up, {n_shards} global shards "
          f"({dist.get_backend()} on {device})", flush=True)

    n = 8
    triplets = spherical_cutoff_triplets(n)
    parts = round_robin_stick_partition(triplets, (n, n, n), n_shards)
    planes = even_plane_split(n, n_shards)
    # Collective build: each process contributes ITS shard only; the
    # plan build allgathers the stick lists and validates the blake2b
    # fingerprint across processes (the reference's plan-time Allreduce
    # mismatch check, grid_internal.cpp:148-167).
    local = slice(pid, pid + 1)
    group = dist.group.WORLD
    plan_ix = build_distributed_plan_multihost(
        TransformType.C2C, n, n, n, parts[local], planes[local],
        process_group=group)
    plan = DistributedTransformPlan(
        plan_ix, mesh=make_mesh(n_shards, device, process_group=group),
        precision="single")
    rng = np.random.default_rng(0)
    values = [(rng.uniform(-1, 1, len(p))
               + 1j * rng.uniform(-1, 1, len(p))).astype(np.complex64)
              for p in parts]
    out = plan.forward(plan.backward(values[local]), Scaling.FULL)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    got = plan.unshard_values(out)[0]
    err = float(np.abs(got - values[pid]).max()) if len(got) else 0.0
    dist.destroy_process_group()
    if not err < 1e-3:
        raise RuntimeError(f"round trip max error {err:.2e}")
    print(f"worker {pid}: round trip max error {err:.2e}", flush=True)
    print(f"worker {pid}: ok", flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(device) -> int:
    from spfft_tpu_torch import DeviceError
    try:
        worker_device(device, 0)
    except DeviceError as exc:
        print(f"error: DeviceError: {exc}", file=sys.stderr)
        return 1
    port = int(os.environ.get("SPFFT_SMOKE_PORT") or free_port())
    extra = [] if device is None else ["--device", device]
    procs = []
    for pid in range(NPROC):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             str(pid), "--port", str(port), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + TIMEOUT_S
    outs = [None] * NPROC
    for i, p in enumerate(procs):
        try:
            outs[i], _ = p.communicate(timeout=max(1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            p.kill()
            outs[i], _ = p.communicate()
            outs[i] += "\n<timed out>"
    ok = all(p.returncode == 0 and f"worker {i}: ok" in (outs[i] or "")
             for i, p in enumerate(procs))
    for i, o in enumerate(outs):
        print(f"--- worker {i} (rc={procs[i].returncode}) ---")
        print(o)
    print("MULTIHOST SMOKE:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", type=int, default=None,
                    help="run as worker <pid> (the parent spawns these)")
    ap.add_argument("--port", type=int, default=None,
                    help="the store's port (worker mode)")
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain PyTorch versions "
                         "on the host)")
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.port, args.device)
    else:
        sys.exit(main(args.device))
