"""One rank of a spfft_tpu_torch process group, for tests/test_torch_ranks.py.

    python tests/torch_ranks_worker.py SPEC.json RANK

``SPEC.json`` names the store's port, the world size, the backend, the
device and the cases; each case's inputs (every shard's triplets, plane
counts, values and space slabs) are in its ``.npz``. The rank brings up
the group (``initialize_multihost``), builds each case's plan from ITS OWN
shards' triplets only (``build_distributed_plan_multihost``) on a mesh
over the group, runs backward, forward(FULL) of that backward and
forward(NONE) of the given slabs on its own shards, and writes them to
``<out>/<case>_r<RANK>.npz`` with the plan's exchange kind, wire rung and
wire bytes. A case with ``"mismatch"`` passes other dims on rank 1 and
records the error every rank raised. This file imports torch and the
port only (no JAX).
"""

import json
import os
import sys

import numpy as np
import torch


def _plan(sp, mesh, case, parts, planes, rank, local):
    from spfft_tpu_torch.parallel import dist as tdist
    dims = [int(d) for d in case["dims"]]
    kind = sp.TransformType[case["transform"].upper()]
    lo = rank * local
    dp = sp.build_distributed_plan_multihost(
        kind, *dims, parts[lo:lo + local], planes[lo:lo + local])
    old = os.environ.pop(tdist.COMPACT_PPERMUTE_ENV, None)
    if case.get("ppermute"):
        os.environ[tdist.COMPACT_PPERMUTE_ENV] = "1"
    try:
        return sp.DistributedTransformPlan(
            dp, mesh=mesh, precision=case["precision"],
            exchange=sp.ExchangeType[case["exchange"]],
            overlap_chunks=case.get("k", 1),
            wire_precision=case.get("wire", 0),
            wire_error_budget=case.get("budget", 1.0),
            fused=case.get("fused", True))
    finally:
        os.environ.pop(tdist.COMPACT_PPERMUTE_ENV, None)
        if old is not None:
            os.environ[tdist.COMPACT_PPERMUTE_ENV] = old


def run_case(sp, group, spec, case, rank):
    data = np.load(case["npz"])
    s = int(data["num_shards"])
    parts = [data[f"parts_{r}"] for r in range(s)]
    planes = [int(p) for p in data["planes"]]
    world = spec["world"]
    local = s // world
    mesh = sp.make_mesh(s, spec["device"], process_group=group)
    out = os.path.join(spec["out"], f"{case['name']}_r{rank}.npz")
    if case.get("mismatch"):
        dims = [int(d) for d in case["dims"]]
        if rank == 1:
            dims[2] += 1
            planes = list(planes)
            planes[-1] += 1
        try:
            sp.build_distributed_plan_multihost(
                sp.TransformType.C2C, *dims,
                parts[rank * local:(rank + 1) * local],
                planes[rank * local:(rank + 1) * local])
            raised = ""
        except Exception as exc:  # noqa: BLE001 - recorded for the test
            raised = type(exc).__name__
        np.savez(out, raised=np.asarray(raised))
        return
    try:
        plan = _plan(sp, mesh, case, parts, planes, rank, local)
    except sp.DistributedError as exc:
        np.savez(out, refused=np.asarray(str(exc)))
        return
    mine = range(rank * local, (rank + 1) * local)
    values = [data[f"values_{r}"] for r in mine]
    slabs = [data[f"space_{r}"] for r in mine]
    space = plan.backward(values)
    full = plan.forward(space, sp.Scaling.FULL)
    none = plan.forward(slabs, sp.Scaling.NONE)
    again = plan.backward(plan.shard_values(values))
    np.savez(out, backward=space.cpu().numpy(), forward_full=full.cpu()
             .numpy(), forward_none=none.cpu().numpy(),
             repeat_equal=np.asarray(torch.equal(again, space)),
             kind=np.asarray(plan.exchange_kind),
             rung=np.asarray(plan.wire_rung_name),
             probe=np.asarray(plan.wire_probe_error),
             wire_bytes=np.asarray(plan.exchange_wire_bytes()),
             fingerprint=np.frombuffer(sp.plan_fingerprint(plan.dist_plan),
                                       np.uint8))


def main(spec_path: str, rank: int) -> int:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    import spfft_tpu_torch as sp
    import torch.distributed as dist
    sp.initialize_multihost(f"localhost:{spec['port']}", spec["world"], rank,
                            backend=spec["backend"], timeout_s=60)
    try:
        for case in spec["cases"]:
            run_case(sp, dist.group.WORLD, spec, case, rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
