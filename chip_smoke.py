#!/usr/bin/env python3
"""Drive spfft_tpu_torch on one CUDA card and hold every kernel to its
plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. the card's name and power limit (``nvidia-smi``), and the TF32 switches
   (both off: the plain versions must run in full f32);
2. build every CUDA kernel from ``spfft_tpu_torch/csrc`` (``nvcc``, all at
   once) and print how long it took;
3. the C2C path's plan: 256^3, the spherical-cutoff set sorted
   stick-major, single precision, values from a numpy seed;
4. each kernel of that path on the card at the shapes the path gives it,
   against its plain version on the same inputs (tolerance below), with
   its time, the plain version's time and a library yardstick's time
   (cuFFT plus indexing, which the package never calls); then each
   kernel at odd shapes and in both value layouts, against its plain
   version;
5. the C2C path itself, backward + forward(FULL) through the public
   plan, with every launch counter set to 0 before and read after; the
   backward against a dense complex128 ``torch.fft.ifftn`` oracle on the
   card, within ``predicted_rel_error``; the round trip within 1e-6; a
   second backward identical to the first; the pair's median time;
6. phases 3-5 for the R2C path: the non-redundant half of the 256^3
   sphere, values from a seeded real field band-limited to the sphere
   (complex128 on the card; the oracle is that field); the real xy
   kernels ``prdft2`` and ``pdft2_cr`` and the (0,0)-stick completion of
   ``decompress_zdft``, at the path's shapes and at odd R2C shapes; the
   counted pair, which must not launch ``pdft2``;
7. one JSON line ``{"design_bound_ms": {...}}``, one JSON line
   ``{"kernels": [...]}`` (every kernel record of both paths, each with
   its ``path``) and, last, one JSON line
   ``{"ok": true, "device": {...}}``.

Times are medians of CUDA-event timings over ``REPS`` runs after a
warm-up. ``bound_ms`` is the least time the card could take for each
function: the larger of the bytes it must move (each input read once,
each output written once) over 3.35 TB/s and the FP32 operations the
function needs over 67 TFLOP/s, the H100 SXM's published peaks. The
operations are those of an FFT, 5 n log2 n per complex line of length
n (half that for a real transform), so at these sizes the bytes bind.
The kernels compute each DFT as a matrix product, which needs far more
operations; that design's own bound (the cheapest matrix form: the
Karatsuba triple at 6 FLOP per complex multiply-add, 4 FLOP per real by
complex one) is printed on a line of its own, ``{"design_bound_ms":
{path: {kernel: ms}}}``, before the kernels line, so that line holds
only measured numbers and ``bound_ms``. The kernels use the plain
4-product form (8 FLOP per complex multiply-add), so their complex
stages can reach at most 3/4 of that design bound.

The script runs on one card: where ``CUDA_VISIBLE_DEVICES`` is unset it
shows the process card 0 only, and where it lists several cards, the
first of them.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

os.environ["CUDA_VISIBLE_DEVICES"] = \
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 256
SEED = 0
REPS = 10
#: kernel vs plain version: max |kernel - plain| / max |plain|, and the
#: relative l2 difference. Both sum f32 products in different orders
#: (each about 1e-7 relative per pass), so 2e-6 is the JAX package's own
#: kernel-vs-composition tolerance (tests/test_fused_kernel.py).
KERNEL_TOL = 2e-6
ROUNDTRIP_TOL = 1e-6
MEM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: real FLOP per complex multiply-add of the cheapest matrix-form DFT,
#: and per real-by-complex multiply-add (the real stages of R2C)
FLOP_PER_CMAC = 6.0
FLOP_PER_RMAC = 4.0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def timed_ms(fn, device, reps=REPS, warmup=2) -> float:
    """Median wall time of ``fn`` in ms: CUDA events on a card, the host
    clock (after a synchronize) elsewhere."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def compare(name, got, want):
    """(max_abs_err, relative max error, relative l2) of two results
    (tuples of tensors); fails beyond ``KERNEL_TOL``."""
    g = torch.cat([t.reshape(-1).double() for t in got])
    w = torch.cat([t.reshape(-1).double() for t in want])
    if not torch.isfinite(g).all():
        fail(f"{name}: kernel output is not finite")
    max_abs = float((g - w).abs().max()) if g.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    rel_max = max_abs / scale if scale else max_abs
    rel_l2 = float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) \
        if scale else max_abs
    if rel_max > KERNEL_TOL or rel_l2 > KERNEL_TOL:
        fail(f"{name}: kernel vs plain max_abs={max_abs:.3e} "
             f"rel_max={rel_max:.3e} rel_l2={rel_l2:.3e} > {KERNEL_TOL}")
    return max_abs, rel_max, rel_l2


def fft_flops(lines: int, n: int) -> float:
    """Real FP32 operations of ``lines`` complex FFTs of length ``n``."""
    return 5.0 * lines * n * math.log2(n) if n > 1 else 0.0


def rfft_flops(lines: int, n: int) -> float:
    """Real FP32 operations of ``lines`` real FFTs of length ``n``."""
    return fft_flops(lines, n) / 2


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: path -> kernel name -> the matrix-form design bound in ms (see the
#: docstring)
DESIGN_BOUND_MS = {}


def kernel_record(path, name, source, replaces, err, ms, plain_ms,
                  library_ms, nbytes, flops, design_flops):
    b_ms, b_by = bound(nbytes, flops)
    DESIGN_BOUND_MS.setdefault(path, {})[name] = \
        bound(nbytes, design_flops)[0]
    return {"path": path, "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err[0],
            "rel_err": err[1], "rel_l2": err[2], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}


def print_records(recs):
    for r in recs:
        lib = r["library_ms"]
        print(f"kernel {r['path']} {r['name']}: "
              f"max_abs_err={r['max_abs_err']:.3e} "
              f"rel_err={r['rel_err']:.3e} rel_l2={r['rel_l2']:.3e} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"design_bound_ms="
              f"{DESIGN_BOUND_MS[r['path']][r['name']]:.4f}", flush=True)


def main_path_plan(sp, n, device):
    from spfft_tpu_torch.utils.workloads import (spherical_cutoff_triplets,
                                                 sort_triplets_stick_major)
    t0 = time.perf_counter()
    trip = sort_triplets_stick_major(spherical_cutoff_triplets(n),
                                     (n, n, n))
    plan = sp.make_local_plan(sp.TransformType.C2C, n, n, n, trip,
                              device=device)
    rng = np.random.default_rng(SEED)
    m = len(trip)
    vals = (rng.standard_normal(m) + 1j * rng.standard_normal(m)) \
        .astype(np.complex64)
    values = torch.view_as_real(torch.from_numpy(vals)).to(device)
    print(f"plan: C2C {n}^3 sphere, {plan.num_local_elements} values in "
          f"{plan.index_plan.num_sticks} sticks, split_x={plan.split_x}, "
          f"pair_io={plan.pair_values_io}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan, trip, values


def decompress_record(path, plan, values, device):
    """decompress_zdft at the path's backward shapes (with the plan's
    (0,0)-stick completion on the R2C path) vs its plain version; returns
    the record and the kernel's sticks."""
    from spfft_tpu_torch.ops import fused_kernel
    p = plan.index_plan
    dz, nv = p.dim_z, p.num_values
    v = plan._coerce_values(values)
    if plan._conj is not None:
        v = v * plan._conj
    pair = plan.pair_values_io
    mz = plan._mats["z_b"]
    zs = plan._zero_stick
    got = fused_kernel.decompress_zdft(v, plan._slot_src, mz, dz, pair, zs)
    want = fused_kernel.decompress_zdft_plain(v, plan._slot_src, mz, dz,
                                              pair, zs)
    err = compare(f"{path} decompress_zdft", got, want)
    vpad = torch.cat([torch.view_as_complex(
        (v.t() if pair else v).contiguous()),
        torch.zeros(1, dtype=torch.complex64, device=device)])
    slot64 = plan._slot_src.long()
    rows = plan._slot_src.numel() // dz
    return kernel_record(
        path, "decompress_zdft", "spfft_tpu_torch/csrc/fused_compress.cu",
        "spfft_tpu/ops/fused_kernel.py:587", err,
        timed_ms(lambda: fused_kernel.decompress_zdft(
            v, plan._slot_src, mz, dz, pair, zs), device),
        timed_ms(lambda: fused_kernel.decompress_zdft_plain(
            v, plan._slot_src, mz, dz, pair, zs), device),
        timed_ms(lambda: torch.fft.ifft(vpad[slot64].view(rows, dz),
                                        norm="forward"), device),
        nv * 8 + rows * dz * 4 + 2 * dz * dz * 4 + 2 * rows * dz * 4,
        fft_flops(rows, dz), FLOP_PER_CMAC * rows * dz * dz), got


def kernel_phase(plan, values, device):
    """Each kernel of the C2C path at its shapes vs its plain version."""
    from spfft_tpu_torch.ops import dft, dft_kernel, stages
    p = plan.index_plan
    recs = []

    rec, (sr, si) = decompress_record("c2c", plan, values, device)
    recs.append(rec)

    # pdft2, backward shapes: (z, x, y) -> (z, y, x)
    gr = stages.sticks_to_grid_padded(sr, plan._col_inv, plan._grid_w,
                                      p.dim_y)
    gi = stages.sticks_to_grid_padded(si, plan._col_inv, plan._grid_w,
                                      p.dim_y)
    m1, m2 = plan._mats["y_b"], plan._mats["x_b"]
    got = dft_kernel.pdft2(gr, gi, m1, m2)
    err_b = compare("pdft2 backward", got,
                    dft.pdft2_minor(gr, gi, m1, m2))
    space = torch.stack(got, dim=-1)
    # pdft2, forward shapes: (z, y, x) -> (z, w, y)
    xr, xi = space[..., 0].contiguous(), space[..., 1].contiguous()
    f1, f2 = plan._mats["x_f"], plan._mats["y_f"]
    fgot = dft_kernel.pdft2(xr, xi, f1, f2)
    err_f = compare("pdft2 forward", fgot, dft.pdft2_minor(xr, xi, f1, f2))
    err = max(err_b, err_f)
    gc = torch.complex(gr, gi)
    pp, a, b = gr.shape
    b_out, a_out = m1[0].shape[1], m2[0].shape[1]
    recs.append(kernel_record(
        "c2c", "pdft2", "spfft_tpu_torch/csrc/dft2.cu",
        "spfft_tpu/ops/dft_kernel.py:277", err,
        timed_ms(lambda: dft_kernel.pdft2(gr, gi, m1, m2), device),
        timed_ms(lambda: dft.pdft2_minor(gr, gi, m1, m2), device),
        timed_ms(lambda: torch.fft.ifft2(gc, norm="forward")
                 .transpose(-1, -2).contiguous(), device)
        if (b_out, a_out) == (b, a) else None,
        2 * pp * a * b * 4 + 2 * pp * b_out * a_out * 4
        + 2 * (b * b_out + a * a_out) * 4,
        fft_flops(pp * a, b) + fft_flops(pp * b_out, a),
        FLOP_PER_CMAC * pp * (a * b * b_out + b_out * a * a_out)))

    recs.append(zdft_compress_record("c2c", plan, fgot, device))
    print_records(recs)
    return recs


def zdft_compress_record(path, plan, grid, device):
    """zdft_compress at the path's forward shapes: raw sticks (S, dz)
    gathered from the xy stage's output ``grid``, FULL scale."""
    from spfft_tpu_torch.ops import fused_kernel, stages
    p = plan.index_plan
    dz, s, nv = p.dim_z, p.num_sticks, p.num_values
    pair = plan.pair_values_io
    fr = stages.grid_to_sticks(grid[0], plan._scatter_cols)
    fi = stages.grid_to_sticks(grid[1], plan._scatter_cols)
    mf = plan._mats["z_fs"]
    got = fused_kernel.zdft_compress(fr, fi, mf, plan._csr, pair)
    err = compare(f"{path} zdft_compress", (got,),
                  (fused_kernel.zdft_compress_plain(fr, fi, mf, plan._csr,
                                                    pair),))
    fc = torch.complex(fr, fi)
    vi64 = torch.as_tensor(p.value_indices.astype(np.int64), device=device)
    gs = 1.0 / plan.global_size
    return kernel_record(
        path, "zdft_compress", "spfft_tpu_torch/csrc/fused_compress.cu",
        "spfft_tpu/ops/fused_kernel.py:783", err,
        timed_ms(lambda: fused_kernel.zdft_compress(fr, fi, mf, plan._csr,
                                                    pair), device),
        timed_ms(lambda: fused_kernel.zdft_compress_plain(
            fr, fi, mf, plan._csr, pair), device),
        timed_ms(lambda: torch.fft.fft(fc).view(-1)[vi64] * gs, device),
        2 * s * dz * 4 + (s + 1 + 2 * nv) * 4 + 2 * dz * dz * 4 + nv * 8,
        fft_flops(s, dz), FLOP_PER_CMAC * s * dz * dz)


def odd_shapes_phase(device):
    """Each kernel at shapes the main path does not reach (axes that are
    not multiples of the tiles, rectangular split-x matrices, more than
    256 output columns, the 512 axis, empty sticks, duplicate values,
    both value layouts) against its plain version."""
    from spfft_tpu_torch.indexing import inverse_slot_map
    from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel
    rng = np.random.default_rng(SEED + 1)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=device)

    def mats(m):
        return dft.device_mats(m, device)

    cases = 0
    for (pp, a, b), m1, m2 in (
            ((3, 20, 24), dft.c2c_mats(24, dft.BACKWARD),
             dft.c2c_mats(20, dft.BACKWARD)),
            ((5, 9, 16), dft.c2c_mats(16, dft.FORWARD),
             dft.sub_rows_mats(24, dft.BACKWARD, (20, 21, 22, 23, 0, 1, 2,
                                                  3, 4))),
            ((4, 24, 20), dft.sub_cols_mats(20, dft.FORWARD, (17, 18, 19, 0,
                                                            1, 2)),
             dft.c2c_mats(24, dft.FORWARD)),
            ((2, 7, 300), dft.c2c_mats(300, dft.FORWARD),
             dft.c2c_mats(7, dft.FORWARD)),
            ((2, 512, 9), dft.c2c_mats(9, dft.BACKWARD),
             dft.c2c_mats(512, dft.BACKWARD))):
        xr, xi = rand(pp, a, b), rand(pp, a, b)
        m1, m2 = mats(m1), mats(m2)
        compare(f"pdft2 {(pp, a, b)}", dft_kernel.pdft2(xr, xi, m1, m2),
                dft.pdft2_minor(xr, xi, m1, m2))
        cases += 1
    for s, dz, fill in ((37, 12, 0.5), (21, 384, 0.3), (16, 16, 1.0)):
        slots = np.flatnonzero(rng.random(s * dz) < fill)
        slots = np.concatenate([slots, slots[:5]])  # duplicate triplets
        rng.shuffle(slots)
        nv = len(slots)
        slot_src = torch.as_tensor(np.concatenate(
            [inverse_slot_map(slots, s * dz, nv),
             np.full(dz, nv, np.int32)]), device=device)
        csr = tuple(torch.as_tensor(t, device=device)
                    for t in fused_kernel.compress_csr(slots, s, dz))
        zb = mats(dft.c2c_mats(dz, dft.BACKWARD))
        zf = mats(dft.c2c_mats(dz, dft.FORWARD, 0.5))
        for pair in (False, True):
            vals = rand(2, nv) if pair else rand(nv, 2)
            compare(f"decompress_zdft s={s} dz={dz} pair={pair}",
                    fused_kernel.decompress_zdft(vals, slot_src, zb, dz,
                                                 pair),
                    fused_kernel.decompress_zdft_plain(vals, slot_src, zb,
                                                       dz, pair))
            sr, si = rand(s, dz), rand(s, dz)
            compare(f"zdft_compress s={s} dz={dz} pair={pair}",
                    (fused_kernel.zdft_compress(sr, si, zf, csr, pair),),
                    (fused_kernel.zdft_compress_plain(sr, si, zf, csr,
                                                      pair),))
            cases += 2
    print(f"odd shapes: {cases} kernel-vs-plain cases within {KERNEL_TOL}",
          flush=True)


#: launches of one backward + forward(FULL) pair per path: (least, most)
C2C_LAUNCHES = {"decompress_zdft": (1, None), "pdft2": (1, None),
                "zdft_compress": (1, None), "prdft2": (0, 0),
                "pdft2_cr": (0, 0)}
R2C_LAUNCHES = {"decompress_zdft": (1, None), "prdft2": (2, None),
                "pdft2_cr": (2, None), "zdft_compress": (1, None),
                "pdft2": (0, 0)}


def read_launches(path, counters, want):
    """Each counter's launches since they were set to 0; fails when one
    lies outside its ``want`` bounds."""
    launches = {name: c.launches for name, c in counters.items()}
    print(f"{path} path launches: {launches}", flush=True)
    for name, (lo, hi) in want.items():
        k = launches[name]
        if k < lo or (hi is not None and k > hi):
            fail(f"{path} path launched {name} {k} times, expected "
                 f"{lo}..{'' if hi is None else hi}")
    return launches


def pair_phase(sp, path, plan, values, oracle_rel, device, counters,
               want):
    """The public backward + forward(FULL) pair of ``path``, counted
    (``want``), checked and timed: the backward (the complex slab for
    C2C, the real one for R2C) within ``predicted_rel_error`` of the
    complex128 oracle on the card (``oracle_rel(space)`` gives the
    relative l2 error), the round trip within 1e-6, and a second
    backward equal to the first."""
    for c in counters.values():
        c.launches = 0
    space = plan.backward(values)
    out = plan.forward(space, sp.Scaling.FULL)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches(path, counters, want)

    shape = (plan.dim_z, plan.dim_y, plan.dim_x)
    if path == "c2c":
        shape += (2,)
    if tuple(space.shape) != shape or space.dtype != torch.float32 \
            or not torch.isfinite(space).all():
        fail(f"{path} backward output malformed: {tuple(space.shape)} "
             f"{space.dtype}")
    rel = oracle_rel(space)
    pred = sp.predicted_rel_error("single", max(shape[:3]), True)
    print(f"{path} backward vs complex128 oracle: rel_l2={rel:.3e} "
          f"(predicted_rel_error={pred:.3e})", flush=True)
    if not rel <= pred:
        fail(f"{path} backward rel_l2 {rel:.3e} above {pred:.3e}")
    vals_out = out.t() if plan.pair_values_io else out
    rt = float(torch.linalg.norm(vals_out.double() - values.double())
               / torch.linalg.norm(values.double()))
    print(f"{path} forward(FULL) round trip: rel_l2={rt:.3e}", flush=True)
    if not rt <= ROUNDTRIP_TOL:
        fail(f"{path} round trip rel_l2 {rt:.3e} above {ROUNDTRIP_TOL}")
    if not torch.equal(plan.backward(values), space):
        fail(f"{path}: a second backward differs from the first")

    pair_ms = timed_ms(lambda: plan.forward(plan.backward(values),
                                            sp.Scaling.FULL), device)
    print(f"{path} path pair (backward + forward FULL): {pair_ms:.4f} ms "
          f"median of {REPS}", flush=True)
    return launches


def c2c_oracle_rel(plan, trip, values, device):
    """``oracle_rel`` of the C2C path: the backward against a dense
    complex128 ``torch.fft.ifftn`` of the values placed on the grid."""
    def rel(space):
        dims = np.array([plan.dim_x, plan.dim_y, plan.dim_z])
        st = torch.as_tensor(np.where(trip < 0, trip + dims, trip).astype(
            np.int64), device=device)
        grid = torch.zeros((plan.dim_z, plan.dim_y, plan.dim_x),
                           dtype=torch.complex128, device=device)
        grid[st[:, 2], st[:, 1], st[:, 0]] = torch.view_as_complex(
            values.double().contiguous())
        ref = torch.fft.ifftn(grid, norm="forward")
        del grid
        got = torch.view_as_complex(space.double().contiguous())
        return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
    return rel


# -- the R2C path -------------------------------------------------------------

def r2c_plan(sp, n, device):
    """The R2C path's plan on the non-redundant half of the n^3 sphere
    (as bench.py builds it), sorted stick-major; values from a seeded
    real field band-limited to the sphere, the half set's hermitian
    closure. Returns the plan, the values (N, 2) f32 and the oracle of
    backward: that field times n^3, real f64, from complex128 on
    ``device``. The spectrum is rounded to complex64 before both are
    taken, so the oracle is exact for the values the plan is given."""
    from spfft_tpu_torch.utils.workloads import (spherical_cutoff_triplets,
                                                 sort_triplets_stick_major)
    t0 = time.perf_counter()
    full = spherical_cutoff_triplets(n)
    x, y, z = full[:, 0], full[:, 1], full[:, 2]
    half = full[(x > 0) | ((x == 0) & ((y > 0) | ((y == 0) & (z >= 0))))]
    trip = sort_triplets_stick_major(half, (n, n, n))
    plan = sp.make_local_plan(sp.TransformType.R2C, n, n, n, trip,
                              device=device)

    def storage(t):
        return torch.as_tensor(np.where(t < 0, t + n, t).astype(np.int64),
                               device=device)

    gen = torch.Generator(device=device).manual_seed(SEED)
    spec = torch.fft.fftn(torch.randn((n, n, n), generator=gen,
                                      dtype=torch.float64, device=device))
    spec = spec.to(torch.complex64).to(torch.complex128)
    sf = storage(full)
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    mask[sf[:, 2], sf[:, 1], sf[:, 0]] = True
    spec *= mask
    del mask, sf
    sh = storage(trip)
    values = torch.view_as_real(spec[sh[:, 2], sh[:, 1], sh[:, 0]]
                                .to(torch.complex64)).contiguous()
    oracle = torch.fft.ifftn(spec, norm="forward").real.contiguous()
    del spec
    p = plan.index_plan
    print(f"plan: R2C {n}^3 half sphere, {plan.num_local_elements} values "
          f"in {p.num_sticks} sticks, dim_x_freq={p.dim_x_freq}, "
          f"zero_stick={p.zero_stick_id}, split_x={plan.split_x}, "
          f"pair_io={plan.pair_values_io}, built with its values in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan, values, oracle


def r2c_kernel_phase(plan, values, device):
    """Each kernel of the R2C path at its shapes vs its plain version."""
    from spfft_tpu_torch.ops import dft, dft_kernel, stages
    p = plan.index_plan
    recs = []
    rec, (sr, si) = decompress_record("r2c", plan, values, device)
    recs.append(rec)

    # pdft2_cr, backward shapes: planar (z, w, y) -> real (z, y, x)
    gr = stages.sticks_to_grid_padded(sr, plan._col_inv, plan._grid_w,
                                      p.dim_y)
    gi = stages.sticks_to_grid_padded(si, plan._col_inv, plan._grid_w,
                                      p.dim_y)
    if plan._complete_x0:
        stages.complete_plane_hermitian_t(gr, gi)
    m1, m2 = plan._mats["y_b"], plan._mats["x_b"]
    space = dft_kernel.pdft2_cr(gr, gi, m1, m2)
    err = compare("r2c pdft2_cr", (space,),
                  (dft.pdft2_minor_cr(gr, gi, m1, m2),))
    gc = torch.complex(gr, gi)
    pp, a, b = gr.shape
    b_out, a_out = m1[0].shape[1], m2[0].shape[1]
    recs.append(kernel_record(
        "r2c", "pdft2_cr", "spfft_tpu_torch/csrc/dft2.cu",
        "spfft_tpu/ops/dft_kernel.py:277", err,
        timed_ms(lambda: dft_kernel.pdft2_cr(gr, gi, m1, m2), device),
        timed_ms(lambda: dft.pdft2_minor_cr(gr, gi, m1, m2), device),
        timed_ms(lambda: torch.fft.irfft2(
            gc.transpose(-1, -2), s=(b_out, a_out), norm="forward"), device)
        if a == p.dim_x_freq else None,
        2 * pp * a * b * 4 + pp * b_out * a_out * 4
        + 2 * (b * b_out + a * a_out) * 4,
        fft_flops(pp * a, b) + rfft_flops(pp * b_out, a_out),
        FLOP_PER_CMAC * pp * a * b * b_out
        + FLOP_PER_RMAC * pp * b_out * a * a_out))

    # prdft2, forward shapes: real (z, y, x) -> planar (z, w, y)
    f1, f2 = plan._mats["x_f"], plan._mats["y_f"]
    fgot = dft_kernel.prdft2(space, f1, f2)
    err = compare("r2c prdft2", fgot, dft.prdft2_minor(space, f1, f2))
    pp, a, b = space.shape
    b_out, a_out = f1[0].shape[1], f2[0].shape[1]
    recs.append(kernel_record(
        "r2c", "prdft2", "spfft_tpu_torch/csrc/dft2.cu",
        "spfft_tpu/ops/dft_kernel.py:277", err,
        timed_ms(lambda: dft_kernel.prdft2(space, f1, f2), device),
        timed_ms(lambda: dft.prdft2_minor(space, f1, f2), device),
        timed_ms(lambda: torch.fft.rfft2(space).transpose(-1, -2)
                 .contiguous(), device)
        if b_out == p.dim_x_freq else None,
        pp * a * b * 4 + 2 * pp * b_out * a_out * 4
        + 2 * (b * b_out + a * a_out) * 4,
        rfft_flops(pp * a, b) + fft_flops(pp * b_out, a),
        FLOP_PER_RMAC * pp * a * b * b_out
        + FLOP_PER_CMAC * pp * b_out * a * a_out))

    recs.append(zdft_compress_record("r2c", plan, fgot, device))
    print_records(recs)
    return recs


def r2c_odd_shapes_phase(device):
    """The R2C kernels at shapes the path does not reach: odd and even
    real axes (7, 15, 24, 512; an odd one has no Nyquist bin), split
    windows of the half spectrum with x0 == 0 and x0 > 0, and the
    (0,0)-stick completion with no slot of the stick given, half of it
    given, a given value of exactly 0 whose mirror slot is given (so only
    completion by value fills it, not completion of empty slots), and no
    zero stick at all, in both value layouts; each against its plain
    version."""
    from spfft_tpu_torch.indexing import inverse_slot_map
    from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel
    rng = np.random.default_rng(SEED + 2)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device=device)

    def mats(m):
        return dft.device_mats(m, device)

    cases = 0
    for nx, ny, pp, windows in ((7, 9, 3, ((0, 2), (1, 3))),
                                (15, 20, 3, ((0, 3), (2, 4))),
                                (24, 16, 3, ((0, 5), (3, 5))),
                                (512, 9, 2, ((0, 100), (50, 120)))):
        for win in (None,) + windows:
            cols = None if win is None else tuple(range(win[0],
                                                        win[0] + win[1]))
            r2c = dft.r2c_mats(nx) if cols is None \
                else dft.sub_cols_r2c_mats(nx, cols)
            c2r = dft.c2r_mats(nx) if cols is None \
                else dft.sub_rows_c2r_mats(nx, cols)
            x = rand(pp, ny, nx)
            m1, m2 = mats(r2c), mats(dft.c2c_mats(ny, dft.FORWARD))
            compare(f"prdft2 nx={nx} window={win}",
                    dft_kernel.prdft2(x, m1, m2),
                    dft.prdft2_minor(x, m1, m2))
            k = c2r[0].shape[0]
            xr, xi = rand(pp, k, ny), rand(pp, k, ny)
            m1, m2 = mats(dft.c2c_mats(ny, dft.BACKWARD)), mats(c2r)
            compare(f"pdft2_cr nx={nx} window={win}",
                    (dft_kernel.pdft2_cr(xr, xi, m1, m2),),
                    (dft.pdft2_minor_cr(xr, xi, m1, m2),))
            cases += 2
    for s, dz in ((37, 12), (21, 13), (9, 384)):
        zb = mats(dft.c2c_mats(dz, dft.BACKWARD))
        for kind, zid in (("half", 0), ("empty", s // 2), ("exact0", s - 1),
                          ("absent", -1)):
            occ = rng.random((s, dz)) < 0.5
            if zid >= 0:
                occ[zid] = np.zeros(dz, bool) if kind == "empty" \
                    else np.arange(dz) <= dz // 2
                # exact0 zeroes slot 1; its mirror dz - 1 is given
                occ[zid, dz - 1] |= kind == "exact0"
            slots = np.flatnonzero(occ)
            rng.shuffle(slots)
            nv = len(slots)
            slot_src = torch.as_tensor(np.concatenate(
                [inverse_slot_map(slots, s * dz, nv),
                 np.full(dz, nv, np.int32)]), device=device)
            for pair in (False, True):
                vals = rand(2, nv) if pair else rand(nv, 2)
                if kind == "exact0":
                    hit = int(np.flatnonzero(slots == zid * dz + 1)[0])
                    (vals[:, hit] if pair else vals[hit]).zero_()
                compare(f"decompress_zdft s={s} dz={dz} zero stick {kind} "
                        f"pair={pair}",
                        fused_kernel.decompress_zdft(vals, slot_src, zb, dz,
                                                     pair, zid),
                        fused_kernel.decompress_zdft_plain(
                            vals, slot_src, zb, dz, pair, zid))
                cases += 1
    print(f"odd R2C shapes: {cases} kernel-vs-plain cases within "
          f"{KERNEL_TOL}", flush=True)


def run(device, n=N):
    """Every phase after the build on ``device`` at size ``n``, both
    paths; returns the kernel records."""
    import spfft_tpu_torch as sp
    from spfft_tpu_torch.ops import dft_kernel, fused_kernel
    counters = {"decompress_zdft": fused_kernel.decompress_zdft,
                "pdft2": dft_kernel.pdft2,
                "prdft2": dft_kernel.prdft2,
                "pdft2_cr": dft_kernel.pdft2_cr,
                "zdft_compress": fused_kernel.zdft_compress}
    plan, trip, values = main_path_plan(sp, n, device)
    c2c = kernel_phase(plan, values, device)
    odd_shapes_phase(device)
    launches = pair_phase(sp, "c2c", plan, values,
                          c2c_oracle_rel(plan, trip, values, device),
                          device, counters, C2C_LAUNCHES)
    for r in c2c:
        r["launches"] = launches[r["name"]]
    del plan, trip, values

    plan, values, oracle = r2c_plan(sp, n, device)
    r2c = r2c_kernel_phase(plan, values, device)
    r2c_odd_shapes_phase(device)
    launches = pair_phase(
        sp, "r2c", plan, values,
        lambda space: float(torch.linalg.norm(space.double() - oracle)
                            / torch.linalg.norm(oracle)),
        device, counters, R2C_LAUNCHES)
    for r in r2c:
        r["launches"] = launches[r["name"]]
    return c2c + r2c


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    if torch.cuda.device_count() != 1:
        fail(f"expected one visible card, got {torch.cuda.device_count()}")
    try:
        from spfft_tpu_torch.ops import _build
    except ImportError as exc:
        fail(f"spfft_tpu_torch is not importable here ({exc}); run from "
             f"the repository root")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.perf_counter()
    per_source = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"({', '.join(f'{k} {v:.2f} s' for k, v in per_source.items())})",
          flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    device = torch.device("cuda", torch.cuda.current_device())
    recs = run(device)
    print(json.dumps({"design_bound_ms": DESIGN_BOUND_MS}), flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
