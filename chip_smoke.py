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
   (cuFFT plus indexing, which the package never calls) and, for the
   redesigned complex stages, the matrix form's time on the same inputs
   and the two-launch FFT form's; then each kernel at odd shapes and in
   both value layouts, against its plain version, and every form of the
   complex stage at odd shapes (fft, cluster, two-launch, matrix);
5. the C2C path itself, backward + forward(FULL) through the public
   plan, with every launch counter (and every count by form) set to 0
   before and read after; the
   backward against a dense complex128 ``torch.fft.ifftn`` oracle on the
   card, within ``predicted_rel_error``; the round trip within 1e-6; a
   second backward identical to the first; the pair's median time;
6. phases 3-5 for the R2C path: the non-redundant half of the 256^3
   sphere, values from a seeded real field band-limited to the sphere
   (complex128 on the card; the oracle is that field); the real xy
   kernels ``prdft2`` and ``pdft2_cr`` (their real halves in the real FFT
   form, against the plain version, beside both halves as matrices) and
   the (0,0)-stick completion of ``decompress_zdft``, at the path's
   shapes and at odd R2C shapes (the real FFT form at every kind of even
   length, the matrix form at odd lengths and other primes, windows
   from 0, past 0 and wrapped, nonzero imaginary parts at DC and
   Nyquist, which must not reach the output); the counted pair, which
   must not launch ``pdft2`` nor a real stage in the matrix form;
7. for each path, the two-kernel route (``fused=False``): the gather
   kernel in both directions (exact against its plain version) and
   ``pdft_last`` at the route's 256^3 shapes, then the counted pair
   (gather 2, ``pdft_last`` 2 in the FFT form, no fused z kernel) with the
   same oracle, round-trip and repeat checks, timed beside the fused
   pair, and its results against the fused route's; the gather at B = 4
   both ways (exact, each band equal to a single launch) and the counted
   batched two-kernel pair;
8. for each path, batched execution at B = 4: the batched grids of both
   fused z kernels against their plain versions and, bit for bit,
   against four single launches; then the counted batched pair (one
   launch of each z kernel, the xy launches of one single pair), each
   band equal to the single pair's result; ``apply_pointwise`` with a
   potential and ``iterate_pointwise(steps=3)`` against the same pairs
   run one call at a time;
9. the new kernels at odd shapes (B = 3, both value layouts, odd dim_z,
   an empty stick, duplicates, the R2C zero stick) against their plain
   versions; the gather's scalar paths and shard axis exactly (num_out
   not a multiple of 4, every operand one element off its alignment, B
   in {1, 3, 5}, 5 shards with uneven tables and an empty shard); and
   the FFT form of both z kernels at
   every radix, dim_z 1 to 512 (and 13 in the matrix form), B = 3, both
   value layouts, windows, an empty stick, duplicates and the R2C zero
   stick, each call's form checked by its launch counts;
10. the batched-versus-looped sweep (``{"batched_sweep": [...]}``): per
   band ms of a batched pair against B single pairs at n/2 and n, B in
   {2, 4, 8}, both paths (what ``spfft_tpu_torch.multi``'s gate rests
   on);
11. the distributed plan over 4 shards held on the card (sticks
   round-robin, 64-plane slabs at 256^3), through the public
   ``make_distributed_plan``: ``pdft2_swapped`` (its xy stage) at the
   C2C path's shapes, both directions, and at odd shapes, against its
   plain version; each shard's ``decompress_zdft`` (its own slot row,
   padding sticks and zero stick) and ``zdft_compress`` (its own CSR)
   against their plain versions; plans with uneven and empty shards on
   the card against the same plans on the CPU; the counted C2C pair
   (``pdft2_swapped`` 2 in the cluster form, each z kernel 4 — once per
   shard — and ``pdft2`` never), its backward against the complex128
   oracle and
   against the local plan's backward of the same values, the round
   trip, the repeat, its time beside the local pair's and its exchange
   bytes; the pair run through the plan's own stage methods with a CUDA
   event after each (z, the exchange's pack, transpose and unpack, xy),
   equal to the public pair bit for bit; a batched B = 4 pair and the
   pointwise calls, bit for bit against single calls; the two-kernel
   route (the gather one launch a direction over every shard's stacked
   tables, exact, a shard's padding value slots 0, and ``pdft_last`` over
   all shards' sticks, then its pair: gather 2, ``pdft_last`` 2, and its
   stage split) against the fused one, bit for bit; and the R2C path
   (each shard's z kernels, the owner of the (0,0) stick and the others;
   ``pdft_last`` at its y stage; its x stage, ``pirdft_last`` and
   ``prdft_last`` in the real FFT form, against the plain FP32 products
   it replaced, timed beside them; its pair with no ``pdft2_swapped``,
   ``pdft_last`` 2 and each real x launch once) with its stage split and
   structure checks, then its two-kernel route as C2C's (its pair:
   gather 2, ``pdft_last`` 4 with the y stage's), bit for bit against the
   fused route; the plans with uneven and empty shards hold the
   two-kernel gathers exact on their own stacked tables;
12. double precision (``double_phases``): phases 3–9 and 11 again with
   ``precision="double"`` plans on the kernels' float64 instances (paths
   ending in ``_f64``): each kernel at the 256^3 shapes against its
   plain float64 version within ``DOUBLE_KERNEL_TOL`` (the gather
   exact), the local C2C and R2C pairs on both routes (backward within
   ``predicted_rel_error("double", 256)`` of the complex128 oracle, the
   round trip within 3 times that, the single pairs' launch tables, the
   routes bit for bit), B = 4 and pointwise calls bit for bit against
   single calls, ``Grid`` / ``Transform`` and multi-transform, the
   distributed C2C and R2C plans over 4 shards on both routes (within
   twice ``predicted_rel_error`` of the local backward), and every form
   at odd shapes in float64;
13. the C ABI (``capi_phase``): build ``libspfft_tpu_torch.so``
   (``spfft_tpu_torch.native.build_capi``, its seconds printed), compile
   ``examples/example.c`` against the JAX package's header, unchanged,
   and ``spfft_tpu_torch/native/capi_drive.c`` against the library, and
   run the example (it must print OK); in this process, through
   ``ctypes``, the main path (256^3 sphere, numpy seed 0, C2C single,
   ``PALLAS_AUTO``): ``backward``, ``forward(FULL)`` and
   ``execute_pair`` bit for bit the Python API's on the same host
   arrays, the backward within ``predicted_rel_error`` of the complex128
   oracle, the launches by form of the C pair and of ``execute_pair``
   each equal to ``C2C_LAUNCHES`` (counts set to 0 before each, read
   after); the error surface on the card (``COMPACT_BUFFERED`` -> 5, an
   invalid handle -> 2, an out-of-bounds index -> 7); then
   ``capi_drive`` in a process of its own per case (its own embedded
   interpreter): C2C single on ``PALLAS_AUTO`` and ``PALLAS_OFF`` (the
   latter also bit for bit the former), R2C single, C2C double and
   distributed C2C over 4 shards, each with ``multi_backward`` /
   ``multi_forward`` at B = 4 under one handle (but ``PALLAS_OFF``),
   every output bit for bit the Python API's on the same inputs; each
   call's host-clock ms (the drive's median of 10 after 2 warm-ups)
   beside the Python API's on host arrays and on device-resident ones,
   and the bytes over PCIe with the GB/s they imply, each line with the
   card's name and power limit; and the rate of one 134.2 MB copy each
   way from pageable and from pinned host memory;
14. the long axes (``long_axes_phase``), at full width: C2C on the 768^3
   sphere (``spherical_cutoff_triplets(768)`` stick-major, 237M values in
   463k sticks, numpy seed 0, single precision), whose every axis, 768 =
   24 x 32, takes the two-pass FFT (``csrc/fft_long.cu``); the plan's
   time and the host memory the planner took, its route (the pair
   layout; the two-kernel route, the fused kernels declining the z axis
   with ``"dimz_over_cap"``); ``pdft_last`` (the z stage) and ``pdft2``
   at the path's shapes against their plain versions (the two-stage
   product), timed beside ``torch.fft`` and beside their two-launch form
   (pass 1, then pass 2) on the same inputs; the counted pair (gather 2,
   ``pdft_last`` 2 and ``pdft2`` 4 launches in the two-pass form, one a
   stage, no fused z launch, no ``torch.fft`` call) with the backward
   within ``predicted_rel_error("single", 768)`` of the complex128
   oracle, the round trip within 1e-6, a repeat, the pair per call and
   on the device alone and the peak device memory; then the same for
   R2C on the half sphere, whose x axis (half 384) takes the real FFT
   form;
15. the long forms at odd shapes (``long_odd_shapes_phase``, float32 and
   float64): ``pdft_last`` at z lengths 520 (20 x 26, a direct factor),
   521 (the long matrix form, ``csrc/dft2.cu`` staged), 1024, 1080, 2048,
   4097 and 8192 (above the one-launch kernel's 4096: pass 1, then pass
   2) and 1031 (``torch.fft``, counted by form only), whole and windowed;
   the plane wrappers with long stages (8192 and 5200 in two launches);
   the real stages at 1000, 1022
   (long matrix), 1024 (the real FFT at half 512) and 1031; each call's
   launches by form; then plans (``long_plans_phase``): distributed C2C
   (521, 64, 1024) and R2C (1022, 64, 520) over 4 shards against the
   local plan (2e-6 in float32, twice ``predicted_rel_error`` in float64)
   with records of their long forms, and a local double C2C (768, 64,
   1024) against its oracle;
16. the benchmark CLI (``benchmark_phase``): ``spfft_tpu_torch.benchmark
   .main`` in this process at ``-d 256 -r 10`` (C2C), ``-t r2c``,
   ``--shards 4`` and ``-d 768 -s 0.25 -r 5``, each JSON printed;
17. one JSON line ``{"batched_sweep": [...]}``, one ``{"benchmark":
   [...]}`` (phase 16's parameters), one ``{"capi": {...}}``
   (phase 13's numbers), one ``{"design_bound_ms": {...}}``, the
   script's wall time, one ``{"kernels": [...]}`` (every kernel record
   of every path, float32 and float64, each with its ``path`` and
   ``dtype``) and, last, one JSON line ``{"ok": true, "device":
   {...}}``.

Times are medians of CUDA-event timings over ``REPS`` runs after a
warm-up, one call between two events, so a call's host work (a wrapper's
checks and launch) counts while the card waits. Every record also
carries ``device_ms`` and ``library_device_ms``: the kernel and the
library call on the device alone (``GRAPH_CALLS`` calls in one CUDA
graph, replayed back to back); each pair prints its time on the device
alone likewise (``PAIR_GRAPH_CALLS`` pairs in one graph). ``bound_ms``
is the least time the card could take for each function: the larger of
the bytes it must move (each input read once, each output written once,
4 bytes a real in float32 and 8 in float64) over 3.35 TB/s and the
operations the function needs over the peak of their type, 67 TFLOP/s
in FP32 and 34 TFLOP/s in FP64 (the CUDA cores; the H100 SXM's
published peaks). The operations are those of an FFT, 5 n log2 n per
complex line of length n (half that for a real transform), so at these
sizes the bytes bind.

Forms. The complex DFT stages are no longer matrix products:
``pdft_last`` is an FFT in shared memory (form ``fft``), ``pdft2`` and
``pdft2_swapped`` one launch of a cluster kernel per call (form
``cluster``: both FFTs of a plane in one cluster of 8 blocks, the swap
through distributed shared memory), the complex halves of ``prdft2``
and ``pdft2_cr`` the FFT stage, and their real halves, like the
distributed R2C x stage (``prdft_last``, ``pirdft_last``), a real FFT
(form ``rfft``: a half-length complex FFT and a pass over the pairs of
bins, ``csrc/rfft.cu``): ``prdft2`` is form ``rfft+fft``, ``pdft2_cr``
``fft+rfft``. The fused z kernels
(``decompress_zdft``, ``zdft_compress``) gather and transform in one
launch of an FFT in shared memory (form ``fft``, ``csrc/fused_fft.cu``).
Any stage or z kernel whose length (for a real stage: an odd length, or
its half) has a prime factor other than 2, 3 and 5, or whose matrices
do not carry their function, computes its DFT as a matrix product (form
``matrix``). Each counted pair checks the launches of each wrapper by
form (``form_launches``); no pair of the main paths takes the matrix
form of any stage or z kernel. Each
record of a redesigned kernel carries ``form`` and ``matrix_ms``, the
matrix form timed on the same inputs in the same run (the "before").
``design_bound_ms`` is the bound of the record's own design: for the
one-launch FFT, real FFT and cluster forms ``bound_ms`` itself; for the
two launches of ``prdft2`` / ``pdft2_cr`` their bytes with the
intermediate written and read once more; for a matrix product the
cheapest matrix form (the Karatsuba triple at 6 FLOP per complex
multiply-add, 4 FLOP per real by complex one), of which the kernels'
plain 4-product form reaches at most 3/4. It is printed on a line of its
own, ``{"design_bound_ms": {path: {kernel: ms}}}``, before the kernels
line, so that line holds only measured numbers and ``bound_ms``.

The script runs on one card: where ``CUDA_VISIBLE_DEVICES`` is unset it
shows the process card 0 only, and where it lists several cards, the
first of them.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
import types

os.environ["CUDA_VISIBLE_DEVICES"] = \
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: the script's start, for its wall time
T_START = time.perf_counter()

N = 256
SEED = 0
REPS = 10
#: kernel vs plain version: max |kernel - plain| / max |plain|, and the
#: relative l2 difference. Both sum f32 products in different orders
#: (each about 1e-7 relative per pass), so 2e-6 is the JAX package's own
#: kernel-vs-composition tolerance (tests/test_fused_kernel.py).
KERNEL_TOL = 2e-6
ROUNDTRIP_TOL = 1e-6
#: the same in float64 (the kernels' float64 instances against their plain
#: float64 versions): at most 1e-14 relative l2 (an FFT's float64 error is
#: about 1e-16 log2 n, a plain matrix product's about 1e-16 sqrt(n)), and
#: 1e-13 on the largest element's error relative to the largest value
DOUBLE_KERNEL_TOL = 1e-14
DOUBLE_KERNEL_TOL_MAX = 1e-13
MEM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: FP64 on the CUDA cores (the kernels use no tensor cores), the H100
#: SXM's published peak
FP64_FLOP_PER_S = 34e12
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


#: calls of one CUDA graph in :func:`graph_ms`: a kernel's, and a whole
#: pair's
GRAPH_CALLS = 20
PAIR_GRAPH_CALLS = 3


def graph_ms(fn, device, calls=GRAPH_CALLS, reps=REPS):
    """Device time of one call of ``fn`` in ms, without the host's share
    that :func:`timed_ms` includes (a wrapper's checks and launch, while
    the card waits): ``calls`` calls captured in one CUDA graph, replayed
    back to back between CUDA events, median of ``reps`` replays per
    call. None off the card."""
    if device.type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def kernel_tol(dtype):
    """The kernel-vs-plain tolerance of a result of ``dtype``: (relative
    max error, relative l2)."""
    if dtype == torch.float64:
        return DOUBLE_KERNEL_TOL_MAX, DOUBLE_KERNEL_TOL
    return KERNEL_TOL, KERNEL_TOL


def compare(name, got, want):
    """(max_abs_err, relative max error, relative l2) of two results
    (tuples of tensors); fails beyond :func:`kernel_tol` of their real
    type (``KERNEL_TOL`` in float32, ``DOUBLE_KERNEL_TOL`` in
    float64)."""
    tol_max, tol_l2 = kernel_tol(got[0].dtype)
    g = torch.cat([t.reshape(-1).double() for t in got])
    w = torch.cat([t.reshape(-1).double() for t in want])
    if not torch.isfinite(g).all():
        fail(f"{name}: kernel output is not finite")
    max_abs = float((g - w).abs().max()) if g.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    rel_max = max_abs / scale if scale else max_abs
    rel_l2 = float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) \
        if scale else max_abs
    if rel_max > tol_max or rel_l2 > tol_l2:
        fail(f"{name}: kernel vs plain max_abs={max_abs:.3e} "
             f"rel_max={rel_max:.3e} rel_l2={rel_l2:.3e} > "
             f"{tol_max} / {tol_l2}")
    return max_abs, rel_max, rel_l2


def fft_flops(lines: int, n: int) -> float:
    """Real FP32 operations of ``lines`` complex FFTs of length ``n``."""
    return 5.0 * lines * n * math.log2(n) if n > 1 else 0.0


def rfft_flops(lines: int, n: int) -> float:
    """Real FP32 operations of ``lines`` real FFTs of length ``n``."""
    return fft_flops(lines, n) / 2


def table_bytes(mats, form: str) -> int:
    """Bytes of a DFT stage's tables as its form reads them: the FFT,
    real FFT and cluster forms read the (2, n) twiddle table, the matrix
    form the matrix pair, both in the matrices' real type."""
    e = mats[0].element_size()
    if form in ("fft", "cluster", "rfft"):
        return 2 * mats.n * e
    return sum(m.numel() for m in mats[:2]) * e


def plane_table_bytes(mats1, mats2, forms) -> int:
    """:func:`table_bytes` of a plane call's two stages in ``forms`` (a
    cluster launch reads both stages' twiddle tables)."""
    f1, f2 = ("fft", "fft") if forms == ("cluster",) else forms
    return table_bytes(mats1, f1) + table_bytes(mats2, f2)


def bound(nbytes: float, flops: float, dtype=torch.float32):
    """The least time in ms of moving ``nbytes`` and doing ``flops``
    operations of ``dtype``, and which of the two binds."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    peak = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: path -> kernel name -> the design bound of the record's form in ms (see
#: the docstring)
DESIGN_BOUND_MS = {}


#: the redesigned complex stages (pdft_last, pdft2, pdft2_swapped, the
#: complex halves of prdft2 and pdft2_cr); the real stages (the real
#: halves, prdft_last, pirdft_last); the matrix form is dft2.cu
FFT_SRC = "spfft_tpu_torch/csrc/fft.cu"
RFFT_SRC = "spfft_tpu_torch/csrc/rfft.cu"
#: _kernel2's real stages (modes rc and cr), launched there
REAL_REPLACES = "spfft_tpu/ops/dft_kernel.py:277"
DFT2_SRC = "spfft_tpu_torch/csrc/dft2.cu"
#: the fused z kernels by form
Z_SRC = {"fft": "spfft_tpu_torch/csrc/fused_fft.cu",
         "matrix": "spfft_tpu_torch/csrc/fused_compress.cu"}
DEC_REPLACES = "spfft_tpu/ops/fused_kernel.py:587"
CMP_REPLACES = "spfft_tpu/ops/fused_kernel.py:783"


def complex_of(t: torch.Tensor) -> torch.dtype:
    """The complex dtype of ``t``'s real type."""
    return torch.complex128 if t.dtype == torch.float64 else torch.complex64


def matrix_pair(mats):
    """The same matrices without the function they carry: a wrapper runs
    its matrix form on them (the "before" of the FFT forms)."""
    return (mats[0], mats[1])


def uncounted():
    """A stand-in wrapper for stage launches made outside the wrappers
    (the forms a record is compared with): their counts go nowhere."""
    return types.SimpleNamespace(launches=0, form_launches={})


def fft_two_launch(ins, mats1, mats2, swap_out=False):
    """``pdft2`` (``pdft2_swapped`` with ``swap_out``) in the two-launch
    FFT form: csrc/fft.cu's stage kernel over B stored transposed within
    each plane, then over A, the form the wrappers take where a plane
    does not fit one cluster; not counted."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    p, a, b = ins[0].shape
    b_out, a_out = mats1[0].shape[1], mats2[0].shape[1]
    dev = ins[0].device
    dt = ins[0].dtype
    mid = tuple(torch.empty((p, b_out, a), dtype=dt, device=dev)
                for _ in range(2))
    out = tuple(torch.empty((p, a_out, b_out) if swap_out
                            else (p, b_out, a_out), dtype=dt, device=dev)
                for _ in range(2))
    if dev.type != "cuda":  # the stage kernels run only on the card
        return (dft.cdft2_xy if swap_out else dft.pdft2_minor)(
            *ins, mats1, mats2)
    dft_kernel._stage(uncounted(), "cc", ins, mats1, mid, plane_rows=a)
    dft_kernel._stage(uncounted(), "cc", mid, mats2, out,
                      plane_rows=b_out if swap_out else 0)
    return out


def _first_tensor(out):
    """The first tensor of a call's result (a tensor, or nested tuples
    and lists of them)."""
    while not isinstance(out, torch.Tensor):
        out = out[0]
    return out


def kernel_record(path, name, source, replaces, err, kernel, plain,
                  library, nbytes, flops, design_flops, form=None,
                  matrix=None, design_bytes=None):
    """One kernel's record, timed here: ``kernel``, its ``plain`` version,
    the ``library`` yardstick (or None) and ``matrix``, the matrix form on
    the same inputs (or None; a matrix-form kernel's ``matrix_ms`` is its
    own ``ms``), each a call timed one call at a time
    (:func:`timed_ms`), and the kernel and the library call on the device
    alone (:func:`graph_ms`: ``device_ms``, ``library_device_ms``). The
    record's ``dtype`` is the kernel's output's; its bounds take the
    peak rate of that type. ``form``: ``fft``, ``rfft``, ``cluster``,
    ``matrix``, a two-launch ``rfft+fft`` / ``fft+rfft`` or None (no
    DFT). The design bound of the one-launch FFT forms is ``bound_ms``;
    any other form's is ``design_bytes`` (default ``nbytes``) against
    ``design_flops``."""
    out = _first_tensor(kernel())
    dtype, device = out.dtype, out.device
    del out
    b_ms, b_by = bound(nbytes, flops, dtype)
    DESIGN_BOUND_MS.setdefault(path, {})[name] = \
        b_ms if form in ("fft", "cluster", "rfft") else bound(
            nbytes if design_bytes is None else design_bytes,
            design_flops, dtype)[0]
    ms = timed_ms(kernel, device)
    matrix_ms = timed_ms(matrix, device) if matrix is not None else \
        ms if form == "matrix" else None
    return {"path": path, "name": name, "dtype": str(dtype).split(".")[-1],
            "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err[0],
            "rel_err": err[1], "rel_l2": err[2], "ms": ms,
            "device_ms": graph_ms(kernel, device),
            "plain_ms": timed_ms(plain, device), "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None if library is None else timed_ms(library,
                                                                device),
            "library_device_ms": None if library is None else graph_ms(
                library, device),
            "form": form, "matrix_ms": matrix_ms}


def _ms(x):
    return "null" if x is None else f"{x:.4f}"


def print_records(recs):
    for r in recs:
        print(f"kernel {r['path']} {r['name']}: "
              f"max_abs_err={r['max_abs_err']:.3e} "
              f"rel_err={r['rel_err']:.3e} rel_l2={r['rel_l2']:.3e} "
              f"form={r['form']} ms={r['ms']:.4f} matrix_ms="
              f"{_ms(r['matrix_ms'])} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={_ms(r['library_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"design_bound_ms="
              f"{DESIGN_BOUND_MS[r['path']][r['name']]:.4f}"
              + (f" device_ms={_ms(r['device_ms'])} library_device_ms="
                 f"{_ms(r['library_device_ms'])}" if "device_ms" in r
                 else ""), flush=True)


def main_path_plan(sp, n, device, precision="single"):
    """The C2C path's plan at ``precision`` on the n^3 sphere, sorted
    stick-major, and its values (N, 2) from numpy seed ``SEED`` (complex64
    for a single plan, complex128 for a double one)."""
    from spfft_tpu_torch.utils.workloads import \
        spherical_cutoff_triplets_stick_major
    t0 = time.perf_counter()
    trip = spherical_cutoff_triplets_stick_major(n)
    plan = sp.make_local_plan(sp.TransformType.C2C, n, n, n, trip,
                              precision=precision, device=device)
    rng = np.random.default_rng(SEED)
    m = len(trip)
    vals = (rng.standard_normal(m) + 1j * rng.standard_normal(m)) \
        .astype(np.complex64 if precision == "single" else np.complex128)
    values = torch.view_as_real(torch.from_numpy(vals)).to(device)
    print(f"plan: C2C {n}^3 sphere, {precision}, "
          f"{plan.num_local_elements} values in "
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
        torch.zeros(1, dtype=complex_of(v), device=device)])
    slot64 = plan._slot_src.long()
    rows = plan._slot_src.numel() // dz
    form = fused_kernel.z_form(mz, dz)
    e = v.element_size()
    return kernel_record(
        path, "decompress_zdft", Z_SRC[form], DEC_REPLACES, err,
        lambda: fused_kernel.decompress_zdft(
            v, plan._slot_src, mz, dz, pair, zs),
        lambda: fused_kernel.decompress_zdft_plain(
            v, plan._slot_src, mz, dz, pair, zs),
        lambda: torch.fft.ifft(vpad[slot64].view(rows, dz),
                               norm="forward"),
        nv * 2 * e + rows * dz * 4 + table_bytes(mz, form)
        + 2 * rows * dz * e,
        fft_flops(rows, dz), FLOP_PER_CMAC * rows * dz * dz, form,
        lambda: fused_kernel.decompress_zdft(
            v, plan._slot_src, matrix_pair(mz), dz, pair, zs)), got


def kernel_phase(plan, values, device, path="c2c"):
    """Each kernel of the C2C path at its shapes vs its plain version."""
    from spfft_tpu_torch.ops import dft, dft_kernel, stages
    p = plan.index_plan
    recs = []

    rec, (sr, si) = decompress_record(path, plan, values, device)
    recs.append(rec)

    # pdft2, backward shapes: (z, x, y) -> (z, y, x)
    gr = stages.sticks_to_grid_padded(sr, plan._col_inv, plan._grid_w,
                                      p.dim_y)
    gi = stages.sticks_to_grid_padded(si, plan._col_inv, plan._grid_w,
                                      p.dim_y)
    m1, m2 = plan._mats["y_b"], plan._mats["x_b"]
    got = dft_kernel.pdft2(gr, gi, m1, m2)
    err_b = compare(f"{path} pdft2 backward", got,
                    dft.pdft2_minor(gr, gi, m1, m2))
    space = torch.stack(got, dim=-1)
    # pdft2, forward shapes: (z, y, x) -> (z, w, y)
    xr, xi = space[..., 0].contiguous(), space[..., 1].contiguous()
    f1, f2 = plan._mats["x_f"], plan._mats["y_f"]
    fgot = dft_kernel.pdft2(xr, xi, f1, f2)
    err_f = compare(f"{path} pdft2 forward", fgot,
                    dft.pdft2_minor(xr, xi, f1, f2))
    err = max(err_b, err_f)
    two = compare(f"{path} pdft2 backward, two-launch FFT form",
                  fft_two_launch((gr, gi), m1, m2), got)
    gc = torch.complex(gr, gi)
    pp, a, b = gr.shape
    b_out, a_out = m1[0].shape[1], m2[0].shape[1]
    forms = dft_kernel.plane_forms(m1, m2, a)
    form = "+".join(forms)
    e = gr.element_size()
    recs.append(kernel_record(
        path, "pdft2", FFT_SRC, "spfft_tpu/ops/dft_kernel.py:277", err,
        lambda: dft_kernel.pdft2(gr, gi, m1, m2),
        lambda: dft.pdft2_minor(gr, gi, m1, m2),
        (lambda: torch.fft.ifft2(gc, norm="forward")
         .transpose(-1, -2).contiguous())
        if (b_out, a_out) == (b, a) else None,
        2 * pp * a * b * e + 2 * pp * b_out * a_out * e
        + plane_table_bytes(m1, m2, forms),
        fft_flops(pp * a, b) + fft_flops(pp * b_out, a),
        FLOP_PER_CMAC * pp * (a * b * b_out + b_out * a * a_out), form,
        lambda: dft_kernel.pdft2(gr, gi, matrix_pair(m1),
                                 matrix_pair(m2))))
    ms2 = timed_ms(lambda: fft_two_launch((gr, gi), m1, m2), device)
    print(f"{path} pdft2 backward in the two-launch FFT form: {ms2:.4f} ms "
          f"(reference; the path takes form {form}), max_abs_err against "
          f"the {form} form {two[0]:.3e}", flush=True)

    recs.append(zdft_compress_record(path, plan, fgot, device))
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
    form = fused_kernel.z_form(mf, dz)
    e = fr.element_size()
    return kernel_record(
        path, "zdft_compress", Z_SRC[form], CMP_REPLACES, err,
        lambda: fused_kernel.zdft_compress(fr, fi, mf, plan._csr, pair),
        lambda: fused_kernel.zdft_compress_plain(
            fr, fi, mf, plan._csr, pair),
        lambda: torch.fft.fft(fc).view(-1)[vi64] * gs,
        2 * s * dz * e + (s + 1 + 2 * nv) * 4 + table_bytes(mf, form)
        + nv * 2 * e,
        fft_flops(s, dz), FLOP_PER_CMAC * s * dz * dz, form,
        lambda: fused_kernel.zdft_compress(
            fr, fi, matrix_pair(mf), plan._csr, pair))


def odd_shapes_phase(device, dtype=torch.float32):
    """Each kernel at shapes the main path does not reach (axes that are
    not multiples of the tiles, rectangular split-x matrices, more than
    256 output columns, the 512 axis, empty sticks, duplicate values,
    both value layouts) against its plain version."""
    from spfft_tpu_torch.indexing import inverse_slot_map
    from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel
    rng = np.random.default_rng(SEED + 1)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)

    def mats(m):
        return dft.device_mats(m, device, dtype)

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
    print(f"odd shapes: {cases} kernel-vs-plain cases within "
          f"{kernel_tol(dtype)[1]} ({dtype})", flush=True)


def fft_odd_shapes_phase(device, dtype=torch.float32):
    """The redesigned complex stages at shapes the paths do not reach,
    against their plain versions, each call's form checked by its launch
    counts: ``pdft_last`` in the FFT form at every radix (n = 1, 2, 3, 5,
    12, 45, 60, 100, 128, 384, 512), ragged row counts, input and output
    windows (wrapped), both signs and a scale, and at prime lengths (11,
    13) in the matrix form; ``pdft2`` and ``pdft2_swapped`` in the
    cluster form (P = 1, A not a multiple of 8, rectangular, windowed,
    3·5-smooth, a ragged 129-row K), the two-launch FFT form (512²
    planes), a mixed FFT + matrix call and the matrix form; ``prdft2``
    and ``pdft2_cr`` with their complex half in the FFT form."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    rng = np.random.default_rng(SEED + 8)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)

    def c2c(n, sign, scale=1.0, **window):
        return dft.device_c2c(n, sign, scale, device=device, dtype=dtype,
                              **window)

    def forms_of(wrapper, fn):
        wrapper.form_launches = dict.fromkeys(wrapper.form_launches, 0)
        out = fn()
        return out, {f: k for f, k in wrapper.form_launches.items() if k}

    on_card = device.type == "cuda"
    cases = 0
    for lead, n, sign, scale, window in (
            ((5,), 1, 1, 0.5, {}), ((7,), 2, -1, 1.0, {}),
            ((33,), 3, 1, 1.0, {}), ((9,), 5, -1, 0.2, {}),
            ((37,), 12, 1, 1.0, {"rows": (10, 5)}),
            ((3, 7), 45, -1, 1 / 45, {"cols": (40, 20)}),
            ((1001,), 60, 1, 1.0, {"rows": (59, 31), "cols": (50, 60)}),
            ((11,), 100, -1, 1.0, {"rows": (90, 30)}),
            ((1001,), 256, 1, 1.0, {}), ((65,), 128, -1, 0.25, {}),
            ((9,), 384, 1, 1.0, {}), ((3,), 512, -1, 1 / 512,
                                      {"cols": (500, 100)}),
            ((21,), 13, 1, 1.0, {}), ((4,), 11, -1, 0.5, {"rows": (9, 4)})):
        m = c2c(n, sign, scale, **window)
        k = m[0].shape[0]
        xr, xi = rand(*lead, k), rand(*lead, k)
        got, forms = forms_of(dft_kernel.pdft_last,
                              lambda: dft_kernel.pdft_last(xr, xi, m))
        want_form = dft_kernel.stage_form(m)
        if want_form != ("matrix" if n in (11, 13) else "fft") or (
                on_card and forms != {want_form: 1}):
            fail(f"pdft_last n={n}: form {forms}, expected {want_form}")
        compare(f"pdft_last {lead + (k,)} n={n} {window} form {want_form}",
                got, dft.pdft_last(xr, xi, m))
        cases += 1
    planes = (  # (P, A, B), mats1 over B, mats2 over A, forms
        ((3, 20, 24), c2c(24, 1), c2c(20, -1), ("cluster",)),
        ((5, 9, 16), c2c(16, -1), c2c(24, 1, rows=(20, 9)), ("cluster",)),
        ((4, 24, 20), c2c(20, -1, cols=(17, 6)), c2c(24, -1), ("cluster",)),
        ((2, 45, 60), c2c(60, 1, 1 / 60), c2c(45, 1, 2.0), ("cluster",)),
        ((1, 3, 5), c2c(5, 1), c2c(3, 1), ("cluster",)),
        ((3, 256, 129), c2c(256, 1, rows=(0, 129)), c2c(256, 1),
         ("cluster",)),
        ((2, 512, 9), c2c(9, 1), c2c(512, 1), ("cluster",)),
        ((2, 512, 512), c2c(512, 1), c2c(512, -1, 0.5), ("fft", "fft")),
        ((2, 7, 300), c2c(300, -1), c2c(7, -1), ("fft", "matrix")),
        ((2, 11, 13), c2c(13, 1), c2c(11, 1), ("matrix", "matrix")))
    for (pp, a, b), m1, m2, want in planes:
        if dft_kernel.plane_forms(m1, m2, a) != want:
            fail(f"plane {(pp, a, b)}: forms "
                 f"{dft_kernel.plane_forms(m1, m2, a)}, expected {want}")
        xr, xi = rand(pp, a, b), rand(pp, a, b)
        for wrapper, plain in ((dft_kernel.pdft2, dft.pdft2_minor),
                               (dft_kernel.pdft2_swapped, dft.cdft2_xy)):
            got, forms = forms_of(wrapper, lambda: wrapper(xr, xi, m1, m2))
            counted = {}
            for f in want:
                counted[f] = counted.get(f, 0) + 1
            if on_card and forms != counted:
                fail(f"{wrapper.__name__} {(pp, a, b)}: launches by form "
                     f"{forms}, expected {counted}")
            compare(f"{wrapper.__name__} {(pp, a, b)} form "
                    f"{'+'.join(want)}", got, plain(xr, xi, m1, m2))
            cases += 1
    for nx, ny, pp, cols in ((24, 20, 3, None), (15, 45, 2, (2, 4)),
                             (256, 256, 2, None)):
        r2c = dft.r2c_mats(nx) if cols is None \
            else dft.sub_cols_r2c_mats(nx, tuple(range(cols[0],
                                                       cols[0] + cols[1])))
        c2r = dft.c2r_mats(nx) if cols is None \
            else dft.sub_rows_c2r_mats(nx, tuple(range(cols[0],
                                                       cols[0] + cols[1])))
        r2c = dft.device_mats(r2c, device, dtype)
        c2r = dft.device_mats(c2r, device, dtype)
        x = rand(pp, ny, nx)
        yf, yb = c2c(ny, dft.FORWARD), c2c(ny, dft.BACKWARD)
        got, forms = forms_of(dft_kernel.prdft2,
                              lambda: dft_kernel.prdft2(x, r2c, yf))
        if on_card and forms != {"matrix": 1, "fft": 1}:
            fail(f"prdft2 nx={nx}: launches by form {forms}")
        compare(f"prdft2 nx={nx} ny={ny} window={cols} form matrix+fft", got,
                dft.prdft2_minor(x, r2c, yf))
        k = c2r[0].shape[0]
        gr, gi = rand(pp, k, ny), rand(pp, k, ny)
        got, forms = forms_of(dft_kernel.pdft2_cr,
                              lambda: dft_kernel.pdft2_cr(gr, gi, yb, c2r))
        if on_card and forms != {"matrix": 1, "fft": 1}:
            fail(f"pdft2_cr nx={nx}: launches by form {forms}")
        compare(f"pdft2_cr nx={nx} ny={ny} window={cols} form fft+matrix",
                (got,), (dft.pdft2_minor_cr(gr, gi, yb, c2r),))
        cases += 2
    print(f"odd shapes of the FFT and cluster forms: {cases} kernel-vs-plain "
          f"cases within {kernel_tol(dtype)[1]} ({dtype}), each in its "
          f"expected form", flush=True)


def z_fft_odd_shapes_phase(device, dtype=torch.float32):
    """The FFT form of both fused z kernels at shapes the paths do not
    reach, against their plain versions, each call's form checked by its
    launch counts: every radix (dim_z 1, 2, 3, 4, 5, 8, 12, 60, 100, 128,
    384, 512) and 13 in the matrix form; one transform and B = 3 (each
    band bit for bit against its single launch); both value layouts;
    input and output windows off 0 and a scale; an empty stick, duplicate
    triplets and the R2C zero stick (half of it given, a given value of
    exactly 0 whose mirror is given, absent)."""
    from spfft_tpu_torch.indexing import inverse_slot_map
    from spfft_tpu_torch.ops import dft, fused_kernel as fk
    rng = np.random.default_rng(SEED + 9)
    on_card = device.type == "cuda"

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    def counted(wrapper, form, name, fn):
        wrapper.form_launches = dict.fromkeys(wrapper.form_launches, 0)
        out = fn()
        forms = {f: k for f, k in wrapper.form_launches.items() if k}
        if on_card and forms != {form: 1}:
            fail(f"{name}: launches by form {forms}, expected {form}")
        return out

    cases = 0
    for dz, s, window in ((1, 40, {}), (2, 33, {}), (3, 21, {}), (4, 19, {}),
                          (5, 17, {}), (8, 9, {}),
                          (12, 37, {"rows": (5, 12), "cols": (3, 12)}),
                          (60, 11, {}), (100, 7, {"cols": (91, 100)}),
                          (128, 9, {}), (384, 9, {"rows": (200, 384)}),
                          (512, 5, {}), (13, 21, {})):
        form = "matrix" if dz == 13 else "fft"
        zb = dft.device_c2c(dz, dft.BACKWARD, device=device, dtype=dtype,
                            **window)
        zf = dft.device_c2c(dz, dft.FORWARD, 1.0 / dz, device=device,
                            dtype=dtype, **window)
        if fk.z_form(zb, dz) != form or fk.z_form(zf, dz) != form:
            fail(f"z kernels dim_z={dz}: form {fk.z_form(zb, dz)}, "
                 f"expected {form}")
        kinds = (("half", 0), ("absent", -1)) + (
            (("exact0", s - 1),) if dz >= 3 else ())
        for kind, zid in kinds:
            occ = rng.random((s, dz)) < 0.5
            occ[s // 2] = False  # an empty stick
            if zid >= 0:
                occ[zid] = np.arange(dz) <= dz // 2
                # exact0 zeroes slot 1; its mirror dz - 1 is given
                occ[zid, dz - 1] |= kind == "exact0"
            slots = np.flatnonzero(occ)
            slots = np.concatenate([slots, slots[:3]])  # duplicate triplets
            rng.shuffle(slots)
            nv = len(slots)
            ss = i32(np.concatenate([inverse_slot_map(slots, s * dz, nv),
                                     np.full(dz, nv, np.int32)]))
            csr = tuple(i32(t) for t in fk.compress_csr(slots, s, dz))
            hits = np.flatnonzero(slots == zid * dz + 1)
            for pair in (False, True):
                for lead in ((), (3,)):
                    name = (f"z kernels dim_z={dz} {window} zero stick "
                            f"{kind} B={lead} pair={pair} form {form}")
                    vals = rand(*lead, 2, nv) if pair else rand(*lead, nv, 2)
                    if kind == "exact0":
                        idx = torch.as_tensor(hits, device=device)
                        if pair:
                            vals[..., idx] = 0.0
                        else:
                            vals[..., idx, :] = 0.0
                    got = counted(fk.decompress_zdft, form,
                                  f"decompress_zdft {name}",
                                  lambda: fk.decompress_zdft(
                                      vals, ss, zb, dz, pair, zid))
                    compare(f"decompress_zdft {name}", got,
                            fk.decompress_zdft_plain(vals, ss, zb, dz, pair,
                                                     zid))
                    sr, si = rand(*lead, s, dz), rand(*lead, s, dz)
                    out = counted(fk.zdft_compress, form,
                                  f"zdft_compress {name}",
                                  lambda: fk.zdft_compress(sr, si, zf, csr,
                                                           pair))
                    compare(f"zdft_compress {name}", (out,),
                            (fk.zdft_compress_plain(sr, si, zf, csr, pair),))
                    for b in range(lead[0] if lead else 0):
                        one = fk.decompress_zdft(vals[b], ss, zb, dz, pair,
                                                 zid)
                        if not (torch.equal(one[0], got[0][b])
                                and torch.equal(one[1], got[1][b])
                                and torch.equal(fk.zdft_compress(
                                    sr[b], si[b], zf, csr, pair), out[b])):
                            fail(f"{name}: band {b} differs from its single "
                                 f"launch")
                    cases += 2
    print(f"odd shapes of the fused z kernels' FFT form: {cases} "
          f"kernel-vs-plain cases within {kernel_tol(dtype)[1]} ({dtype}), "
          f"each in its expected form, batched bands equal to single "
          f"launches", flush=True)


#: launches of one backward + forward(FULL) pair per path: (least, most),
#: and for a DFT wrapper that launches, its launches by form (exactly)
CLUSTER2 = (2, 2, {"cluster": 2})  # one cluster launch per call
FFT2 = (2, 2, {"fft": 2})
REAL2 = (2, 2, {"rfft": 1, "fft": 1})  # the real half, the complex half
#: the real x stage of a distributed R2C pair: one launch per direction
RFFT1 = (1, 1, {"rfft": 1})
#: the single-stage real wrappers, on every path but the distributed R2C
NO_REAL_LAST = {"prdft_last": (0, 0), "pirdft_last": (0, 0)}
ZFFT1 = (1, 1, {"fft": 1})  # one fused z launch per direction
C2C_LAUNCHES = {"decompress_zdft": ZFFT1, "pdft2": CLUSTER2,
                "zdft_compress": ZFFT1, "prdft2": (0, 0),
                "pdft2_cr": (0, 0), "gather": (0, 0), "pdft_last": (0, 0),
                "pdft2_swapped": (0, 0),
                **NO_REAL_LAST}
R2C_LAUNCHES = {"decompress_zdft": ZFFT1, "prdft2": REAL2,
                "pdft2_cr": REAL2, "zdft_compress": ZFFT1,
                "pdft2": (0, 0), "gather": (0, 0), "pdft_last": (0, 0),
                "pdft2_swapped": (0, 0),
                **NO_REAL_LAST}
#: the two-kernel route's pair, exactly
C2C_2K_LAUNCHES = {"gather": (2, 2), "pdft_last": FFT2,
                   "decompress_zdft": (0, 0), "zdft_compress": (0, 0),
                   "pdft2": CLUSTER2, "prdft2": (0, 0), "pdft2_cr": (0, 0),
                   "pdft2_swapped": (0, 0),
                   **NO_REAL_LAST}
R2C_2K_LAUNCHES = {"gather": (2, 2), "pdft_last": FFT2,
                   "decompress_zdft": (0, 0), "zdft_compress": (0, 0),
                   "prdft2": REAL2, "pdft2_cr": REAL2, "pdft2": (0, 0),
                   "pdft2_swapped": (0, 0),
                   **NO_REAL_LAST}
#: a batched pair launches what ONE single pair does, whatever B is
C2C_BATCHED_LAUNCHES = {"decompress_zdft": ZFFT1, "zdft_compress": ZFFT1,
                        "pdft2": CLUSTER2, "prdft2": (0, 0),
                        "pdft2_cr": (0, 0), "gather": (0, 0),
                        "pdft_last": (0, 0), "pdft2_swapped": (0, 0),
                        **NO_REAL_LAST}
R2C_BATCHED_LAUNCHES = {"decompress_zdft": ZFFT1, "zdft_compress": ZFFT1,
                        "prdft2": REAL2, "pdft2_cr": REAL2, "pdft2": (0, 0),
                        "gather": (0, 0), "pdft_last": (0, 0),
                        "pdft2_swapped": (0, 0),
                        **NO_REAL_LAST}
#: record name -> the launch counter it reads
COUNTER_OF = {"gather_dec": "gather", "gather_cmp": "gather",
              "gather_dec_batched": "gather", "gather_cmp_batched": "gather",
              "decompress_zdft_batched": "decompress_zdft",
              "zdft_compress_batched": "zdft_compress"}


def reset_launches(counters):
    """Set every launch counter, and every count by form, to 0."""
    for c in counters.values():
        c.launches = 0
        if hasattr(c, "form_launches"):
            c.form_launches = dict.fromkeys(c.form_launches, 0)


def read_launches(path, counters, want):
    """Each counter's launches since :func:`reset_launches`; fails when
    one lies outside its ``want`` bounds, or a DFT wrapper's launches by
    form differ from ``want``'s (its third entry: every form not named
    there must be 0)."""
    launches = {name: c.launches for name, c in counters.items()}
    forms = {name: {f: k for f, k in c.form_launches.items() if k}
             for name, c in counters.items() if hasattr(c, "form_launches")}
    print(f"{path} path launches: {launches}; by form: {forms}", flush=True)
    for name, (lo, hi, *by_form) in want.items():
        k = launches[name]
        if k < lo or (hi is not None and k > hi):
            fail(f"{path} path launched {name} {k} times, expected "
                 f"{lo}..{'' if hi is None else hi}")
        expect = by_form[0] if by_form else {}
        if name in forms and forms[name] != expect:
            fail(f"{path} path launched {name} by form {forms[name]}, "
                 f"expected {expect}")
    return launches


def roundtrip_tol(sp, precision, n):
    """The round trip's bound: ``ROUNDTRIP_TOL`` in single precision, 3
    times ``predicted_rel_error("double", n)`` in double."""
    if precision == "single":
        return ROUNDTRIP_TOL
    return 3 * sp.predicted_rel_error(precision, n, True)


def pair_phase(sp, path, plan, values, oracle_rel, device, counters,
               want):
    """The public backward + forward(FULL) pair of ``path``, counted
    (``want``), checked and timed: the backward (the complex slab for
    C2C, the real one for R2C) within ``predicted_rel_error`` of the
    plan's precision of the complex128 oracle on the card
    (``oracle_rel(space)`` gives the relative l2 error), the round trip
    within :func:`roundtrip_tol`, and a second backward equal to the
    first."""
    reset_launches(counters)
    space = plan.backward(values)
    out = plan.forward(space, sp.Scaling.FULL)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches(path, counters, want)

    shape = (plan.dim_z, plan.dim_y, plan.dim_x)
    if plan.transform_type is sp.TransformType.C2C:
        shape += (2,)
    if tuple(space.shape) != shape or space.dtype != plan.real_dtype \
            or out.dtype != plan.real_dtype \
            or not torch.isfinite(space).all():
        fail(f"{path} backward output malformed: {tuple(space.shape)} "
             f"{space.dtype}")
    rel = oracle_rel(space)
    pred = sp.predicted_rel_error(plan.precision, max(shape[:3]), True)
    print(f"{path} backward vs complex128 oracle: rel_l2={rel:.3e} "
          f"(predicted_rel_error={pred:.3e})", flush=True)
    if not rel <= pred:
        fail(f"{path} backward rel_l2 {rel:.3e} above {pred:.3e}")
    vals_out = out.t() if plan.pair_values_io else out
    rt = float(torch.linalg.norm(vals_out.double() - values.double())
               / torch.linalg.norm(values.double()))
    rt_tol = roundtrip_tol(sp, plan.precision, max(shape[:3]))
    print(f"{path} forward(FULL) round trip: rel_l2={rt:.3e} (at most "
          f"{rt_tol:.3e})", flush=True)
    if not rt <= rt_tol:
        fail(f"{path} round trip rel_l2 {rt:.3e} above {rt_tol:.3e}")
    if not torch.equal(plan.backward(values), space):
        fail(f"{path}: a second backward differs from the first")

    def pair():
        return plan.forward(plan.backward(values), sp.Scaling.FULL)

    pair_ms = timed_ms(pair, device)
    dev_ms = graph_ms(pair, device, PAIR_GRAPH_CALLS)
    print(f"{path} path pair (backward + forward FULL): {pair_ms:.4f} ms "
          f"median of {REPS}; on the device alone {_ms(dev_ms)} ms",
          flush=True)
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

def r2c_plan(sp, n, device, precision="single"):
    """The R2C path's plan at ``precision`` on the non-redundant half of
    the n^3 sphere (as bench.py builds it), sorted stick-major; values
    from a seeded real field band-limited to the sphere, the half set's
    hermitian closure. Returns the plan, the values (N, 2) in the plan's
    real type and the oracle of backward: that field times n^3, real f64,
    from complex128 on ``device``. In single precision the spectrum is
    rounded to complex64 before both are taken, so the oracle is exact
    for the values the plan is given. Returns the plan, its triplets, the
    values and the oracle."""
    from spfft_tpu_torch.utils.workloads import \
        spherical_cutoff_triplets_stick_major
    t0 = time.perf_counter()
    full = spherical_cutoff_triplets_stick_major(n)
    x, y, z = full[:, 0], full[:, 1], full[:, 2]
    # a subset of a stick-major set keeps its order
    trip = full[(x > 0) | ((x == 0) & ((y > 0) | ((y == 0) & (z >= 0))))]
    plan = sp.make_local_plan(sp.TransformType.R2C, n, n, n, trip,
                              precision=precision, device=device)
    cdt = torch.complex64 if precision == "single" else torch.complex128

    def storage(t):
        return torch.as_tensor(np.where(t < 0, t + n, t).astype(np.int64),
                               device=device)

    gen = torch.Generator(device=device).manual_seed(SEED)
    spec = torch.fft.fftn(torch.randn((n, n, n), generator=gen,
                                      dtype=torch.float64, device=device))
    spec = spec.to(cdt).to(torch.complex128)
    sf = storage(full)
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    mask[sf[:, 2], sf[:, 1], sf[:, 0]] = True
    spec *= mask
    del mask, sf
    sh = storage(trip)
    values = torch.view_as_real(spec[sh[:, 2], sh[:, 1], sh[:, 0]]
                                .to(cdt)).contiguous()
    oracle = torch.fft.ifftn(spec, norm="forward").real.contiguous()
    del spec
    p = plan.index_plan
    print(f"plan: R2C {n}^3 half sphere, {precision}, "
          f"{plan.num_local_elements} values "
          f"in {p.num_sticks} sticks, dim_x_freq={p.dim_x_freq}, "
          f"zero_stick={p.zero_stick_id}, split_x={plan.split_x}, "
          f"pair_io={plan.pair_values_io}, built with its values in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan, trip, values, oracle


def r2c_kernel_phase(plan, values, device, path="r2c"):
    """Each kernel of the R2C path at its shapes vs its plain version."""
    from spfft_tpu_torch.ops import dft, dft_kernel, stages
    p = plan.index_plan
    recs = []
    rec, (sr, si) = decompress_record(path, plan, values, device)
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
    err = compare(f"{path} pdft2_cr", (space,),
                  (dft.pdft2_minor_cr(gr, gi, m1, m2),))
    gc = torch.complex(gr, gi)
    pp, a, b = gr.shape
    b_out, a_out = m1[0].shape[1], m2[0].shape[1]
    cc, rf = dft_kernel.stage_form(m1), dft_kernel.stage_form(m2)
    e = gr.element_size()
    nbytes = 2 * pp * a * b * e + pp * b_out * a_out * e \
        + table_bytes(m1, cc) + table_bytes(m2, rf)
    recs.append(kernel_record(
        path, "pdft2_cr", RFFT_SRC, REAL_REPLACES, err,
        lambda: dft_kernel.pdft2_cr(gr, gi, m1, m2),
        lambda: dft.pdft2_minor_cr(gr, gi, m1, m2),
        (lambda: torch.fft.irfft2(
            gc.transpose(-1, -2), s=(b_out, a_out), norm="forward"))
        if a == p.dim_x_freq else None,
        nbytes, fft_flops(pp * a, b) + rfft_flops(pp * b_out, a_out),
        (fft_flops(pp * a, b) if cc == "fft"
         else FLOP_PER_CMAC * pp * a * b * b_out)
        + (rfft_flops(pp * b_out, a_out) if rf == "rfft"
           else FLOP_PER_RMAC * pp * b_out * a * a_out), f"{cc}+{rf}",
        lambda: dft_kernel.pdft2_cr(gr, gi, matrix_pair(m1),
                                    matrix_pair(m2)),
        design_bytes=nbytes + 2 * 2 * pp * b_out * a * e))

    # prdft2, forward shapes: real (z, y, x) -> planar (z, w, y)
    f1, f2 = plan._mats["x_f"], plan._mats["y_f"]
    fgot = dft_kernel.prdft2(space, f1, f2)
    err = compare(f"{path} prdft2", fgot, dft.prdft2_minor(space, f1, f2))
    pp, a, b = space.shape
    b_out, a_out = f1[0].shape[1], f2[0].shape[1]
    rf, cc = dft_kernel.stage_form(f1), dft_kernel.stage_form(f2)
    nbytes = pp * a * b * e + 2 * pp * b_out * a_out * e \
        + table_bytes(f1, rf) + table_bytes(f2, cc)
    recs.append(kernel_record(
        path, "prdft2", RFFT_SRC, REAL_REPLACES, err,
        lambda: dft_kernel.prdft2(space, f1, f2),
        lambda: dft.prdft2_minor(space, f1, f2),
        (lambda: torch.fft.rfft2(space).transpose(-1, -2)
         .contiguous())
        if b_out == p.dim_x_freq else None,
        nbytes, rfft_flops(pp * a, b) + fft_flops(pp * b_out, a),
        (rfft_flops(pp * a, b) if rf == "rfft"
         else FLOP_PER_RMAC * pp * a * b * b_out)
        + (fft_flops(pp * b_out, a) if cc == "fft"
           else FLOP_PER_CMAC * pp * b_out * a * a_out), f"{rf}+{cc}",
        lambda: dft_kernel.prdft2(space, matrix_pair(f1),
                                  matrix_pair(f2)),
        design_bytes=nbytes + 2 * 2 * pp * b_out * a * e))

    recs.append(zdft_compress_record(path, plan, fgot, device))
    print_records(recs)
    return recs


def r2c_odd_shapes_phase(device, dtype=torch.float32):
    """The R2C kernels at shapes the path does not reach: the real stages
    of ``prdft2`` / ``pdft2_cr`` and the single-stage ``prdft_last`` /
    ``pirdft_last`` in the real FFT form at even lengths of every kind
    (2, 4, 6, 10, 24, 100, 250, 256, 512: half lengths 1, 2, odd,
    powers of two, mixed radix) and in the matrix form at odd lengths (7,
    15) and at 14 (a 7 in the half), with the plan's matrices and with
    plain pairs, in windows of the half spectrum from 0, past 0 and
    wrapped, scaled, with nonzero imaginary parts at DC and Nyquist
    (changing them must leave the real inverse's output unchanged, bit for
    bit, in the real FFT form), both stores of the real FFT stage kernel
    (straight and transposed within planes), each call's form checked by
    its launch counts; then the (0,0)-stick completion with no slot of the
    stick given, half of it given, a given value of exactly 0 whose mirror
    slot is given (so only completion by value fills it, not completion of
    empty slots), and no zero stick at all, in both value layouts; each
    against its plain version."""
    from spfft_tpu_torch.indexing import inverse_slot_map
    from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel
    rng = np.random.default_rng(SEED + 2)
    on_card = device.type == "cuda"

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)

    def mats(m):
        return dft.device_mats(m, device, dtype)

    def counted(wrapper, want, name, fn):
        """``fn()``, failing on the card unless ``wrapper`` launched
        ``want`` (a dict by form) in it."""
        wrapper.form_launches = dict.fromkeys(wrapper.form_launches, 0)
        out = fn()
        got = {f: k for f, k in wrapper.form_launches.items() if k}
        if on_card and got != want:
            fail(f"{name}: launches by form {got}, expected {want}")
        return out

    cases = 0
    for nx, ny, pp, windows in ((2, 9, 3, ((1, 1),)),
                                (4, 6, 3, ((0, 2), (2, 2))),
                                (6, 5, 3, ((1, 3), (3, 2))),
                                (7, 9, 3, ((0, 2), (1, 3))),
                                (10, 12, 2, ((0, 3), (4, 2))),
                                (14, 8, 3, ((0, 4), (6, 2))),
                                (15, 20, 3, ((0, 3), (2, 4))),
                                (24, 16, 3, ((0, 5), (3, 5), (11, 4))),
                                (100, 10, 2, ((0, 30), (40, 11))),
                                (250, 6, 2, ((0, 120), (120, 6))),
                                (256, 40, 2, ((0, 100), (50, 79))),
                                (512, 9, 2, ((0, 100), (50, 120)))):
        xf = nx // 2 + 1
        for win in (None,) + windows:
            scale = 1.0 if win is None else 1.0 / nx
            spec_r2c = dft.device_r2c(nx, scale, cols=win, device=device,
                                      dtype=dtype)
            spec_c2r = dft.device_c2r(nx, scale, rows=win, device=device,
                                      dtype=dtype)
            form = dft_kernel.stage_form(spec_r2c)
            if form != ("rfft" if nx % 2 == 0 and nx != 14 else "matrix"):
                fail(f"real stage nx={nx}: form {form}")
            k = spec_r2c[0].shape[1]
            x = rand(pp, ny, nx)
            xr, xi = rand(pp, k, ny), rand(pp, k, ny)
            bins = [(win[0] + j) % xf if win else j for j in range(k)]
            dc_nyq = [j for j, q in enumerate(bins)
                      if q == 0 or (nx % 2 == 0 and q == nx // 2)]
            yf = dft.device_c2c(ny, dft.FORWARD, device=device, dtype=dtype)
            yb = dft.device_c2c(ny, dft.BACKWARD, device=device, dtype=dtype)
            for kind, r2c, c2r, f in (
                    ("spec", spec_r2c, spec_c2r, form),
                    ("plain", matrix_pair(spec_r2c), matrix_pair(spec_c2r),
                     "matrix")):
                name = f"nx={nx} window={win} {kind} form {f}"
                compare(f"prdft2 {name}",
                        counted(dft_kernel.prdft2, {f: 1, "fft": 1},
                                f"prdft2 {name}",
                                lambda: dft_kernel.prdft2(x, r2c, yf)),
                        dft.prdft2_minor(x, r2c, yf))
                compare(f"pdft2_cr {name}",
                        (counted(dft_kernel.pdft2_cr, {"fft": 1, f: 1},
                                 f"pdft2_cr {name}",
                                 lambda: dft_kernel.pdft2_cr(xr, xi, yb,
                                                             c2r)),),
                        (dft.pdft2_minor_cr(xr, xi, yb, c2r),))
                rows = rand(pp, 7, nx)
                compare(f"prdft_last {name}",
                        counted(dft_kernel.prdft_last, {f: 1},
                                f"prdft_last {name}",
                                lambda: dft_kernel.prdft_last(rows, r2c)),
                        dft.prdft_last(rows, r2c))
                hr, hi = rand(pp, 7, k), rand(pp, 7, k)
                got = counted(dft_kernel.pirdft_last, {f: 1},
                              f"pirdft_last {name}",
                              lambda: dft_kernel.pirdft_last(hr, hi, c2r))
                compare(f"pirdft_last {name}", (got,),
                        (dft.pirdft_last(hr, hi, c2r),))
                if f == "rfft" and dc_nyq:
                    hi2 = hi.clone()
                    hi2[..., dc_nyq] += 1.0 + rand(pp, 7, len(dc_nyq))
                    if not torch.equal(
                            dft_kernel.pirdft_last(hr, hi2, c2r), got):
                        fail(f"pirdft_last {name}: the imaginary parts at "
                             f"DC / Nyquist reached the output")
                cases += 4
    # the real FFT stage kernel's transposed store (prdft2's first launch
    # takes it; the real inverse supports it too), many blocks, ragged
    # planes
    for nx, planes, plane_rows, win in ((256, 3, 700, None),
                                        (24, 5, 129, (3, 7)),
                                        (250, 2, 64, (100, 26))):
        r2c = dft.device_r2c(nx, cols=win, device=device, dtype=dtype)
        c2r = dft.device_c2r(nx, rows=win, device=device, dtype=dtype)
        k = r2c[0].shape[1]
        x = rand(planes, plane_rows, nx)
        out = tuple(torch.empty((planes, k, plane_rows), dtype=dtype,
                                device=device)
                    for _ in range(2))
        if on_card:
            dft_kernel._stage(uncounted(), "rc", (x,), r2c, out,
                              plane_rows=plane_rows)
        else:
            out = tuple(t.transpose(1, 2) for t in dft.prdft_last(x, r2c))
        compare(f"rfft stage rc nx={nx} transposed within {plane_rows} rows",
                out, tuple(t.transpose(1, 2)
                           for t in dft.prdft_last(x, r2c)))
        y = (rand(planes, plane_rows, k), rand(planes, plane_rows, k))
        real = torch.empty((planes, nx, plane_rows), dtype=dtype,
                           device=device)
        if on_card:
            dft_kernel._stage(uncounted(), "cr", y, c2r, (real,),
                              plane_rows=plane_rows)
        else:
            real = dft.pirdft_last(*y, c2r).transpose(1, 2)
        compare(f"rfft stage cr nx={nx} transposed within {plane_rows} rows",
                (real,), (dft.pirdft_last(*y, c2r).transpose(1, 2),))
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
          f"{kernel_tol(dtype)[1]} ({dtype})", flush=True)


# -- the two-kernel route, batched execution, the round trip -----------------

#: batch of the batched kernel and pair phases
BATCH = 4
SWEEP_BATCHES = (2, 4, 8)
GATHER_SRC = "spfft_tpu_torch/csrc/gather.cu"
#: run_gather, which reaches the Pallas gathers at :751/:778 and
#: :824/:848 (narrow) and :1119/:1145 (wide), rows 8 and 9 of PERF.md
GATHER_REPLACES = "spfft_tpu/ops/gather_kernel.py:1177"


def compare_exact(name, got, want):
    """The gather moves values and computes nothing: it must equal its
    plain version bit for bit. Returns the error triple of
    :func:`compare` (all 0)."""
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            diff = float((g.double() - w.double()).abs().max()) \
                if g.shape == w.shape else float("nan")
            fail(f"{name}: kernel differs from its plain version "
                 f"(shapes {tuple(g.shape)} {tuple(w.shape)}, max_abs "
                 f"{diff:.3e}); the gather must be exact")
    return 0.0, 0.0, 0.0


def band_values(plan, values, batch):
    """``batch`` value sets in the plan's coerced layout, ``(B, N, 2)`` or
    ``(B, 2, N)``: band b is ``values`` rolled by 7 b along the value
    axis, so the bands differ."""
    v = plan._coerce_values(values)
    axis = v.dim() - 1 if plan.pair_values_io else 0
    return torch.stack([v.roll(7 * b, dims=axis) for b in range(batch)])


def two_kernel_kernel_phase(path, plan, values, device):
    """The two-kernel route's kernels at its shapes: the gather both ways
    (exact), ``pdft_last`` backward (with the R2C (0,0)-stick completion
    between the two, as the route runs it) and forward (FULL scale)."""
    from spfft_tpu_torch.ops import dft, dft_kernel, gather_kernel, stages
    p = plan.index_plan
    dz, nv, s = p.dim_z, p.num_values, p.num_sticks
    pair = plan.pair_values_io
    v = plan._coerce_values(values)
    if plan._conj is not None:
        v = v * plan._conj
    ss = plan._slot_src
    rows = ss.numel() // dz
    recs = []

    sr, si = gather_kernel.decompress(v, ss, dz, pair)
    err = compare_exact(f"{path} gather decompress", (sr, si),
                        gather_kernel.decompress_plain(v, ss, dz, pair))
    vpad = torch.cat([torch.view_as_complex(
        (v.t() if pair else v).contiguous()),
        torch.zeros(1, dtype=complex_of(v), device=device)])
    slot64 = ss.long()
    e = v.element_size()
    recs.append(gather_record(
        path, "gather_dec", err,
        lambda: gather_kernel.decompress(v, ss, dz, pair),
        lambda: gather_kernel.decompress_plain(v, ss, dz, pair),
        lambda: torch.index_select(vpad, 0, slot64),
        nv * 2 * e + rows * dz * 4 + rows * dz * 2 * e))

    zid = plan._zero_stick
    if zid >= 0:
        sr[zid], si[zid] = stages.complete_stick_hermitian(sr[zid], si[zid])
    zb, zf = plan._mats["z_b"], plan._mats["z_fs"]
    yr, yi = dft_kernel.pdft_last(sr, si, zb)
    err_b = compare(f"{path} pdft_last backward", (yr, yi),
                    dft.pdft_last(sr, si, zb))
    fr, fi = yr[:s].contiguous(), yi[:s].contiguous()
    fy = dft_kernel.pdft_last(fr, fi, zf)
    err_f = compare(f"{path} pdft_last forward", fy, dft.pdft_last(fr, fi, zf))
    sc = torch.complex(sr, si)
    recs.append(kernel_record(
        path, "pdft_last", FFT_SRC, "spfft_tpu/ops/dft_kernel.py:165",
        max(err_b, err_f),
        lambda: dft_kernel.pdft_last(sr, si, zb),
        lambda: dft.pdft_last(sr, si, zb),
        lambda: torch.fft.ifft(sc, norm="forward"),
        4 * rows * dz * e + table_bytes(zb, dft_kernel.stage_form(zb)),
        fft_flops(rows, dz), FLOP_PER_CMAC * rows * dz * dz,
        dft_kernel.stage_form(zb),
        lambda: dft_kernel.pdft_last(sr, si, matrix_pair(zb))))

    vi = plan._value_indices
    got = gather_kernel.compress(*fy, vi, pair)
    err = compare_exact(f"{path} gather compress", (got,),
                        (gather_kernel.compress_plain(*fy, vi, pair),))
    fc = torch.complex(*fy)
    vi64 = vi.long()
    recs.append(gather_record(
        path, "gather_cmp", err,
        lambda: gather_kernel.compress(*fy, vi, pair),
        lambda: gather_kernel.compress_plain(*fy, vi, pair),
        lambda: fc.view(-1)[vi64], nv * 4 + 2 * nv * 2 * e))
    print_records(recs)
    return recs


def gather_record(path, name, err, kernel, plain, library, nbytes):
    """A gather record (:func:`kernel_record`: no arithmetic, no form)."""
    return kernel_record(path, name, GATHER_SRC, GATHER_REPLACES, err,
                         kernel, plain, library, nbytes, 0.0, 0.0)


def batched_gather_phase(path, plan, values, device, batch=BATCH):
    """The gather both ways with ``batch`` bands at the path's shapes, as
    the two-kernel route's batched pair runs it (one launch a direction,
    the index read once for every band): exact against its plain version,
    and each band equal to a single launch on it."""
    from spfft_tpu_torch.ops import gather_kernel as gk
    p = plan.index_plan
    dz, nv, s = p.dim_z, p.num_values, p.num_sticks
    pair = plan.pair_values_io
    vb = band_values(plan, values, batch)
    if plan._conj is not None:
        vb = vb * plan._conj
    ss, vi = plan._slot_src, plan._value_indices
    rows = ss.numel() // dz
    got = gk.decompress(vb, ss, dz, pair)
    err_d = compare_exact(f"{path} gather decompress B={batch}", got,
                          gk.decompress_plain(vb, ss, dz, pair))
    fr, fi = got[0][:, :s].contiguous(), got[1][:, :s].contiguous()
    out = gk.compress(fr, fi, vi, pair)
    err_c = compare_exact(f"{path} gather compress B={batch}", (out,),
                          (gk.compress_plain(fr, fi, vi, pair),))
    for b in range(batch):
        compare_exact(f"{path} gather decompress band {b} of {batch}",
                      gk.decompress(vb[b], ss, dz, pair),
                      (got[0][b], got[1][b]))
        compare_exact(f"{path} gather compress band {b} of {batch}",
                      (gk.compress(fr[b], fi[b], vi, pair),), (out[b],))
    vrows = (vb.transpose(1, 2) if pair else vb).contiguous()
    vpad = torch.cat([torch.view_as_complex(vrows), torch.zeros(
        (batch, 1), dtype=complex_of(vb), device=device)], dim=1)
    slot64, vi64 = ss.long(), vi.long()
    fc = torch.complex(fr, fi).view(batch, -1)
    e = vb.element_size()
    recs = [gather_record(
        path, "gather_dec_batched", err_d,
        lambda: gk.decompress(vb, ss, dz, pair),
        lambda: gk.decompress_plain(vb, ss, dz, pair),
        lambda: torch.index_select(vpad, 1, slot64),
        batch * (nv * 2 * e + rows * dz * 2 * e) + rows * dz * 4),
        gather_record(
        path, "gather_cmp_batched", err_c,
        lambda: gk.compress(fr, fi, vi, pair),
        lambda: gk.compress_plain(fr, fi, vi, pair),
        lambda: torch.index_select(fc, 1, vi64),
        nv * 4 + batch * 2 * nv * 2 * e)]
    print_records(recs)
    for r in recs:
        print(f"kernel {r['path']} {r['name']}: {r['ms'] / batch:.4f} ms "
              f"per band (B={batch}, one launch)", flush=True)
    return recs


def route_phase(sp, path, fused, split, values):
    """The two-kernel route (``split``) against the fused route on the
    same values, backward and forward(FULL): bit-identical, since both
    routes run the same FFT on the same sticks (fft_tile.cuh)."""
    full = sp.Scaling.FULL
    a, b = fused.backward(values), split.backward(values)
    err_b = compare(f"{path} two-kernel vs fused backward", (b,), (a,))
    fa, fb = fused.forward(a, full), split.forward(a, full)
    err_f = compare(f"{path} two-kernel vs fused forward", (fb,), (fa,))
    same_b, same_f = torch.equal(a, b), torch.equal(fa, fb)
    print(f"{path} two-kernel vs fused route: backward max_abs_err="
          f"{err_b[0]:.3e} (bit-identical: {same_b}), forward "
          f"max_abs_err={err_f[0]:.3e} (bit-identical: {same_f})",
          flush=True)
    if not (same_b and same_f):
        fail(f"{path}: the two-kernel and fused routes differ")


def batched_kernel_phase(path, plan, values, device, batch=BATCH):
    """The batched grids of both fused z kernels at the path's shapes
    with ``batch`` bands: against their plain versions, and each band
    bit for bit against a single launch on that band."""
    from spfft_tpu_torch.ops import fused_kernel
    p = plan.index_plan
    dz, nv, s = p.dim_z, p.num_values, p.num_sticks
    pair = plan.pair_values_io
    vb = band_values(plan, values, batch)
    if plan._conj is not None:
        vb = vb * plan._conj
    ss, mz, zs = plan._slot_src, plan._mats["z_b"], plan._zero_stick
    rows = ss.numel() // dz
    recs = []

    got = fused_kernel.decompress_zdft(vb, ss, mz, dz, pair, zs)
    err = compare(f"{path} decompress_zdft B={batch}", got,
                  fused_kernel.decompress_zdft_plain(vb, ss, mz, dz, pair,
                                                     zs))
    for b in range(batch):
        one = fused_kernel.decompress_zdft(vb[b], ss, mz, dz, pair, zs)
        if not (torch.equal(one[0], got[0][b])
                and torch.equal(one[1], got[1][b])):
            fail(f"{path} decompress_zdft: band {b} of the batched launch "
                 f"differs from its single launch")
    vrows = (vb.transpose(1, 2) if pair else vb).contiguous()
    vpad = torch.cat([torch.view_as_complex(vrows), torch.zeros(
        (batch, 1), dtype=complex_of(vb), device=device)], dim=1)
    slot64 = ss.long()
    form = fused_kernel.z_form(mz, dz)
    e = vb.element_size()
    recs.append(kernel_record(
        path, "decompress_zdft_batched", Z_SRC[form], DEC_REPLACES, err,
        lambda: fused_kernel.decompress_zdft(vb, ss, mz, dz, pair, zs),
        lambda: fused_kernel.decompress_zdft_plain(
            vb, ss, mz, dz, pair, zs),
        lambda: torch.fft.ifft(vpad[:, slot64].view(
            batch, rows, dz), norm="forward"),
        batch * (nv * 2 * e + 2 * rows * dz * e) + rows * dz * 4
        + table_bytes(mz, form),
        batch * fft_flops(rows, dz), batch * FLOP_PER_CMAC * rows * dz * dz,
        form, lambda: fused_kernel.decompress_zdft(
            vb, ss, matrix_pair(mz), dz, pair, zs)))

    fr, fi = got[0][:, :s].contiguous(), got[1][:, :s].contiguous()
    mf, csr = plan._mats["z_fs"], plan._csr
    out = fused_kernel.zdft_compress(fr, fi, mf, csr, pair)
    err = compare(f"{path} zdft_compress B={batch}", (out,),
                  (fused_kernel.zdft_compress_plain(fr, fi, mf, csr, pair),))
    for b in range(batch):
        one = fused_kernel.zdft_compress(fr[b], fi[b], mf, csr, pair)
        if not torch.equal(one, out[b]):
            fail(f"{path} zdft_compress: band {b} of the batched launch "
                 f"differs from its single launch")
    fc = torch.complex(fr, fi)
    vi64 = torch.as_tensor(p.value_indices.astype(np.int64), device=device)
    gs = 1.0 / plan.global_size
    form = fused_kernel.z_form(mf, dz)
    recs.append(kernel_record(
        path, "zdft_compress_batched", Z_SRC[form], CMP_REPLACES, err,
        lambda: fused_kernel.zdft_compress(fr, fi, mf, csr, pair),
        lambda: fused_kernel.zdft_compress_plain(fr, fi, mf, csr, pair),
        lambda: torch.fft.fft(fc).view(batch, -1)[:, vi64] * gs,
        batch * (2 * s * dz * e + nv * 2 * e) + (s + 1 + 2 * nv) * 4
        + table_bytes(mf, form),
        batch * fft_flops(s, dz), batch * FLOP_PER_CMAC * s * dz * dz,
        form, lambda: fused_kernel.zdft_compress(
            fr, fi, matrix_pair(mf), csr, pair)))
    print_records(recs)
    for r in recs:
        print(f"kernel {r['path']} {r['name']}: {r['ms'] / batch:.4f} ms "
              f"per band (B={batch}, one launch)", flush=True)
    return recs


def batched_pair_phase(sp, path, plan, values, device, counters, want,
                       batch=BATCH):
    """``backward_batched`` + ``forward_batched(FULL)`` on ``batch`` bands,
    counted (``want``: one launch of each z kernel and the xy launches of
    one single pair), every band equal to the single pair on its band,
    timed against one single pair."""
    vb = band_values(plan, values, batch)
    reset_launches(counters)
    space_b = plan.backward_batched(vb)
    out_b = plan.forward_batched(space_b, sp.Scaling.FULL)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches(f"{path} batched B={batch}", counters, want)
    for b in range(batch):
        one = plan.backward(vb[b])
        if not torch.equal(space_b[b], one):
            fail(f"{path} batched backward: band {b} differs from the "
                 f"single backward")
        if not torch.equal(out_b[b], plan.forward(one, sp.Scaling.FULL)):
            fail(f"{path} batched forward: band {b} differs from the "
                 f"single forward")
    del space_b, out_b
    ms_b = timed_ms(lambda: plan.forward_batched(plan.backward_batched(vb),
                                                 sp.Scaling.FULL), device)
    ms_1 = timed_ms(lambda: plan.forward(plan.backward(vb[0]),
                                         sp.Scaling.FULL), device)
    print(f"{path} batched pair B={batch}: {ms_b:.4f} ms, {ms_b / batch:.4f} "
          f"ms per band; single pair {ms_1:.4f} ms (same run); every band "
          f"equal to its single pair", flush=True)
    return launches


def pointwise_phase(sp, path, plan, values, device):
    """``apply_pointwise`` with a potential (``fn_args``) and
    ``iterate_pointwise(steps=3)`` against the same round trips run one
    public call at a time; the identity ``apply_pointwise`` against one
    pair."""
    p = plan.index_plan
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    pot = torch.rand((p.dim_z, p.dim_y, p.dim_x), generator=gen,
                     device=device)
    c2c = plan.transform_type is sp.TransformType.C2C

    def fn(space, w):
        return space * (w[..., None] if c2c else w)

    full = sp.Scaling.FULL
    want = plan.forward(fn(plan.backward(values), pot), full)
    err1 = compare(f"{path} apply_pointwise(potential)",
                   (plan.apply_pointwise(values, fn, pot, scaling=full),),
                   (want,))
    want = values
    for _ in range(3):
        want = plan.forward(fn(plan.backward(want), pot), full)
    err3 = compare(f"{path} iterate_pointwise(steps=3)",
                   (plan.iterate_pointwise(values, fn, pot, steps=3),),
                   (want,))
    err0 = compare(f"{path} apply_pointwise(identity)",
                   (plan.apply_pointwise(values, scaling=full),),
                   (plan.forward(plan.backward(values), full),))
    ms = timed_ms(lambda: plan.apply_pointwise(values, fn, pot,
                                               scaling=full), device)
    print(f"{path} pointwise: apply_pointwise(potential) max_abs_err="
          f"{err1[0]:.3e}, iterate_pointwise(steps=3) max_abs_err="
          f"{err3[0]:.3e}, identity max_abs_err={err0[0]:.3e} against "
          f"the same calls one at a time; apply_pointwise(potential) "
          f"{ms:.4f} ms", flush=True)


def sweep_phase(sp, path, plan, values, device, out):
    """Per-band ms of a batched pair against B single pairs, B in
    ``SWEEP_BATCHES``, each timed twice in turns (looped, batched,
    batched, looped); appends one row per B to ``out``."""
    full = sp.Scaling.FULL
    for batch in SWEEP_BATCHES:
        vb = band_values(plan, values, batch)

        def looped():
            for b in range(batch):
                plan.forward(plan.backward(vb[b]), full)

        def batched():
            plan.forward_batched(plan.backward_batched(vb), full)

        t = [timed_ms(f, device) for f in (looped, batched, batched, looped)]
        row = {"path": path, "n": plan.dim_x, "B": batch,
               "batch_grid": batch * plan.global_size,
               "looped_ms_per_band": (t[0] + t[3]) / 2 / batch,
               "batched_ms_per_band": (t[1] + t[2]) / 2 / batch}
        out.append(row)
        print(f"sweep {path} n={plan.dim_x} B={batch}: looped "
              f"{row['looped_ms_per_band']:.4f} ms per band, batched "
              f"{row['batched_ms_per_band']:.4f} ms per band", flush=True)
        del vb


def new_odd_shapes_phase(device, dtype=torch.float32):
    """The gather, ``pdft_last`` and the batched z kernels at shapes the
    paths do not reach: B = 3, both value layouts, odd dim_z, an empty
    stick, duplicate values, the sentinel, invalid and out-of-range
    indices, rectangular matrices, the R2C zero stick."""
    from spfft_tpu_torch.indexing import inverse_slot_map
    from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel, \
        gather_kernel
    rng = np.random.default_rng(SEED + 4)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                               device=device)

    def mats(m):
        return dft.device_mats(m, device, dtype)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    cases = 0
    for s, dz in ((37, 12), (21, 13), (9, 384)):
        occ = rng.random((s, dz)) < 0.5
        occ[s // 2] = False  # an empty stick
        slots = np.flatnonzero(occ)
        slots = np.concatenate([slots, slots[:5]])  # duplicate triplets
        rng.shuffle(slots)
        nv = len(slots)
        ss = i32(np.concatenate([inverse_slot_map(slots, s * dz, nv),
                                 np.full(dz, nv, np.int32)]))
        vi = i32(slots)
        for pair in (False, True):
            for lead in ((), (3,)):
                vals = rand(*lead, 2, nv) if pair else rand(*lead, nv, 2)
                compare_exact(f"gather decompress s={s} dz={dz} B={lead} "
                              f"pair={pair}",
                              gather_kernel.decompress(vals, ss, dz, pair),
                              gather_kernel.decompress_plain(vals, ss, dz,
                                                             pair))
                sr, si = rand(*lead, s, dz), rand(*lead, s, dz)
                compare_exact(f"gather compress s={s} dz={dz} B={lead} "
                              f"pair={pair}",
                              (gather_kernel.compress(sr, si, vi, pair),),
                              (gather_kernel.compress_plain(sr, si, vi,
                                                            pair),))
                cases += 2
    # the general form: a valid mask and indices outside the source
    src = (rand(3, 1000), rand(3, 1000))
    idx = i32(rng.integers(-5, 1010, 4000))
    valid = torch.as_tensor(rng.random(4000) < 0.7, device=device)
    got = tuple(torch.empty((3, 4000), dtype=dtype, device=device)
                for _ in range(2))
    want = tuple(torch.empty((3, 4000), dtype=dtype, device=device)
                 for _ in range(2))
    gather_kernel.gather(src, idx, got, valid)
    gather_kernel.gather_plain(src, idx, want, valid)
    compare_exact("gather with a valid mask and out-of-range indices", got,
                  want)
    cases += 1 + gather_odd_cases(device, rng, dtype)

    for lead, k, n_out, m in (
            ((37,), 12, 12, dft.c2c_mats(12, dft.BACKWARD)),
            ((21,), 13, 13, dft.c2c_mats(13, dft.FORWARD, 0.25)),
            ((9,), 384, 384, dft.c2c_mats(384, dft.BACKWARD)),
            ((5,), 300, 7, dft.sub_cols_mats(300, dft.FORWARD,
                                              tuple(range(7)))),
            ((3,), 7, 300, dft.sub_rows_mats(300, dft.BACKWARD,
                                              tuple(range(7)))),
            ((3, 5), 16, 16, dft.c2c_mats(16, dft.FORWARD)),
            ((2,), 512, 512, dft.c2c_mats(512, dft.BACKWARD))):
        xr, xi = rand(*lead, k), rand(*lead, k)
        mm = mats(m)
        compare(f"pdft_last {lead + (k,)} -> {n_out}",
                dft_kernel.pdft_last(xr, xi, mm), dft.pdft_last(xr, xi, mm))
        cases += 1

    for s, dz in ((37, 12), (21, 13), (9, 384)):
        zb = mats(dft.c2c_mats(dz, dft.BACKWARD))
        zf = mats(dft.c2c_mats(dz, dft.FORWARD, 0.5))
        for kind, zid in (("half", 0), ("empty", s // 2), ("absent", -1)):
            occ = rng.random((s, dz)) < 0.5
            if zid >= 0:
                occ[zid] = np.zeros(dz, bool) if kind == "empty" \
                    else np.arange(dz) <= dz // 2
            slots = np.flatnonzero(occ)
            slots = np.concatenate([slots, slots[:3]])
            rng.shuffle(slots)
            nv = len(slots)
            ss = i32(np.concatenate([inverse_slot_map(slots, s * dz, nv),
                                     np.full(dz, nv, np.int32)]))
            csr = tuple(i32(t) for t in fused_kernel.compress_csr(slots, s,
                                                                  dz))
            for pair in (False, True):
                vals = rand(3, 2, nv) if pair else rand(3, nv, 2)
                got = fused_kernel.decompress_zdft(vals, ss, zb, dz, pair,
                                                   zid)
                compare(f"decompress_zdft B=3 s={s} dz={dz} zero stick "
                        f"{kind} pair={pair}", got,
                        fused_kernel.decompress_zdft_plain(vals, ss, zb, dz,
                                                           pair, zid))
                sr, si = rand(3, s, dz), rand(3, s, dz)
                out = fused_kernel.zdft_compress(sr, si, zf, csr, pair)
                compare(f"zdft_compress B=3 s={s} dz={dz} pair={pair}",
                        (out,), (fused_kernel.zdft_compress_plain(
                            sr, si, zf, csr, pair),))
                for b in range(3):
                    one = fused_kernel.decompress_zdft(vals[b], ss, zb, dz,
                                                       pair, zid)
                    if not (torch.equal(one[0], got[0][b])
                            and torch.equal(one[1], got[1][b])
                            and torch.equal(fused_kernel.zdft_compress(
                                sr[b], si[b], zf, csr, pair), out[b])):
                        fail(f"batched z kernels s={s} dz={dz} {kind} "
                             f"pair={pair}: band {b} differs from its "
                             f"single launch")
                cases += 2
    print(f"odd shapes of the new kernels: {cases} kernel-vs-plain cases "
          f"(the gather exact, the rest within {kernel_tol(dtype)[1]} "
          f"({dtype}); batched bands equal to single launches)", flush=True)


def gather_odd_cases(device, rng, real=torch.float32) -> int:
    """The gather's scalar paths and shard axis against its plain version,
    exact: num_out not a multiple of 4 (a ragged last group), every
    operand one float (or index, or flag) off its alignment, interleaved
    and planar values both ways, B in {1, 3, 5}, and 5 shards with uneven
    tables padded past the source's extent, an empty shard, a mask and
    out-of-range indices. Returns the number of cases."""
    from spfft_tpu_torch.ops import gather_kernel as gk

    def buf(shape, off, dtype=real, fill=None):
        k = int(np.prod(shape))
        if fill is None:
            t = torch.as_tensor(rng.standard_normal(k + 4), dtype=dtype,
                                device=device)
        else:
            t = torch.as_tensor(fill(k + 4), device=device).to(dtype)
        return t[off:off + k].view(shape)

    def planes(shape, off, interleaved):
        if interleaved:
            t = buf(shape + (2,), off)
            return t[..., 0], t[..., 1]
        t = buf(shape[:-1] + (2, shape[-1]), off)
        return t[..., 0, :], t[..., 1, :]

    cases = 0
    for num_out in (1, 3, 5, 6, 7, 9, 13, 4001):
        for off in (0, 1):
            for batch in (1, 3, 5):
                for il_src, il_out in ((True, False), (False, True)):
                    n = 700
                    src = planes((1, batch, n), off, il_src)
                    idx = buf((1, num_out), off, torch.int32,
                              lambda k: rng.integers(-3, n + 3, k))
                    valid = buf((1, num_out), off, torch.bool,
                                lambda k: rng.random(k) < 0.8)
                    want = planes((1, batch, num_out), off, il_out)
                    gk.gather_plain(src, idx, want, valid)
                    got = planes((1, batch, num_out), off, il_out)
                    gk.gather(src, idx, got, valid)
                    compare_exact(
                        f"gather num_out={num_out} off={off} B={batch} "
                        f"interleaved src/out={il_src}/{il_out}", got, want)
                    cases += 1
    # 5 shards, uneven and one empty, stacked as the distributed plan
    # stacks them: sources padded with random rows, each shard's indices
    # in its own rows or out of range, its padding indices at n or past
    extents = (900, 0, 333, 517, 61)
    shards, n, num_out, batch = len(extents), max(extents), 1201, 3
    src = planes((shards, batch, n), 0, True)
    idx = np.stack([rng.integers(-2, e + 2, num_out) for e in extents])
    idx = np.where(idx >= np.array(extents)[:, None],
                   idx - np.array(extents)[:, None] + n, idx)
    idx = torch.as_tensor(idx.astype(np.int32), device=device)
    valid = torch.as_tensor(rng.random((shards, num_out)) < 0.9,
                            device=device)
    for il_out in (True, False):
        for mask in (None, valid):
            want = planes((shards, batch, num_out), 0, il_out)
            gk.gather_plain(src, idx, want, mask)
            got = planes((shards, batch, num_out), 0, il_out)
            gk.gather(src, idx, got, mask)
            compare_exact(f"gather {shards} shards {extents} interleaved "
                          f"out={il_out} mask={mask is not None}", got, want)
            cases += 1
            if want[0][1].any() or want[1][1].any():
                fail("gather: the empty shard's slots are not 0")
    return cases


def set_launches(recs, launches):
    for r in recs:
        r["launches"] = launches[COUNTER_OF.get(r["name"], r["name"])]


# -- the distributed plan: S shards held on the card -------------------------

#: shards of the distributed phases (the layout of a 4-GPU run, held on one
#: card; round-robin sticks, even slabs of n / 4 planes)
DIST_SHARDS = 4
_S = DIST_SHARDS
#: launches of one distributed backward + forward(FULL) pair: the z
#: kernels once per shard (FFT form), the xy stage once over all shards'
#: planes
ZFFT_S = (_S, _S, {"fft": _S})
DIST_C2C_LAUNCHES = {"decompress_zdft": ZFFT_S, "zdft_compress": ZFFT_S,
                     "pdft2_swapped": CLUSTER2, "pdft2": (0, 0),
                     "prdft2": (0, 0), "pdft2_cr": (0, 0), "gather": (0, 0),
                     "pdft_last": (0, 0),
                     **NO_REAL_LAST}
DIST_R2C_LAUNCHES = {"decompress_zdft": ZFFT_S, "zdft_compress": ZFFT_S,
                     "pdft_last": FFT2, "prdft_last": RFFT1,
                     "pirdft_last": RFFT1, "pdft2_swapped": (0, 0),
                     "pdft2": (0, 0), "prdft2": (0, 0), "pdft2_cr": (0, 0),
                     "gather": (0, 0)}
#: the two-kernel route: the gather once a direction over all shards
DIST_C2C_2K_LAUNCHES = {"gather": (2, 2), "pdft_last": FFT2,
                        "pdft2_swapped": CLUSTER2, "decompress_zdft": (0, 0),
                        "zdft_compress": (0, 0), "pdft2": (0, 0),
                        "prdft2": (0, 0), "pdft2_cr": (0, 0),
                        **NO_REAL_LAST}
#: and its R2C pair: ``pdft_last`` at the z stage and at the y stage
DIST_R2C_2K_LAUNCHES = {"gather": (2, 2), "pdft_last": (4, 4, {"fft": 4}),
                        "prdft_last": RFFT1, "pirdft_last": RFFT1,
                        "decompress_zdft": (0, 0), "zdft_compress": (0, 0),
                        "pdft2_swapped": (0, 0), "pdft2": (0, 0),
                        "prdft2": (0, 0), "pdft2_cr": (0, 0)}


def dist_plan(sp, n, trip, values, device, r2c=False):
    """The distributed plan of the path's set ``trip`` over DIST_SHARDS
    shards and the path's ``values`` (N, 2) stacked as (S, max_values,
    2): each shard's values read off a dense cube of the values, so that
    they are the values the local plan is given."""
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition)
    t0 = time.perf_counter()
    parts = round_robin_stick_partition(trip, (n, n, n), _S)
    kind = sp.TransformType.R2C if r2c else sp.TransformType.C2C
    precision = "double" if values.dtype == torch.float64 else "single"
    plan = sp.make_distributed_plan(kind, n, n, n, parts,
                                    even_plane_split(n, _S),
                                    mesh=sp.make_mesh(_S, device),
                                    precision=precision)

    def storage(t):
        return torch.as_tensor(np.where(t < 0, t + n, t).astype(np.int64),
                               device=device)

    cube = torch.zeros((n, n, n), dtype=complex_of(values), device=device)
    st = storage(trip)
    cube[st[:, 2], st[:, 1], st[:, 0]] = torch.view_as_complex(
        values.contiguous())
    dp = plan.dist_plan
    stacked = torch.zeros((_S, dp.max_values, 2), dtype=values.dtype,
                          device=device)
    for r, part in enumerate(parts):
        sr = storage(part)
        stacked[r, :len(part)] = torch.view_as_real(
            cube[sr[:, 2], sr[:, 1], sr[:, 0]])
    del cube
    print(f"plan: distributed {'R2C' if r2c else 'C2C'} {n}^3, {precision}, "
          f"{_S} shards "
          f"on one card: sticks per shard "
          f"{[p.num_sticks for p in dp.shard_plans]}, planes "
          f"{list(dp.num_planes)}, max_values {dp.max_values}, split_x="
          f"{plan.split_x}, built with its values in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan, stacked


def dist_kernel_phase(plan, stacked, device, path="dist_c2c"):
    """``pdft2_swapped`` at the distributed C2C path's shapes, both
    directions, against its plain version (``ops.dft.cdft2_xy``)."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    dp = plan.dist_plan
    gr, gi = plan._exchange(plan._z_backward(stacked[:, None]))
    planes = (-1, dp.dim_y, plan._xf_eff)
    gr, gi = gr.view(planes), gi.view(planes)
    m = plan._mats
    xb, yb, xf, yf = m["x_b"], m["y_b"], m["x_f"], m["y_f"]
    got = dft_kernel.pdft2_swapped(gr, gi, xb, yb)
    err_b = compare(f"{path} pdft2_swapped backward", got,
                    dft.cdft2_xy(gr, gi, xb, yb))
    fgot = dft_kernel.pdft2_swapped(*got, xf, yf)
    err_f = compare(f"{path} pdft2_swapped forward", fgot,
                    dft.cdft2_xy(*got, xf, yf))
    two = compare(f"{path} pdft2_swapped backward, two-launch FFT form",
                  fft_two_launch((gr, gi), xb, yb, swap_out=True), got)
    gc = torch.complex(gr, gi)
    pp, a, b = gr.shape
    b_out, a_out = xb[0].shape[1], yb[0].shape[1]
    forms = dft_kernel.plane_forms(xb, yb, a)
    form = "+".join(forms)
    e = gr.element_size()
    rec = kernel_record(
        path, "pdft2_swapped", FFT_SRC,
        "spfft_tpu/ops/dft_kernel.py:277", max(err_b, err_f),
        lambda: dft_kernel.pdft2_swapped(gr, gi, xb, yb),
        lambda: dft.cdft2_xy(gr, gi, xb, yb),
        (lambda: torch.fft.ifft2(gc, norm="forward"))
        if (b_out, a_out) == (b, a) else None,
        2 * pp * a * b * e + 2 * pp * a_out * b_out * e
        + plane_table_bytes(xb, yb, forms),
        fft_flops(pp * a, b) + fft_flops(pp * b_out, a),
        FLOP_PER_CMAC * pp * (a * b * b_out + b_out * a * a_out), form,
        lambda: dft_kernel.pdft2_swapped(
            gr, gi, matrix_pair(xb), matrix_pair(yb)))
    print_records([rec])
    ms2 = timed_ms(lambda: fft_two_launch((gr, gi), xb, yb, True), device)
    print(f"{path} pdft2_swapped backward in the two-launch FFT form: "
          f"{ms2:.4f} ms (reference; the path takes form {form}), "
          f"max_abs_err against the {form} form {two[0]:.3e}", flush=True)
    return [rec]


def dist_odd_shapes_phase(device, dtype=torch.float32):
    """``pdft2_swapped`` at shapes the path does not reach (P in {1, 3},
    A != B, rectangular and windowed matrices, a ragged 129-row K, axes
    above 256) against its plain version."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    rng = np.random.default_rng(SEED + 5)
    wrapped = tuple(range(26, 30)) + tuple(range(20))
    cases = (((1, 20, 24), dft.sub_rows_mats(30, dft.BACKWARD, wrapped),
              dft.c2c_mats(20, dft.BACKWARD)),
             ((3, 12, 7), dft.sub_cols_mats(7, dft.FORWARD, (5, 6, 0)),
              dft.c2c_mats(12, dft.FORWARD)),
             ((3, 256, 129), dft.sub_rows_mats(256, dft.BACKWARD,
                                               tuple(range(129))),
              dft.c2c_mats(256, dft.BACKWARD)),
             ((1, 300, 5), dft.c2c_mats(5, dft.FORWARD),
              dft.c2c_mats(300, dft.FORWARD)),
             ((3, 9, 512), dft.c2c_mats(512, dft.BACKWARD),
              dft.sub_cols_mats(9, dft.FORWARD, (0, 1, 2, 3))))
    for (pp, a, b), m1, m2 in cases:
        xr, xi = (torch.as_tensor(rng.standard_normal((pp, a, b)),
                                  dtype=dtype, device=device)
                  for _ in range(2))
        m1 = dft.device_mats(m1, device, dtype)
        m2 = dft.device_mats(m2, device, dtype)
        compare(f"pdft2_swapped {(pp, a, b)}",
                dft_kernel.pdft2_swapped(xr, xi, m1, m2),
                dft.cdft2_xy(xr, xi, m1, m2))
    print(f"odd shapes of pdft2_swapped: {len(cases)} kernel-vs-plain cases "
          f"within {kernel_tol(dtype)[1]} ({dtype})", flush=True)


def dist_gather_dec(plan, v, f):
    """A two-kernel distributed plan's decompress gather as the plan runs
    it, one launch over every shard's stacked tables (``f``: the wrapper
    or its plain version): values ``(S, B, max_values, 2)`` -> planar
    sticks, each ``(B, S, max_sticks, dim_z)``."""
    dp = plan.dist_plan
    sr = torch.empty((v.shape[1], dp.num_shards, dp.max_sticks, dp.dim_z),
                     dtype=v.dtype, device=v.device)
    si = torch.empty_like(sr)
    f((v[..., 0], v[..., 1]), plan._t_slot_src,
      tuple(t.view(t.shape[0], t.shape[1], -1).transpose(0, 1)
            for t in (sr, si)))
    return sr, si


def dist_gather_cmp(plan, sticks, f):
    """The compress gather likewise: planar sticks ``(B, S, max_sticks,
    dim_z)`` -> values ``(S, B, max_values, 2)``, every value slot
    written."""
    dp = plan.dist_plan
    b = sticks[0].shape[0]
    out = torch.empty((dp.num_shards, b, dp.max_values, 2),
                      dtype=sticks[0].dtype, device=sticks[0].device)
    f(tuple(t.reshape(b, dp.num_shards, -1).transpose(0, 1)
            for t in sticks), plan._t_vi, (out[..., 0], out[..., 1]))
    return out


def check_padding(plan, out):
    """Fails unless each shard's padding value slots of ``out`` ``(S, B,
    max_values, 2)`` are 0; returns ``out``."""
    for r, p in enumerate(plan.dist_plan.shard_plans):
        if out[r, :, p.num_values:].any():
            fail(f"gather compress: shard {r}'s padding value slots are "
                 f"not 0")
    return out


def dist_z_kernel_phase(path, plan, stacked, device):
    """The per-shard z kernels of a distributed path at the path's
    shapes, each shard's launch against its plain version on the same
    inputs. ``fused=True``: ``decompress_zdft`` on shard r's values with
    its own ``slot_src`` row (sentinel ``max_values``, padding sticks up
    to ``max_sticks``) and its (0,0) stick, or -1 on the shards that do
    not own it; ``zdft_compress`` on the sticks the forward exchange
    gives shard r, with its CSR over ``max_sticks``; each record times the
    S launches of one direction. ``fused=False``: the gather both ways,
    one launch over every shard's stacked tables as the plan runs it,
    exact (a shard's padding value slots 0), and ``pdft_last`` over every
    shard's sticks. The inputs come from the plan's own stage methods."""
    from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel as fk, \
        gather_kernel as gk
    dp = plan.dist_plan
    S, ms, dz = dp.num_shards, dp.max_sticks, dp.dim_z
    zb, zfs = plan._mats["z_b"], plan._mats["z_fs"]
    v = stacked[:, None]
    if plan._t_conj is not None:
        v = v * plan._t_conj
    fsr, fsi = plan._exchange(plan._xy_forward(plan._xy_backward(
        plan._exchange(plan._z_backward(stacked[:, None])))), forward=True)
    nvs = [p.num_values for p in dp.shard_plans]
    zids = plan._zero_sticks
    slot64 = [plan._t_slot_src[r].long() for r in range(S)]
    vpad = [torch.cat([torch.view_as_complex(v[r, 0].contiguous()),
                       torch.zeros(1, dtype=complex_of(v), device=device)])
            for r in range(S)]
    e = v.element_size()
    vi64 = [torch.as_tensor(p.value_indices.astype(np.int64), device=device)
            for p in dp.shard_plans]
    gs = 1.0 / plan.global_size
    recs = []

    def each(fn):
        return lambda: [fn(r) for r in range(S)]

    if plan.fused_dist_active:
        def dec(r, f=fk.decompress_zdft):
            return f(v[r], plan._t_slot_src[r], zb, dz, False, zids[r])

        def cmp(r, f=fk.zdft_compress):
            return f(fsr[:, r], fsi[:, r], zfs, plan._t_csr[r])

        err = max(compare(f"{path} decompress_zdft shard {r} (zero stick "
                          f"{zids[r]})", dec(r),
                          dec(r, fk.decompress_zdft_plain))
                  for r in range(S))
        form = fk.z_form(zb, dz)
        recs.append(kernel_record(
            path, "decompress_zdft", Z_SRC[form], DEC_REPLACES, err,
            each(dec),
            each(lambda r: dec(r, fk.decompress_zdft_plain)),
            each(lambda r: torch.fft.ifft(
                vpad[r][slot64[r]].view(ms, dz), norm="forward")),
            sum(nv * 2 * e for nv in nvs) + S * (ms * dz * 4
                                                 + table_bytes(zb, form)
                                                 + 2 * ms * dz * e),
            fft_flops(S * ms, dz), FLOP_PER_CMAC * S * ms * dz * dz, form,
            each(lambda r: fk.decompress_zdft(
                v[r], plan._t_slot_src[r], matrix_pair(zb), dz, False,
                zids[r]))))
        err = max(compare(f"{path} zdft_compress shard {r}", (cmp(r),),
                          (cmp(r, lambda *a: fk.zdft_compress_plain(
                              *a, False)),))
                  for r in range(S))
        fc = torch.complex(fsr[0], fsi[0])
        form = fk.z_form(zfs, dz)
        recs.append(kernel_record(
            path, "zdft_compress", Z_SRC[form], CMP_REPLACES, err,
            each(cmp),
            each(lambda r: cmp(r, lambda *a: fk.zdft_compress_plain(
                *a, False))),
            each(lambda r: torch.fft.fft(fc[r]).view(-1)[vi64[r]]
                 * gs),
            sum(2 * ms * dz * e + (ms + 1 + 2 * nv) * 4
                + table_bytes(zfs, form) + nv * 2 * e for nv in nvs),
            fft_flops(S * ms, dz), FLOP_PER_CMAC * S * ms * dz * dz, form,
            each(lambda r: fk.zdft_compress(
                fsr[:, r], fsi[:, r], matrix_pair(zfs), plan._t_csr[r]))))
        print(f"{path}: decompress_zdft zero sticks per shard {zids}, "
              f"values per shard {nvs} (max_values {dp.max_values}), "
              f"sticks per shard "
              f"{[p.num_sticks for p in dp.shard_plans]} (max_sticks {ms})",
              flush=True)
        print_records(recs)
        return recs

    def gdec(f=gk.gather):
        return dist_gather_dec(plan, v, f)

    err = compare_exact(f"{path} gather decompress, {S} shards in one "
                        f"launch", gdec(), gdec(gk.gather_plain))
    # the library call: one index_select over every shard's values with a
    # zero row each (each shard's slot map offset to its rows)
    mv = dp.max_values
    vflat = torch.cat([torch.view_as_complex(v[:, 0].contiguous()),
                       torch.zeros((S, 1), dtype=complex_of(v),
                                   device=device)], 1).view(-1)
    dec_rows = (plan._t_slot_src.long() + torch.arange(
        S, device=device)[:, None] * (mv + 1)).view(-1)
    recs.append(gather_record(
        path, "gather_dec", err, gdec, lambda: gdec(gk.gather_plain),
        lambda: torch.index_select(vflat, 0, dec_rows),
        sum(nv * 2 * e for nv in nvs) + S * (ms * dz * 4 + ms * dz * 2 * e)))
    sr, si = gdec()
    err_b = compare(f"{path} pdft_last backward", dft_kernel.pdft_last(
        sr, si, zb), dft.pdft_last(sr, si, zb))
    fy = dft_kernel.pdft_last(fsr, fsi, zfs)
    err_f = compare(f"{path} pdft_last forward", fy,
                    dft.pdft_last(fsr, fsi, zfs))
    sc = torch.complex(sr, si)
    rows = S * ms
    recs.append(kernel_record(
        path, "pdft_last", FFT_SRC, "spfft_tpu/ops/dft_kernel.py:165",
        max(err_b, err_f),
        lambda: dft_kernel.pdft_last(sr, si, zb),
        lambda: dft.pdft_last(sr, si, zb),
        lambda: torch.fft.ifft(sc, norm="forward"),
        4 * rows * dz * e + table_bytes(zb, dft_kernel.stage_form(zb)),
        fft_flops(rows, dz), FLOP_PER_CMAC * rows * dz * dz,
        dft_kernel.stage_form(zb),
        lambda: dft_kernel.pdft_last(sr, si, matrix_pair(zb))))

    def gcmp(f=gk.gather):
        return dist_gather_cmp(plan, fy, f)

    err = compare_exact(f"{path} gather compress, {S} shards in one launch",
                        (check_padding(plan, gcmp()),),
                        (gcmp(gk.gather_plain),))
    # the library call: one indexed read of every shard's slots and a zero
    fc = torch.cat([torch.complex(*fy)[0].reshape(-1),
                    torch.zeros(1, dtype=complex_of(v), device=device)])
    vi = plan._t_vi.long()
    cmp_rows = torch.where(vi < ms * dz, vi + torch.arange(
        S, device=device)[:, None] * (ms * dz), S * ms * dz).view(-1)
    recs.append(gather_record(
        path, "gather_cmp", err, gcmp, lambda: gcmp(gk.gather_plain),
        lambda: fc[cmp_rows], sum(nv * 4 + 2 * nv * 2 * e for nv in nvs)))
    print(f"{path}: values per shard {nvs} (max_values {mv}), sticks per "
          f"shard {[p.num_sticks for p in dp.shard_plans]} (max_sticks "
          f"{ms}); each gather record is one launch over all {S} shards",
          flush=True)
    print_records(recs)
    return recs


def dist_odd_shards_phase(sp, device, precision="single"):
    """Distributed plans the 256^3 paths do not reach, on the card against
    the same plans on the CPU (where every wrapper runs its plain
    version): 5 shards with uneven sticks and slabs, one shard with no
    values, no sticks and no planes, another with sticks but no planes,
    the R2C (0,0) stick owned by the fourth shard; dim_z 13 (the fused z
    kernels in their matrix form) and 12 (their FFT form, checked by the
    launch counts); C2C and R2C, fused and two-kernel; the backward and
    forward(FULL) within ``KERNEL_TOL``, and a second backward identical
    to the first."""
    from spfft_tpu_torch.ops import fused_kernel as fk
    rng = np.random.default_rng(SEED + 7)
    cpu = torch.device("cpu")
    weights = (3, 0, 1, 2, 1)  # stick share per shard
    cases = 0
    for nz in (13, 12):
        nx, ny, nz = dims = (12, 10, nz)
        planes = [5, 0, nz - 7, 0, 2]
        z_form = "matrix" if nz == 13 else "fft"
        for kind in (sp.TransformType.C2C, sp.TransformType.R2C):
            r2c = kind is sp.TransformType.R2C
            xs = nx // 2 + 1 if r2c else nx
            sticks = [(x, y) for x in range(xs) for y in range(ny)
                      if (x, y) == (0, 0) or rng.random() < 0.6]
            owner = rng.choice(len(weights), len(sticks),
                               p=np.array(weights) / sum(weights))
            owner[sticks.index((0, 0))] = 3
            parts = [np.array([(x, y, z) for (x, y), o in zip(sticks, owner)
                               if o == r for z in range(nz)
                               if rng.random() < 0.7], np.int64).reshape(-1, 3)
                     for r in range(len(weights))]
            vals = [(rng.standard_normal(len(t)) + 1j * rng.standard_normal(
                len(t))).astype(np.complex64 if precision == "single"
                                else np.complex128) for t in parts]
            for fused in (True, False):
                got, want = (sp.make_distributed_plan(
                    kind, *dims, parts, planes, device=d, fused=fused,
                    precision=precision) for d in (device, cpu))
                name = (f"dist odd shards {kind.name} {precision} "
                        f"dim_z={nz} fused={fused}")
                for w in (fk.decompress_zdft, fk.zdft_compress):
                    w.form_launches = dict.fromkeys(w.form_launches, 0)
                b = got.backward(vals)
                compare(f"{name} backward", (b.cpu(),),
                        (want.backward(vals),))
                compare(f"{name} forward(FULL)",
                        (got.forward(b, sp.Scaling.FULL).cpu(),),
                        (want.forward(b.cpu(), sp.Scaling.FULL),))
                for w in (fk.decompress_zdft, fk.zdft_compress):
                    forms = {f for f, k in w.form_launches.items() if k}
                    if device.type == "cuda" and forms != (
                            {z_form} if fused else set()):
                        fail(f"{name}: {w.__name__} launched the forms "
                             f"{w.form_launches}, expected {z_form}")
                if not torch.equal(got.backward(vals), b):
                    fail(f"{name}: a second backward differs from the "
                         f"first")
                if not fused:  # its gathers on its stacked tables, exact
                    from spfft_tpu_torch.ops import gather_kernel as gk
                    v = got.shard_values(vals)[:, None]
                    dp = got.dist_plan
                    sticks = tuple(torch.as_tensor(rng.standard_normal(
                        (1, dp.num_shards, dp.max_sticks, dp.dim_z)),
                        dtype=got.real_dtype, device=device)
                        for _ in range(2))
                    compare_exact(f"{name} gather decompress",
                                  dist_gather_dec(got, v, gk.gather),
                                  dist_gather_dec(got, v, gk.gather_plain))
                    compare_exact(f"{name} gather compress",
                                  (check_padding(got, dist_gather_cmp(
                                      got, sticks, gk.gather)),),
                                  (dist_gather_cmp(got, sticks,
                                                   gk.gather_plain),))
                cases += 1
    tol = kernel_tol(torch.float64 if precision == "double"
                     else torch.float32)[1]
    print(f"dist odd shards: {cases} plans (values per shard "
          f"{[len(t) for t in parts]}, planes {planes}; the fused z kernels "
          f"in the matrix form at dim_z 13, the FFT form at 12) on the card "
          f"within {tol} of the CPU's plain versions", flush=True)


def dist_y_kernel_record(path, plan, stacked, device):
    """``pdft_last`` at the distributed R2C y stage's shape (every
    shard's planes, x-major: ``S * max_planes * xf`` rows of ``dim_y``,
    the layout ``stages._cdft_mid`` hands it), with the backward and the
    forward y matrices, against its plain version."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    dp = plan.dist_plan
    y = dp.dim_y
    gr, gi = plan._exchange(plan._z_backward(stacked[:, None]))
    xr, xi = (t.view(-1, y, plan._xf_eff).transpose(-1, -2).contiguous()
              for t in (gr, gi))
    yb, yf = plan._mats["y_b"], plan._mats["y_f"]
    err = max(compare(f"{path} pdft_last y {tuple(xr.shape)} {d}",
                      dft_kernel.pdft_last(xr, xi, m),
                      dft.pdft_last(xr, xi, m))
              for d, m in (("backward", yb), ("forward", yf)))
    xc = torch.complex(xr, xi)
    rows = xr.shape[0] * xr.shape[1]
    e = xr.element_size()
    rec = kernel_record(
        path, "pdft_last", FFT_SRC, "spfft_tpu/ops/dft_kernel.py:165", err,
        lambda: dft_kernel.pdft_last(xr, xi, yb),
        lambda: dft.pdft_last(xr, xi, yb),
        lambda: torch.fft.ifft(xc, norm="forward"),
        4 * rows * y * e + table_bytes(yb, dft_kernel.stage_form(yb)),
        fft_flops(rows, y), FLOP_PER_CMAC * rows * y * y,
        dft_kernel.stage_form(yb),
        lambda: dft_kernel.pdft_last(xr, xi, matrix_pair(yb)))
    print_records([rec])
    return [rec]


def dist_x_kernel_records(path, plan, stacked, device):
    """The distributed R2C x stage at the path's shapes (every shard's
    planes, rows of ``dim_x`` reals and of the half spectrum's ``w``
    bins): ``pirdft_last`` on the y stage's output and ``prdft_last`` on
    its result, each against its plain version, the FP32 ``torch.matmul``
    products that ran this stage before the real FFT form (timed beside
    it, once: ``plain_ms``), with ``library_ms`` one ``torch.fft.irfft``
    / ``rfft`` call."""
    from spfft_tpu_torch.ops import dft, dft_kernel, stages
    dp = plan.dist_plan
    gr, gi = plan._exchange(plan._z_backward(stacked[:, None]))
    planes = (-1, dp.dim_y, plan._xf_eff)
    yr, yi = stages._cdft_mid(gr.view(planes), gi.view(planes),
                              plan._mats["y_b"])
    xb, xf = plan._mats["x_b"], plan._mats["x_f"]
    nx, w = dp.dim_x, xb[0].shape[0]
    rows = yr.numel() // w
    full = w == dp.dim_x_freq
    space = dft_kernel.pirdft_last(yr, yi, xb)
    err_b = compare(f"{path} pirdft_last {tuple(yr.shape)}", (space,),
                    (dft.pirdft_last(yr, yi, xb),))
    err_f = compare(f"{path} prdft_last {tuple(space.shape)}",
                    dft_kernel.prdft_last(space, xf),
                    dft.prdft_last(space, xf))
    yc = torch.complex(yr, yi)
    e = yr.element_size()
    recs = []
    for name, err, run, plain, lib, m in (
            ("pirdft_last", err_b,
             lambda m: dft_kernel.pirdft_last(yr, yi, m),
             lambda: dft.pirdft_last(yr, yi, xb),
             lambda: torch.fft.irfft(yc, n=nx, norm="forward"), xb),
            ("prdft_last", err_f, lambda m: dft_kernel.prdft_last(space, m),
             lambda: dft.prdft_last(space, xf),
             lambda: torch.fft.rfft(space), xf)):
        form = dft_kernel.stage_form(m)
        recs.append(kernel_record(
            path, name, RFFT_SRC, REAL_REPLACES, err,
            lambda: run(m), plain,
            lib if full else None,
            rows * nx * e + 2 * rows * w * e + table_bytes(m, form),
            rfft_flops(rows, nx), FLOP_PER_RMAC * rows * nx * w, form,
            lambda: run(matrix_pair(m))))
    print_records(recs)
    print(f"{path} x stage: the FP32 torch.matmul (cuBLAS) products it ran "
          f"before, {recs[0]['plain_ms']:.4f} ms backward and "
          f"{recs[1]['plain_ms']:.4f} ms forward; the real FFT form "
          f"{recs[0]['ms']:.4f} / {recs[1]['ms']:.4f} ms", flush=True)
    # what the odd width of the half spectrum costs the real FFT form: the
    # same rows with one bin fewer (w - 1, a multiple of 4 at 256^3)
    if w > 1:
        nb = dft.device_c2r(nx, rows=(0, w - 1), device=device,
                            dtype=yr.dtype)
        nf = dft.device_r2c(nx, cols=(0, w - 1), device=device,
                            dtype=yr.dtype)
        nr, ni = yr[..., :w - 1].contiguous(), yi[..., :w - 1].contiguous()
        ms_b = timed_ms(lambda: dft_kernel.pirdft_last(nr, ni, nb), device)
        ms_f = timed_ms(lambda: dft_kernel.prdft_last(space, nf), device)
        print(f"{path} x stage, half spectrum {w} bins wide against "
              f"{w - 1}: pirdft_last {recs[0]['ms']:.4f} / {ms_b:.4f} ms, "
              f"prdft_last {recs[1]['ms']:.4f} / {ms_f:.4f} ms", flush=True)
    return recs


#: the stages of the distributed pair, in the order they run
DIST_STAGES = ("z backward",) + tuple(
    f"exchange {s} backward" for s in ("pack", "transpose", "unpack")) + (
    "xy backward", "xy forward") + tuple(
    f"exchange {s} forward" for s in ("pack", "transpose", "unpack")) + (
    "z forward",)


def dist_breakdown_phase(sp, path, plan, stacked, device):
    """Where the distributed pair's time goes: the pair run through the
    plan's own stage methods one after another (``_z_backward``, the
    exchange's steps ``_exchange_steps`` on the real then the imaginary
    plane, ``_xy_backward``, ``_xy_forward``, the exchange back,
    ``_z_forward``), a CUDA event after each, with no wait in between,
    so that the stage times add up to the staged run. Its values must
    equal the public pair's bit for bit. The public pair minus the staged
    run is the public layout's copies (stacking, interleaving). Medians
    of ``REPS`` runs after a warm-up; returns the medians by stage."""
    full = sp.Scaling.FULL
    v = stacked[:, None]

    def exchange(planes, forward, mark):
        d = "forward" if forward else "backward"
        out = []
        for t in planes:
            for name, step in plan._exchange_steps(forward):
                t = step(t)
                mark(f"exchange {name} {d}")
            out.append(t)
        return tuple(out)

    def staged(mark):
        t = plan._z_backward(v)
        mark("z backward")
        t = plan._xy_backward(exchange(t, False, mark))
        mark("xy backward")
        t = plan._xy_forward(t)
        mark("xy forward")
        t = plan._z_forward(exchange(t, True, mark), True)
        mark("z forward")
        return t

    def run():
        marks = []
        if device.type == "cuda":
            def mark(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append((name, e))
        else:
            def mark(name):
                marks.append((name, time.perf_counter()))
        mark(None)
        out = staged(mark)
        if device.type == "cuda":
            marks[-1][1].synchronize()
            ms = [b.elapsed_time(a) for (_, b), (_, a) in
                  zip(marks, marks[1:])]
        else:
            ms = [(a - b) * 1e3 for (_, b), (_, a) in zip(marks, marks[1:])]
        per = dict.fromkeys(DIST_STAGES, 0.0)
        for (name, _), t in zip(marks[1:], ms):
            per[name] += t
        return out, per

    want = plan.forward(plan.backward(stacked), full)
    out, _ = run()
    if not torch.equal(out[:, 0], want):
        fail(f"{path}: the plan's stage methods run one after another "
             f"differ from the public pair")
    del out, want
    run()
    reps = [run()[1] for _ in range(REPS)]
    med = {k: float(np.median([r[k] for r in reps])) for k in DIST_STAGES}
    total = float(np.median([sum(r.values()) for r in reps]))
    pair = timed_ms(lambda: plan.forward(plan.backward(stacked), full),
                    device)
    for k in DIST_STAGES:
        print(f"{path} stage {k}: {med[k]:.4f} ms", flush=True)
    print(f"{path} stages: staged run {total:.4f} ms (sum of the stage "
          f"medians {sum(med.values()):.4f}); public pair {pair:.4f} ms, "
          f"so the public layout's copies {pair - total:.4f} ms; the staged "
          f"run equals the public pair bit for bit", flush=True)
    return med


def dist_pair_phase(sp, path, plan, stacked, local, local_values,
                    oracle_rel, device, counters, want):
    """The public distributed backward + forward(FULL) pair, counted
    (``want``) and checked: the backward, its slabs stacked in z order,
    within ``predicted_rel_error`` of the complex128 oracle on the card
    and, of the local plan's backward of the same values, within
    ``KERNEL_TOL`` (single) or twice ``predicted_rel_error`` relative l2
    (double); the round trip within :func:`roundtrip_tol`; a second
    backward identical to the first; the median pair time beside the
    local pair's, timed in turns (local, distributed, distributed,
    local)."""
    dp = plan.dist_plan
    if len(set(dp.num_planes)) != 1:
        fail(f"{path}: uneven slabs {dp.num_planes}")
    reset_launches(counters)
    space = plan.backward(stacked)
    out = plan.forward(space, sp.Scaling.FULL)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches(path, counters, want)

    shape = (_S, dp.max_planes, dp.dim_y, dp.dim_x)
    if not dp.hermitian:
        shape += (2,)
    if tuple(space.shape) != shape or space.dtype != plan.real_dtype \
            or out.dtype != plan.real_dtype \
            or not torch.isfinite(space).all():
        fail(f"{path} backward output malformed: {tuple(space.shape)} "
             f"{space.dtype}")
    full = space.reshape((dp.dim_z,) + shape[2:])
    rel = oracle_rel(full)
    pred = sp.predicted_rel_error(plan.precision, dp.dim_z, True)
    print(f"{path} backward vs complex128 oracle: rel_l2={rel:.3e} "
          f"(predicted_rel_error={pred:.3e})", flush=True)
    if not rel <= pred:
        fail(f"{path} backward rel_l2 {rel:.3e} above {pred:.3e}")
    lb = local.backward(local_values)
    if plan.precision == "single":
        err = compare(f"{path} backward vs the local plan's", (full,), (lb,))
    else:
        d = float(torch.linalg.norm(full.double() - lb.double())
                  / torch.linalg.norm(lb.double()))
        err = (float((full - lb).abs().max()), None, d)
        if not d <= 2 * pred:
            fail(f"{path} backward vs the local plan's: rel_l2={d:.3e} "
                 f"above twice predicted_rel_error, {2 * pred:.3e}")
    del lb
    print(f"{path} backward vs the local plan's on the same values: "
          f"max_abs_err={err[0]:.3e} rel_l2={err[2]:.3e}", flush=True)
    rt = float(torch.linalg.norm(out.double() - stacked.double())
               / torch.linalg.norm(stacked.double()))
    rt_tol = roundtrip_tol(sp, plan.precision, dp.dim_z)
    print(f"{path} forward(FULL) round trip: rel_l2={rt:.3e} (at most "
          f"{rt_tol:.3e})", flush=True)
    if not rt <= rt_tol:
        fail(f"{path} round trip rel_l2 {rt:.3e} above {rt_tol:.3e}")
    if not torch.equal(plan.backward(stacked), space):
        fail(f"{path}: a second backward differs from the first")
    del full, out

    full_ = sp.Scaling.FULL
    t = [timed_ms(f, device) for f in (
        lambda: local.forward(local.backward(local_values), full_),
        lambda: plan.forward(plan.backward(stacked), full_),
        lambda: plan.forward(plan.backward(stacked), full_),
        lambda: local.forward(local.backward(local_values), full_))]
    dev_ms = graph_ms(lambda: plan.forward(plan.backward(stacked), full_),
                      device, PAIR_GRAPH_CALLS)
    print(f"{path} path pair (backward + forward FULL): "
          f"{(t[1] + t[2]) / 2:.4f} ms against the local pair's "
          f"{(t[0] + t[3]) / 2:.4f} ms (medians of {REPS}, in turns "
          f"{[round(x, 4) for x in t]}); on the device alone {_ms(dev_ms)} "
          f"ms; exchange_wire_bytes={plan.exchange_wire_bytes()} per "
          f"direction", flush=True)
    return launches


def dist_structure_phase(sp, path, plan, stacked, device, counters, want,
                         batch=BATCH):
    """A batched pair of ``batch`` bands (band b the values times 1 +
    b / 2), counted (``want``: the launches of one single pair), each
    band equal bit for bit to the single calls on it; ``apply_pointwise``
    with a potential and ``iterate_pointwise(steps=3)`` equal bit for bit
    to the same calls made one at a time."""
    full = sp.Scaling.FULL
    bands = torch.stack([stacked * (1 + b / 2) for b in range(batch)], 1)
    reset_launches(counters)
    space_b = plan.backward_batched(bands)
    out_b = plan.forward_batched(space_b, full)
    if device.type == "cuda":
        torch.cuda.synchronize()
    read_launches(f"{path} batched B={batch}", counters, want)
    for b in range(batch):
        one = plan.backward(bands[:, b])
        if not torch.equal(space_b[:, b], one):
            fail(f"{path} batched backward: band {b} differs from the "
                 f"single backward")
        if not torch.equal(out_b[:, b], plan.forward(one, full)):
            fail(f"{path} batched forward: band {b} differs from the "
                 f"single forward")
    del space_b, out_b
    ms_b = timed_ms(lambda: plan.forward_batched(
        plan.backward_batched(bands), full), device)
    dp = plan.dist_plan
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    pot = torch.rand((_S, dp.max_planes, dp.dim_y, dp.dim_x), generator=gen,
                     device=device)

    def fn(space, w):
        return space * (w if dp.hermitian else w[..., None])

    if not torch.equal(plan.apply_pointwise(stacked, fn, pot, scaling=full),
                       plan.forward(fn(plan.backward(stacked), pot), full)):
        fail(f"{path} apply_pointwise(potential) differs from its calls "
             f"made one at a time")
    want_v = stacked
    for _ in range(3):
        want_v = plan.forward(fn(plan.backward(want_v), pot), full)
    if not torch.equal(plan.iterate_pointwise(stacked, fn, pot, steps=3),
                       want_v):
        fail(f"{path} iterate_pointwise(steps=3) differs from its calls "
             f"made one at a time")
    print(f"{path} batched pair B={batch}: {ms_b:.4f} ms, "
          f"{ms_b / batch:.4f} ms per band, every band equal to its single "
          f"calls; apply_pointwise(potential) and iterate_pointwise(steps=3) "
          f"equal to the calls made one at a time", flush=True)


def dist_c2c_phases(sp, n, local, trip, values, oracle, device, counters,
                    tag=""):
    """Every distributed C2C phase at the precision of ``values`` (its
    paths named with ``tag``, "_f64" for the double ones); returns its
    kernel records (the fused route's ``pdft2_swapped`` and per-shard z
    kernels, the two-kernel route's gather and ``pdft_last``)."""
    plan, stacked = dist_plan(sp, n, trip, values, device)
    name = "dist c2c" + tag.replace("_", " ")
    recs = dist_kernel_phase(plan, stacked, device, "dist_c2c" + tag)
    recs += dist_z_kernel_phase("dist_c2c" + tag, plan, stacked, device)
    dist_odd_shapes_phase(device, plan.real_dtype)
    dist_odd_shards_phase(sp, device, plan.precision)
    set_launches(recs, dist_pair_phase(
        sp, name, plan, stacked, local, values, oracle, device,
        counters, DIST_C2C_LAUNCHES))
    dist_breakdown_phase(sp, name, plan, stacked, device)
    dist_structure_phase(sp, name, plan, stacked, device, counters,
                         DIST_C2C_LAUNCHES)
    plan2 = sp.DistributedTransformPlan(plan.dist_plan, mesh=plan.mesh,
                                        fused=False,
                                        precision=plan.precision)
    recs2 = dist_z_kernel_phase("dist_c2c_2k" + tag, plan2, stacked, device)
    set_launches(recs2, dist_pair_phase(
        sp, f"{name} two-kernel", plan2, stacked, local, values, oracle,
        device, counters, DIST_C2C_2K_LAUNCHES))
    dist_breakdown_phase(sp, f"{name} two-kernel", plan2, stacked, device)
    route_phase(sp, name, plan, plan2, stacked)
    return recs + recs2


def dist_r2c_phases(sp, n, local, trip, values, oracle_rel, device,
                    counters, tag=""):
    """Every distributed R2C phase at the precision of ``values`` (its
    paths named with ``tag``); returns its kernel records (the per-shard
    z kernels, the owner's and the other shards' zero sticks among them,
    ``pdft_last`` at the y stage, ``pirdft_last`` and ``prdft_last`` at
    the x stage; the two-kernel route's gather and z stage
    ``pdft_last``)."""
    plan, stacked = dist_plan(sp, n, trip, values, device, r2c=True)
    name = "dist r2c" + tag.replace("_", " ")
    path = "dist_r2c" + tag
    recs = dist_z_kernel_phase(path, plan, stacked, device)
    recs += dist_y_kernel_record(path, plan, stacked, device)
    recs += dist_x_kernel_records(path, plan, stacked, device)
    set_launches(recs, dist_pair_phase(
        sp, name, plan, stacked, local, values, oracle_rel, device,
        counters, DIST_R2C_LAUNCHES))
    dist_breakdown_phase(sp, name, plan, stacked, device)
    dist_structure_phase(sp, name, plan, stacked, device, counters,
                         DIST_R2C_LAUNCHES)
    plan2 = sp.DistributedTransformPlan(plan.dist_plan, mesh=plan.mesh,
                                        fused=False,
                                        precision=plan.precision)
    recs2 = dist_z_kernel_phase("dist_r2c_2k" + tag, plan2, stacked, device)
    set_launches(recs2, dist_pair_phase(
        sp, f"{name} two-kernel", plan2, stacked, local, values, oracle_rel,
        device, counters, DIST_R2C_2K_LAUNCHES))
    dist_breakdown_phase(sp, f"{name} two-kernel", plan2, stacked, device)
    route_phase(sp, name, plan, plan2, stacked)
    return recs + recs2


# -- the long axes (above 512): the two-pass FFT, the long matrix form, the
# real FFT to 1024 and torch.fft --------------------------------------------

#: the long axes' full-width cell: the 768^3 sphere (237M values), every
#: axis 768 = 24 x 32 in the two-pass form
LONG_N = 768
LONG_SRC = "spfft_tpu_torch/csrc/fft_long.cu"
#: the long forms are forms of the stage wrappers (rows 7 and 3-6 of the
#: kernel table); the JAX package runs these lengths as XLA dots
#: (spfft_tpu/ops/dft.py:268 _pdft_two_stage) or jnp.fft, not Pallas
STAGE_REPLACES = "spfft_tpu/ops/dft_kernel.py:165"
PLANE_REPLACES = "spfft_tpu/ops/dft_kernel.py:277"
#: the 768^3 pairs: the two-kernel route (the fused kernels decline a z of
#: 768), the z stage and each plane stage one two-pass launch a direction
LONG_C2C_LAUNCHES = {"gather": (2, 2), "pdft_last": (2, 2, {"two_pass": 2}),
                     "pdft2": (4, 4, {"two_pass": 4}),
                     "decompress_zdft": (0, 0), "zdft_compress": (0, 0),
                     "prdft2": (0, 0), "pdft2_cr": (0, 0),
                     "pdft2_swapped": (0, 0), **NO_REAL_LAST}
LONG_R2C_LAUNCHES = {"gather": (2, 2), "pdft_last": (2, 2, {"two_pass": 2}),
                     "prdft2": (2, 2, {"rfft": 1, "two_pass": 1}),
                     "pdft2_cr": (2, 2, {"two_pass": 1, "rfft": 1}),
                     "decompress_zdft": (0, 0), "zdft_compress": (0, 0),
                     "pdft2": (0, 0), "pdft2_swapped": (0, 0),
                     **NO_REAL_LAST}


def _rss_bytes() -> int:
    """The process's resident bytes now (Linux ``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def peak_rss_over(fn, every_s: float = 0.02):
    """``fn()`` and the host memory it took: the peak of the process's
    resident bytes, sampled every ``every_s`` seconds while it runs, less
    its resident bytes before."""
    import threading
    before = _rss_bytes()
    peak = [before]
    done = threading.Event()

    def sample():
        while not done.wait(every_s):
            peak[0] = max(peak[0], _rss_bytes())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        out = fn()
    finally:
        done.set()
        t.join()
    peak[0] = max(peak[0], _rss_bytes())
    return out, peak[0] - before


def stage_bytes(mats, rows: int, e: int) -> int:
    """Bytes a DFT stage must move: ``rows`` input rows of K and output
    rows of N (planar complex; a real side one plane) read and written
    once, and its tables."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    k, n = dft.mats_shape(mats)
    kin = 1 if getattr(mats, "kind", "c2c") == "r2c" else 2
    kout = 1 if getattr(mats, "kind", "c2c") == "c2r" else 2
    if dft_kernel.stage_form(mats) in ("fft", "rfft", "two_pass"):
        tables = mats.twiddles.numel()  # the FFT forms read the table only
    else:
        tables = sum(t.numel() for t in mats)
    return (rows * (kin * k + kout * n) + tables) * e


def stage_flops(mats, rows: int) -> float:
    """FFT operations of a stage of ``rows`` lines (half for a real
    transform)."""
    n = mats.n
    return (rfft_flops if mats.kind != "c2c" else fft_flops)(rows, n)


def stage_design(mats, rows: int, e: int):
    """The design bound's (bytes, operations) of a stage in its form: the
    two-pass form moves its intermediate once more (written by pass 1,
    read by pass 2); the matrix forms do K N multiply-adds a row."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    form = dft_kernel.stage_form(mats)
    nbytes = stage_bytes(mats, rows, e)
    if form == "two_pass":
        return nbytes + 4 * rows * mats.n * e, stage_flops(mats, rows)
    if form in ("matrix", "long_matrix"):
        k, n = dft.mats_shape(mats)
        per = FLOP_PER_CMAC if mats.kind == "c2c" else FLOP_PER_RMAC
        return nbytes, per * rows * k * n
    return nbytes, stage_flops(mats, rows)


def stage_library(mode, ins, mats):
    """The library yardstick of one stage: one ``torch.fft`` call along
    the same axis (``ifft``/``fft``, ``rfft``, ``irfft``) on the inputs
    expanded to the whole axis, never called by the package."""
    from spfft_tpu_torch.ops import dft
    n = mats.n
    if mode == "rc":
        x = ins[0]
        return lambda: torch.fft.rfft(x)
    length = n if mode == "cc" else n // 2 + 1
    z = torch.complex(dft.expand_window(ins[0], mats.rows, length),
                      dft.expand_window(ins[1], mats.rows, length))
    if mode == "cr":
        return lambda: torch.fft.irfft(z, n=n, norm="forward")
    if mats.sign > 0:
        return lambda: torch.fft.ifft(z, norm="forward")
    return lambda: torch.fft.fft(z)


def long_stage_record(path, name, wrapper, plain, mode, ins, mats, err,
                      source=LONG_SRC, replaces=STAGE_REPLACES):
    """A record of one single-stage wrapper call in a long form."""
    from spfft_tpu_torch.ops import dft_kernel
    x = ins[0]
    e = x.element_size()
    rows = x.numel() // x.shape[-1]
    dbytes, dflops = stage_design(mats, rows, e)
    return kernel_record(
        path, name, source, replaces, err, lambda: wrapper(*ins, mats),
        lambda: plain(*ins, mats), stage_library(mode, ins, mats),
        stage_bytes(mats, rows, e), stage_flops(mats, rows), dflops,
        dft_kernel.stage_form(mats), None, dbytes)


def long_plane_record(path, name, wrapper, plain, modes, ins, mats1, mats2,
                      err, library):
    """A record of one plane wrapper call ``(P, A, B)``: two stages, each
    in its form, the intermediate through device memory once."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    p, a, b = ins[0].shape
    e = ins[0].element_size()
    b_out = dft.mats_shape(mats1)[1]
    nbytes = stage_bytes(mats1, p * a, e) + stage_bytes(mats2, p * b_out, e) \
        - 2 * 2 * p * a * b_out * e  # the intermediate is not the function's
    d1 = stage_design(mats1, p * a, e)
    d2 = stage_design(mats2, p * b_out, e)
    forms = [dft_kernel.stage_form(m) for m in (mats1, mats2)]
    src = LONG_SRC if "two_pass" in forms else FFT_SRC
    return kernel_record(
        path, name, src, PLANE_REPLACES, err,
        lambda: wrapper(*ins, mats1, mats2), lambda: plain(*ins, mats1, mats2),
        library, nbytes, stage_flops(mats1, p * a)
        + stage_flops(mats2, p * b_out), d1[1] + d2[1], "+".join(forms),
        None, d1[0] + d2[0])


def long_two_launch(ins, mats1, mats2=None):
    """``pdft_last`` against ``mats1`` (``mats2`` None) or ``pdft2`` with
    every stage in the two-pass form's two launches, csrc/fft_long.cu's
    pass 1 then pass 2 (the form the wrappers take for a row longer than
    ``LONG_WHOLE_N``); not counted."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    x = ins[0]

    def stage(src, mats, shape, plane_rows):
        if dft_kernel.stage_form(mats) != "two_pass":
            fail(f"long_two_launch: a stage of form "
                 f"{dft_kernel.stage_form(mats)}")
        out = tuple(torch.empty(shape, dtype=x.dtype, device=x.device)
                    for _ in range(2))
        dft_kernel._long_passes(uncounted(), src, mats, out, plane_rows,
                                one_launch=False)
        return out

    b_out = dft.mats_shape(mats1)[1]
    if mats2 is None:
        return stage(ins, mats1, x.shape[:-1] + (b_out,), 0)
    p, a, _ = x.shape
    mid = stage(ins, mats1, (p, b_out, a), a)
    return stage(mid, mats2, (p, b_out, dft.mats_shape(mats2)[1]), 0)


def two_launch(rec, fn, two, device):
    """The record's call ``fn`` against ``two``, the same call with every
    two-pass stage in its two-launch form (:func:`long_two_launch`):
    checked against the one-launch result (``KERNEL_TOL``) and timed on
    the same inputs, as ``two_launch_ms``."""
    want, got = fn(), two()
    compare(f"{rec['path']} {rec['name']} two-launch form", got,
            want if isinstance(want, tuple) else (want,))
    del got, want
    rec["two_launch_ms"] = timed_ms(two, device)
    print(f"kernel {rec['path']} {rec['name']}: two-launch form "
          f"{rec['two_launch_ms']:.4f} ms against {rec['ms']:.4f} in one "
          f"launch (same inputs)", flush=True)


def long_c2c_records(path, plan, values, device):
    """The 768^3 C2C path's kernels at its shapes against their plain
    versions: ``pdft_last`` (the z stage of the two-kernel route, two
    passes) and ``pdft2`` (both plane stages two-pass), backward."""
    from spfft_tpu_torch.ops import dft, dft_kernel, gather_kernel, stages
    p = plan.index_plan
    v = plan._coerce_values(values)
    sr, si = gather_kernel.decompress(v, plan._slot_src, p.dim_z,
                                      plan.pair_values_io)
    del v
    zb = plan._mats["z_b"]
    got = dft_kernel.pdft_last(sr, si, zb)
    err = compare(f"{path} pdft_last backward (two-pass)", got,
                  dft.pdft_last(sr, si, zb))
    recs = [long_stage_record(path, "pdft_last", dft_kernel.pdft_last,
                              dft.pdft_last, "cc", (sr, si), zb, err)]
    two_launch(recs[-1], lambda: dft_kernel.pdft_last(sr, si, zb),
               lambda: long_two_launch((sr, si), zb), device)
    del sr, si
    gr = stages.sticks_to_grid_padded(got[0], plan._col_inv, plan._grid_w,
                                      p.dim_y)
    gi = stages.sticks_to_grid_padded(got[1], plan._col_inv, plan._grid_w,
                                      p.dim_y)
    del got
    m1, m2 = plan._mats["y_b"], plan._mats["x_b"]
    out = dft_kernel.pdft2(gr, gi, m1, m2)
    err = compare(f"{path} pdft2 backward (two-pass)", out,
                  dft.pdft2_minor(gr, gi, m1, m2))
    del out
    gc = torch.complex(gr, gi)
    recs.append(long_plane_record(
        path, "pdft2", dft_kernel.pdft2, dft.pdft2_minor, ("cc", "cc"),
        (gr, gi), m1, m2, err,
        lambda: torch.fft.ifft2(gc, norm="forward").transpose(-1, -2)
        .contiguous()))
    two_launch(recs[-1], lambda: dft_kernel.pdft2(gr, gi, m1, m2),
               lambda: long_two_launch((gr, gi), m1, m2), device)
    print_records(recs)
    return recs


def long_r2c_records(path, plan, values, device):
    """The 768^3 R2C path's plane kernels at its shapes: ``pdft2_cr``
    (the y stage two-pass, the real x stage a real FFT of half 384) and
    ``prdft2``."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    p = plan.index_plan
    space = plan._bwd_space(plan._coerce_values(values))
    planes = (-1, p.dim_y, p.dim_x)
    x = space.reshape(planes)
    f1, f2 = plan._mats["x_f"], plan._mats["y_f"]
    got = dft_kernel.prdft2(x, f1, f2)
    err = compare(f"{path} prdft2 (rfft + two-pass)", got,
                  dft.prdft2_minor(x, f1, f2))
    recs = [long_plane_record(
        path, "prdft2", dft_kernel.prdft2, dft.prdft2_minor, ("rc", "cc"),
        (x,), f1, f2, err,
        lambda: torch.fft.fft(torch.fft.rfft(x), dim=-2).transpose(-1, -2)
        .contiguous())]
    gr, gi = got[0].contiguous(), got[1].contiguous()
    del got
    m1, m2 = plan._mats["y_b"], plan._mats["x_b"]
    out = dft_kernel.pdft2_cr(gr, gi, m1, m2)
    err = compare(f"{path} pdft2_cr (two-pass + rfft)", (out,),
                  (dft.pdft2_minor_cr(gr, gi, m1, m2),))
    del out, space
    gc = torch.complex(gr, gi)
    recs.append(long_plane_record(
        path, "pdft2_cr", dft_kernel.pdft2_cr, dft.pdft2_minor_cr,
        ("cc", "cr"), (gr, gi), m1, m2, err,
        lambda: torch.fft.irfft(torch.fft.ifft(gc, dim=-1, norm="forward")
                                .transpose(-1, -2), n=p.dim_x,
                                norm="forward")))
    print_records(recs)
    return recs


def long_axes_phase(sp, device, counters):
    """The long axes at full width: C2C on ``spherical_cutoff_triplets
    (768)`` sorted stick-major, single precision, values from numpy seed
    ``SEED``, then R2C on the half sphere (``r2c_plan``): the plan's time
    and the host memory the planner took, its route (two-kernel, the
    fused kernels' decline, the pair layout), each kernel at the path's
    shapes against its plain version, and the counted pair
    (``pair_phase``: the backward within ``predicted_rel_error("single",
    768)`` of the complex128 oracle, the round trip within 1e-6, a
    repeat, the pair per call and on the device alone) with the peak
    device memory. Returns the records."""
    from spfft_tpu_torch.utils.workloads import \
        spherical_cutoff_triplets_stick_major
    n = LONG_N
    t0 = time.perf_counter()
    trip = spherical_cutoff_triplets_stick_major(n)
    t_trip = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan, rss = peak_rss_over(lambda: sp.make_local_plan(
        sp.TransformType.C2C, n, n, n, trip, device=device))
    plan_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    m = len(trip)
    vals = (rng.standard_normal(m) + 1j * rng.standard_normal(m)) \
        .astype(np.complex64)
    values = torch.view_as_real(torch.from_numpy(vals)).to(device)
    del vals
    p = plan.index_plan
    print(f"plan: C2C {n}^3 sphere, single, {plan.num_local_elements} "
          f"values in {p.num_sticks} sticks, split_x={plan.split_x}, "
          f"pair_io={plan.pair_values_io}, fused_active="
          f"{plan.fused_active}, fused_fallback_reasons="
          f"{plan.fused_fallback_reasons}; triplets {t_trip:.2f} s, plan "
          f"built in {plan_s:.2f} s, host memory the planner took "
          f"{rss / 2**30:.2f} GiB (peak resident over the build)",
          flush=True)
    if rss <= 0:
        fail(f"long{n}: the planner's host memory read {rss} bytes")
    if not plan.pair_values_io or plan.fused_active \
            or plan.fused_fallback_reasons != {"dec": "dimz_over_cap",
                                               "cmp": "dimz_over_cap"}:
        fail(f"long{n}: expected the pair layout and the two-kernel route")
    path = f"long{n}"
    recs = long_c2c_records(path, plan, values, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    oracle = c2c_oracle_rel(plan, trip, values, device)
    set_launches(recs, pair_phase(sp, f"{path} c2c", plan, values, oracle,
                                  device, counters, LONG_C2C_LAUNCHES))
    print(f"{path} c2c: peak device memory over the pair phase (oracle "
          f"included) {torch.cuda.max_memory_allocated(device) / 2**30:.2f} "
          f"GiB", flush=True)
    del plan, trip, values, oracle
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    plan, _, values, oracle = r2c_plan(sp, n, device)
    print(f"{path} r2c: plan with its values in "
          f"{time.perf_counter() - t0:.2f} s, fused_fallback_reasons="
          f"{plan.fused_fallback_reasons}", flush=True)
    rrecs = long_r2c_records(path + "_r2c", plan, values, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)

    def oracle_rel(space):
        return float(torch.linalg.norm(space.double() - oracle)
                     / torch.linalg.norm(oracle))

    set_launches(rrecs, pair_phase(sp, f"{path} r2c", plan, values,
                                   oracle_rel, device, counters,
                                   LONG_R2C_LAUNCHES))
    print(f"{path} r2c: peak device memory over the pair phase "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB",
          flush=True)
    del plan, values, oracle
    torch.cuda.empty_cache()
    return recs + rrecs


#: the odd long lengths: z lengths by form, R2C x lengths by form
LONG_Z = (520, 521, 1024, 1080, 2048, 4097, 8192, 1031)
#: the longest row csrc/fft_long.cu's one-launch kernel holds (WHOLE_N): a
#: two-pass stage is one launch up to it, pass 1 then pass 2 above it
LONG_WHOLE_N = 4096
LONG_X_R2C = (1000, 1022, 1024, 1031)


def _long_rows(rng, rows, k, dtype, device):
    return tuple(torch.as_tensor(rng.standard_normal((rows, k)), dtype=dtype,
                                 device=device) for _ in range(2))


def _check_forms(name, wrapper, want):
    from spfft_tpu_torch.ops import dft_kernel
    got = {f: k for f, k in wrapper.form_launches.items() if k}
    if got != want:
        fail(f"{name}: launched by form {got}, expected {want}")
    launches = sum(k for f, k in want.items() if f != "library")
    if wrapper.launches != launches:
        fail(f"{name}: {wrapper.launches} launches, expected {launches}")
    wrapper.launches = 0
    wrapper.form_launches = dict.fromkeys(dft_kernel.ALL_FORMS, 0)


def _want(*mats):
    """The launches by form a call over stages ``mats`` must count: one a
    stage, two for a two-pass stage longer than ``LONG_WHOLE_N``."""
    from spfft_tpu_torch.ops import dft_kernel
    out = {}
    for m in mats:
        f = dft_kernel.stage_form(m)
        out[f] = out.get(f, 0) + (
            2 if f == "two_pass" and m.n > LONG_WHOLE_N else 1)
    return out


def long_odd_shapes_phase(sp, device, counters, dtype):
    """Each long form on the card against its plain version at small
    shapes, in ``dtype``: ``pdft_last`` at z lengths ``LONG_Z`` (two-pass
    with 2^a 3^b 5^c factors and with a direct factor, the long matrix
    form to 1024, ``torch.fft`` above), whole and windowed; ``pdft2`` /
    ``pdft2_swapped`` with long stages on either axis; the real stages at
    ``LONG_X_R2C`` (the real FFT to 1024, the long matrix form,
    ``torch.fft``), alone and inside ``prdft2`` / ``pdft2_cr``; each
    call's launches by form checked (the two-pass form in one launch up to
    ``LONG_WHOLE_N``, in two above it: 4097, 8192)."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    if device.type == "cuda" and dft_kernel.long_row_max() != LONG_WHOLE_N:
        fail(f"csrc/fft_long.cu holds rows of {dft_kernel.long_row_max()} "
             f"in one launch, expected {LONG_WHOLE_N}")
    rng = np.random.default_rng(SEED)
    reset_launches(counters)
    cases = 0
    for n in LONG_Z:
        for sign, window in ((dft.BACKWARD, {}), (dft.FORWARD, {}),
                             (dft.BACKWARD, {"rows": (n - 50, 300)}),
                             (dft.FORWARD, {"cols": (n - 7, 100)})):
            m = dft.device_c2c(n, sign, 1.0 / n, device=device, dtype=dtype,
                               **window)
            x = _long_rows(rng, 257, m.shape[0], dtype, device)
            got = dft_kernel.pdft_last(*x, m)
            compare(f"pdft_last {n} {sign} {window}", got,
                    dft.pdft_last(*x, m))
            _check_forms(f"pdft_last {n}", dft_kernel.pdft_last, _want(m))
            cases += 1
    for (p, a, b), (n1, w1), (n2, w2) in (
            ((3, 64, 520), (520, {}), (64, {})),
            ((2, 520, 48), (48, {}), (520, {})),
            ((2, 33, 768), (768, {"rows": (760, 768)}), (33, {})),
            ((2, 40, 1000), (1000, {"cols": (990, 20)}), (40, {})),
            ((3, 17, 521), (521, {}), (17, {})),
            ((1, 521, 520), (520, {}), (521, {})),
            ((2, 6, 1031), (1031, {}), (6, {})),
            ((1, 3, 8192), (8192, {}), (3, {})),
            ((1, 5200, 2), (2, {}), (5200, {"cols": (5190, 20)}))):
        m1 = dft.device_c2c(n1, dft.BACKWARD, device=device, dtype=dtype,
                            **w1)
        m2 = dft.device_c2c(n2, dft.BACKWARD, 0.5, device=device,
                            dtype=dtype, **w2)
        x = tuple(torch.as_tensor(rng.standard_normal((p, a, b)),
                                  dtype=dtype, device=device)
                  for _ in range(2))
        for wrapper, plain in ((dft_kernel.pdft2, dft.pdft2_minor),
                               (dft_kernel.pdft2_swapped, dft.cdft2_xy)):
            compare(f"{wrapper.__name__} {(p, a, b)}", wrapper(*x, m1, m2),
                    plain(*x, m1, m2))
            _check_forms(f"{wrapper.__name__} {(p, a, b)}", wrapper,
                         _want(m1, m2))
            cases += 1
    for n in LONG_X_R2C:
        xf = n // 2 + 1
        for cols in (None, (3, xf - 10)):
            r2c = dft.device_r2c(n, 1.0 / n, cols=cols, device=device,
                                 dtype=dtype)
            c2r = dft.device_c2r(n, rows=cols, device=device, dtype=dtype)
            x = torch.as_tensor(rng.standard_normal((3, 40, n)), dtype=dtype,
                                device=device)
            compare(f"prdft_last {n} {cols}", dft_kernel.prdft_last(x, r2c),
                    dft.prdft_last(x, r2c))
            _check_forms(f"prdft_last {n}", dft_kernel.prdft_last, _want(r2c))
            k = r2c.shape[1]
            y = tuple(torch.as_tensor(rng.standard_normal((3, 40, k)),
                                      dtype=dtype, device=device)
                      for _ in range(2))
            compare(f"pirdft_last {n} {cols}", (dft_kernel.pirdft_last(
                *y, c2r),), (dft.pirdft_last(*y, c2r),))
            _check_forms(f"pirdft_last {n}", dft_kernel.pirdft_last,
                         _want(c2r))
            my = dft.device_c2c(40, dft.FORWARD, device=device, dtype=dtype)
            compare(f"prdft2 {n} {cols}", dft_kernel.prdft2(x, r2c, my),
                    dft.prdft2_minor(x, r2c, my))
            _check_forms(f"prdft2 {n}", dft_kernel.prdft2, _want(r2c, my))
            yy = tuple(torch.as_tensor(rng.standard_normal((3, k, 40)),
                                       dtype=dtype, device=device)
                       for _ in range(2))
            mb = dft.device_c2c(40, dft.BACKWARD, device=device, dtype=dtype)
            compare(f"pdft2_cr {n} {cols}", (dft_kernel.pdft2_cr(
                *yy, mb, c2r),), (dft.pdft2_minor_cr(*yy, mb, c2r),))
            _check_forms(f"pdft2_cr {n}", dft_kernel.pdft2_cr, _want(mb, c2r))
            cases += 4
    print(f"odd shapes of the long forms ({dtype}): {cases} kernel-vs-plain "
          f"cases within {kernel_tol(dtype)[1]}, each call's launches by "
          f"form as its stages' lengths say (torch.fft counted by form "
          f"only), the two-pass form in one launch and in two", flush=True)


def _sparse_sticks(dims, keep, seed, half=False):
    """Every z of a seeded random ``keep`` share of the (x, y) sticks
    (with ``half``, x below the Nyquist plane: a hermitian half set needs
    no completion there, only at x = 0, which the plans complete)."""
    nx, ny, nz = dims
    rng = np.random.default_rng(seed)
    xs = (nx + 1) // 2 if half else nx
    xy = np.stack(np.meshgrid(np.arange(xs), np.arange(ny), indexing="ij"),
                  -1).reshape(-1, 2)
    xy = xy[rng.random(len(xy)) < keep]
    z = np.arange(nz)
    return np.concatenate([np.repeat(xy, nz, 0),
                           np.tile(z, len(xy))[:, None]], 1).astype(np.int32)


def _spectrum(dims, trip, device, dtype, seed):
    """Hermitian values at ``trip``: the spectrum of a seeded real field,
    and the field times the grid size (the backward's oracle)."""
    nx, ny, nz = dims
    gen = torch.Generator(device=device).manual_seed(seed)
    field = torch.randn((nz, ny, nx), generator=gen, dtype=torch.float64,
                        device=device)
    spec = torch.fft.fftn(field)
    t = torch.as_tensor(trip.astype(np.int64), device=device)
    vals = torch.view_as_real(spec[t[:, 2], t[:, 1], t[:, 0]]
                              .to(complex_of(torch.zeros(0, dtype=dtype))))
    return vals.contiguous(), field * (nx * ny * nz)


#: the long-axis plans of the odd phase: distributed C2C with an x of 521
#: (the long matrix form) and a z of 1024 (two-pass), distributed R2C with
#: an x of 1022 (long matrix, half 511 = 7 x 73) and a z of 520 (two-pass
#: with the direct factor 26), a local double plan with x 768 and z 1024
LONG_DIST = {"c2c": (521, 64, 1024), "r2c": (1022, 64, 520)}
LONG_F64 = (768, 64, 1024)


def long_plans_phase(sp, device, counters):
    """Plans with long axes at small stick sets, on the card: each
    distributed plan over 4 shards against the local plan on the same
    values (backward within 2e-6, float32, or twice
    ``predicted_rel_error``, float64, the round trip) with its pair
    counted, and ``LONG_F64`` in double against its oracle; records of
    the long forms these pairs run, at their shapes, timed. Returns the
    records."""
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition)
    recs = []
    for kind, dims in LONG_DIST.items():
        r2c = kind == "r2c"
        for dtype in (torch.float32, torch.float64):
            precision = "single" if dtype == torch.float32 else "double"
            trip = _sparse_sticks(dims, 0.05, 3, r2c)
            tt = sp.TransformType[kind.upper()]
            vals, field = _spectrum(dims, trip, device, dtype, 4)
            local = sp.make_local_plan(tt, *dims, trip, precision=precision,
                                       device=device)
            parts = round_robin_stick_partition(trip, dims, _S)
            plan = sp.make_distributed_plan(
                tt, *dims, parts, even_plane_split(dims[2], _S),
                mesh=sp.make_mesh(_S, device), precision=precision)
            trip_t = torch.as_tensor(trip.astype(np.int64), device=device)
            cube = torch.zeros(dims[::-1], dtype=complex_of(vals),
                               device=device)
            cube[trip_t[:, 2], trip_t[:, 1], trip_t[:, 0]] = \
                torch.view_as_complex(vals)
            stacked = plan.shard_values(
                [cube[torch.as_tensor(pp[:, 2].astype(np.int64)),
                      torch.as_tensor(pp[:, 1].astype(np.int64)),
                      torch.as_tensor(pp[:, 0].astype(np.int64))]
                 for pp in parts])
            del cube
            path = f"long_dist_{kind}" + ("_f64" if precision == "double"
                                          else "")
            reset_launches(counters)
            space = plan.backward(stacked)
            out = plan.forward(space, sp.Scaling.FULL)
            torch.cuda.synchronize()
            launches = {k: c.launches for k, c in counters.items()}
            forms = {k: {f: v for f, v in c.form_launches.items() if v}
                     for k, c in counters.items()
                     if hasattr(c, "form_launches")}
            print(f"{path} pair {dims}: launches {launches}; by form "
                  f"{forms}", flush=True)
            lb = local.backward(vals)
            full = space.reshape(lb.shape)
            pred = sp.predicted_rel_error(precision, max(dims), True)
            d = float(torch.linalg.norm(full.double() - lb.double())
                      / torch.linalg.norm(lb.double()))
            tol = KERNEL_TOL if precision == "single" else 2 * pred
            rt = float(torch.linalg.norm(out.double() - stacked.double())
                       / torch.linalg.norm(stacked.double()))
            print(f"{path}: backward vs the local plan's rel_l2={d:.3e} "
                  f"(at most {tol:.3e}), round trip {rt:.3e}", flush=True)
            if not d <= tol or not rt <= roundtrip_tol(sp, precision,
                                                       max(dims)):
                fail(f"{path}: backward {d:.3e} or round trip {rt:.3e} "
                     f"out of bounds")
            want = "long_matrix"
            got_x = forms.get("prdft_last" if r2c else "pdft2_swapped", {})
            if want not in got_x or forms["decompress_zdft"] or \
                    forms["zdft_compress"] or \
                    forms["pdft_last"].get("two_pass", 0) < 2:
                fail(f"{path}: expected the long matrix x stage and a "
                     f"two-pass z stage on the two-kernel route, got "
                     f"{forms}")
            if precision == "single":
                recs += long_dist_records(path, plan, stacked, forms)
            del plan, local, space, out, stacked, lb, full, field
            torch.cuda.empty_cache()

    # the local double plan with a 768 x axis and a 1024 z axis
    dims = LONG_F64
    trip = _sparse_sticks(dims, 0.05, 5)
    rng = np.random.default_rng(SEED)
    v = rng.standard_normal(len(trip)) + 1j * rng.standard_normal(len(trip))
    values = torch.view_as_real(torch.from_numpy(v)).to(device)
    plan = sp.make_local_plan(sp.TransformType.C2C, *dims, trip,
                              precision="double", device=device)
    reset_launches(counters)
    space = plan.backward(values)
    torch.cuda.synchronize()
    forms = {k: {f: n for f, n in c.form_launches.items() if n}
             for k, c in counters.items() if hasattr(c, "form_launches")}
    rel = c2c_oracle_rel(plan, trip, values, device)(space)
    pred = sp.predicted_rel_error("double", max(dims), True)
    print(f"long local C2C {dims} double: backward vs complex128 oracle "
          f"rel_l2={rel:.3e} (predicted_rel_error={pred:.3e}); launches by "
          f"form {forms}", flush=True)
    if not rel <= pred:
        fail(f"long local double {dims}: rel_l2 {rel:.3e} above {pred:.3e}")
    if forms["pdft_last"] != {"two_pass": 1} \
            or forms["pdft2"] != {"fft": 1, "two_pass": 1}:
        fail(f"long local double {dims}: forms {forms}")
    del plan, space, values
    torch.cuda.empty_cache()
    return recs


def long_dist_records(path, plan, stacked, forms):
    """Records of the distributed long-axis pair's new forms at its
    shapes: the two-kernel z stage (``pdft_last``, two-pass) and the x
    stage (the long matrix form: ``pdft2_swapped`` for C2C,
    ``prdft_last`` / ``pirdft_last`` for R2C), against their plain
    versions, each with the pair's launches."""
    from spfft_tpu_torch.ops import dft, dft_kernel, gather_kernel
    dp = plan.dist_plan
    sr, si = plan._z_backward(stacked[:, None])  # (1, S, max_sticks, dz)
    zb = plan._mats["z_b"]
    # the sticks before the z stage: the gather alone
    gr = torch.empty_like(sr)
    gi = torch.empty_like(si)
    v = stacked[:, None]
    if plan._t_conj is not None:
        v = v * plan._t_conj
    from spfft_tpu_torch.parallel.dist import _shard_rows
    gather_kernel.gather((v[..., 0], v[..., 1]), plan._t_slot_src,
                         (_shard_rows(gr), _shard_rows(gi)))
    err = compare(f"{path} pdft_last (z)", dft_kernel.pdft_last(gr, gi, zb),
                  dft.pdft_last(gr, gi, zb))
    recs = [long_stage_record(path, "pdft_last", dft_kernel.pdft_last,
                              dft.pdft_last, "cc", (gr, gi), zb, err)]
    grid = plan._exchange((sr, si))
    planes = (-1, dp.dim_y, plan._xf_eff)
    m = plan._mats
    if dp.hermitian:
        hr, hi = stages_mid(grid, planes, m["y_b"])
        xb = m["x_b"]
        err = compare(f"{path} pirdft_last (x)", (dft_kernel.pirdft_last(
            hr, hi, xb),), (dft.pirdft_last(hr, hi, xb),))
        recs.append(long_stage_record(
            path, "pirdft_last", dft_kernel.pirdft_last, dft.pirdft_last,
            "cr", (hr, hi), xb, err, DFT2_SRC, REAL_REPLACES))
        xs = dft.pirdft_last(hr, hi, xb).contiguous()
        xf = m["x_f"]
        err = compare(f"{path} prdft_last (x)", dft_kernel.prdft_last(xs, xf),
                      dft.prdft_last(xs, xf))
        recs.append(long_stage_record(
            path, "prdft_last", dft_kernel.prdft_last, dft.prdft_last, "rc",
            (xs,), xf, err, DFT2_SRC, REAL_REPLACES))
    else:
        gr2, gi2 = grid[0].reshape(planes), grid[1].reshape(planes)
        m1, m2 = m["x_b"], m["y_b"]
        err = compare(f"{path} pdft2_swapped (x long matrix, y fft)",
                      dft_kernel.pdft2_swapped(gr2, gi2, m1, m2),
                      dft.cdft2_xy(gr2, gi2, m1, m2))
        gc = torch.complex(gr2, gi2)
        rec = long_plane_record(
            path, "pdft2_swapped", dft_kernel.pdft2_swapped, dft.cdft2_xy,
            ("cc", "cc"), (gr2, gi2), m1, m2, err,
            lambda: torch.fft.ifft2(gc, norm="forward"))
        rec["source"] = DFT2_SRC
        recs.append(rec)
    for r in recs:  # the pair's launches of the record's forms
        r["launches"] = sum(forms[r["name"]].get(f, 0)
                            for f in r["form"].split("+"))
    print_records(recs)
    return recs


def stages_mid(grid, planes, mats_y):
    """The distributed R2C y stage (``ops.stages._cdft_mid``) on an
    exchanged grid: the half-spectrum planes after the y DFT."""
    from spfft_tpu_torch.ops import stages
    return stages._cdft_mid(grid[0].reshape(planes), grid[1].reshape(planes),
                            mats_y)


#: the CLI runs of ``benchmark_phase``
BENCH_RUNS = (["-d", "256", "-r", "10"],
              ["-d", "256", "-r", "10", "-t", "r2c"],
              ["-d", "256", "-r", "10", "--shards", "4"],
              ["-d", "768", "-s", "0.25", "-r", "5"])


def benchmark_phase(card: str) -> list:
    """``python -m spfft_tpu_torch.benchmark`` in this process for each of
    ``BENCH_RUNS``: exit code 0, its JSON ``parameters`` on the card
    (``backend`` cuda, ``pallas`` true, the card's name and power limit);
    prints each JSON. Returns the parameters."""
    import contextlib
    import io
    from spfft_tpu_torch import benchmark
    out = []
    for argv in BENCH_RUNS:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = benchmark.main(argv)
        text = buf.getvalue()
        if rc != 0:
            fail(f"benchmark {' '.join(argv)} exited {rc}:\n{text[-2000:]}")
        params = json.loads(text[:text.index("\n}\n") + 2])
        if params["backend"] != "cuda" or not params["pallas"] \
                or not params["device_kind"] or not params["power_limit"]:
            fail(f"benchmark {' '.join(argv)}: {params}")
        print(f"benchmark {' '.join(argv)} ({card}; "
              f"{time.perf_counter() - t0:.1f} s with its plan): "
              f"{json.dumps(params)}", flush=True)
        out.append(params)
        torch.cuda.empty_cache()
    return out


def launch_counters() -> dict:
    """Every kernel wrapper, by the name the launch tables use; each
    counts its launches (``.launches``, and by form ``.form_launches``)."""
    from spfft_tpu_torch.ops import dft_kernel, fused_kernel, gather_kernel
    return {"decompress_zdft": fused_kernel.decompress_zdft,
            "pdft2": dft_kernel.pdft2,
            "pdft2_swapped": dft_kernel.pdft2_swapped,
            "prdft2": dft_kernel.prdft2,
            "pdft2_cr": dft_kernel.pdft2_cr,
            "zdft_compress": fused_kernel.zdft_compress,
            "gather": gather_kernel.gather,
            "pdft_last": dft_kernel.pdft_last,
            "prdft_last": dft_kernel.prdft_last,
            "pirdft_last": dft_kernel.pirdft_last}


def run(device, n=N):
    """Every phase after the build on ``device`` at size ``n``, both
    paths; returns the kernel records and the batched sweep's rows."""
    import spfft_tpu_torch as sp
    counters = launch_counters()
    sweep = []
    plan, trip, values = main_path_plan(sp, n, device)
    c2c = kernel_phase(plan, values, device)
    odd_shapes_phase(device)
    fft_odd_shapes_phase(device)
    z_fft_odd_shapes_phase(device)
    oracle = c2c_oracle_rel(plan, trip, values, device)
    set_launches(c2c, pair_phase(sp, "c2c", plan, values, oracle, device,
                                 counters, C2C_LAUNCHES))
    plan2 = sp.TransformPlan(plan.index_plan, device=device, fused=False)
    recs = two_kernel_kernel_phase("c2c", plan2, values, device)
    set_launches(recs, pair_phase(sp, "c2c two-kernel", plan2, values,
                                  oracle, device, counters, C2C_2K_LAUNCHES))
    route_phase(sp, "c2c", plan, plan2, values)
    c2c += recs
    recs = batched_gather_phase("c2c", plan2, values, device)
    set_launches(recs, batched_pair_phase(sp, "c2c two-kernel", plan2,
                                          values, device, counters,
                                          C2C_2K_LAUNCHES))
    c2c += recs
    del plan2
    recs = batched_kernel_phase("c2c", plan, values, device)
    set_launches(recs, batched_pair_phase(sp, "c2c", plan, values, device,
                                          counters, C2C_BATCHED_LAUNCHES))
    c2c += recs
    pointwise_phase(sp, "c2c", plan, values, device)
    sweep_phase(sp, "c2c", plan, values, device, sweep)
    dist = dist_c2c_phases(sp, n, plan, trip, values, oracle, device,
                           counters)
    del plan, trip, values, oracle

    plan, trip, values, oracle = r2c_plan(sp, n, device)
    r2c = r2c_kernel_phase(plan, values, device)
    r2c_odd_shapes_phase(device)

    def oracle_rel(space):
        return float(torch.linalg.norm(space.double() - oracle)
                     / torch.linalg.norm(oracle))

    set_launches(r2c, pair_phase(sp, "r2c", plan, values, oracle_rel,
                                 device, counters, R2C_LAUNCHES))
    plan2 = sp.TransformPlan(plan.index_plan, device=device, fused=False)
    recs = two_kernel_kernel_phase("r2c", plan2, values, device)
    set_launches(recs, pair_phase(sp, "r2c two-kernel", plan2, values,
                                  oracle_rel, device, counters,
                                  R2C_2K_LAUNCHES))
    route_phase(sp, "r2c", plan, plan2, values)
    r2c += recs
    recs = batched_gather_phase("r2c", plan2, values, device)
    set_launches(recs, batched_pair_phase(sp, "r2c two-kernel", plan2,
                                          values, device, counters,
                                          R2C_2K_LAUNCHES))
    r2c += recs
    del plan2
    recs = batched_kernel_phase("r2c", plan, values, device)
    set_launches(recs, batched_pair_phase(sp, "r2c", plan, values, device,
                                          counters, R2C_BATCHED_LAUNCHES))
    r2c += recs
    pointwise_phase(sp, "r2c", plan, values, device)
    sweep_phase(sp, "r2c", plan, values, device, sweep)
    dist += dist_r2c_phases(sp, n, plan, trip, values, oracle_rel, device,
                            counters)
    del plan, trip, values, oracle

    new_odd_shapes_phase(device)
    plan, _, values = main_path_plan(sp, n // 2, device)
    sweep_phase(sp, "c2c", plan, values, device, sweep)
    plan, _, values, _ = r2c_plan(sp, n // 2, device)
    sweep_phase(sp, "r2c", plan, values, device, sweep)
    del plan, values
    return c2c + r2c + dist + double_phases(sp, device, counters, n), sweep


def grid_phase(sp, path, plan, trip, values, device):
    """The double plan through ``Grid`` / ``Transform`` and
    ``multi_transform_backward`` / ``_forward`` of two transforms of one
    plan (one batched execution): each result equal bit for bit to the
    plan's own calls."""
    p = plan.index_plan
    grid = sp.Grid(p.dim_x, p.dim_y, p.dim_z, p.num_sticks,
                   precision=plan.precision, device=device)
    t = grid.create_transform(sp.ProcessingUnit.DEVICE, p.transform_type,
                              p.dim_x, p.dim_y, p.dim_z, indices=trip)
    want = plan.backward(values)
    if t.precision != plan.precision or not torch.equal(t.backward(values),
                                                        want):
        fail(f"{path} Grid transform: backward differs from the plan's")
    full = sp.Scaling.FULL
    pair = [t, t.clone()]
    spaces = sp.multi_transform_backward(pair, [values, values])
    outs = sp.multi_transform_forward(pair, spaces, [full, full])
    want_f = plan.forward(want, full)
    for s_, o in zip(spaces, outs):
        if not (torch.equal(s_, want) and torch.equal(o, want_f)):
            fail(f"{path} multi-transform: a result differs from the "
                 f"plan's")
    print(f"{path} Grid / Transform and multi-transform of 2: equal to the "
          f"plan's calls bit for bit", flush=True)


def double_phases(sp, device, counters, n=N):
    """The phases above for ``precision="double"`` plans, on the kernels'
    float64 instances (records with paths ending in ``_f64``): at the
    paths' 256^3 shapes each kernel against its plain float64 version
    (``DOUBLE_KERNEL_TOL``); the local C2C and R2C pairs on both routes
    against the complex128 oracle within ``predicted_rel_error("double",
    n)``, the round trip within 3 times that, the launches by form of the
    single pairs' tables, the routes bit for bit; B = 4 and pointwise
    calls bit for bit against single calls; ``Grid`` and multi-transform;
    the distributed C2C and R2C plans over 4 shards, both routes, within
    twice ``predicted_rel_error`` of the local plans; and every form at
    odd shapes in float64. Returns the kernel records."""
    f64 = torch.float64
    plan, trip, values = main_path_plan(sp, n, device, "double")
    recs = kernel_phase(plan, values, device, "c2c_f64")
    oracle = c2c_oracle_rel(plan, trip, values, device)
    set_launches(recs, pair_phase(sp, "c2c f64", plan, values, oracle,
                                  device, counters, C2C_LAUNCHES))
    plan2 = sp.TransformPlan(plan.index_plan, precision="double",
                             device=device, fused=False)
    more = two_kernel_kernel_phase("c2c_f64", plan2, values, device)
    set_launches(more, pair_phase(sp, "c2c f64 two-kernel", plan2, values,
                                  oracle, device, counters, C2C_2K_LAUNCHES))
    route_phase(sp, "c2c f64", plan, plan2, values)
    recs += more
    more = batched_gather_phase("c2c_f64", plan2, values, device)
    set_launches(more, batched_pair_phase(sp, "c2c f64 two-kernel", plan2,
                                          values, device, counters,
                                          C2C_2K_LAUNCHES))
    recs += more
    del plan2
    more = batched_kernel_phase("c2c_f64", plan, values, device)
    set_launches(more, batched_pair_phase(sp, "c2c f64", plan, values,
                                          device, counters,
                                          C2C_BATCHED_LAUNCHES))
    recs += more
    pointwise_phase(sp, "c2c f64", plan, values, device)
    grid_phase(sp, "c2c f64", plan, trip, values, device)
    recs += dist_c2c_phases(sp, n, plan, trip, values, oracle, device,
                            counters, "_f64")
    del plan, trip, values, oracle

    plan, trip, values, oracle = r2c_plan(sp, n, device, "double")
    more = r2c_kernel_phase(plan, values, device, "r2c_f64")

    def oracle_rel(space):
        return float(torch.linalg.norm(space.double() - oracle)
                     / torch.linalg.norm(oracle))

    set_launches(more, pair_phase(sp, "r2c f64", plan, values, oracle_rel,
                                  device, counters, R2C_LAUNCHES))
    recs += more
    plan2 = sp.TransformPlan(plan.index_plan, precision="double",
                             device=device, fused=False)
    more = two_kernel_kernel_phase("r2c_f64", plan2, values, device)
    set_launches(more, pair_phase(sp, "r2c f64 two-kernel", plan2, values,
                                  oracle_rel, device, counters,
                                  R2C_2K_LAUNCHES))
    route_phase(sp, "r2c f64", plan, plan2, values)
    recs += more
    more = batched_gather_phase("r2c_f64", plan2, values, device)
    set_launches(more, batched_pair_phase(sp, "r2c f64 two-kernel", plan2,
                                          values, device, counters,
                                          R2C_2K_LAUNCHES))
    recs += more
    del plan2
    more = batched_kernel_phase("r2c_f64", plan, values, device)
    set_launches(more, batched_pair_phase(sp, "r2c f64", plan, values,
                                          device, counters,
                                          R2C_BATCHED_LAUNCHES))
    recs += more
    pointwise_phase(sp, "r2c f64", plan, values, device)
    recs += dist_r2c_phases(sp, n, plan, trip, values, oracle_rel, device,
                            counters, "_f64")
    del plan, trip, values, oracle

    odd_shapes_phase(device, f64)
    fft_odd_shapes_phase(device, f64)
    z_fft_odd_shapes_phase(device, f64)
    r2c_odd_shapes_phase(device, f64)
    new_odd_shapes_phase(device, f64)
    return recs


# -- the C ABI: libspfft_tpu_torch.so ------------------------------------------

#: SpfftTpuPallasMode: AUTO the fused route, OFF the two-kernel route
PALLAS_AUTO, PALLAS_OFF = -1, 0
CAPI_BATCH = 4
#: the C drive's cases (``native/capi_drive.c``), each in a process of its
#: own: name -> (R2C, double, SpfftTpuPallasMode, shards (0: a local
#: plan), batch)
CAPI_CASES = {"c2c": (False, False, PALLAS_AUTO, 0, CAPI_BATCH),
              "c2c_off": (False, False, PALLAS_OFF, 0, 1),
              "r2c": (True, False, PALLAS_AUTO, 0, CAPI_BATCH),
              "c2c_f64": (False, True, PALLAS_AUTO, 0, CAPI_BATCH),
              "dist_c2c": (False, False, PALLAS_AUTO, _S, CAPI_BATCH)}
CAPI_CALLS = ("backward", "forward", "pair", "multi_backward",
              "multi_forward")


def capi_lib(path):
    """The port's library loaded into this process (``RTLD_LOCAL``, it
    shares this interpreter), typed for the calls the phase makes."""
    import ctypes
    c_int, c_ll, vp = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    lib = ctypes.CDLL(str(path))
    sigs = {"spfft_tpu_abi_version": [],
            "spfft_tpu_init": [ctypes.c_char_p],
            "spfft_tpu_plan_create": [vp, c_int, c_int, c_int, c_int, c_ll,
                                      vp, c_int, c_int],
            "spfft_tpu_plan_create_distributed": [
                vp, c_int, c_int, c_int, c_int, c_int, vp, vp, vp, c_int,
                c_int, c_int],
            "spfft_tpu_plan_destroy": [vp],
            "spfft_tpu_backward": [vp, vp, vp],
            "spfft_tpu_forward": [vp, vp, c_int, vp],
            "spfft_tpu_execute_pair": [vp, vp, c_int, vp]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, c_int
    lib.spfft_tpu_error_string.argtypes = [c_int]
    lib.spfft_tpu_error_string.restype = ctypes.c_char_p
    return lib


def capi_check(lib, what, code, want=0):
    if code != want:
        fail(f"C ABI {what} returned {code} "
             f"({lib.spfft_tpu_error_string(code).decode()}), expected "
             f"{want}")


def capi_build():
    """Build the library and compile ``examples/example.c`` (against the
    JAX package's header, unchanged) and ``capi_drive.c`` against it;
    returns their paths and the library's build seconds."""
    from pathlib import Path

    from spfft_tpu_torch import native
    t0 = time.perf_counter()
    lib = native.build_capi()
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    example = native.build_program(
        Path(__file__).resolve().parent / "examples" / "example.c",
        "example_c")
    drive = native.build_program(native.DRIVE, "capi_drive")
    print(f"capi build: libspfft_tpu_torch.so {lib_s:.2f} s, example.c and "
          f"capi_drive.c {time.perf_counter() - t0:.2f} s (g++)", flush=True)
    return lib, example, drive, lib_s


def capi_run(args, what):
    """Run a C program of the C ABI (its own embedded interpreter) with
    this interpreter's site directories and the repository on its path;
    fails unless it exits 0."""
    from spfft_tpu_torch import native
    out = subprocess.run([str(a) for a in args], capture_output=True,
                         text=True, timeout=900, env=native.embed_env())
    if out.returncode != 0:
        fail(f"{what} exited {out.returncode}:\n{out.stdout[-2000:]}\n"
             f"{out.stderr[-4000:]}")
    return out.stdout


def host_ms(fn, device, reps=REPS, warmup=2) -> float:
    """Median host-clock ms of ``fn`` (ended by a synchronize), the C
    drive's protocol: 2 warm-ups, ``reps`` timed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def capi_in_process(sp, lib, device, n, counters):
    """The main path through the C ABI in this process: the 256^3 sphere,
    numpy seed 0, C2C single, PALLAS_AUTO. backward, forward(FULL) and
    execute_pair bit for bit the Python API's on the same host arrays, the
    backward within ``predicted_rel_error`` of the complex128 oracle, the
    launches by form of the C pair and of execute_pair each equal to
    ``C2C_LAUNCHES``; then the error surface on the card. Returns the
    plan creation's seconds and the pair's launches."""
    import ctypes

    from spfft_tpu_torch.utils.workloads import (spherical_cutoff_triplets,
                                                 sort_triplets_stick_major)
    trip = np.ascontiguousarray(sort_triplets_stick_major(
        spherical_cutoff_triplets(n), (n, n, n)), np.int32)
    rng = np.random.default_rng(SEED)
    m = len(trip)
    values = np.ascontiguousarray(torch.view_as_real(torch.from_numpy(
        (rng.standard_normal(m) + 1j * rng.standard_normal(m))
        .astype(np.complex64))).numpy())
    h = ctypes.c_void_p()
    t0 = time.perf_counter()
    capi_check(lib, "plan_create", lib.spfft_tpu_plan_create(
        ctypes.addressof(h), 0, n, n, n, m, trip.ctypes.data, 0,
        PALLAS_AUTO))
    create_s = time.perf_counter() - t0
    plan = sp.make_local_plan(sp.TransformType.C2C, n, n, n, trip,
                              device=device)
    space = np.empty((n, n, n, 2), np.float32)
    fwd, pair = np.empty_like(values), np.empty_like(values)
    reset_launches(counters)
    capi_check(lib, "backward", lib.spfft_tpu_backward(
        h, values.ctypes.data, space.ctypes.data))
    capi_check(lib, "forward", lib.spfft_tpu_forward(
        h, space.ctypes.data, 1, fwd.ctypes.data))
    launches = read_launches("capi c2c", counters, C2C_LAUNCHES)
    reset_launches(counters)
    capi_check(lib, "execute_pair", lib.spfft_tpu_execute_pair(
        h, values.ctypes.data, 1, pair.ctypes.data))
    read_launches("capi c2c execute_pair", counters, C2C_LAUNCHES)
    full = sp.Scaling.FULL
    for what, got, want in (
            ("backward", space, plan.backward(values)),
            ("forward(FULL)", fwd, plan.forward(space, full)),
            ("execute_pair", pair, plan.apply_pointwise(values,
                                                        scaling=full))):
        if not np.array_equal(got, want.cpu().numpy()):
            fail(f"capi c2c {what} differs from the Python API's on the "
                 f"same host arrays")
    rel = c2c_oracle_rel(plan, trip, torch.from_numpy(values).to(device),
                         device)(torch.from_numpy(space).to(device))
    pred = sp.predicted_rel_error("single", n, True)
    print(f"capi c2c in process: plan_create {create_s:.2f} s; backward, "
          f"forward(FULL), execute_pair bit for bit the Python API's; "
          f"backward vs complex128 oracle rel_l2={rel:.3e} "
          f"(predicted_rel_error={pred:.3e})", flush=True)
    if not rel <= pred:
        fail(f"capi c2c backward rel_l2 {rel:.3e} above {pred:.3e}")

    # the error surface on the card
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition)
    parts = round_robin_stick_partition(trip, (n, n, n), _S)
    dtrip = np.ascontiguousarray(np.concatenate(parts), np.int32)
    vps = np.array([len(p) for p in parts], np.int64)
    pps = np.array(even_plane_split(n, _S), np.int32)
    d = ctypes.c_void_p()
    capi_check(lib, "plan_create_distributed(COMPACT_BUFFERED)",
               lib.spfft_tpu_plan_create_distributed(
                   ctypes.addressof(d), 0, n, n, n, _S, vps.ctypes.data,
                   dtrip.ctypes.data, pps.ctypes.data, 0, 3, PALLAS_AUTO), 5)
    capi_check(lib, "backward(invalid handle)", lib.spfft_tpu_backward(
        12345, values.ctypes.data, space.ctypes.data), 2)
    bad = np.array([[n, 0, 0]], np.int32)
    capi_check(lib, "plan_create(bad index)", lib.spfft_tpu_plan_create(
        ctypes.addressof(d), 0, n, n, n, 1, bad.ctypes.data, 0,
        PALLAS_AUTO), 7)
    capi_check(lib, "plan_destroy", lib.spfft_tpu_plan_destroy(h))
    print("capi error surface on the card: COMPACT_BUFFERED -> 5, invalid "
          "handle -> 2, out-of-bounds index -> 7", flush=True)
    return create_s, launches


def capi_case_inputs(sp, n, r2c, double, shards, batch, device):
    """A drive case's triplets (the sphere, or its non-redundant half;
    per-shard lists concatenated for a distributed case), its ``batch``
    value sets (numpy seeds SEED, SEED + 1, ...) and its Python plan."""
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition,
                                                 spherical_cutoff_triplets,
                                                 sort_triplets_stick_major)
    trip = spherical_cutoff_triplets(n)
    if r2c:
        x, y, z = trip.T
        trip = trip[(x > 0) | ((x == 0) & ((y > 0) | ((y == 0)
                                                      & (z >= 0))))]
    trip = sort_triplets_stick_major(trip, (n, n, n))
    kind = sp.TransformType.R2C if r2c else sp.TransformType.C2C
    precision = "double" if double else "single"
    if shards:
        parts = round_robin_stick_partition(trip, (n, n, n), shards)
        trip = np.concatenate(parts)
        plan = sp.make_distributed_plan(kind, n, n, n, parts,
                                        even_plane_split(n, shards),
                                        mesh=sp.make_mesh(shards, device),
                                        precision=precision)
    else:
        plan = sp.make_local_plan(kind, n, n, n, trip, precision=precision,
                                  device=device)
    vals = np.stack([np.random.default_rng(SEED + b).standard_normal(
        (len(trip), 2)) for b in range(batch)]).astype(
            np.float64 if double else np.float32)
    return np.ascontiguousarray(trip, np.int32), vals, plan


def capi_case_refs(sp, plan, vals, device):
    """The Python API's results for a drive case, in the C layout on the
    host: backward of each value set, forward(FULL) of each, execute_pair
    (FULL) of the first; and the API's times, ``(on host arrays,
    device-resident)`` ms per call (per band for a batch) in the drive's
    protocol. On host arrays: numpy in (a distributed plan's per-shard
    lists), the result copied into a host buffer."""
    full = sp.Scaling.FULL
    dist = hasattr(plan, "dist_plan")
    batch = len(vals)
    if dist:
        dp = plan.dist_plan
        counts = [p.num_values for p in dp.shard_plans]
        host_in = [np.split(v, np.cumsum(counts)[:-1]) for v in vals]

        def c_space(s):
            return torch.cat([s[r, :k] for r, k in enumerate(dp.num_planes)])

        def c_values(o):
            return torch.cat([o[r, :k] for r, k in enumerate(counts)])

        def host_space(s):
            s = s.cpu().numpy()
            return [s[r, :k] for r, k in enumerate(dp.num_planes)]
        dev_in = [plan.shard_values(v) for v in host_in]
        dev_b = torch.stack(dev_in, dim=1)
    else:
        host_in = list(vals)

        def c_space(s):
            return s

        def c_values(o):
            return o.t() if plan.pair_values_io else o

        def host_space(s):
            return s.cpu().numpy()
        dev_in = [torch.from_numpy(v).to(device) for v in vals]
        dev_b = torch.stack(dev_in)
    spaces = [plan.backward(v) for v in dev_in]
    refs = {"backward": np.stack([c_space(s).cpu().numpy() for s in spaces]),
            "forward": np.stack([c_values(plan.forward(s, full)).cpu().numpy()
                                 for s in spaces]),
            "pair": np.ascontiguousarray(c_values(plan.apply_pointwise(
                dev_in[0], scaling=full)).cpu().numpy())}
    sp_host = [host_space(s) for s in spaces]
    space_buf = torch.empty(spaces[0].shape, dtype=spaces[0].dtype)
    val_buf = torch.empty(dev_in[0].shape, dtype=spaces[0].dtype)
    calls = {
        "backward": (lambda: space_buf.copy_(plan.backward(host_in[0])),
                     lambda: plan.backward(dev_in[0])),
        "forward": (lambda: val_buf.copy_(plan.forward(sp_host[0], full)),
                    lambda: plan.forward(spaces[0], full)),
        "pair": (lambda: val_buf.copy_(plan.apply_pointwise(
                     host_in[0], scaling=full)),
                 lambda: plan.apply_pointwise(dev_in[0], scaling=full))}
    if batch > 1:
        space_b = plan.backward_batched(dev_b)
        space_b_buf = torch.empty(space_b.shape, dtype=space_b.dtype)
        val_b_buf = torch.empty(dev_b.shape, dtype=dev_b.dtype)
        # a local plan takes a batch staged in one host array, moved in
        # one copy (``batch_row_template``); a distributed one, the lists
        host_b = (host_in, sp_host) if dist else (vals, np.stack(sp_host))
        calls["multi_backward"] = (
            lambda: space_b_buf.copy_(plan.backward_batched(host_b[0])),
            lambda: plan.backward_batched(dev_b))
        calls["multi_forward"] = (
            lambda: val_b_buf.copy_(plan.forward_batched(host_b[1], full)),
            lambda: plan.forward_batched(space_b, full))
    ms = {}
    for call, (host_fn, dev_fn) in calls.items():
        per = batch if call.startswith("multi") else 1
        ms[call] = (host_ms(host_fn, device) / per,
                    host_ms(dev_fn, device) / per)
    return refs, ms


def capi_drive_phase(sp, drive, device, n, smi):
    """Each case of :data:`CAPI_CASES` through ``capi_drive`` (a process
    of its own, its own embedded interpreter): every output bit for bit
    the Python API's on the same inputs (the two-kernel case also the
    fused case's), and each call's time beside the Python API's on host
    arrays and on device-resident ones, with the bytes the call moves
    over PCIe. Returns the rows ``PERF.md`` records."""
    import shutil

    from spfft_tpu_torch import native
    root = native.BUILD_DIR / "drive"
    rows = {}
    fused_refs = None
    for name, (r2c, double, pallas, shards, batch) in CAPI_CASES.items():
        trip, vals, plan = capi_case_inputs(sp, n, r2c, double, shards,
                                            batch, device)
        if pallas == PALLAS_OFF:
            plan = sp.TransformPlan(plan.index_plan, device=device,
                                    fused=False, precision=plan.precision)
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "case.txt").write_text(
            f"{int(r2c)} {n} {n} {n} {int(double)} {pallas} {shards} "
            f"{batch}\n")
        trip.tofile(d / "triplets.bin")
        vals.tofile(d / "values.bin")
        if shards:
            dp = plan.dist_plan
            (d / "shards.bin").write_bytes(
                np.array([p.num_values for p in dp.shard_plans],
                         np.int64).tobytes()
                + np.array(dp.num_planes, np.int32).tobytes())
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out = capi_run([drive, d], f"capi_drive {name}")
        line = [ln for ln in out.splitlines() if ln.startswith("capi_drive")]
        c_ms = {k: float(v) for k, v in re.findall(
            r"(\w+)_(?:ms|s)=([0-9.]+)", line[-1])}
        refs, py_ms = capi_case_refs(sp, plan, vals, device)
        files = {"backward": refs["backward"][0], "forward":
                 refs["forward"][0], "pair": refs["pair"]}
        if batch > 1:
            files["multi_backward"] = refs["backward"]
            files["multi_forward"] = refs["forward"]
        for call, want in files.items():
            got = np.fromfile(d / f"{call}.bin", want.dtype)
            if got.size != want.size or not np.array_equal(
                    got, want.reshape(-1)):
                fail(f"capi_drive {name} {call} differs from the Python "
                     f"API's on the same inputs")
            if fused_refs is not None and name == "c2c_off" and \
                    not np.array_equal(got, fused_refs[call].reshape(-1)):
                fail(f"capi_drive c2c_off {call} differs from the fused "
                     f"route's (c2c)")
        if name == "c2c":
            fused_refs = files
        shutil.rmtree(d, ignore_errors=True)
        vbytes = vals[0].nbytes
        sbytes = refs["backward"][0].nbytes
        moves = {"backward": (vbytes, sbytes), "forward": (sbytes, vbytes),
                 "pair": (vbytes, vbytes),
                 "multi_backward": (vbytes, sbytes),
                 "multi_forward": (sbytes, vbytes)}
        row = {"create_s": c_ms["create"]}
        for call in CAPI_CALLS:
            if call not in py_ms:
                continue
            to_card, back = moves[call]
            c = c_ms[call]
            host, dev = py_ms[call]
            row[call] = {"c_ms": c, "python_host_ms": host,
                         "python_device_ms": dev, "h2d_bytes": to_card,
                         "d2h_bytes": back}
            print(f"capi {name} {call}{' per band' if call in CAPI_CALLS[3:] else ''}: "
                  f"C {c:.4f} ms, Python API on host arrays {host:.4f} ms, "
                  f"device-resident {dev:.4f} ms; {to_card / 1e6:.2f} MB to "
                  f"the card + {back / 1e6:.2f} MB back = "
                  f"{(to_card + back) / c / 1e6:.2f} GB/s through C "
                  f"({smi})", flush=True)
        print(f"capi {name}: plan_create through C {c_ms['create']:.2f} s, "
              f"every output bit for bit the Python API's"
              + (" and the fused route's" if name == "c2c_off" else "")
              + f" ({smi})", flush=True)
        rows[name] = row
        del plan, vals, refs
    return rows


def capi_copy_rates(device, nbytes: int, smi: str) -> dict:
    """GB/s of one host-to-device and one device-to-host copy of
    ``nbytes`` (the 256^3 C2C space's 134.2 MB), from pageable host memory
    (what a C caller's buffers are, and what the C ABI copies from and
    into) and from pinned memory: what the C ABI's copies could reach.
    Host clock, the drive's protocol."""
    if device.type != "cuda":
        return {}
    dev = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    rates = {}
    for kind, pin in (("pageable", False), ("pinned", True)):
        host = torch.ones(nbytes // 4, dtype=torch.float32, pin_memory=pin)
        rates[kind] = {
            "h2d_gb_s": nbytes / host_ms(lambda: dev.copy_(host), device)
            / 1e6,
            "d2h_gb_s": nbytes / host_ms(lambda: host.copy_(dev), device)
            / 1e6}
    print(f"capi host copies of {nbytes / 1e6:.1f} MB: pageable "
          f"{rates['pageable']['h2d_gb_s']:.2f} GB/s to the card, "
          f"{rates['pageable']['d2h_gb_s']:.2f} back; pinned "
          f"{rates['pinned']['h2d_gb_s']:.2f} / "
          f"{rates['pinned']['d2h_gb_s']:.2f} ({smi})", flush=True)
    return rates


def capi_phase(sp, device, counters, smi, n=N):
    """The C ABI: build the library (its seconds), compile and run
    ``examples/example.c`` (must print OK), the main path in this process
    (:func:`capi_in_process`), then :func:`capi_drive_phase`. Returns the
    ``{"capi": ...}`` record."""
    from spfft_tpu_torch import capi_bridge
    os.environ[capi_bridge.DEVICE_ENV] = device.type
    lib_path, example, drive, lib_s = capi_build()
    out = capi_run([example], "examples/example.c")
    if not out.strip().endswith("OK"):
        fail(f"examples/example.c did not print OK:\n{out}")
    print("capi examples/example.c (built against include/spfft_tpu.h, "
          "linked to libspfft_tpu_torch.so): OK", flush=True)
    lib = capi_lib(lib_path)
    capi_check(lib, "abi_version", lib.spfft_tpu_abi_version(), 2)
    capi_check(lib, "init", lib.spfft_tpu_init(None))
    create_s, launches = capi_in_process(sp, lib, device, n, counters)
    rows = capi_drive_phase(sp, drive, device, n, smi)
    rates = capi_copy_rates(device, n ** 3 * 8, smi)
    return {"build_s": lib_s, "in_process_create_s": create_s,
            "in_process_launches": launches, "cases": rows,
            "copy_rates": rates, "card": smi}


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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
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
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                print(f"ptxas {name}: {line.strip()}", flush=True)

    device = torch.device("cuda", torch.cuda.current_device())
    recs, sweep = run(device)
    import spfft_tpu_torch as sp
    t_long = time.perf_counter()
    recs += long_axes_phase(sp, device, launch_counters())
    for dtype in (torch.float32, torch.float64):
        long_odd_shapes_phase(sp, device, launch_counters(), dtype)
    recs += long_plans_phase(sp, device, launch_counters())
    print(f"long-axis phases: {time.perf_counter() - t_long:.1f} s",
          flush=True)
    bench = benchmark_phase(card)
    capi = capi_phase(sp, device, launch_counters(), card)
    print(json.dumps({"batched_sweep": sweep}), flush=True)
    print(json.dumps({"benchmark": bench}), flush=True)
    print(json.dumps({"capi": capi}), flush=True)
    print(json.dumps({"design_bound_ms": DESIGN_BOUND_MS}), flush=True)
    print(f"chip_smoke: wall time {time.perf_counter() - T_START:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
