#!/usr/bin/env python3
"""Drive spfft_tpu_torch on one CUDA card and hold every kernel to its
plain PyTorch version.

    python3 chip_smoke.py
    python3 chip_smoke.py --ptxas-of TREE   # another tree's ptxas report
    python3 chip_smoke.py --examples        # the build, the examples phase

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
   length, radix 7 and 11 halves too, the Bluestein form at odd lengths
   and halves with a prime of 13 or more, plain pairs in the matrix form,
   windows
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
11b. the exchanges of the distributed plan on the same 256^3 index plans
   over 4 shards (``exchange_phases``, each kind a plan of its own): the
   lossless kinds (``BUFFERED``, ``UNBUFFERED``, ``COMPACT_BUFFERED`` ragged
   and with ``SPFFT_TPU_COMPACT_PPERMUTE=1`` the op schedule, and
   ``overlap_chunks`` 2 and 4 of the block, ragged and op kinds), C2C and
   R2C, fused and two-kernel: each counted pair with its gather launches
   (``EXCHANGE_GATHERS``), backward and forward(FULL) bit for bit the
   ``BUFFERED`` plan's, its ms per call and on the device, its staged
   exchange steps and wire bytes; the wire cases (``WIRE_CASES``:
   ``BUFFERED_FLOAT``, ``COMPACT_BUFFERED_FLOAT``, ``wire_precision`` 1, 2,
   3, int8 at K = 2 and on the ring, int8 declined on the ragged layout)
   with their rung and declines, the backward within ``max(4 *
   wire_probe_error, predicted_rel_error)`` of the complex128 oracle, the
   int8 kernels K launches a direction, K = 2 int8 bit for bit K = 1;
   ``csrc/wire.cu`` at the path's blocks both directions against its plain
   version (payloads, scales and dequantized values identical; records
   ``wire_quantize`` / ``wire_dequantize``), the ragged exchange's three
   gathers (records ``gather_ragged_*``); the distributed batched sweep
   (``{"dist_batched_sweep": [...]}``, which
   ``multi.FUSED_BATCH_MAX_DIST_TOTAL`` rests on: 128^3 and 256^3, B in
   {2, 4, 8}); in double the lossless kinds on the fused C2C route and
   ``wire.cu``'s float64 records; then a skewed split of the C2C sphere
   (sticks 40 / 30 / 20 / 10 %, contiguous stick-major; planes 112 / 80 /
   40 / 24: ``exchange_skew_phase``), the ragged wire bytes against the
   padded ones (below half) and each kind's pair and exchange ms. Rows
   in ``{"exchange": [...]}``, each with the card's name and power limit;
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
   after); every distributed exchange code 1-5 creating and running a
   plan (the lossless ones bit for bit BUFFERED's backward); the error
   surface on the card (exchange code 42 -> 5, an
   invalid handle -> 2, an out-of-bounds index -> 7); then
   ``capi_drive`` in one process for every case (its own embedded
   interpreter; only the first case's ``plan_create`` is a cold start):
   C2C single on ``PALLAS_AUTO`` and ``PALLAS_OFF`` (the
   latter also bit for bit the former), R2C single, C2C double and
   distributed C2C over 4 shards, each with ``multi_backward`` /
   ``multi_forward`` at B = 4 under one handle (but ``PALLAS_OFF``),
   every output bit for bit the Python API's on the same inputs; each
   call's host-clock ms (the drive's median of 10 after 2 warm-ups)
   beside the Python API's on host arrays and on device-resident ones,
   and the bytes over PCIe with the GB/s they imply, each line with the
   card's name and power limit; and the rate of one 134.2 MB copy each
   way from pageable and from pinned host memory;
13b. the example programs and the ``make ci`` programs over the port
   (``examples_phase``, after the C ABI; ``--examples`` runs it alone
   after the build): (a) each of ``examples_torch/`` as a process on the
   card, ``example_multihost.py`` also as two processes over a localhost
   coordinator (one card, gloo), (b) ``scripts/torch_multihost_smoke.py``,
   every process loading the libraries this script built (none built
   again), each exiting 0 with its last line, its lines and seconds
   printed; beside them in this process (c) ``example_scf.py``'s loop at
   256^3 (the main path's sphere), each step's launches (``decompress_zdft``
   1, ``pdft2`` 2, ``zdft_compress`` 1) and builds (none after step 0),
   steps 0 and 1 within ``predicted_rel_error("single", 256)`` of a
   complex128 computation of the same step on the host, and (d) the
   precision matrix (``scripts/torch_precision_matrix.py``'s functions):
   single at 64, 128 and 256, C2C and R2C, both indexings up to 128,
   double at 64 and 128, and the three adversarial cases, every row at
   most its bar (1e-6, 2e-11); a row above ``predicted_rel_error`` is
   printed as such. Its numbers in ``{"examples": {...}}``;
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
   521, 997 and 1021 (Bluestein's FFT, ``csrc/bluestein.cu``), 1024,
   1080, 2016 (42 x 48: a radix-7 factor in shared memory beside a float
   register factor above 32), 2048, 4097, 4480 and 8192 (above the
   one-launch kernel's 4096: pass 1, then pass 2; 4480 = 64 x 70 has a 7
   in pass 2) and 1031 (``torch.fft``, counted by form only), whole and
   windowed, both signs; the plane wrappers with long stages (8192 and
   5200 in two launches); the real stages at 520 and 1022 (Bluestein),
   1000, 1024 (the real FFT at half 512) and 1031, whole and windowed;
   each call's launches by form; then plans (``long_plans_phase``):
   distributed C2C (521, 64, 1024) and R2C (1022, 64, 520) over 4 shards
   against the local plan (2e-6 in float32, twice
   ``predicted_rel_error`` in float64), the local plan's backward within
   ``predicted_rel_error`` of its oracle, with records of their long
   forms in both precisions, and a local double C2C (768, 64, 1024)
   against its oracle; the float64 records of the 768^3 stages
   (``long_f64_records``: random rows at the path's shapes);
15b. the lengths up to 512 that ran the matrix form before radix 7 / 11
   and Bluestein below 513, float32 and float64, each record one call
   counted alone against its plain version and beside the matrix form on
   the same inputs and one ``torch.fft`` call: ``radix_records`` (row 7M,
   ``pdft_last`` at 448 = 2^6 x 7, a length the reference's
   ``good_fft_order`` admits, over a 448^3 sphere's 157,696 z sticks; at
   352, 462 and 343; ``pdft2`` on 112^3 in two stage launches; kernel A
   at 896 = 28 x 32 beside its factor 28 on the direct DFT path),
   ``bluestein_small_records`` (Bluestein at 13, 26, 52, 100, 257, 416,
   509 complex, 135, 375, 510 both real modes), ``fused_prime_records``
   (the fused z kernels' Bluestein form, both directions, at dim_z 416,
   13 and 509, each beside the matrix form on a plain pair, gather +
   Bluestein and one ``torch.fft`` call), ``prime_path_phase`` (the 416^3
   C2C pair, fused and two-kernel, every stage in the Bluestein form,
   against the complex128 oracle within ``predicted_rel_error("single",
   416)`` = 3.571e-7), and ``length_phases``: the 448^3 C2C path (47,077,534
   values) and R2C half sphere, each kernel at its shapes beside the
   matrix form, and the counted pairs against the complex128 oracle
   within ``predicted_rel_error("single", 448)`` = 3.606e-7, no launch in
   the matrix form, then both again in float64 on the same index plans
   (``*_f64``, within ``predicted_rel_error("double", 448)``); the local
   R2C plan at 375^3, whose odd x takes Bluestein: each kernel at its
   shapes against its plain version (``prdft2`` / ``pdft2_cr`` in
   Bluestein's rc / cr modes with stores transposed within planes, the
   fused z kernels at dim_z 375) in float32, and its counted pair within
   3.524e-7;
16. the benchmark CLI (``benchmark_phase``): ``spfft_tpu_torch.benchmark
   .main`` in this process at ``-d 256 -r 10`` (C2C), ``-t r2c``,
   ``--shards 4``, ``--shards 4 -e compact --overlap-chunks 2``, ``--shards
   4 -e all`` (its five ``exchange_sweep`` rows) and ``-d 768 -s 0.25 -r
   5``, each JSON printed;
17. one JSON line ``{"batched_sweep": [...]}``, one
   ``{"dist_batched_sweep": [...]}``, one ``{"exchange": [...]}``, one
   ``{"benchmark":
   [...]}`` (phase 16's parameters), the obs, serving, pod and control
   phases' ``{"obs"|"serve"|"pod"|"control"|"examples": {...}}``, one
   ``{"capi": {...}}``
   (phase 13's numbers), one ``{"design_bound_ms": {...}}``, the
   script's wall time, one ``{"kernels": [...]}`` (every kernel record
   of every path, float32 and float64, each with its ``path`` and
   ``dtype``) and, last, one JSON line ``{"ok": true, "device":
   {...}}``.

After the 256^3 paths come the observability, fault and plan-surface
phases, the serving phase (``serve_phase``: a ``ServeExecutor`` over the
256^3 sphere, ``{"serve": ...}``) and the pod phase (``pod_phase``,
``{"pod": ...}``): (a) a loopback ``PodFrontend`` of two prewarmed lanes
over the sphere's local plan and its 4-shard plan, 3 bursts of 32 single
and 16 distributed backward requests from 4 threads, then their
forward(FULL), every result bit for bit its direct plan call, each local
bucket launching the direction's fused z kernel and ``pdft2`` once and
each coalesced distributed round the fused z kernel once per shard and
``pdft2_swapped`` once; (b) ``net.smoke.run_pod_smoke`` with agent
processes on the card (the JAX smoke's trace at 256^3 bit for bit,
agent-side coalescing, three 256^3 requests one at a time with their
steps timed apart; then, at 32^3, a warm join with ``builds == 0``,
``kill -9`` failover, self-heal and readmission, a drain-leave) and
``wire_overhead_probe``. Then the control phase (``control_phase``,
``{"control": ...}``), each CLI a process of its own: (a) ``python -m
spfft_tpu_torch.serve.bench`` at 256^3 (96 requests over three
signatures, the controller and the SLO watchdog on), 24 requests bit
for bit the serial calls and each plan execution one launch of
``decompress_zdft`` and ``pdft2``; (b) ``python -m
spfft_tpu_torch.control tune --quick`` and a ``--config`` replay (both at
128^3); (c) ``--smoke --control``, ``--fault-smoke --devices 2``, ``--chaos
7``; (d) ``python -m spfft_tpu_torch.obs demo``, ``validate``, ``prom``
and ``incident --peer`` against an agent process.

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
The FFT forms take radices 4, 2, 3, 5, 7 and 11. A stage whose length
(for a real stage: an odd length, or its half) has a prime factor of 13
or more runs Bluestein's FFT (form ``bluestein``); a stage whose
matrices do not carry their function, and a fused z kernel at such a
dim_z, compute the DFT as a matrix product (form ``matrix``). Each
counted pair checks the launches of each wrapper by
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


#: calls of one CUDA graph in :func:`graph_ms`: a kernel's (few, to hold
#: the run's wall time), and a whole pair's
GRAPH_CALLS = 10
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
    real FFT and cluster forms read the (2, n) twiddle table, the
    Bluestein form its chirp, spectrum and twiddles, the matrix form the
    matrix pair, each in the tables' real type."""
    if form == "bluestein":
        return sum(t.numel() * t.element_size() for t in mats.bluestein)
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
         "bluestein": "spfft_tpu_torch/csrc/fused_bluestein.cu",
         "matrix": "spfft_tpu_torch/csrc/fused_compress.cu"}
DEC_REPLACES = "spfft_tpu/ops/fused_kernel.py:587"
CMP_REPLACES = "spfft_tpu/ops/fused_kernel.py:783"


def complex_of(t: torch.Tensor) -> torch.dtype:
    """The complex dtype of ``t``'s real type."""
    return torch.complex128 if t.dtype == torch.float64 else torch.complex64


def matrix_pair(mats):
    """The same function as a plain matrix pair, without the function it
    carries: a wrapper runs its matrix form (``csrc/dft2.cu``) on it, the
    "before" of the FFT forms. A stage whose form holds no pair (the
    Bluestein form) gets the pair the matrix builders give its function,
    bit for bit the pair its matrix form held."""
    if len(mats):
        return (mats[0], mats[1])
    from spfft_tpu_torch.ops import dft
    t = mats.bluestein.chirp
    if mats.kind == "c2c":
        m = dft.device_c2c(mats.n, mats.sign, mats.scale, rows=mats.rows,
                           cols=mats.cols, device=t.device, dtype=t.dtype,
                           form="matrix")
        return (m[0], m[1])
    xf = mats.n // 2 + 1
    win = mats.cols if mats.kind == "r2c" else mats.rows
    idx = tuple(int(i) for i in (win[0] + np.arange(win[1])) % xf)
    build = dft.sub_cols_r2c_mats if mats.kind == "r2c" \
        else dft.sub_rows_c2r_mats
    return dft.device_mats(build(mats.n, idx, mats.scale,
                                 dft.NP_REAL[t.dtype]), t.device, t.dtype)


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
    t0 = time.perf_counter()
    trip, values = c2c_inputs(n, device, precision)
    plan = sp.make_local_plan(sp.TransformType.C2C, n, n, n, trip,
                              precision=precision, device=device)
    check_native(f"c2c {n}^3 plan", [plan.index_plan])
    print(f"plan: C2C {n}^3 sphere, {precision}, "
          f"{plan.num_local_elements} values in "
          f"{plan.index_plan.num_sticks} sticks, split_x={plan.split_x}, "
          f"pair_io={plan.pair_values_io}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan, trip, values


def c2c_inputs(n, device, precision="single"):
    """The C2C path's set (the n^3 sphere, stick-major) and its values
    ``(N, 2)`` from numpy seed ``SEED`` on ``device``, as
    :func:`main_path_plan` describes them."""
    from spfft_tpu_torch.utils.workloads import \
        spherical_cutoff_triplets_stick_major
    trip = spherical_cutoff_triplets_stick_major(n)
    rng = np.random.default_rng(SEED)
    m = len(trip)
    vals = (rng.standard_normal(m) + 1j * rng.standard_normal(m)) \
        .astype(np.complex64 if precision == "single" else np.complex128)
    return trip, torch.view_as_real(torch.from_numpy(vals)).to(device)


def check_native(what, index_plans):
    """Fail where an index plan that could take the native planner was
    built by another (the numpy planner runs only where asked for, or
    for a hermitian set with its x < 0 half)."""
    for p in index_plans:
        if p.planner != "native":
            fail(f"{what}: planned by {p.planner} ({p.planner_reason}), "
                 f"not the native planner")


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
    recs.append(pdft2_record(path, "pdft2", (gr, gi), m1, m2, err))
    form = recs[-1]["form"]
    ms2 = timed_ms(lambda: fft_two_launch((gr, gi), m1, m2), device)
    print(f"{path} pdft2 backward in the two-launch FFT form: {ms2:.4f} ms "
          f"(reference; the path takes form {form}), max_abs_err against "
          f"the {form} form {two[0]:.3e}", flush=True)

    recs.append(zdft_compress_record(path, plan, fgot, device))
    print_records(recs)
    return recs


def pdft2_record(path, name, ins, m1, m2, err):
    """The record of ``pdft2`` on planes ``ins`` ``(P, A, B)`` over B
    (``m1``) then A (``m2``), backward transforms, in the forms
    ``plane_forms`` gives, with one ``torch.fft.ifft2`` call as the
    library yardstick and the matrix form on the same inputs; the design
    bound of the two-launch FFT form moves the intermediate once more."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    gr, gi = ins
    gc = torch.complex(gr, gi)
    pp, a, b = gr.shape
    b_out, a_out = dft.mats_shape(m1)[1], dft.mats_shape(m2)[1]
    forms = dft_kernel.plane_forms(m1, m2, a)
    e = gr.element_size()
    nbytes = 2 * pp * a * b * e + 2 * pp * b_out * a_out * e \
        + plane_table_bytes(m1, m2, forms)
    flops = fft_flops(pp * a, b) + fft_flops(pp * b_out, a)
    return kernel_record(
        path, name, FFT_SRC, "spfft_tpu/ops/dft_kernel.py:277", err,
        lambda: dft_kernel.pdft2(gr, gi, m1, m2),
        lambda: dft.pdft2_minor(gr, gi, m1, m2),
        (lambda: torch.fft.ifft2(gc, norm="forward")
         .transpose(-1, -2).contiguous())
        if (b_out, a_out) == (b, a) else None,
        nbytes, flops,
        flops if set(forms) <= {"fft", "cluster"}
        else FLOP_PER_CMAC * pp * (a * b * b_out + b_out * a * a_out),
        "+".join(forms),
        lambda: dft_kernel.pdft2(gr, gi, matrix_pair(m1), matrix_pair(m2)),
        nbytes + 2 * 2 * pp * b_out * a * e if len(forms) == 2 else None)


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
    7, 11, 12, 45, 49, 60, 77, 100, 121, 128, 343, 384, 448, 462, 512),
    ragged row counts, input and output windows (wrapped), both signs and
    a scale, at primes of 13 or more (13, 509) in the Bluestein form and
    in the matrix form (a plain pair); ``pdft2`` and ``pdft2_swapped`` in
    the cluster form (P = 1, A not a multiple of 8, rectangular,
    windowed, 3·5-smooth, a ragged 129-row K), the two-launch FFT form
    (512² planes, and every plane with radix 7 or 11: 56², 112², 448²,
    7 x 300), a Bluestein + FFT call and the matrix form; ``prdft2`` and
    ``pdft2_cr`` with their complex half in the FFT form."""
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
            ((21,), 13, 1, 1.0, {}), ((4,), 11, -1, 0.5, {"rows": (9, 4)}),
            ((33,), 7, 1, 1.0, {}), ((17,), 49, -1, 1.0, {"cols": (40, 30)}),
            ((9,), 77, 1, 1 / 77, {}), ((5, 3), 121, -1, 1.0,
                                        {"rows": (100, 50)}),
            ((1001,), 343, 1, 1.0, {}), ((65,), 448, -1, 0.25,
                                         {"rows": (440, 100)}),
            ((7,), 462, 1, 1.0, {"cols": (450, 30)}),
            ((3,), 352, -1, 1.0, {}), ((11,), 509, 1, 1.0,
                                       {"rows": (500, 20)})):
        m = c2c(n, sign, scale, **window)
        k = dft.mats_shape(m)[0]
        xr, xi = rand(*lead, k), rand(*lead, k)
        for mm, want_form in ((m, dft.c2c_form(n)),
                              (matrix_pair(m), "matrix")):
            if mm is not m and n not in (11, 13, 448):
                continue  # the matrix form at a few lengths
            got, forms = forms_of(dft_kernel.pdft_last,
                                  lambda: dft_kernel.pdft_last(xr, xi, mm))
            if dft_kernel.stage_form(mm) != want_form or (
                    on_card and forms != {want_form: 1}):
                fail(f"pdft_last n={n}: form {forms}, expected {want_form}")
            compare(f"pdft_last {lead + (k,)} n={n} {window} form "
                    f"{want_form}", got, dft.pdft_last(xr, xi, mm))
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
        ((2, 7, 300), c2c(300, -1), c2c(7, -1), ("fft", "fft")),
        ((3, 56, 56), c2c(56, 1), c2c(56, -1, 1 / 56), ("fft", "fft")),
        ((2, 100, 112), c2c(112, -1), c2c(112, -1, rows=(0, 100)),
         ("fft", "fft")),
        ((1, 448, 448), c2c(448, 1), c2c(448, 1), ("fft", "fft")),
        ((2, 11, 13), c2c(13, 1), c2c(11, 1), ("bluestein", "fft")),
        ((2, 11, 13), matrix_pair(c2c(13, 1)), matrix_pair(c2c(11, 1)),
         ("matrix", "matrix")))
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
    launch counts: every radix (dim_z 1, 2, 3, 4, 5, 7, 8, 11, 12, 60, 77,
    100, 128, 384, 448, 512), and their Bluestein form at 13, 26, 509 and
    491 (M = 25, 54, 1024, 1024: every factor a thread's register row, in
    float64 too; the lengths' own z tables, as a plan builds them); one
    transform and B = 3 (each band bit for bit against its single
    launch); both value layouts;
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
                          (512, 5, {}), (13, 21, {}), (7, 23, {}),
                          (11, 19, {"rows": (4, 11)}), (77, 9, {}),
                          (448, 5, {"cols": (400, 448)}),
                          (26, 11, {"rows": (7, 26), "cols": (20, 26)}),
                          (509, 5, {}), (491, 6, {"cols": (300, 491)})):
        form = "fft" if dft.c2c_form(dz) == "fft" else "bluestein"
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
    print(f"odd shapes of the fused z kernels' FFT and Bluestein forms: "
          f"{cases} "
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
              "gather_ragged_pack": "gather", "gather_ragged_emu": "gather",
              "gather_ragged_unpack": "gather",
              "wire_quantize backward": "wire_quantize",
              "wire_quantize forward": "wire_quantize",
              "wire_dequantize backward": "wire_dequantize",
              "wire_dequantize forward": "wire_dequantize",
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
    t0 = time.perf_counter()
    trip, values, oracle = r2c_inputs(n, device, precision)
    plan = sp.make_local_plan(sp.TransformType.R2C, n, n, n, trip,
                              precision=precision, device=device)
    check_native(f"r2c {n}^3 plan", [plan.index_plan])
    p = plan.index_plan
    print(f"plan: R2C {n}^3 half sphere, {precision}, "
          f"{plan.num_local_elements} values "
          f"in {p.num_sticks} sticks, dim_x_freq={p.dim_x_freq}, "
          f"zero_stick={p.zero_stick_id}, split_x={plan.split_x}, "
          f"pair_io={plan.pair_values_io}, built with its values in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan, trip, values, oracle


def r2c_inputs(n, device, precision="single"):
    """The R2C path's set (the non-redundant half of the n^3 sphere,
    stick-major), its values ``(N, 2)`` in the precision's real type and
    the backward's oracle, as :func:`r2c_plan` describes them."""
    from spfft_tpu_torch.utils.workloads import \
        spherical_cutoff_triplets_stick_major
    full = spherical_cutoff_triplets_stick_major(n)
    x, y, z = full[:, 0], full[:, 1], full[:, 2]
    # a subset of a stick-major set keeps its order
    trip = full[(x > 0) | ((x == 0) & ((y > 0) | ((y == 0) & (z >= 0))))]
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
    return trip, values, oracle


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
    b_out, a_out = dft.mats_shape(m1)[1], dft.mats_shape(m2)[1]
    cc, rf = dft_kernel.stage_form(m1), dft_kernel.stage_form(m2)
    e = gr.element_size()
    nbytes = 2 * pp * a * b * e + pp * b_out * a_out * e \
        + table_bytes(m1, cc) + table_bytes(m2, rf)
    pairs = matrix_pair(m1), matrix_pair(m2)
    recs.append(kernel_record(
        path, "pdft2_cr", BLUESTEIN_SRC if rf == "bluestein" else RFFT_SRC,
        REAL_REPLACES, err,
        lambda: dft_kernel.pdft2_cr(gr, gi, m1, m2),
        lambda: dft.pdft2_minor_cr(gr, gi, m1, m2),
        (lambda: torch.fft.irfft2(
            gc.transpose(-1, -2), s=(b_out, a_out), norm="forward"))
        if a == p.dim_x_freq else None,
        nbytes, fft_flops(pp * a, b) + rfft_flops(pp * b_out, a_out),
        stage_design(m1, pp * a, e)[1] + stage_design(m2, pp * b_out, e)[1],
        f"{cc}+{rf}", lambda: dft_kernel.pdft2_cr(gr, gi, *pairs),
        design_bytes=nbytes + 2 * 2 * pp * b_out * a * e))

    # prdft2, forward shapes: real (z, y, x) -> planar (z, w, y)
    f1, f2 = plan._mats["x_f"], plan._mats["y_f"]
    fgot = dft_kernel.prdft2(space, f1, f2)
    err = compare(f"{path} prdft2", fgot, dft.prdft2_minor(space, f1, f2))
    pp, a, b = space.shape
    b_out, a_out = dft.mats_shape(f1)[1], dft.mats_shape(f2)[1]
    rf, cc = dft_kernel.stage_form(f1), dft_kernel.stage_form(f2)
    nbytes = pp * a * b * e + 2 * pp * b_out * a_out * e \
        + table_bytes(f1, rf) + table_bytes(f2, cc)
    pairs = matrix_pair(f1), matrix_pair(f2)
    recs.append(kernel_record(
        path, "prdft2", BLUESTEIN_SRC if rf == "bluestein" else RFFT_SRC,
        REAL_REPLACES, err,
        lambda: dft_kernel.prdft2(space, f1, f2),
        lambda: dft.prdft2_minor(space, f1, f2),
        (lambda: torch.fft.rfft2(space).transpose(-1, -2)
         .contiguous())
        if b_out == p.dim_x_freq else None,
        nbytes, rfft_flops(pp * a, b) + fft_flops(pp * b_out, a),
        stage_design(f1, pp * a, e)[1] + stage_design(f2, pp * b_out, e)[1],
        f"{rf}+{cc}", lambda: dft_kernel.prdft2(space, *pairs),
        design_bytes=nbytes + 2 * 2 * pp * b_out * a * e))

    recs.append(zdft_compress_record(path, plan, fgot, device))
    print_records(recs)
    return recs


def r2c_odd_shapes_phase(device, dtype=torch.float32):
    """The R2C kernels at shapes the path does not reach: the real stages
    of ``prdft2`` / ``pdft2_cr`` and the single-stage ``prdft_last`` /
    ``pirdft_last`` in the real FFT form at even lengths of every kind (2, 4,
    6, 10, 14, 22, 24, 100, 250, 256, 448, 512: half lengths 1, 2, odd, powers
    of two, mixed radix, radix 7 and 11) and in the Bluestein form at odd
    lengths (7, 15, 375) and at 26 (a 13 in the half), with the plan's
    matrices and with plain pairs (the matrix form), in windows of the half
    spectrum from 0, past 0 and wrapped, scaled, with nonzero imaginary parts
    at DC and Nyquist (changing them must leave the real inverse's output
    unchanged, bit for bit, in the real FFT form), both stores of the real FFT
    stage kernel (straight and transposed within planes), each call's form
    checked by its launch counts; then the (0,0)-stick completion with no
    slot of the
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
                                (22, 6, 3, ((0, 4), (8, 4))),
                                (26, 7, 3, ((0, 5), (10, 4))),
                                (375, 4, 2, ((0, 100), (150, 38))),
                                (448, 5, 2, ((0, 100), (200, 25))),
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
            if form != ("rfft" if nx % 2 == 0 and nx != 26 else "bluestein"):
                fail(f"real stage nx={nx}: form {form}")
            k = dft.mats_shape(spec_r2c)[1]
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
    for s, dz in ((37, 12), (21, 13), (9, 384), (11, 14)):
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
                 f"{diff:.3e}); a move of values must be exact")
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
    check_native(f"distributed {n}^3 plan", plan.dist_plan.shard_plans)
    dp = plan.dist_plan
    stacked = stacked_values(n, trip, values, parts, dp.max_values, device)
    print(f"plan: distributed {'R2C' if r2c else 'C2C'} {n}^3, {precision}, "
          f"{_S} shards "
          f"on one card: sticks per shard "
          f"{[p.num_sticks for p in dp.shard_plans]}, planes "
          f"{list(dp.num_planes)}, max_values {dp.max_values}, split_x="
          f"{plan.split_x}, built with its values in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return plan, stacked


def stacked_values(n, trip, values, parts, max_values, device):
    """The values ``(N, 2)`` of the set ``trip`` at each of ``parts``'s
    triplets, read off a dense cube of them (so that they are the values
    the local plan is given), stacked ``(len(parts), max_values, 2)``,
    zero-padded."""
    def storage(t):
        return torch.as_tensor(np.where(t < 0, t + n, t).astype(np.int64),
                               device=device)

    cube = torch.zeros((n, n, n), dtype=complex_of(values), device=device)
    st = storage(trip)
    cube[st[:, 2], st[:, 1], st[:, 0]] = torch.view_as_complex(
        values.contiguous())
    stacked = torch.zeros((len(parts), max_values, 2), dtype=values.dtype,
                          device=device)
    for r, part in enumerate(parts):
        sr = storage(part)
        stacked[r, :len(part)] = torch.view_as_real(
            cube[sr[:, 2], sr[:, 1], sr[:, 0]])
    return stacked


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
    kernels in their Bluestein form) and 12 (their FFT form), checked by
    the launch counts; C2C and R2C, fused and two-kernel; the
    backward and forward(FULL) within ``KERNEL_TOL``, and a second
    backward identical to the first."""
    from spfft_tpu_torch.ops import fused_kernel as fk
    rng = np.random.default_rng(SEED + 7)
    cpu = torch.device("cpu")
    weights = (3, 0, 1, 2, 1)  # stick share per shard
    cases = 0
    for nz in (13, 12):
        nx, ny, nz = dims = (12, 10, nz)
        planes = [5, 0, nz - 7, 0, 2]
        z_form = "bluestein" if nz == 13 else "fft"
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
          f"in the Bluestein form at dim_z 13, the FFT form at 12) on the card "
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


def dist_breakdown_phase(sp, path, plan, stacked, device, quiet=False):
    """Where the distributed pair's time goes: the pair run through the
    plan's own stage methods one after another (``_z_backward``, the
    exchange's steps ``_exchange_steps`` on the planar pair,
    ``_xy_backward``, ``_xy_forward``, the exchange back, ``_z_forward``),
    a CUDA event after each, with no wait in between, so that the stage
    times add up to the staged run. Its values must equal the public
    pair's bit for bit. The public pair minus the staged run is the
    public layout's copies (stacking, interleaving). Medians of ``REPS``
    runs after a warm-up; returns the medians by stage, in the order the
    stages run (``quiet``: printed on one line)."""
    full = sp.Scaling.FULL
    v = stacked[:, None]

    def exchange(planes, forward, mark):
        d = "forward" if forward else "backward"
        for name, step in plan._exchange_steps(forward):
            planes = step(planes)
            mark(f"exchange {name} {d}")
        return planes

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
        per = {}
        for (name, _), t in zip(marks[1:], ms):
            per[name] = per.get(name, 0.0) + t
        return out, per

    want = plan.forward(plan.backward(stacked), full)
    out, names = run()
    if not torch.equal(out[:, 0], want):
        fail(f"{path}: the plan's stage methods run one after another "
             f"differ from the public pair")
    del out, want
    reps = [run()[1] for _ in range(REPS)]
    med = {k: float(np.median([r[k] for r in reps])) for k in names}
    total = float(np.median([sum(r.values()) for r in reps]))
    pair = timed_ms(lambda: plan.forward(plan.backward(stacked), full),
                    device)
    if quiet:
        print(f"{path} stages: " + ", ".join(
            f"{k} {t:.4f}" for k, t in med.items()) + " ms", flush=True)
    else:
        for k, t in med.items():
            print(f"{path} stage {k}: {t:.4f} ms", flush=True)
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
    del plan2
    return recs + recs2 + exchange_phases(sp, name, "dist_c2c" + tag, plan,
                                          stacked, oracle, device, counters,
                                          DIST_C2C_LAUNCHES,
                                          DIST_C2C_2K_LAUNCHES, tag)


def exchange_phases(sp, name, path, plan, stacked, oracle_rel, device,
                    counters, base, base_2k, tag):
    """The exchange slice on a path's plan (single: every lossless kind
    on the fused route and the one-chunk kinds (``EXCHANGE_ONE_CHUNK``) on
    the two-kernel route, the wire cases, ``wire.cu``'s and the ragged
    gathers' records, the distributed sweep; double: the one-chunk kinds
    on the fused route and ``wire.cu``'s records). Returns the records."""
    t0 = time.perf_counter()
    dp, mesh = plan.dist_plan, plan.mesh
    rows = exchange_kinds_phase(sp, name, dp, mesh, stacked, device,
                                counters, base,
                                labels=EXCHANGE_ONE_CHUNK if tag
                                else tuple(EXCHANGE_KINDS))
    EXCHANGE_ROWS.extend(rows)
    recs = wire_kernel_records(path, plan, stacked, device)
    if not tag:
        EXCHANGE_ROWS.extend(exchange_kinds_phase(
            sp, f"{name} two-kernel", dp, mesh, stacked, device, counters,
            base_2k, fused=False, labels=EXCHANGE_ONE_CHUNK))
        wire = exchange_wire_phase(sp, name, dp, mesh, stacked, oracle_rel,
                                   device, counters, base,
                                   plan.backward(stacked))
        EXCHANGE_ROWS.extend(wire)
        set_launches(recs, next(r["launches"] for r in wire
                                if r["kind"] == "wire_int8"))
        more = ragged_gather_records(sp, path, dp, mesh, stacked, device)
        set_launches(more, next(r["launches"] for r in rows
                                if r["kind"] == "ragged"))
        recs += more
        dist_sweep_phase(sp, path, plan, stacked, device, DIST_SWEEP)
    else:  # the int8 wire of a double plan: its kernels' own counts
        int8 = exchange_plan(sp, dp, mesh, "buffered",
                             precision=plan.precision, wire_precision=3,
                             wire_error_budget=1.0)
        reset_launches(counters)
        int8.forward(int8.backward(stacked), sp.Scaling.FULL)
        _sync(device)
        set_launches(recs, read_launches(f"{name} int8", counters,
                                         exchange_want(base, 0, 1)))
        del int8
    print(f"{name} exchange phases: {time.perf_counter() - t0:.1f} s "
          f"({CARD})", flush=True)
    return recs


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
    del plan2
    if tag:  # the double lossless kinds run on the C2C path alone
        return recs + recs2
    return recs + recs2 + exchange_phases(sp, name, path, plan, stacked,
                                          oracle_rel, device, counters,
                                          DIST_R2C_LAUNCHES,
                                          DIST_R2C_2K_LAUNCHES, tag)


# -- the exchanges of the distributed plan: ring, exact counts, chunks, wire -

#: every exchange phase's rows (``{"exchange": [...]}``) and the
#: distributed batched sweep's (``{"dist_batched_sweep": [...]}``)
EXCHANGE_ROWS = []
DIST_SWEEP = []

#: the card's ``nvidia-smi`` name and power limit (set by :func:`main`),
#: carried by the exchange slice's records
CARD = None
WIRE_SRC = "spfft_tpu_torch/csrc/wire.cu"
QUANT_REPLACES = "spfft_tpu/parallel/exchange.py:124"
DEQUANT_REPLACES = "spfft_tpu/parallel/exchange.py:156"
#: the ragged exchange's table gathers (``jnp.take``, mode fill) in the JAX
#: package: its pack (dist.py:1160), the emulated collective
#: (exchange.py:663) and its unpack (dist.py:1166)
RAGGED_PACK_REPLACES = "spfft_tpu/parallel/dist.py:1160"
RAGGED_EMU_REPLACES = "spfft_tpu/parallel/exchange.py:663"
RAGGED_UNPACK_REPLACES = "spfft_tpu/parallel/dist.py:1166"
#: the lossless kinds: label -> (ExchangeType name, the op schedule through
#: SPFFT_TPU_COMPACT_PPERMUTE=1, overlap_chunks, the plan's exchange_kind)
EXCHANGE_KINDS = {
    "buffered": ("BUFFERED", False, 1, "block"),
    "ring": ("UNBUFFERED", False, 1, "ring"),
    "ragged": ("COMPACT_BUFFERED", False, 1, "ragged"),
    "compact": ("COMPACT_BUFFERED", True, 1, "compact"),
    "block_k2": ("BUFFERED", False, 2, "blockx2"),
    "block_k4": ("BUFFERED", False, 4, "blockx4"),
    "ragged_k2": ("COMPACT_BUFFERED", False, 2, "raggedx2"),
    "ragged_k4": ("COMPACT_BUFFERED", False, 4, "raggedx4"),
    "compact_k2": ("COMPACT_BUFFERED", True, 2, "compactx2"),
    "compact_k4": ("COMPACT_BUFFERED", True, 4, "compactx4"),
}
#: the kinds of one chunk (K = 1): the two-kernel route's and the double
#: plan's kinds (the chunked kinds run on the single fused route only, a
#: cut of the script's depth for its time limit)
EXCHANGE_ONE_CHUNK = ("buffered", "ring", "ragged", "compact")
#: gather launches each kind's exchange adds to a backward + forward pair,
#: literal for the 256^3 paths over 4 round-robin shards: ragged 3 a
#: direction (pack, emulation, unpack), 2K + 1 with K chunks; the op
#: schedule one a pack of each op and the unpack: 8 ops (a hop's shards
#: differ by one stick, two size classes a hop), its chunks 4 ops
#: backward (8 in the last) and 8 forward
EXCHANGE_GATHERS = {"buffered": 0, "ring": 0, "ragged": 6, "compact": 18,
                    "block_k2": 0, "block_k4": 0, "ragged_k2": 10,
                    "ragged_k4": 18, "compact_k2": 30, "compact_k4": 54}
#: the wire cases: label -> (ExchangeType name, wire_precision, K, the rung
#: it resolves to, its declines); every one under wire_error_budget 1.0
WIRE_CASES = {
    "buffered_float": ("BUFFERED_FLOAT", 0, 1, "bf16", ()),
    "compact_float": ("COMPACT_BUFFERED_FLOAT", 0, 1, "bf16", ()),
    "wire_f32": ("BUFFERED", 1, 1, "f32", ()),
    "wire_bf16": ("BUFFERED", 2, 1, "bf16", ()),
    "wire_int8": ("BUFFERED", 3, 1, "int8", ()),
    "wire_int8_k2": ("BUFFERED", 3, 2, "int8", ()),
    "ring_int8": ("UNBUFFERED", 3, 1, "int8", ()),
    "compact_int8": ("COMPACT_BUFFERED", 3, 1, "bf16",
                     (("int8", "exact_count_layout"),)),
}
#: the skewed split of the 256^3 sphere: stick shares (contiguous
#: stick-major ranges) and planes per shard (at another n, in proportion)
SKEW_STICKS = (0.4, 0.3, 0.2, 0.1)
SKEW_PLANES = (112, 80, 40, 24)


def exchange_plan(sp, dp, mesh, label, fused=True, precision="single",
                  **kw):
    """The plan of ``dp`` under the kind ``label`` of
    :data:`EXCHANGE_KINDS` (``exchange`` in ``kw`` overrides its
    exchange), the op schedule selected through the environment for its
    construction only."""
    from spfft_tpu_torch.parallel import dist
    name, ppermute, k, _ = EXCHANGE_KINDS[label]
    exchange = kw.pop("exchange", name)
    old = os.environ.pop(dist.COMPACT_PPERMUTE_ENV, None)
    if ppermute:
        os.environ[dist.COMPACT_PPERMUTE_ENV] = "1"
    try:
        return sp.DistributedTransformPlan(
            dp, mesh=mesh, precision=precision, fused=fused,
            exchange=sp.ExchangeType[exchange],
            overlap_chunks=kw.pop("overlap_chunks", k), **kw)
    finally:
        os.environ.pop(dist.COMPACT_PPERMUTE_ENV, None)
        if old is not None:
            os.environ[dist.COMPACT_PPERMUTE_ENV] = old


def exchange_want(base, gathers, int8_per_direction=0):
    """A pair's launch table: ``base`` with the exchange's gathers added
    and the int8 wire kernels' launches (K a direction each)."""
    g = base["gather"][0] + gathers
    q = 2 * int8_per_direction
    return {**base, "gather": (g, g), "wire_quantize": (q, q),
            "wire_dequantize": (q, q)}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def exchange_kinds_phase(sp, path, dp, mesh, stacked, device, counters,
                         base, fused=True, labels=tuple(EXCHANGE_KINDS),
                         skewed=False):
    """Every lossless kind of ``labels`` on ``dp``: its counted backward
    + forward(FULL) pair (the launches of ``base`` with the exchange's
    gathers), both outputs bit for bit the BUFFERED plan's (the first
    label), the pair's ms per call and on the device alone, the staged
    run's exchange steps and wire bytes. Returns one row per kind."""
    precision = "double" if stacked.dtype == torch.float64 else "single"
    full = sp.Scaling.FULL
    ref = None
    rows = []
    for label in labels:
        t0 = time.perf_counter()
        plan = exchange_plan(sp, dp, mesh, label, fused, precision)
        build_s = time.perf_counter() - t0
        if plan.exchange_kind != EXCHANGE_KINDS[label][3]:
            fail(f"{path} {label}: the plan runs {plan.exchange_kind}")
        reset_launches(counters)
        space = plan.backward(stacked)
        out = plan.forward(space, full)
        _sync(device)
        if skewed and EXCHANGE_KINDS[label][1]:
            # the op schedule's op counts are the split's own: the pack
            # gathers of its ops and the unpack, a direction
            ops = len(plan._compact.ops)
            launches = read_launches(f"{path} {label}", counters,
                                     exchange_want(base, 2 * (ops + 1)))
        else:
            launches = read_launches(f"{path} {label}", counters,
                                     exchange_want(base,
                                                   EXCHANGE_GATHERS[label]))
        if ref is None:
            ref = (space, out)
        elif not (torch.equal(space, ref[0]) and torch.equal(out, ref[1])):
            fail(f"{path} {label}: backward or forward differs from the "
                 f"BUFFERED plan's (a lossless exchange only moves values)")
        pair = timed_ms(lambda: plan.forward(plan.backward(stacked), full),
                        device)
        dev = graph_ms(lambda: plan.forward(plan.backward(stacked), full),
                       device, PAIR_GRAPH_CALLS)
        stages = dist_breakdown_phase(sp, f"{path} {label}", plan, stacked,
                                      device, quiet=True)
        exch = {k: v for k, v in stages.items() if k.startswith("exchange")}
        row = {"path": path, "kind": label, "fused": fused,
               "precision": precision, "exchange_kind": plan.exchange_kind,
               "overlap_chunks": plan.overlap_chunks, "pair_ms": pair,
               "pair_device_ms": dev, "exchange_ms": sum(exch.values()),
               "exchange_steps_ms": exch,
               "wire_bytes": plan.exchange_wire_bytes(),
               "wire_bytes_forward": plan.exchange_wire_bytes(True),
               "busiest_link_bytes": plan.exchange_busiest_link_bytes(),
               "gather_launches": launches["gather"],
               "device_table_bytes": plan.estimated_device_bytes(),
               "plan_s": build_s, "launches": launches, "card": CARD}
        rows.append(row)
        print(f"{path} {label} ({plan.exchange_kind}): pair {pair:.4f} ms, "
              f"on the device alone {_ms(dev)} ms, exchange "
              f"{row['exchange_ms']:.4f} ms a pair (both directions, "
              f"staged), wire {row['wire_bytes']} B a direction, gather "
              f"launches {launches['gather']}, plan {build_s:.2f} s; equal "
              f"to BUFFERED bit for bit ({CARD})", flush=True)
        del plan, space, out
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def exchange_wire_phase(sp, path, dp, mesh, stacked, oracle_rel, device,
                        counters, base, ref_space):
    """The wire ladder at the path's shapes, fused route, single: each
    case of :data:`WIRE_CASES` resolves its rung and declines as listed;
    its backward within ``max(4 * wire_probe_error,
    predicted_rel_error)`` of the complex128 oracle (the bound
    tests/test_torch_wire.py holds on the CPU); the f32 rung (a no-op
    in single) and the K = 2 int8 wire bit for bit their twins; the
    counted pair launches the int8 kernels K times a direction. Returns
    one row per case."""
    full = sp.Scaling.FULL
    rows = []
    int8_space = None
    for label, (name, wp, k, rung, declines) in WIRE_CASES.items():
        kind = "ragged" if name.startswith("COMPACT") else "buffered"
        plan = exchange_plan(sp, dp, mesh, kind, exchange=name,
                             wire_precision=wp, wire_error_budget=1.0,
                             overlap_chunks=k)
        if (plan.wire_rung_name, plan.wire_declines) != (rung, declines):
            fail(f"{path} {label}: wire rung {plan.wire_rung_name} "
                 f"declines {plan.wire_declines}, expected {rung} "
                 f"{declines}")
        gathers = EXCHANGE_GATHERS["ragged" if kind == "ragged" else
                                   "buffered"]
        reset_launches(counters)
        space = plan.backward(stacked)
        out = plan.forward(space, full)
        _sync(device)
        launches = read_launches(f"{path} {label}", counters, exchange_want(
            base, gathers, k if rung == "int8" else 0))
        dp_ = plan.dist_plan  # even slabs: the stacked slabs are the cube
        rel = oracle_rel(space.reshape((dp_.dim_z,)
                                       + tuple(space.shape[2:])))
        bound_ = max(4 * plan.wire_probe_error,
                     sp.predicted_rel_error("single", dp_.dim_z, True))
        rt = float(torch.linalg.norm(out.double() - stacked.double())
                   / torch.linalg.norm(stacked.double()))
        if not rel <= bound_ or not torch.isfinite(out).all():
            fail(f"{path} {label}: backward rel_l2 {rel:.3e} against the "
                 f"oracle above {bound_:.3e}")
        if rung == "f32" and not torch.equal(space, ref_space):
            fail(f"{path} {label}: the f32 rung of a single plan differs "
                 f"from the full wire")
        if label == "wire_int8":
            int8_space = space
        if label == "wire_int8_k2" and not torch.equal(space, int8_space):
            fail(f"{path} {label}: the int8 wire at K = 2 differs from "
                 f"K = 1")
        pair = timed_ms(lambda: plan.forward(plan.backward(stacked), full),
                        device)
        stages = dist_breakdown_phase(sp, f"{path} {label}", plan, stacked,
                                      device, quiet=True)
        rows.append({"path": path, "kind": label,
                     "wire_rung": plan.wire_rung_name,
                     "wire_declines": [list(d) for d in plan.wire_declines],
                     "probe_error": plan.wire_probe_error,
                     "oracle_rel_l2": rel, "bound": bound_,
                     "roundtrip_rel_l2": rt, "pair_ms": pair,
                     "exchange_ms": sum(v for n, v in stages.items()
                                        if n.startswith("exchange")),
                     "wire_bytes": plan.exchange_wire_bytes(),
                     "wire_bytes_forward": plan.exchange_wire_bytes(True),
                     "launches": launches, "card": CARD})
        print(f"{path} {label}: rung {plan.wire_rung_name} (declines "
              f"{plan.wire_declines}), probe error "
              f"{plan.wire_probe_error:.3e}; backward vs complex128 oracle "
              f"rel_l2={rel:.3e} (at most {bound_:.3e}); round trip "
              f"{rt:.3e}; pair {pair:.4f} ms, wire {rows[-1]['wire_bytes']} "
              f"B backward / {rows[-1]['wire_bytes_forward']} B forward "
              f"({CARD})", flush=True)
        del plan, space, out
    return rows


def _wire_bytes(g, s, ms, mp, esize, quant):
    """Bytes each wire kernel must move: quantize reads the planes and
    writes the int8 payloads and the scales; dequantize the reverse."""
    rows = ms if quant == 1 else mp
    return 2 * g * s * ms * mp * (esize + 1) + 4 * g * s * rows


def wire_kernel_records(path, plan, stacked, device):
    """``csrc/wire.cu`` at the path's blocks against its plain version:
    quantize on the backward's packed blocks (quant axis 1, per stick) and
    the forward's (quant axis 2, per plane), payloads and scales
    identical; dequantize of them identical too (the same product).
    Records ``wire_quantize`` / ``wire_dequantize`` per direction (no
    library call computes the quantization: ``library_ms`` null)."""
    from spfft_tpu_torch.ops import wire_kernel as wk
    recs = []
    sticks = plan._z_backward(stacked[:, None])
    grid = plan._xy_forward(plan._xy_backward(plan._exchange(sticks)))
    dtype = stacked.dtype
    e = stacked.element_size()
    for quant, planes in ((1, plan._pack_blocks(sticks, False)),
                          (2, plan._pack_blocks(grid, True))):
        blocks = tuple(t.reshape((-1,) + tuple(t.shape[-3:]))
                       for t in planes)
        g, s, ms, mp = blocks[0].shape
        got = wk.quantize(blocks, quant)
        want = wk.quantize_plain(blocks, quant)
        err = compare_exact(f"{path} wire quantize axis {quant}", got, want)
        back = wk.dequantize(got[:2], got[2], quant, dtype)
        err_d = compare_exact(f"{path} wire dequantize axis {quant}", back,
                              wk.dequantize_plain(want[:2], want[2], quant,
                                                  dtype))
        nb = _wire_bytes(g, s, ms, mp, e, quant)
        d = "backward" if quant == 1 else "forward"
        for name, src, rep, er, fn, plain in (
                (f"wire_quantize {d}", WIRE_SRC, QUANT_REPLACES, err,
                 lambda: wk.quantize(blocks, quant),
                 lambda: wk.quantize_plain(blocks, quant)),
                (f"wire_dequantize {d}", WIRE_SRC, DEQUANT_REPLACES, err_d,
                 lambda: wk.dequantize(got[:2], got[2], quant, dtype),
                 lambda: wk.dequantize_plain(got[:2], got[2], quant,
                                             dtype))):
            rec = kernel_record(path, name, src, rep, er, fn, plain, None,
                                nb, 0.0, 0.0)
            rec["dtype"] = str(dtype).split(".")[-1]
            rec["card"] = CARD
            recs.append(rec)
    del sticks, grid
    print_records(recs)
    return recs


def ragged_gather_records(sp, path, dp, mesh, stacked, device):
    """The ragged exchange's three table gathers of the backward
    (``csrc/gather.cu``, one launch each over every shard) at the path's
    shapes against the plain version (exact), each beside one
    ``torch.gather`` of the same slots (the library yardstick)."""
    from spfft_tpu_torch.ops import gather_kernel as gk
    from spfft_tpu_torch.parallel.exchange import gather_planes
    plan = exchange_plan(sp, dp, mesh, "ragged")
    t = plan._t_x
    sticks = plan._z_backward(stacked[:, None])
    flat = plan._flat(sticks)
    send = gather_planes(flat, t["bwd_pack"])
    b, s, cap = send[0].shape
    every = tuple(x.reshape(b, 1, s * cap).expand(b, s, s * cap)
                  for x in send)
    recv = gather_planes(every, t["emu_bwd"])
    e = stacked.element_size()
    recs = []

    def plain(src, idx):
        out = tuple(torch.empty((src[0].shape[0], src[0].shape[1],
                                 idx.shape[1]), dtype=src[0].dtype,
                                device=device) for _ in range(2))
        gk.gather_plain(tuple(x.transpose(0, 1) for x in src), idx,
                        tuple(x.transpose(0, 1) for x in out))
        return out

    def library(src, idx):
        n = src[0].shape[-1]
        c = torch.complex(src[0][0], src[1][0])
        c = torch.cat([c, c.new_zeros(c.shape[:-1] + (1,))], -1)
        i = torch.where(idx >= n, n, idx.long())
        return lambda: torch.gather(c, -1, i)

    for name, rep, src, idx in (
            ("gather_ragged_pack", RAGGED_PACK_REPLACES, flat, t["bwd_pack"]),
            ("gather_ragged_emu", RAGGED_EMU_REPLACES, every, t["emu_bwd"]),
            ("gather_ragged_unpack", RAGGED_UNPACK_REPLACES, recv,
             t["bwd_unpack"])):
        err = compare_exact(f"{path} {name}", gather_planes(src, idx),
                            plain(src, idx))
        valid = int((idx < src[0].shape[-1]).sum())
        nb = idx.numel() * (4 + 2 * e) + valid * 2 * e
        rec = gather_record(path, name, err,
                            lambda s_=src, i_=idx: gather_planes(s_, i_),
                            lambda s_=src, i_=idx: plain(s_, i_),
                            library(src, idx), nb)
        rec["replaces"] = rep
        rec["card"] = CARD
        recs.append(rec)
    del plan, sticks, flat, send, recv, every
    print_records(recs)
    return recs


def skewed_dist_plan(sp, n, trip, values, device):
    """The path's sphere split 40 / 30 / 20 / 10 % of its sticks over 4
    shards (contiguous stick-major ranges) with slabs of 112 / 80 / 40 / 24
    planes, and the path's values stacked on it."""
    keys = trip[:, 0].astype(np.int64) * (2 * n + 1) + trip[:, 1]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    cuts = [int(round(c * len(starts))) for c in np.cumsum(SKEW_STICKS)[:-1]]
    bounds = [0] + [int(starts[c]) for c in cuts] + [len(trip)]
    parts = [trip[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    planes = [p * n // sum(SKEW_PLANES) for p in SKEW_PLANES[:-1]]
    dp = sp.parallel.build_distributed_plan(
        sp.TransformType.C2C, n, n, n, parts, planes + [n - sum(planes)])
    stacked = torch.zeros((_S, dp.max_values, 2), dtype=values.dtype,
                          device=device)
    for r, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        stacked[r, :b - a] = values[a:b]
    return dp, stacked


def exchange_skew_phase(sp, n, trip, values, oracle, device, counters):
    """The exact-count layouts where they pay: the skewed split of
    :func:`skewed_dist_plan`; each kind's counted pair bit for bit
    BUFFERED's and its backward (the slabs in z order) within
    ``predicted_rel_error`` of the oracle; the ragged schedule's wire
    bytes against the padded layout's (expected about a third), and each
    kind's exchange and pair ms."""
    dp, stacked = skewed_dist_plan(sp, n, trip, values, device)
    mesh = sp.make_mesh(_S, device)
    print(f"dist c2c skewed: sticks per shard "
          f"{[p.num_sticks for p in dp.shard_plans]}, planes "
          f"{list(dp.num_planes)}, max_values {dp.max_values}", flush=True)
    plan = exchange_plan(sp, dp, mesh, "buffered")
    space = plan.backward(stacked)
    full = torch.cat([space[r, :k] for r, k in enumerate(dp.num_planes)])
    rel = oracle(full)
    pred = sp.predicted_rel_error("single", n, True)
    if not rel <= pred:
        fail(f"dist c2c skewed backward rel_l2 {rel:.3e} above {pred:.3e}")
    print(f"dist c2c skewed backward vs complex128 oracle: rel_l2={rel:.3e} "
          f"(predicted_rel_error={pred:.3e})", flush=True)
    del plan, space, full
    rows = exchange_kinds_phase(
        sp, "dist c2c skewed", dp, mesh, stacked, device, counters,
        DIST_C2C_LAUNCHES, labels=("buffered", "ring", "ragged", "compact",
                                   "ragged_k2"), skewed=True)
    padded = rows[0]["wire_bytes"]
    ragged = next(r for r in rows if r["kind"] == "ragged")["wire_bytes"]
    print(f"dist c2c skewed wire bytes a direction: ragged {ragged} against "
          f"padded {padded}, ratio {ragged / padded:.4f} ({CARD})",
          flush=True)
    if not ragged < 0.5 * padded:
        fail(f"dist c2c skewed: ragged wire {ragged} B not below half the "
             f"padded {padded} B")
    return rows


def dist_sweep_phase(sp, path, plan, stacked, device, out):
    """The distributed batched-versus-looped sweep that
    ``multi.FUSED_BATCH_MAX_DIST_TOTAL`` rests on: per band ms of a
    batched pair against B single pairs, B in ``SWEEP_BATCHES``, timed in
    turns (looped, batched, batched, looped); one row per B."""
    full = sp.Scaling.FULL
    dp = plan.dist_plan
    for batch in SWEEP_BATCHES:
        bands = torch.stack([stacked * (1 + b / 2) for b in range(batch)], 1)

        def looped():
            for b in range(batch):
                plan.forward(plan.backward(bands[:, b]), full)

        def batched():
            plan.forward_batched(plan.backward_batched(bands), full)

        t = [timed_ms(f, device) for f in (looped, batched, batched, looped)]
        row = {"path": path, "n": plan.dim_x, "shards": dp.num_shards,
               "B": batch,
               "slab_batch": batch * dp.dim_x * dp.dim_y * dp.max_planes,
               "looped_ms_per_band": (t[0] + t[3]) / 2 / batch,
               "batched_ms_per_band": (t[1] + t[2]) / 2 / batch,
               "card": CARD}
        out.append(row)
        print(f"dist sweep {path} n={plan.dim_x} B={batch}: looped "
              f"{row['looped_ms_per_band']:.4f} ms per band, batched "
              f"{row['batched_ms_per_band']:.4f} ms per band", flush=True)
        del bands


# -- the long axes (above 512): the two-pass FFT, Bluestein's FFT, the real
# FFT to 1024 and torch.fft ---------------------------------------------------

#: the long axes' full-width cell: the 768^3 sphere (237M values), every
#: axis 768 = 24 x 32 in the two-pass form
LONG_N = 768
LONG_SRC = "spfft_tpu_torch/csrc/fft_long.cu"
BLUESTEIN_SRC = "spfft_tpu_torch/csrc/bluestein.cu"
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
    form = dft_kernel.stage_form(mats)
    if form in ("fft", "rfft", "two_pass"):
        tables = mats.twiddles.numel()  # the FFT forms read the table only
    elif form == "bluestein":  # the chirp, spectrum and twiddles
        tables = sum(t.numel() for t in mats.bluestein)
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
    read by pass 2); the Bluestein form moves the function's bytes and
    does two complex FFTs of its length M and 8 M operations (the chirp
    and spectrum products) a row; the matrix form does K N multiply-adds
    a row."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    form = dft_kernel.stage_form(mats)
    nbytes = stage_bytes(mats, rows, e)
    if form == "two_pass":
        return nbytes + 4 * rows * mats.n * e, stage_flops(mats, rows)
    if form == "bluestein":
        m = mats.bluestein.m
        return nbytes, 2 * fft_flops(rows, m) + 8.0 * rows * m
    if form == "matrix":
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
    src = LONG_SRC if "two_pass" in forms else \
        BLUESTEIN_SRC if "bluestein" in forms else FFT_SRC
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
    check_native(f"long{n} plan", [p])
    print(f"long{n} plan on the native planner: {plan_s:.2f} s, "
          f"{rss / 2**30:.2f} GiB, beside the numpy planner's "
          f"{NUMPY_768_PLAN[0]:.2f} s, {NUMPY_768_PLAN[1]:.2f} GiB "
          f"({NUMPY_768_PLAN[2]}; this run {CARD})", flush=True)
    PLANNER_ROWS.append({"n": n, "planner": "native", "plan_s": plan_s,
                         "rss_gib": rss / 2**30, "what": "make_local_plan",
                         "card": CARD})
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


#: the odd long lengths: z lengths by form (520 two-pass with a direct
#: factor; 521, 997 and 1021 Bluestein), R2C x lengths by form (520 and
#: 1022 Bluestein)
LONG_Z = (520, 521, 997, 1021, 1024, 1080, 2016, 2048, 4097, 4480, 8192,
          1031)
#: the longest row csrc/fft_long.cu's one-launch kernel holds (WHOLE_N): a
#: two-pass stage is one launch up to it, pass 1 then pass 2 above it
LONG_WHOLE_N = 4096
LONG_X_R2C = (520, 1000, 1022, 1024, 1031)


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
    with 2^a 3^b 5^c factors, with a direct factor, and with a 7 in a
    shared-memory factor: 2016 = 42 x 48, whose 48 takes the float
    register class 64, and 4480 = 64 x 70, pass 2 over 70 above
    ``LONG_WHOLE_N``; Bluestein to 1024, ``torch.fft`` above), whole and
    windowed, both signs; ``pdft2`` /
    ``pdft2_swapped`` with long stages on either axis; the real stages at
    ``LONG_X_R2C`` (the real FFT to 1024, Bluestein, ``torch.fft``),
    whole and windowed, alone and inside ``prdft2`` / ``pdft2_cr``; each
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
#: (Bluestein) and a z of 1024 (two-pass), distributed R2C with an x of
#: 1022 (Bluestein, half 511 = 7 x 73) and a z of 520 (two-pass with the
#: direct factor 26), a local double plan with x 768 and z 1024
LONG_DIST = {"c2c": (521, 64, 1024), "r2c": (1022, 64, 520)}
LONG_F64 = (768, 64, 1024)


def sparse_oracle_rel(dims, trip, vals, field, r2c, space) -> float:
    """The backward ``space`` of the values ``vals`` at ``trip`` against
    a dense complex128 oracle on the card: C2C the values on the grid
    through ``ifftn``; R2C the half spectrum of the sticks, with the
    mirror of each stick of the x = 0 plane (the plans' hermitian
    completion; ``field``'s spectrum holds both), through ``irfftn``."""
    nx, ny, nz = dims
    t = torch.as_tensor(trip.astype(np.int64), device=space.device)
    if not r2c:
        grid = torch.zeros((nz, ny, nx), dtype=torch.complex128,
                           device=space.device)
        grid[t[:, 2], t[:, 1], t[:, 0]] = torch.view_as_complex(
            vals.double().contiguous())
        ref = torch.fft.ifftn(grid, norm="forward")
        got = torch.view_as_complex(space.double().contiguous())
    else:
        spec = torch.fft.fftn(field / (nx * ny * nz))
        half = torch.zeros((nz, ny, nx // 2 + 1), dtype=torch.complex128,
                           device=space.device)
        xy = torch.unique(t[:, :2], dim=0)
        half[:, xy[:, 1], xy[:, 0]] = spec[:, xy[:, 1], xy[:, 0]]
        y0 = xy[xy[:, 0] == 0, 1]
        half[:, (-y0) % ny, 0] = spec[:, (-y0) % ny, 0]
        del spec
        ref = torch.fft.irfftn(half, s=(nz, ny, nx), norm="forward")
        got = space.double()
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


def long_plans_phase(sp, device, counters):
    """Plans with long axes at small stick sets, on the card: each
    distributed plan over 4 shards against the local plan on the same
    values (backward within 2e-6, float32, or twice
    ``predicted_rel_error``, float64, the round trip) with its pair
    counted, the local plan's backward within ``predicted_rel_error`` of
    its oracle (the field), and ``LONG_F64`` in double against its
    oracle; records of the long forms these pairs run, at their shapes,
    timed, in both precisions. Returns the records."""
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
            orel = sparse_oracle_rel(dims, trip, vals, field, r2c, lb)
            print(f"{path}: the local plan's backward vs its complex128 "
                  f"oracle rel_l2={orel:.3e} (predicted_rel_error="
                  f"{pred:.3e})", flush=True)
            if not orel <= pred:
                fail(f"{path}: local backward {orel:.3e} above {pred:.3e}")
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
            want = "bluestein"
            got_x = forms.get("prdft_last" if r2c else "pdft2_swapped", {})
            if want not in got_x or forms["decompress_zdft"] or \
                    forms["zdft_compress"] or \
                    forms["pdft_last"].get("two_pass", 0) < 2 or \
                    any(f.get("library") for f in forms.values()):
                fail(f"{path}: expected the Bluestein x stage, a two-pass "
                     f"z stage on the two-kernel route and no torch.fft "
                     f"call, got {forms}")
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
    stage (the Bluestein form: ``pdft2_swapped`` for C2C,
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
            "cr", (hr, hi), xb, err, BLUESTEIN_SRC, REAL_REPLACES))
        xs = dft.pirdft_last(hr, hi, xb).contiguous()
        xf = m["x_f"]
        err = compare(f"{path} prdft_last (x)", dft_kernel.prdft_last(xs, xf),
                      dft.prdft_last(xs, xf))
        recs.append(long_stage_record(
            path, "prdft_last", dft_kernel.prdft_last, dft.prdft_last, "rc",
            (xs,), xf, err, BLUESTEIN_SRC, REAL_REPLACES))
    else:
        gr2, gi2 = grid[0].reshape(planes), grid[1].reshape(planes)
        m1, m2 = m["x_b"], m["y_b"]
        err = compare(f"{path} pdft2_swapped (x Bluestein, y fft)",
                      dft_kernel.pdft2_swapped(gr2, gi2, m1, m2),
                      dft.cdft2_xy(gr2, gi2, m1, m2))
        gc = torch.complex(gr2, gi2)
        rec = long_plane_record(
            path, "pdft2_swapped", dft_kernel.pdft2_swapped, dft.cdft2_xy,
            ("cc", "cc"), (gr2, gi2), m1, m2, err,
            lambda: torch.fft.ifft2(gc, norm="forward"))
        recs.append(rec)
    for r in recs:  # the pair's launches of the record's forms
        r["launches"] = sum(forms[r["name"]].get(f, 0)
                            for f in r["form"].split("+"))
    print_records(recs)
    return recs


#: the float64 records of the 768^3 stages: the z stage's rows (the
#: sphere's sticks)
LONG_F64_Z_ROWS = 463188


def long_f64_records(device):
    """The 768^3 path's two-pass stages in float64 at its shapes, on
    seeded random rows (a double plan of the 768^3 sphere is not built):
    ``pdft_last`` over the z stage's ``LONG_F64_Z_ROWS`` sticks and
    ``pdft2`` over the 768 planes of 768 x 768, each against its plain
    version and ``torch.fft`` in complex128. A record's launches are
    those of its one checked call, counted alone and held to
    :func:`_want`. Returns the records."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    n = LONG_N
    path = f"long{n}_f64"
    gen = torch.Generator(device=device).manual_seed(SEED)
    dt = torch.float64

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=dt, device=device)

    def counted(name, wrapper, want, *args):
        # one call, counted alone: its launches are the record's
        wrapper.launches = 0
        wrapper.form_launches = dict.fromkeys(wrapper.form_launches, 0)
        out = wrapper(*args)
        torch.cuda.synchronize()
        got = {f: k for f, k in wrapper.form_launches.items() if k}
        if got != want or wrapper.launches != sum(want.values()):
            fail(f"{path} {name}: launched {wrapper.launches} times, by "
                 f"form {got}, expected {want}")
        return out, wrapper.launches

    zb = dft.device_c2c(n, dft.BACKWARD, device=device, dtype=dt)
    sr, si = rand(LONG_F64_Z_ROWS, n), rand(LONG_F64_Z_ROWS, n)
    got, launches = counted("pdft_last", dft_kernel.pdft_last, _want(zb),
                            sr, si, zb)
    err = compare(f"{path} pdft_last backward (two-pass)", got,
                  dft.pdft_last(sr, si, zb))
    recs = [long_stage_record(path, "pdft_last", dft_kernel.pdft_last,
                              dft.pdft_last, "cc", (sr, si), zb, err)]
    recs[-1]["launches"] = launches
    del sr, si, got
    torch.cuda.empty_cache()
    gr, gi = rand(n, n, n), rand(n, n, n)
    got, launches = counted("pdft2", dft_kernel.pdft2, _want(zb, zb),
                            gr, gi, zb, zb)
    err = compare(f"{path} pdft2 backward (two-pass)", got,
                  dft.pdft2_minor(gr, gi, zb, zb))
    del got
    gc = torch.complex(gr, gi)
    recs.append(long_plane_record(
        path, "pdft2", dft_kernel.pdft2, dft.pdft2_minor, ("cc", "cc"),
        (gr, gi), zb, zb, err,
        lambda: torch.fft.ifft2(gc, norm="forward").transpose(-1, -2)
        .contiguous()))
    recs[-1]["launches"] = launches
    print_records(recs)
    del gr, gi, gc
    torch.cuda.empty_cache()
    return recs


#: row 7M: a length the reference admits (``good_fft_order``: 2^6 x 7) and
#: the z stage it is timed on (the sticks of a 448^3 sphere)
MATRIX_N = 448
MATRIX_ROWS = 157696
#: kernel 1's other ``pdft_last`` lengths: 11 (352 = 4 4 2 11), 2 3 7 11
#: (462) and 7^3 (343), on ``MATRIX_ROWS`` rows; a plane length that would
#: fit one cluster (112 = 4 4 7); kernel A's two-pass length with a 7 in
#: its shared-memory factor (896 = 28 x 32)
RADIX_LENGTHS = (352, 462, 343)
RADIX_CLUSTER_N = 112
RADIX_LONG_N = 896
#: kernel 2's lengths: complex (13, 26, 52, 257, 416 and 509 have a prime
#: of 13 or more; 100's M fell from 540 to 200) and real (135, 375 odd;
#: 510's half 255 = 3 5 17), on about ``STAGE_ELEMS`` elements each
BLUESTEIN_CC = (13, 26, 52, 100, 257, 416, 509)
BLUESTEIN_REAL = (135, 375, 510)
STAGE_ELEMS = 1 << 25
#: the fused z kernels at a dim_z with a prime of 13 or more, in their
#: Bluestein form (csrc/fused_bluestein.cu): at PRIME_Z (2^5 x 13, M = 900)
#: over PRIME_Z_STICKS sticks half full, and at the short and long lengths
#: PRIME_Z_MORE (13: M = 25; 509: M = 1024) over as many slots, each beside
#: the matrix form on a plain pair (csrc/fused_compress.cu, the path such a
#: dim_z ran before) and the two-kernel route (gather + Bluestein) on the
#: same values
PRIME_Z = 416
PRIME_Z_STICKS = 65536
PRIME_Z_MORE = (13, 509)


def _rows_of(n):
    return max(1, STAGE_ELEMS // n)


def _stage_pair(mode):
    """The wrapper and plain version of a single-stage mode."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    return {"cc": (dft_kernel.pdft_last, dft.pdft_last),
            "rc": (dft_kernel.prdft_last, dft.prdft_last),
            "cr": (dft_kernel.pirdft_last, dft.pirdft_last)}[mode]


def _counted_call(name, wrapper, want, fn):
    """``fn()``, one call counted alone: fails on the card unless
    ``wrapper`` launched ``want`` (a dict by form) in it. Returns the
    output and the launches."""
    wrapper.launches = 0
    wrapper.form_launches = dict.fromkeys(wrapper.form_launches, 0)
    out = fn()
    on_card = _first_tensor(out).device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    got = {f: k for f, k in wrapper.form_launches.items() if k}
    if on_card and (got != want or wrapper.launches != sum(want.values())):
        fail(f"{name}: launched {wrapper.launches} times, by form {got}, "
             f"expected {want}")
    return out, wrapper.launches


def form_record(path, name, mode, ins, mats, source, matrix=True):
    """One single-stage wrapper call in the form ``mats`` carries: one
    call counted alone (one launch in that form, the record's
    ``launches``) against its plain version, then the record
    (:func:`long_stage_record`: bound, design bound, plain, one
    ``torch.fft`` call) with ``matrix_ms``, the matrix form
    (``csrc/dft2.cu``) on the same inputs where ``matrix``."""
    from spfft_tpu_torch.ops import dft_kernel
    wrapper, plain = _stage_pair(mode)
    form = dft_kernel.stage_form(mats)
    got, launches = _counted_call(f"{path} {name}", wrapper, {form: 1},
                                  lambda: wrapper(*ins, mats))
    want = plain(*ins, mats)
    err = compare(f"{path} {name} form {form}",
                  got if isinstance(got, tuple) else (got,),
                  want if isinstance(want, tuple) else (want,))
    del got, want
    rec = long_stage_record(path, name, wrapper, plain, mode, ins, mats, err,
                            source)
    if matrix:
        pair = matrix_pair(mats)
        rec["matrix_ms"] = timed_ms(lambda: wrapper(*ins, pair),
                                    ins[0].device)
    rec["launches"] = launches
    return rec


def long_direct_factor(ins, mats):
    """``pdft_last`` in the two-pass form with pass 1's factor on the
    direct DFT path (radices 0: ``dft_rows``), as csrc/fft_long.cu ran a
    factor with a 7 before the tile had radix 7; one launch, not
    counted."""
    from spfft_tpu_torch.ops import _build, dft, dft_kernel
    xr, xi = ins
    n1, n2 = mats.split
    dtype = xr.dtype
    fn = _build.function("fft_long.cu", _build.entry("spfft_fft_long", dtype),
                         dft_kernel._long_args(_build.REAL_TYPES[dtype]))
    out = (torch.empty_like(xr), torch.empty_like(xr))
    paths = int(dft_kernel.reg_plan("fft_long.cu", n1, dtype)) | int(
        dft_kernel.reg_plan("fft_long.cu", n2, dtype)) << 1
    _build.launch(fn, "fft_long direct factor", xr.device, 0,
                  *(t.data_ptr() for t in (xr, xi, *out, mats.twiddles)),
                  xr.numel() // mats.n, mats.n, n1, n2, 0, mats.sign,
                  mats.scale, 0, dft.radix_code(dft.fft_factors(n2)), paths)
    return out


def radix_records(device, dtype):
    """Kernel 1 (radix 7 and 11 in ``csrc/fft_tile.cuh``) on seeded random
    rows in ``dtype``, each against its plain version, the matrix form on
    the same inputs and one ``torch.fft`` call: row 7M, ``pdft_last`` at
    ``MATRIX_N`` over ``MATRIX_ROWS`` rows (the 448^3 sphere's z sticks),
    and at ``RADIX_LENGTHS``; ``pdft2`` on ``RADIX_CLUSTER_N`` planes of
    that side (a plane that fits one cluster, in two stage launches: the
    cluster kernel takes radices 2-5 alone); kernel A (``csrc/fft_long.cu``) at
    ``RADIX_LONG_N``, whose shared-memory factor 28 = 4 x 7 now runs the
    tile's FFT, beside the same launch with that factor on the direct DFT
    path (``direct_ms``). Returns the records."""
    from spfft_tpu_torch.ops import dft, dft_kernel
    path = "radix" + ("_f64" if dtype == torch.float64 else "")
    gen = torch.Generator(device=device).manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    recs = []
    for n in (MATRIX_N,) + RADIX_LENGTHS:
        m = dft.device_c2c(n, dft.BACKWARD, device=device, dtype=dtype)
        if dft_kernel.stage_form(m) != "fft":
            fail(f"pdft_last {n}: form {dft_kernel.stage_form(m)}")
        x = (rand(MATRIX_ROWS, n), rand(MATRIX_ROWS, n))
        recs.append(form_record(path, f"pdft_last {n}", "cc", x, m, FFT_SRC))
        del x
    n = RADIX_CLUSTER_N
    mb = dft.device_c2c(n, dft.BACKWARD, device=device, dtype=dtype)
    x = (rand(n, n, n), rand(n, n, n))
    got, launches = _counted_call(
        f"{path} pdft2 {n}", dft_kernel.pdft2, {"fft": 2},
        lambda: dft_kernel.pdft2(*x, mb, mb))
    err = compare(f"{path} pdft2 {n}", got, dft.pdft2_minor(*x, mb, mb))
    del got
    recs.append(pdft2_record(path, f"pdft2 {n}", x, mb, mb, err))
    recs[-1]["launches"] = launches
    del x
    n = RADIX_LONG_N
    m = dft.device_c2c(n, dft.BACKWARD, device=device, dtype=dtype)
    if dft_kernel.stage_form(m) != "two_pass" or m.split != (28, 32):
        fail(f"pdft_last {n}: form {dft_kernel.stage_form(m)} {m.split}")
    x = (rand(_rows_of(n), n), rand(_rows_of(n), n))
    rec = form_record(path, f"pdft_last {n}", "cc", x, m, LONG_SRC,
                      matrix=False)
    if device.type == "cuda":
        compare(f"{path} pdft_last {n} with its factor 28 direct",
                long_direct_factor(x, m), dft_kernel.pdft_last(*x, m))
        rec["direct_ms"] = timed_ms(lambda: long_direct_factor(x, m), device)
        print(f"kernel {path} pdft_last {n}: factor 28 on the direct DFT "
              f"path {rec['direct_ms']:.4f} ms against {rec['ms']:.4f} in "
              f"the FFT (same inputs)", flush=True)
    recs.append(rec)
    del x
    print_records(recs)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return recs


def bluestein_mats(n, sign, device, dtype):
    """The Bluestein form of a complex length-``n`` DFT, whatever form
    ``dft.c2c_form`` gives ``n`` (100 has an FFT form: measured here for
    its M)."""
    from spfft_tpu_torch.ops import dft
    return dft.DftMats(None, None, n=n, sign=sign, scale=1.0, rows=(0, n),
                       cols=(0, n), twiddles=None, form="bluestein",
                       bluestein=dft.device_bluestein(n, sign, 1.0, device,
                                                      dtype))


def bluestein_small_records(device, dtype):
    """Kernel 2 (``csrc/bluestein.cu`` below 513) on seeded random rows in
    ``dtype``, about ``STAGE_ELEMS`` elements a call, each against its
    plain version, the matrix form on the same inputs and one
    ``torch.fft`` call: ``pdft_last`` at ``BLUESTEIN_CC``, ``prdft_last``
    and ``pirdft_last`` at ``BLUESTEIN_REAL``. Returns the records."""
    from spfft_tpu_torch.ops import dft
    path = "bluestein" + ("_f64" if dtype == torch.float64 else "")
    gen = torch.Generator(device=device).manual_seed(SEED + 1)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    recs = []
    for n in BLUESTEIN_CC:
        m = bluestein_mats(n, dft.BACKWARD, device, dtype)
        x = (rand(_rows_of(n), n), rand(_rows_of(n), n))
        recs.append(form_record(path, f"pdft_last {n}", "cc", x, m,
                                BLUESTEIN_SRC))
        del x
    for n in BLUESTEIN_REAL:
        mr = dft.device_r2c(n, device=device, dtype=dtype)
        mc = dft.device_c2r(n, device=device, dtype=dtype)
        if {mr.form, mc.form} != {"bluestein"}:
            fail(f"real {n}: forms {mr.form} / {mc.form}")
        rows = _rows_of(n)
        x = rand(rows, n)
        recs.append(form_record(path, f"prdft_last {n}", "rc", (x,), mr,
                                BLUESTEIN_SRC))
        y = (rand(rows, n // 2 + 1), rand(rows, n // 2 + 1))
        recs.append(form_record(path, f"pirdft_last {n}", "cr", y, mc,
                                BLUESTEIN_SRC))
        del x, y
    print_records(recs)
    return recs


def bluestein_design_flops(rows, n):
    """Operations of the Bluestein form's design on ``rows`` rows of
    length ``n``: two length-M FFTs and 8 M for the chirp, spectrum and
    chirp products, a row (csrc/bluestein.cu's header)."""
    from spfft_tpu_torch.ops import dft
    m = dft.bluestein_length(n)
    return rows * (2 * fft_flops(1, m) + 8.0 * m)


def _prime_z_case(dz, device, dtype, rng):
    """The sticks of one fused-prime record: ``PRIME_Z_STICKS * PRIME_Z //
    dz`` sticks of ``dz`` slots, each slot given with probability 1/2,
    the values (N, 2) in ``dtype``, and the slot_src (with its sentinel
    stick) and CSR tables."""
    from spfft_tpu_torch.indexing import inverse_slot_map
    from spfft_tpu_torch.ops import fused_kernel as fk
    s = PRIME_Z_STICKS * PRIME_Z // dz
    slots = np.flatnonzero(rng.random(s * dz) < 0.5)
    nv = len(slots)
    slot_src = torch.as_tensor(np.concatenate(
        [inverse_slot_map(slots, s * dz, nv), np.full(dz, nv, np.int32)]),
        device=device)
    csr = tuple(torch.as_tensor(t, device=device)
                for t in fk.compress_csr(slots, s, dz))
    vals = torch.as_tensor(rng.standard_normal((nv, 2)), dtype=dtype,
                           device=device)
    vi = torch.as_tensor(slots.astype(np.int32), device=device)
    return s, nv, slot_src, csr, vals, vi


def fused_prime_records(device, dtype):
    """The fused z kernels in the Bluestein form at ``PRIME_Z`` and
    ``PRIME_Z_MORE`` in ``dtype`` (the lengths' own z tables, as a plan
    hands them), each direction one call counted alone (one launch,
    form ``bluestein``) against its plain version, then its record with
    ``matrix_ms`` (the matrix form on a plain pair of the same function,
    ``csrc/fused_compress.cu``: the old path), ``two_kernel_ms`` /
    ``two_kernel_device_ms`` (the gather and ``pdft_last`` in the
    Bluestein form, the two-kernel route) and ``library_ms`` (one
    ``torch.fft`` call on the gathered sticks, or on the sticks and then
    an index). Returns the records."""
    from spfft_tpu_torch.ops import dft, dft_kernel, fused_kernel as fk
    from spfft_tpu_torch.ops import gather_kernel
    rng = np.random.default_rng(SEED + 13)
    suffix = "_f64" if dtype == torch.float64 else ""
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    e = torch.empty((), dtype=dtype).element_size()
    recs = []
    for dz in (PRIME_Z,) + PRIME_Z_MORE:
        s, nv, slot_src, csr, vals, vi = _prime_z_case(dz, device, dtype,
                                                       rng)
        zb = dft.device_c2c(dz, dft.BACKWARD, device=device, dtype=dtype)
        zf = dft.device_c2c(dz, dft.FORWARD, 1.0 / dz, device=device,
                            dtype=dtype)
        if {fk.z_form(zb, dz), fk.z_form(zf, dz)} != {"bluestein"}:
            fail(f"dim_z {dz}: z forms {fk.z_form(zb, dz)} / "
                 f"{fk.z_form(zf, dz)}, expected bluestein")
        path = f"z{dz}{suffix}"
        rows = s + 1
        tables = table_bytes(zb, "bluestein")

        # backward: the gather, the completion-free stick, the z-DFT
        got, launches = _counted_call(
            f"{path} decompress_zdft", fk.decompress_zdft,
            {"bluestein": 1},
            lambda: fk.decompress_zdft(vals, slot_src, zb, dz))
        want = fk.decompress_zdft_plain(vals, slot_src, zb, dz, False)
        err = compare(f"{path} decompress_zdft (Bluestein form)", got, want)

        def dec_two_kernel():
            sr, si = gather_kernel.decompress(vals, slot_src, dz)
            return dft_kernel.pdft_last(sr, si, zb)

        compare(f"{path} gather + pdft_last (Bluestein)", dec_two_kernel(),
                want)
        del got, want
        vpad = torch.cat([torch.view_as_complex(vals),
                          torch.zeros(1, dtype=cdt, device=device)])
        slot64 = slot_src.long()
        mats = matrix_pair(zb)
        rec = kernel_record(
            path, "decompress_zdft", Z_SRC["bluestein"], DEC_REPLACES, err,
            lambda: fk.decompress_zdft(vals, slot_src, zb, dz),
            lambda: fk.decompress_zdft_plain(vals, slot_src, zb, dz, False),
            lambda: torch.fft.ifft(vpad[slot64].view(rows, dz),
                                   norm="forward"),
            nv * 2 * e + rows * dz * 4 + tables + 2 * rows * dz * e,
            fft_flops(rows, dz), bluestein_design_flops(rows, dz),
            "bluestein",
            matrix=lambda: fk.decompress_zdft(vals, slot_src, mats, dz))
        rec["launches"] = launches
        rec["two_kernel_ms"] = timed_ms(dec_two_kernel, device)
        rec["two_kernel_device_ms"] = graph_ms(dec_two_kernel, device)
        recs.append(rec)
        del vpad, slot64

        # forward: the z-DFT (the FULL scale 1 / dim_z folded in), the CSR
        gen = torch.Generator(device=device).manual_seed(SEED + dz)
        sr, si = (torch.randn((s, dz), generator=gen, dtype=dtype,
                              device=device) for _ in range(2))
        got, launches = _counted_call(
            f"{path} zdft_compress", fk.zdft_compress, {"bluestein": 1},
            lambda: fk.zdft_compress(sr, si, zf, csr))
        want = fk.zdft_compress_plain(sr, si, zf, csr, False)
        err = compare(f"{path} zdft_compress (Bluestein form)", (got,),
                      (want,))

        def cmp_two_kernel():
            yr, yi = dft_kernel.pdft_last(sr, si, zf)
            return gather_kernel.compress(yr, yi, vi)

        compare(f"{path} pdft_last (Bluestein) + gather", (cmp_two_kernel(),),
                (want,))
        del got, want
        vi64 = vi.long()
        mats = matrix_pair(zf)
        rec = kernel_record(
            path, "zdft_compress", Z_SRC["bluestein"], CMP_REPLACES, err,
            lambda: fk.zdft_compress(sr, si, zf, csr),
            lambda: fk.zdft_compress_plain(sr, si, zf, csr, False),
            lambda: torch.fft.fft(torch.complex(sr, si), norm="forward"
                                  ).view(-1)[vi64],
            2 * s * dz * e + ((s + 1) + 2 * nv) * 4 + tables + nv * 2 * e,
            fft_flops(s, dz), bluestein_design_flops(s, dz), "bluestein",
            matrix=lambda: fk.zdft_compress(sr, si, mats, csr))
        rec["launches"] = launches
        rec["two_kernel_ms"] = timed_ms(cmp_two_kernel, device)
        rec["two_kernel_device_ms"] = graph_ms(cmp_two_kernel, device)
        recs.append(rec)
        del sr, si, slot_src, csr, vals, vi, vi64, mats
    print_records(recs)
    for r in recs:
        print(f"kernel {r['path']} {r['name']}: the Bluestein form "
              f"{r['ms']:.4f} ms ({_ms(r['device_ms'])} on the device) "
              f"against the matrix form {_ms(r['matrix_ms'])}, the "
              f"two-kernel route (gather + Bluestein) "
              f"{r['two_kernel_ms']:.4f} ({_ms(r['two_kernel_device_ms'])}) "
              f"and the library call {_ms(r['library_ms'])} "
              f"({_ms(r['library_device_ms'])}), same inputs", flush=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return recs


#: the full-width path at a dim_z with a prime of 13 or more: the C2C
#: sphere at PRIME_N^3 (416 = 2^5 x 13 on every axis, so every stage takes
#: Bluestein's form), fused (each z kernel once in the Bluestein form,
#: pdft2 in two Bluestein stage launches a call) and two-kernel
PRIME_N = 416
BLUE4 = (4, 4, {"bluestein": 4})
C2C416_LAUNCHES = {"decompress_zdft": (1, 1, {"bluestein": 1}),
                   "zdft_compress": (1, 1, {"bluestein": 1}),
                   "pdft2": BLUE4, "prdft2": (0, 0), "pdft2_cr": (0, 0),
                   "gather": (0, 0), "pdft_last": (0, 0),
                   "pdft2_swapped": (0, 0), **NO_REAL_LAST}
C2C416_2K_LAUNCHES = {"decompress_zdft": (0, 0), "zdft_compress": (0, 0),
                      "pdft2": BLUE4, "prdft2": (0, 0), "pdft2_cr": (0, 0),
                      "gather": (2, 2), "pdft_last": (2, 2, {"bluestein": 2}),
                      "pdft2_swapped": (0, 0), **NO_REAL_LAST}


def prime_path_phase(sp, device, counters):
    """The C2C path at ``PRIME_N``^3 (``main_path_plan``: the sphere in
    stick-major order, about 37.7 M values), float32: the fused plan's
    counted pair (each z kernel once in the Bluestein form) against the
    complex128 oracle at ``predicted_rel_error``, then the same index
    plan with ``fused=False`` (the gather and ``pdft_last`` in the
    Bluestein form), its counted pair against the oracle too, and the two
    routes' backward and forward(FULL) within ``KERNEL_TOL`` of each other
    (bit for bit where the two forms' arithmetic coincides, printed).
    ``pair_phase`` prints each route's pair ms."""
    n = PRIME_N
    t0 = time.perf_counter()
    plan, trip, values = main_path_plan(sp, n, device)
    oracle = c2c_oracle_rel(plan, trip, values, device)
    pair_phase(sp, f"c2c{n}", plan, values, oracle, device, counters,
               C2C416_LAUNCHES)
    split = sp.TransformPlan(plan.index_plan, device=device, fused=False)
    pair_phase(sp, f"c2c{n}_2k", split, values, oracle, device, counters,
               C2C416_2K_LAUNCHES)
    full = sp.Scaling.FULL
    a, b = plan.backward(values), split.backward(values)
    compare(f"c2c{n} two-kernel vs fused backward", (b,), (a,))
    fa, fb = plan.forward(a, full), split.forward(a, full)
    compare(f"c2c{n} two-kernel vs fused forward", (fb,), (fa,))
    print(f"c2c{n} two-kernel vs fused route: backward bit for bit "
          f"{torch.equal(a, b)}, forward bit for bit {torch.equal(fa, fb)}",
          flush=True)
    del plan, split, trip, values, a, b, fa, fb
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"prime path {n}^3: {time.perf_counter() - t0:.1f} s", flush=True)


#: small dims at dim_z 13 (the fused z kernels' Bluestein form, M = 25)
#: whose float32 plans are held to the oracle on the card: the CPU rank
#: tests' dims and dist_odd_shards_phase's; and their 4-shard split, stick
#: weights and planes of 13
PRIME_SMALL_DIMS = ((11, 12, 13), (12, 10, 13))
PRIME_SMALL_SHARDS = ((3, 1, 2, 1), (4, 3, 4, 2))


def _small_prime_set(rng, dims, r2c):
    """Storage triplets and complex128 values (rounded to complex64) of a
    small set, and the backward's complex128 oracle ``(dim_z, dim_y,
    dim_x)``: C2C, sticks with probability 0.6 and their slots with 0.7,
    random values; R2C, the hermitian half (x > 0, or x = 0 and y > 0, or
    the (0,0) stick's z >= 0) of a real field's spectrum within a centred
    ellipsoid."""
    nx, ny, nz = dims
    sx, sy, sz = (np.fft.fftfreq(n, 1.0 / n).round().astype(np.int64)
                  for n in dims)
    z, y, x = (a.reshape(-1) for a in np.meshgrid(sz, sy, sx, indexing="ij"))
    if r2c:
        inside = (x / nx) ** 2 + (y / ny) ** 2 + (z / nz) ** 2 <= 0.2
        spec = np.fft.fftn(rng.standard_normal((nz, ny, nx))) * \
            inside.reshape(nz, ny, nx)
        spec = spec.astype(np.complex64).astype(np.complex128)
        half = (x > 0) | ((x == 0) & ((y > 0) | ((y == 0) & (z >= 0))))
        keep = inside & half
        trip = np.stack([x[keep] % nx, y[keep] % ny, z[keep] % nz], 1)
        vals = spec[trip[:, 2], trip[:, 1], trip[:, 0]]
        return trip, vals, np.fft.ifftn(spec, norm="forward").real
    stick = rng.random((ny, nx)) < 0.6
    keep = stick[y % ny, x % nx] & (rng.random(len(x)) < 0.7)
    trip = np.stack([x[keep] % nx, y[keep] % ny, z[keep] % nz], 1)
    vals = (rng.standard_normal(len(trip)) + 1j * rng.standard_normal(
        len(trip))).astype(np.complex64).astype(np.complex128)
    grid = np.zeros((nz, ny, nx), np.complex128)
    grid[trip[:, 2], trip[:, 1], trip[:, 0]] = vals
    return trip, vals, np.fft.ifftn(grid, norm="forward")


def prime_small_phase(sp, device):
    """Fused float32 plans at ``PRIME_SMALL_DIMS``, C2C and R2C, local and
    over 4 uneven shards (``PRIME_SMALL_SHARDS``): each z kernel launched
    in the Bluestein form only (once a direction locally); the backward
    within ``predicted_rel_error("single", 13)`` (relative l2) of the
    complex128 oracle, and the forward(FULL) of that oracle's space,
    rounded to float32, within it of the exact transform of what the plan
    was given. The plain Bluestein stage on the CPU computes its FFTs in
    complex128 (ROADMAP, differences kept on purpose): this phase reads
    the card's float32 kernels at the dims the CPU tests cover."""
    from spfft_tpu_torch.ops import fused_kernel as fk
    rng = np.random.default_rng(SEED + 13)
    on_card = device.type == "cuda"
    wrappers = (fk.decompress_zdft, fk.zdft_compress)
    weights, planes = PRIME_SMALL_SHARDS
    worst = 0.0
    for dims in PRIME_SMALL_DIMS:
        nx, ny, nz = dims
        for kind in (sp.TransformType.C2C, sp.TransformType.R2C):
            r2c = kind is sp.TransformType.R2C
            trip, vals, ref = _small_prime_set(rng, dims, r2c)
            pred = sp.predicted_rel_error("single", max(dims), True)
            sticks = trip[:, 1] * nx + trip[:, 0]
            owner = rng.choice(len(weights), nx * ny,
                               p=np.array(weights) / sum(weights))[sticks]
            parts = [trip[owner == r] for r in range(len(weights))]
            pvals = [vals[owner == r] for r in range(len(weights))]
            for shards in (1, len(weights)):
                name = (f"prime small {kind.name} {dims} "
                        f"{'local' if shards == 1 else f'{shards} shards'}")
                if shards == 1:
                    plan = sp.make_local_plan(kind, *dims, trip,
                                              device=device)
                    given = vals.astype(np.complex64)
                else:
                    plan = sp.make_distributed_plan(kind, *dims, parts,
                                                    list(planes),
                                                    device=device)
                    given = [v.astype(np.complex64) for v in pvals]
                for w in wrappers:
                    w.form_launches = dict.fromkeys(w.form_launches, 0)
                space = plan.backward(given)
                if shards == 1:
                    full, inp = space, space.clone()
                else:  # the slabs in z order, then back into the stacks
                    full = torch.cat([space[r, :planes[r]]
                                      for r in range(shards)])
                    inp = torch.zeros_like(space)
                    z0 = 0
                    for r in range(shards):
                        inp[r, :planes[r]] = full[z0:z0 + planes[r]]
                        z0 += planes[r]
                got = full.double().cpu().numpy()
                if not r2c:
                    got = got[..., 0] + 1j * got[..., 1]
                rel_b = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
                out = plan.forward(inp, sp.Scaling.FULL)
                sp32 = full.cpu().numpy().astype(np.float64)
                if not r2c:
                    sp32 = sp32[..., 0] + 1j * sp32[..., 1]
                exact = np.fft.fftn(sp32) / float(nx * ny * nz)
                if shards == 1:
                    o = out.double().cpu().numpy()
                    o = o[..., 0] + 1j * o[..., 1]
                    want = exact[trip[:, 2], trip[:, 1], trip[:, 0]]
                else:
                    o = np.concatenate(plan.unshard_values(out))
                    cat = np.concatenate(parts)
                    want = exact[cat[:, 2], cat[:, 1], cat[:, 0]]
                rel_f = float(np.linalg.norm(o - want) / np.linalg.norm(want))
                forms = [{f: k for f, k in w.form_launches.items() if k}
                         for w in wrappers]
                print(f"{name}: backward vs complex128 oracle rel_l2="
                      f"{rel_b:.3e}, forward(FULL) {rel_f:.3e} "
                      f"(predicted_rel_error={pred:.3e}); z kernels by form "
                      f"{forms}", flush=True)
                if not (rel_b <= pred and rel_f <= pred):
                    fail(f"{name}: rel_l2 {rel_b:.3e} / {rel_f:.3e} above "
                         f"predicted_rel_error {pred:.3e}")
                if on_card and any(
                        set(f) != {"bluestein"}
                        or (shards == 1 and f != {"bluestein": 1})
                        for f in forms):
                    fail(f"{name}: z kernels launched by form {forms}, "
                         f"expected the Bluestein form only")
                worst = max(worst, rel_b, rel_f)
    print(f"prime small: 8 fused float32 plans at dim_z 13 on "
          f"{device.type}, worst rel_l2 against the oracle {worst:.3e} "
          f"(predicted_rel_error {pred:.3e})", flush=True)


#: the slice's path at full width, 448^3: the C2C pair (fused route: each
#: z kernel once in the FFT form, pdft2 twice in two FFT stage launches,
#: 448^2 planes exceed one cluster) and the R2C pair (as 256^3's); and the
#: local R2C plan at 375^3, whose odd x takes Bluestein's FFT
C2C448_LAUNCHES = {"decompress_zdft": ZFFT1, "pdft2": (4, 4, {"fft": 4}),
                   "zdft_compress": ZFFT1, "prdft2": (0, 0),
                   "pdft2_cr": (0, 0), "gather": (0, 0), "pdft_last": (0, 0),
                   "pdft2_swapped": (0, 0), **NO_REAL_LAST}
R2C375_N = 375
R2C375_LAUNCHES = {"decompress_zdft": ZFFT1,
                   "prdft2": (2, 2, {"bluestein": 1, "fft": 1}),
                   "pdft2_cr": (2, 2, {"fft": 1, "bluestein": 1}),
                   "zdft_compress": ZFFT1, "pdft2": (0, 0), "gather": (0, 0),
                   "pdft_last": (0, 0), "pdft2_swapped": (0, 0),
                   **NO_REAL_LAST}


def _length_path(sp, path, plan, values, oracle_rel, device, counters,
                 want, phase, precisions=("single", "double")):
    """A path of :func:`length_phases`: its kernels at its shapes
    (``phase``: ``kernel_phase`` or ``r2c_kernel_phase``) and its counted
    pair, in float32 and then, where ``precisions`` holds ``"double"``, in
    float64 on the same index plan (``precision="double"``, the values
    widened, records with paths ``*_f64``). Returns the records."""
    recs = []
    for precision in precisions:
        if precision == "double":
            plan = sp.TransformPlan(plan.index_plan, precision=precision,
                                    device=device)
            values, path = values.double(), path + "_f64"
        rr = phase(plan, values, device, path=path)
        set_launches(rr, pair_phase(sp, path, plan, values, oracle_rel,
                                    device, counters, want))
        recs += rr
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return recs


def length_phases(sp, device, counters):
    """The slice's path at full width: the C2C path (``main_path_plan``) at
    ``MATRIX_N``^3 (47,077,534 values in 157,583 sticks), each kernel at
    its shapes against its plain version with the matrix form's time on
    the same inputs (``kernel_phase``), and the counted pair against the
    complex128 oracle (``pair_phase``: every stage and z kernel in an FFT
    form, no matrix launch), in float32 and float64; the same for the R2C
    path on the half sphere; then the local R2C plan at ``R2C375_N``^3,
    whose odd x runs Bluestein's FFT: its kernels at its shapes
    (``r2c_kernel_phase``) and its counted pair, in float32. Returns the
    records."""
    n = MATRIX_N
    plan, trip, values = main_path_plan(sp, n, device)
    recs = _length_path(sp, f"c2c{n}", plan, values,
                        c2c_oracle_rel(plan, trip, values, device), device,
                        counters, C2C448_LAUNCHES, kernel_phase)
    del plan, trip, values
    for n, path, want in ((MATRIX_N, f"r2c{MATRIX_N}", R2C_LAUNCHES),
                          (R2C375_N, f"r2c{R2C375_N}", R2C375_LAUNCHES)):
        plan, _, values, oracle = r2c_plan(sp, n, device)

        def oracle_rel(space, oracle=oracle):
            return float(torch.linalg.norm(space.double() - oracle)
                         / torch.linalg.norm(oracle))

        recs += _length_path(sp, path, plan, values, oracle_rel, device,
                             counters, want, r2c_kernel_phase,
                             ("single", "double") if n == MATRIX_N
                             else ("single",))
        del plan, values, oracle
    return recs


def ptxas_spills(log: str) -> dict:
    """``{kernel: (registers, spill store bytes)}`` of every entry
    function in an ``nvcc -Xptxas -v`` log, by mangled name. An entry's
    lines run from its ``Compiling entry function`` to the next one; its
    spill stores are the sum over every function listed there (the entry
    and the functions it calls)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, None]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[name][1] = (out[name][1] or 0) + int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


#: the kernels whose float instances must not spill, by library, each a
#: pattern of its mangled name up to the template arguments it fixes: every
#: instance of the long-axis and Bluestein kernels (the fused z kernels'
#: Bluestein form too), and the instances of the kernels over
#: fft_tile.cuh that hold its radix-7 and 11 stages (template arguments
#: POW2 false, ODD true: ...ILb0ELb1E...; the cluster kernel takes radices
#: 2-5 alone)
NO_SPILL = {"fft_long.cu": ("fft_long_whole_kernelI", "fft_long_col_kernelI",
                            "fft_long_kernelI"),
            "bluestein.cu": ("bluestein_kernelI",),
            "fft.cu": ("fft_stage_kernelILb0ELb1E",),
            "rfft.cu": ("rfft_stage_kernelILi1ELb0ELb1E",
                        "rfft_stage_kernelILi2ELb0ELb1E"),
            "fused_fft.cu": ("decompress_zdft_fft_kernelILb0ELb1E",
                             "zdft_compress_fft_kernelILb0ELb1E"),
            "fused_bluestein.cu": ("decompress_zdft_bluestein_kernelI",
                                   "zdft_compress_bluestein_kernelI")}


def spill_check(build_log: dict) -> None:
    """Print the registers and spill stores of each instance of the
    kernels ``NO_SPILL`` names, read from the build log kept with each
    library (``_build.build_log``). Fails where a source has no log, a
    pattern has no float instance, an instance's real type, registers or
    spill stores cannot be read, or a float instance spills."""
    for src, kernels in NO_SPILL.items():
        if not build_log.get(src):
            fail(f"{src}: no nvcc log beside its library")
        floats = set()
        for name, (regs, spill) in ptxas_spills(build_log[src]).items():
            kern = next((k for k in kernels if k in name), None)
            if kern is None:
                continue
            # the template arguments: ...kernelILi64EfE... (float) / dE
            m = re.search(kern + r"(?:L[a-z]\d+E)*([fd])E", name)
            if m is None or regs is None or spill is None:
                fail(f"{src}: {name}: real type, registers or spill stores "
                     f"not read from the log ({regs}, {spill})")
            real = {"f": "float", "d": "double"}[m.group(1)]
            print(f"ptxas {src}: {name} ({kern}, {real}): {regs} registers, "
                  f"{spill} bytes spill stores", flush=True)
            if real == "float":
                floats.add(kern)
                if spill:
                    fail(f"{src}: {name} spills {spill} bytes in float")
        if floats != set(kernels):
            fail(f"{src}: no float instance of "
                 f"{sorted(set(kernels) - floats)} in the log")


#: the sources over fft_tile.cuh whose ptxas reports ``--ptxas-of``
#: prints
PTXAS_OF = ("fft.cu", "rfft.cu", "fused_fft.cu", "fft_long.cu")


def ptxas_of(tree: str) -> int:
    """``python3 chip_smoke.py --ptxas-of TREE``: compile ``PTXAS_OF``
    from ``TREE/spfft_tpu_torch/csrc`` (another checkout, such as a
    parent commit's ``git archive``) with this checkout's ``nvcc`` flags,
    one ``nvcc`` a source, all at once, into a temporary directory, and
    print each entry's registers and spill stores (:func:`ptxas_spills`),
    so that a tree's report sits beside the one this checkout's build
    prints. Needs ``nvcc``, not a card."""
    import tempfile
    from spfft_tpu_torch.ops import _build
    csrc = os.path.join(tree, "spfft_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as out:
        procs = {n: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(out, n + ".so"), os.path.join(csrc, n)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in PTXAS_OF}
        try:
            logs = {n: p.communicate(timeout=_build.BUILD_TIMEOUT_S)
                    for n, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for n, (log, _) in logs.items():
        if procs[n].returncode != 0:
            fail(f"nvcc failed on {csrc}/{n}:\n{log[-4000:]}")
        for name, (regs, spill) in ptxas_spills(log).items():
            print(f"ptxas-of {tree} {n}: {name}: {regs} registers, {spill} "
                  f"bytes spill stores", flush=True)
    return 0


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
              ["-d", "256", "-r", "10", "--shards", "4", "-e", "compact",
               "--overlap-chunks", "2"],
              ["-d", "256", "-r", "2", "--shards", "4", "-e", "all"],
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
        if "all" in argv:  # the exchange sweep: its JSON on one line
            sweep = json.loads(next(line for line in text.splitlines()
                                    if line.startswith('{"parameters"')))
            params = dict(sweep["parameters"],
                          exchange_sweep=sweep["exchange_sweep"])
            if len(sweep["exchange_sweep"]) != 5:
                fail(f"benchmark {' '.join(argv)}: {sweep}")
        else:
            params = json.loads(text[:text.index("\n}\n") + 2])
        # (the exchange sweep's parameters have no "pallas", as the JAX
        # CLI's)
        if params["backend"] != "cuda" or not params.get("pallas", True) \
                or not params["device_kind"] or not params["power_limit"]:
            fail(f"benchmark {' '.join(argv)}: {params}")
        print(f"benchmark {' '.join(argv)} ({card}; "
              f"{time.perf_counter() - t0:.1f} s with its plan): "
              f"{json.dumps(params)}", flush=True)
        out.append(params)
        torch.cuda.empty_cache()
    return out


# -- the native planner and one process per GPU -------------------------------

#: the 768^3 C2C plan build (``make_local_plan``) on the numpy planner, as
#: this script measured it before the plans took the native planner:
#: seconds, GiB of host memory the build took, and the card it ran beside
NUMPY_768_PLAN = (26.63, 21.40, "NVIDIA H100 80GB HBM3, 700.00 W")
#: the sides at which the native and numpy index plans are held equal
PLANNER_NS = (256, 448)
PLANNER_ROWS = []


def _index_tables(indexing, n, trip, native):
    """The index plan of the C2C n^3 set ``trip`` and its inverse maps
    (the slot map and the stick-key column map), each on the planner
    ``native`` asks for."""
    p = indexing.build_index_plan("c2c", n, n, n, trip, native=native)
    slot = indexing.inverse_slot_map(p.value_indices, p.num_sticks * n,
                                     p.num_values, native=native)
    cols = indexing.inverse_col_map(p.stick_keys, n * n, p.num_sticks,
                                    native=native)
    return p, slot, cols


def planner_phase(sp):
    """The native and the numpy index planners on the C2C sphere at each
    side of ``PLANNER_NS`` (256^3, the main path, and 448^3): the plans
    equal table for table (value slots, stick keys, the inverse slot and
    column maps, ``centered``), each with its seconds and the host memory
    it took; the native plan says it is native."""
    import gc
    from spfft_tpu_torch import indexing
    from spfft_tpu_torch.native import planner
    from spfft_tpu_torch.utils.workloads import \
        spherical_cutoff_triplets_stick_major
    # the library's build (g++, once per checkout) apart from the timings
    t0 = time.perf_counter()
    reason = planner.unavailable_reason()
    if reason is not None:
        fail(f"planner: {reason}")
    print(f"planner: native library {planner.LIBRARY.name} built and loaded "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    for n in PLANNER_NS:
        trip = spherical_cutoff_triplets_stick_major(n)
        got = {}
        for native in (False, True):
            gc.collect()
            t0 = time.perf_counter()
            tables, rss = peak_rss_over(
                lambda: _index_tables(indexing, n, trip, native))
            got[native] = (tables, time.perf_counter() - t0, rss)
        (nat, nslot, ncols), nat_s, nat_rss = got[True]
        (ref, rslot, rcols), ref_s, ref_rss = got[False]
        check_native(f"planner {n}^3", [nat])
        if ref.planner != "numpy":
            fail(f"planner {n}^3: native=False planned by {ref.planner}")
        for what, a, b in (("value_indices", nat.value_indices,
                            ref.value_indices),
                           ("stick_keys", nat.stick_keys, ref.stick_keys),
                           ("slot map", nslot, rslot),
                           ("column map", ncols, rcols)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                fail(f"planner {n}^3: the native {what} differs from the "
                     f"numpy planner's")
        if nat.centered != ref.centered:
            fail(f"planner {n}^3: centered differs")
        for planner, secs, rss in (("native", nat_s, nat_rss),
                                   ("numpy", ref_s, ref_rss)):
            PLANNER_ROWS.append({"n": n, "planner": planner, "plan_s": secs,
                                 "rss_gib": rss / 2**30,
                                 "what": "index plan and inverse maps",
                                 "card": CARD})
        print(f"planner {n}^3 C2C sphere ({nat.num_values} values, "
              f"{nat.num_sticks} sticks): native {nat_s:.3f} s, "
              f"{nat_rss / 2**30:.3f} GiB; numpy {ref_s:.3f} s, "
              f"{ref_rss / 2**30:.3f} GiB; every table equal (the card's "
              f"host, {CARD})", flush=True)
        del got, nat, ref, nslot, rslot, ncols, rcols, trip


#: the ranks phase: 4 shards of the 256^3 paths, round-robin sticks,
#: 64-plane slabs, over two gloo ranks on the one card (two shards each)
#: and over one NCCL rank (all four). label -> (transform, precision,
#: exchange, the op schedule, K, wire_precision, fused)
RANK_CASES = {
    "buffered": ("c2c", "single", "BUFFERED", False, 1, 0, True),
    "ragged": ("c2c", "single", "COMPACT_BUFFERED", False, 1, 0, True),
    "wire_f32": ("c2c", "single", "BUFFERED", False, 1, 1, True),
    "wire_bf16": ("c2c", "single", "BUFFERED", False, 1, 2, True),
    "wire_int8": ("c2c", "single", "BUFFERED", False, 1, 3, True),
    "block_k2": ("c2c", "single", "BUFFERED", False, 2, 0, True),
    "ragged_k2": ("c2c", "single", "COMPACT_BUFFERED", False, 2, 0, True),
    "buffered_2k": ("c2c", "single", "BUFFERED", False, 1, 0, False),
    "ragged_2k": ("c2c", "single", "COMPACT_BUFFERED", False, 1, 0, False),
    "r2c_buffered": ("r2c", "single", "BUFFERED", False, 1, 0, True),
    "r2c_ragged": ("r2c", "single", "COMPACT_BUFFERED", False, 1, 0, True),
    "r2c_buffered_2k": ("r2c", "single", "BUFFERED", False, 1, 0, False),
    "f64_buffered": ("c2c", "double", "BUFFERED", False, 1, 0, True),
    "f64_ragged": ("c2c", "double", "COMPACT_BUFFERED", False, 1, 0, True),
}
#: the point-to-point kinds: run over NCCL; over gloo on the card a plan
#: of them must be refused with DistributedError
RANK_P2P_CASES = {
    "ring": ("c2c", "single", "UNBUFFERED", False, 1, 0, True),
    "compact": ("c2c", "single", "COMPACT_BUFFERED", True, 1, 0, True),
}
#: the kinds each mechanism takes over ranks
RANK_KINDS = {"block": "all_to_all", "ring": "p2p_ring",
              "ragged": "all_to_all_v", "compact": "p2p_ops"}
#: the lossy rungs, held to the oracle (the others bit for bit)
RANK_LOSSY = ("wire_bf16", "wire_int8")
#: seconds a world of ranks may take (its plans and pairs included)
RANK_TIMEOUT_S = 420
#: the mismatched-dims check's side
RANK_MISMATCH_N = 16


def rank_inputs(transform, precision, n, device, shards):
    """The ranks phase's inputs: the path's set split round-robin over
    ``DIST_SHARDS`` shards, the even slab heights, and the values of the
    shards ``shards`` stacked ``(len(shards), max_values, 2)`` (the
    values the one-process plan is given, ``max_values`` over all
    shards); for C2C single also the complex128 oracle of the backward."""
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition)
    oracle = None
    if transform == "r2c":
        trip, values, _ = r2c_inputs(n, device, precision)
    else:
        trip, values = c2c_inputs(n, device, precision)
        if precision == "single":
            st = torch.as_tensor(np.where(trip < 0, trip + n, trip)
                                 .astype(np.int64), device=device)
            grid = torch.zeros((n, n, n), dtype=torch.complex128,
                               device=device)
            grid[st[:, 2], st[:, 1], st[:, 0]] = torch.view_as_complex(
                values.double().contiguous())
            oracle = torch.fft.ifftn(grid, norm="forward")
            del grid, st
    parts = round_robin_stick_partition(trip, (n, n, n), _S)
    max_values = max(len(p) for p in parts)
    stacked = stacked_values(n, trip, values, [parts[r] for r in shards],
                             max_values, device)
    return parts, even_plane_split(n, _S), stacked, oracle


def _digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def device_busy_ms(fn, reps=3):
    """The card's busy time of one call of ``fn`` in ms: the kernels' and
    copies' durations CUPTI records (``torch.profiler``), summed, per
    call; None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total / 1e3 / reps if total > 0 else None


def _rank_plan(sp, dp, mesh, case):
    from spfft_tpu_torch.parallel import dist
    _, precision, exchange, ppermute, k, wire, fused = case
    old = os.environ.pop(dist.COMPACT_PPERMUTE_ENV, None)
    if ppermute:
        os.environ[dist.COMPACT_PPERMUTE_ENV] = "1"
    try:
        return sp.DistributedTransformPlan(
            dp, mesh=mesh, precision=precision, fused=fused,
            exchange=sp.ExchangeType[exchange], overlap_chunks=k,
            wire_precision=wire, wire_error_budget=1.0)
    finally:
        os.environ.pop(dist.COMPACT_PPERMUTE_ENV, None)
        if old is not None:
            os.environ[dist.COMPACT_PPERMUTE_ENV] = old


def _rank_want(transform, fused, local, gathers, int8_k):
    """The launches of one pair on a rank holding ``local`` shards: the
    z kernels once per local shard (fused), or the gather a direction
    over them; the xy stage once; the exchange's ``gathers`` and the
    int8 kernels ``int8_k`` a direction each."""
    z = (local, local, {"fft": local})
    if transform == "c2c":
        base = dict(DIST_C2C_LAUNCHES if fused else DIST_C2C_2K_LAUNCHES)
    else:
        base = dict(DIST_R2C_LAUNCHES if fused else DIST_R2C_2K_LAUNCHES)
    if fused:
        base["decompress_zdft"] = base["zdft_compress"] = z
    return exchange_want(base, gathers, int8_k)


def rank_worker(spec_path: str, rank: int) -> int:
    """One rank of the ranks phase (``chip_smoke.py --rank-worker SPEC
    RANK``): brings up the group, and per path builds the plan from its
    own shards' triplets (``build_distributed_plan_multihost``) on a mesh
    over the group, then per case of :data:`RANK_CASES` (and, over NCCL,
    :data:`RANK_P2P_CASES`) its counted backward + forward(FULL) pair on
    its own shards: the launches, each shard's output digests, the
    oracle's partial sums for the lossy rungs, the pair's ms per call and
    the card's busy time, the wire bytes. Over gloo, the point-to-point
    kinds' refusal; then a mismatched-dims build. Writes its results as
    JSON beside the spec."""
    with open(spec_path) as f:
        spec = json.load(f)
    global CARD
    CARD = spec["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    import spfft_tpu_torch as sp
    t0 = time.perf_counter()
    sp.initialize_multihost(f"localhost:{spec['port']}", spec["world"], rank,
                            backend=spec["backend"], timeout_s=RANK_TIMEOUT_S)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # over gloo on the card the point-to-point kinds are refused (checked
    # below); NCCL, and gloo on the host, run them
    p2p_runs = spec["backend"] == "nccl" or device.type == "cpu"
    group = dist.group.WORLD
    mesh = sp.make_mesh(_S, device, process_group=group)
    mine = list(mesh.shard_range)
    n = spec["n"]
    counters = launch_counters()
    out = {"rank": rank, "shards": mine, "up_s": time.perf_counter() - t0,
           "cases": {}, "refused": {}, "plans": {}}
    cases = dict(RANK_CASES)
    if p2p_runs:
        cases.update(RANK_P2P_CASES)
    for path in dict.fromkeys((c[0], c[1]) for c in cases.values()):
        transform, precision = path
        parts, planes, stacked, oracle = rank_inputs(transform, precision, n,
                                                     device, mine)
        t0 = time.perf_counter()
        dp = sp.build_distributed_plan_multihost(
            sp.TransformType[transform.upper()], n, n, n,
            [parts[r] for r in mine], [planes[r] for r in mine],
            process_group=group)
        check_native(f"rank {rank} {transform} plan", dp.shard_plans)
        out["plans"]["_".join(path)] = time.perf_counter() - t0
        for label, case in cases.items():
            if case[:2] != path:
                continue
            t0 = time.perf_counter()
            plan = _rank_plan(sp, dp, mesh, case)
            build_s = time.perf_counter() - t0
            base, _, k = plan.exchange_kind.partition("x")
            if base not in RANK_KINDS.values():
                fail(f"rank {rank} {label}: exchange kind "
                     f"{plan.exchange_kind} is not a collective of ranks")
            gathers = {"all_to_all": 0, "p2p_ring": 0,
                       "all_to_all_v": 2 * (plan.overlap_chunks + 1),
                       "p2p_ops": 0}[base]
            if base == "p2p_ops":
                gathers = 2 * (len(plan._compact.ops) + 1)
            int8_k = plan.overlap_chunks if plan.wire_rung_name == "int8" \
                else 0
            reset_launches(counters)
            space = plan.backward(stacked)
            res = plan.forward(space, sp.Scaling.FULL)
            _sync(device)
            # only a CUDA tensor launches a kernel: a rehearsal on the host
            # counts none
            launches = read_launches(
                f"rank {rank} {label}", counters,
                _rank_want(transform, case[6], len(mine), gathers, int8_k)
                if device.type == "cuda" else {})
            rec = {"kind": plan.exchange_kind, "rung": plan.wire_rung_name,
                   "probe": plan.wire_probe_error, "plan_s": build_s,
                   "launches": launches,
                   "backward": [_digest(space[i]) for i in range(len(mine))],
                   "forward": [_digest(res[i]) for i in range(len(mine))],
                   "wire_bytes": plan.exchange_wire_bytes(),
                   "wire_bytes_forward": plan.exchange_wire_bytes(True)}
            if oracle is not None:
                num = den = 0.0
                for i, r in enumerate(mine):
                    lo = plan.local_z_offset(r)
                    ref = oracle[lo:lo + plan.local_z_length(r)]
                    got = torch.view_as_complex(
                        space[i, :ref.shape[0]].double().contiguous())
                    num += float(torch.linalg.norm(got - ref)) ** 2
                    den += float(torch.linalg.norm(ref)) ** 2
                rec["oracle_sums"] = (num, den)
            del space, res
            rec["pair_ms"] = timed_ms(
                lambda: plan.forward(plan.backward(stacked),
                                     sp.Scaling.FULL), device)
            rec["busy_ms"] = device_busy_ms(
                lambda: plan.forward(plan.backward(stacked),
                                     sp.Scaling.FULL)) \
                if device.type == "cuda" else None
            out["cases"][label] = rec
            del plan
            if device.type == "cuda":
                torch.cuda.empty_cache()
        if path == ("c2c", "single") and not p2p_runs:
            for label, case in RANK_P2P_CASES.items():
                try:
                    _rank_plan(sp, dp, mesh, case)
                    out["refused"][label] = None
                except sp.DistributedError as exc:
                    out["refused"][label] = str(exc)
        del dp, stacked, oracle
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["mismatch"] = None
    if spec["world"] > 1:
        out["mismatch"] = _rank_mismatch(sp, rank, spec["world"], mine,
                                         device, group)
    dist.destroy_process_group()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _rank_mismatch(sp, rank, world, mine, device, group):
    """The last rank passes another dim_z (and one more plane) to
    ``build_distributed_plan_multihost``: the class of what this rank
    raised, or None."""
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition)
    m = RANK_MISMATCH_N
    trip, _ = c2c_inputs(m, device)
    parts = round_robin_stick_partition(trip, (m, m, m), _S)
    planes = even_plane_split(m, _S)
    dims = (m, m, m)
    if rank == world - 1:
        dims = (m, m, m + 1)
        planes = planes[:-1] + [planes[-1] + 1]
    try:
        sp.build_distributed_plan_multihost(
            sp.TransformType.C2C, *dims, [parts[r] for r in mine],
            [planes[r] for r in mine], process_group=group)
    except Exception as exc:  # noqa: BLE001 - its class is the check
        return type(exc).__name__
    return None


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(backend: str, world: int, n: int, device,
              card_each: bool = False) -> list:
    """Spawn ``world`` ranks of :func:`rank_worker` over ``backend``, on
    ``device`` (with ``card_each``, rank r on card r alone, through its
    ``CUDA_VISIBLE_DEVICES``); their results, once every rank exited 0
    within ``RANK_TIMEOUT_S`` (the phase fails otherwise, and no rank is
    left running). Each rank's output goes to ``rank<r>.log`` beside its
    results."""
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "ranks", f"{backend}{world}")
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump({"port": _free_port(), "world": world, "backend": backend,
                   "n": n, "out": out, "card": CARD, "device": str(device)},
                  f)
    t0 = time.perf_counter()
    procs, rcs = [], []
    try:
        for r in range(world):
            env = dict(os.environ)
            if card_each:
                env["CUDA_VISIBLE_DEVICES"] = str(r)
            with open(os.path.join(out, f"rank{r}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--rank-worker", spec, str(r)], stdout=log,
                    stderr=subprocess.STDOUT, env=env))
        for p in procs:
            try:
                p.wait(timeout=max(
                    1.0, RANK_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                pass
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.log")) as log:
            tail = [ln for ln in log.read().splitlines()
                    if "socket.cpp" not in ln]
        print(f"{backend} rank {r} of {world}: exit {rcs[r]}; last lines:\n"
              + "\n".join(tail[-8:]), flush=True)
    if rcs != [0] * world:
        fail(f"ranks phase ({backend}, {world} ranks): exit codes {rcs} "
             f"after {time.perf_counter() - t0:.1f} s")
    res = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    print(f"ranks phase ({backend}, {world} ranks): {time.perf_counter() - t0:.1f}"
          f" s wall", flush=True)
    return res


def _reference_digests(sp, n, device) -> dict:
    """The one-process 4-shard plan's digests (BUFFERED, fused) per path:
    each shard's backward and forward(FULL), on the same values."""
    from spfft_tpu_torch.utils.workloads import even_plane_split
    refs = {}
    for path in dict.fromkeys((c[0], c[1]) for c in RANK_CASES.values()):
        transform, precision = path
        parts, planes, stacked, _ = rank_inputs(transform, precision, n,
                                                device, range(_S))
        plan = sp.make_distributed_plan(
            sp.TransformType[transform.upper()], n, n, n, parts,
            even_plane_split(n, _S), mesh=sp.make_mesh(_S, device),
            precision=precision)
        space = plan.backward(stacked)
        res = plan.forward(space, sp.Scaling.FULL)
        refs[path] = ([_digest(space[r]) for r in range(_S)],
                      [_digest(res[r]) for r in range(_S)])
        del plan, space, res, stacked
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return refs


#: the worlds of the ranks phase: (backend, ranks, what its figures are)
RANK_WORLDS = (("gloo", 2, "gloo, two ranks on one card, host-staged"),
               ("nccl", 1, "NCCL, one rank"))


def ranks_phase(sp, device, n=N, worlds=RANK_WORLDS, card_each=False):
    """The distributed plan over the ranks of a process group on the card
    (4 shards of the 256^3 C2C sphere and R2C half sphere, round-robin
    sticks, 64-plane slabs), the worlds side by side: (a) two gloo ranks
    on the one card, two shards each (gloo stages the all-to-all through
    the host); (b) one NCCL rank owning all four. Every case of :data:`RANK_CASES` on every
    rank: the counted pair (z kernels once per local shard, the xy stage
    once, the exchange's gathers and int8 kernels), each shard's
    backward and forward(FULL) bit for bit the one-process 4-shard
    plan's (the lossless kinds and f32; bf16 and int8 within ``max(4 *
    wire_probe_error, predicted_rel_error)`` of the complex128 oracle),
    its ms per call and the card's busy time, its wire bytes. Over NCCL
    also the ring and the op schedule; over gloo their plans must be
    refused with DistributedError (gloo's point-to-point cannot read
    device memory). A rank passing other dims raises
    ParameterMismatchError on every rank. ``worlds`` and ``card_each``
    as in :func:`run_world` (``chip_smoke.py --ranks nccl 4`` on four
    cards). Returns the rows."""
    t0 = time.perf_counter()
    refs = _reference_digests(sp, n, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"ranks phase: one-process references in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tol = sp.predicted_rel_error("single", n)
    rows = []
    # a rehearsal on the host: gloo only
    worlds = [w for w in worlds if device.type == "cuda" or w[0] != "nccl"]
    # the worlds run side by side, each its own processes and port: both
    # are mostly host work (process starts, plan builds, gloo's host
    # staging), which the script's time limit cannot hold one after the
    # other on a slower host; the card is 92 % idle under gloo
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(worlds)) as pool:
        runs = [pool.submit(run_world, backend, world, n, device, card_each)
                for backend, world, _ in worlds]
        results = [r.result() for r in runs]
    for (backend, world, label), res in zip(worlds, results):
        for r in res:
            if world > 1 and r["mismatch"] != "ParameterMismatchError":
                fail(f"{backend} rank {r['rank']}: a rank with other dims "
                     f"raised {r['mismatch']}, not ParameterMismatchError")
            if backend == "gloo" and device.type == "cuda":
                for kind, msg in r["refused"].items():
                    if not msg or "gloo" not in msg \
                            or "batch_isend_irecv" not in msg:
                        fail(f"gloo rank {r['rank']}: the {kind} plan on "
                             f"the card was not refused with "
                             f"DistributedError ({msg})")
        cases = dict(RANK_CASES)
        if backend == "nccl" or device.type == "cpu":
            cases.update(RANK_P2P_CASES)
        for case_label, case in cases.items():
            recs = [r["cases"][case_label] for r in res]
            ref_b, ref_f = refs[case[:2]]
            same = all(rec["backward"][i] == ref_b[s]
                       and rec["forward"][i] == ref_f[s]
                       for r, rec in zip(res, recs)
                       for i, s in enumerate(r["shards"]))
            err = None
            if case_label in RANK_LOSSY:
                num = sum(rec["oracle_sums"][0] for rec in recs)
                den = sum(rec["oracle_sums"][1] for rec in recs)
                err = math.sqrt(num / den)
                bound = max(4 * recs[0]["probe"], tol)
                if err > bound:
                    fail(f"{backend} {case_label}: backward {err:.3e} from "
                         f"the oracle, above {bound:.3e}")
            elif not same:
                fail(f"{backend} {case_label}: a rank's backward or "
                     f"forward differs from the one-process plan's")
            rec = recs[0]
            row = {"backend": backend, "ranks": world, "case": case_label,
                   "kind": rec["kind"], "rung": rec["rung"],
                   "pair_ms": rec["pair_ms"], "busy_ms": rec["busy_ms"],
                   "pair_ms_ranks": [x["pair_ms"] for x in recs],
                   "wire_bytes": rec["wire_bytes"],
                   "wire_bytes_forward": rec["wire_bytes_forward"],
                   "plan_s": rec["plan_s"], "bit_equal": same,
                   "oracle_rel": err, "launches": rec["launches"],
                   "label": label, "card": CARD}
            rows.append(row)
            print(f"ranks {case_label} ({label}; {rec['kind']}, rung "
                  f"{rec['rung']}): pair {rec['pair_ms']:.4f} ms per call "
                  f"(rank 0; every rank {row['pair_ms_ranks']}), card busy "
                  f"{_ms(rec['busy_ms'])} ms, wire {rec['wire_bytes']} B a "
                  f"direction, plan {rec['plan_s']:.2f} s; "
                  + ("bit for bit the one-process plan" if same else
                     f"{err:.3e} from the oracle") + f" ({CARD})",
                  flush=True)
        print(f"ranks {backend}: plan builds "
              f"{[r['plans'] for r in res]} s, up in "
              f"{[round(r['up_s'], 2) for r in res]} s ({CARD})", flush=True)
    return rows


def launch_counters() -> dict:
    """Every kernel wrapper, by the name the launch tables use; each
    counts its launches (``.launches``, and by form ``.form_launches``)."""
    from spfft_tpu_torch.ops import (dft_kernel, fused_kernel, gather_kernel,
                                     wire_kernel)
    return {"wire_quantize": wire_kernel.quantize,
            "wire_dequantize": wire_kernel.dequantize,
            "decompress_zdft": fused_kernel.decompress_zdft,
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
    t0 = time.perf_counter()
    EXCHANGE_ROWS.extend(exchange_skew_phase(sp, n, trip, values, oracle,
                                             device, counters))
    print(f"dist c2c skewed exchange phase: {time.perf_counter() - t0:.1f} s "
          f"({CARD})", flush=True)
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
    plan, trip, values = main_path_plan(sp, n // 2, device)
    sweep_phase(sp, "c2c", plan, values, device, sweep)
    dplan, stacked = dist_plan(sp, n // 2, trip, values, device)
    dist_sweep_phase(sp, "dist_c2c", dplan, stacked, device, DIST_SWEEP)
    plan, trip, values, _ = r2c_plan(sp, n // 2, device)
    sweep_phase(sp, "r2c", plan, values, device, sweep)
    dplan, stacked = dist_plan(sp, n // 2, trip, values, device, r2c=True)
    dist_sweep_phase(sp, "dist_r2c", dplan, stacked, device, DIST_SWEEP)
    del plan, values, dplan, stacked
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


#: timed calls of the C drive (``native/capi_drive.c``: TIMED) and of
#: the Python references beside it
CAPI_TIMED = 5


def host_ms(fn, device, reps=CAPI_TIMED, warmup=2) -> float:
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
    capi_check(lib, "plan_create_distributed(exchange 42)",
               lib.spfft_tpu_plan_create_distributed(
                   ctypes.addressof(d), 0, n, n, n, _S, vps.ctypes.data,
                   dtrip.ctypes.data, pps.ctypes.data, 0, 42, PALLAS_AUTO), 5)
    # every exchange code creates and runs; the lossless ones (BUFFERED 1,
    # COMPACT_BUFFERED 3, UNBUFFERED 5) give the same space bit for bit
    dvals = np.random.default_rng(SEED).standard_normal(
        (len(dtrip), 2)).astype(np.float32)
    dspace = {}
    for code in (1, 2, 3, 4, 5):
        capi_check(lib, f"plan_create_distributed(exchange {code})",
                   lib.spfft_tpu_plan_create_distributed(
                       ctypes.addressof(d), 0, n, n, n, _S, vps.ctypes.data,
                       dtrip.ctypes.data, pps.ctypes.data, 0, code,
                       PALLAS_AUTO))
        out = np.empty((n, n, n, 2), np.float32)
        capi_check(lib, f"backward(exchange {code})", lib.spfft_tpu_backward(
            d.value, dvals.ctypes.data, out.ctypes.data))
        capi_check(lib, "plan_destroy", lib.spfft_tpu_plan_destroy(d.value))
        if not np.isfinite(out).all():
            fail(f"capi exchange {code}: backward not finite")
        dspace[code] = out
    for code in (3, 5):
        if not np.array_equal(dspace[code], dspace[1]):
            fail(f"capi exchange {code}: backward differs from BUFFERED's")
    print("capi distributed exchange codes 1-5 on the card: each created "
          "and ran (code 0); COMPACT_BUFFERED and UNBUFFERED bit for bit "
          "BUFFERED's backward", flush=True)
    capi_check(lib, "backward(invalid handle)", lib.spfft_tpu_backward(
        12345, values.ctypes.data, space.ctypes.data), 2)
    bad = np.array([[n, 0, 0]], np.int32)
    capi_check(lib, "plan_create(bad index)", lib.spfft_tpu_plan_create(
        ctypes.addressof(d), 0, n, n, n, 1, bad.ctypes.data, 0,
        PALLAS_AUTO), 7)
    capi_check(lib, "plan_destroy", lib.spfft_tpu_plan_destroy(h))
    print("capi error surface on the card: exchange code 42 -> 5, invalid "
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
    """Each case of :data:`CAPI_CASES` through ``capi_drive`` (one
    process for every case, its own embedded interpreter): every output
    bit for bit the Python API's on the same inputs (the two-kernel case
    also the fused case's), and each call's time beside the Python API's
    on host arrays and on device-resident ones, with the bytes the call
    moves over PCIe. The cases' inputs are written first, the drive runs
    them one after another, then each case's outputs are compared and
    its directory removed. Returns the rows ``PERF.md`` records."""
    import shutil

    from spfft_tpu_torch import native
    root = native.BUILD_DIR / "drive"
    shutil.rmtree(root, ignore_errors=True)
    cases = []
    for name, (r2c, double, pallas, shards, batch) in CAPI_CASES.items():
        trip, vals, plan = capi_case_inputs(sp, n, r2c, double, shards,
                                            batch, device)
        if pallas == PALLAS_OFF:
            plan = sp.TransformPlan(plan.index_plan, device=device,
                                    fused=False, precision=plan.precision)
        d = root / name
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
        cases.append((name, batch, d, vals, plan))
        del trip
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = capi_run([drive] + [d for _, _, d, _, _ in cases], "capi_drive")
    lines = [ln for ln in out.splitlines() if ln.startswith("capi_drive")]
    if len(lines) != len(cases):
        fail(f"capi_drive printed {len(lines)} case lines for "
             f"{len(cases)} cases:\n{out[-2000:]}")
    rows = {}
    fused_refs = None
    for i, ((name, batch, d, vals, plan), line) in enumerate(zip(cases,
                                                                lines)):
        c_ms = {k: float(v) for k, v in re.findall(
            r"(\w+)_(?:ms|s)=([0-9.]+)", line)}
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
        # one process runs every case: only the first case's plan_create
        # is a cold start of the embedded interpreter
        row = {"create_s": c_ms["create"], "create_cold": i == 0}
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
        print(f"capi {name}: plan_create through C {c_ms['create']:.2f} s "
              f"({'cold' if i == 0 else 'warm'} process), "
              f"every output bit for bit the Python API's"
              + (" and the fused route's" if name == "c2c_off" else "")
              + f" ({smi})", flush=True)
        rows[name] = row
        del refs
    del cases
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


def _card_and_build(all_cards: bool = False):
    """What a phase run alone needs first: the card's name and power
    limit (``CARD``; with ``all_cards``, every card's line printed), TF32
    off, and the kernels' build. Returns the package."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(smi.stdout.strip() if all_cards else CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from spfft_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall", flush=True)
    import spfft_tpu_torch as sp
    return sp


def ranks_only(backend: str, world: int) -> int:
    """``chip_smoke.py --ranks BACKEND WORLD``: the ranks phase alone
    with one world of ``world`` ranks, each on a card of its own (a
    machine with that many cards), after the kernels' build."""
    sp = _card_and_build(all_cards=True)
    rows = ranks_phase(sp, torch.device("cuda", 0), worlds=(
        (backend, world, f"{backend}, {world} ranks, one card each"),),
        card_each=True)
    print(json.dumps({"ranks": rows}), flush=True)
    return 0


# -- faults, the control config, observability and the plan surface -----------

#: one backward: the fused route's launches, and the two-kernel route's (a
#: demoted backward), exactly
_BWD_ZERO = {"zdft_compress": (0, 0), "prdft2": (0, 0), "pdft2_cr": (0, 0),
             "pdft2_swapped": (0, 0), **NO_REAL_LAST}
FUSED_BWD_LAUNCHES = {"decompress_zdft": ZFFT1,
                      "pdft2": (1, 1, {"cluster": 1}), "gather": (0, 0),
                      "pdft_last": (0, 0), **_BWD_ZERO}
DEMOTED_BWD_LAUNCHES = {"decompress_zdft": (0, 0),
                        "pdft2": (1, 1, {"cluster": 1}), "gather": (1, 1),
                        "pdft_last": (1, 1, {"fft": 1}), **_BWD_ZERO}
#: the build of ``estimated_device_bytes``'s bound: the growth of
#: ``torch.cuda.memory_allocated()`` over a plan's construction lies
#: within 1 % + 1 MiB of it (the allocator rounds each block up to 512
#: bytes; a DFT table another plan made may be shared)
EST_BYTES_REL, EST_BYTES_ABS = 0.01, 1 << 20
#: the obs phases' records, printed as ``{"obs": ...}``
OBS_ROWS = {}


def demotions_total() -> float:
    """``spfft_fused_demotions_total`` summed over its labels."""
    from spfft_tpu_torch import obs
    fam = obs.GLOBAL_COUNTERS.snapshot().get("spfft_fused_demotions_total")
    return sum(fam["samples"].values()) if fam else 0.0


def no_demotions(phase: str) -> None:
    """Fail unless no fused kernel was demoted by ``phase``: a real
    kernel failure must never hide behind the demotion ladder."""
    k = demotions_total()
    if k:
        fail(f"{phase}: spfft_fused_demotions_total is {k}, expected 0 (a "
             f"fused kernel failed and was demoted)")


def obs_phase(sp, device, counters, n=N):
    """Tracing (sample rate 1.0) and the recorder on; the 256^3 C2C plan
    built and its counted pair run under them; the plan-build counter and
    span, the Prometheus text (parsed) against a scrape of
    ``MetricsServer`` on 127.0.0.1 port 0, a trace export, an incident
    bundle that validates, and the 4-shard plan's ``exchange.plan_build``
    span carrying its wire bytes. Then the pair's ms per call with obs
    off and on, and ``overhead_probe``'s disabled path. Returns the
    plan, its set and values for the next phases."""
    import urllib.request
    from pathlib import Path

    from spfft_tpu_torch import obs
    out = Path(__file__).resolve().parent / "build" / "obs"
    out.mkdir(parents=True, exist_ok=True)
    obs.GLOBAL_COUNTERS.reset()
    obs.GLOBAL_TRACER.reset()
    obs.reset_recorder()
    obs.enable()
    obs.GLOBAL_TRACER.set_sample_rate(1.0)
    obs.enable_recorder(incident_dir=str(out / "incidents"), auto=False)
    plan, trip, values = main_path_plan(sp, n, device)
    if obs.GLOBAL_COUNTERS.get("spfft_plan_builds_total", kind="local") != 1:
        fail("obs: the plan's build was not counted once")
    spans = [e for e in obs.GLOBAL_TRACER.events()
             if getattr(e, "name", "") == "compile.plan_build"]
    if len(spans) != 1 or spans[0].args.get("dims") != f"{n}x{n}x{n}":
        fail(f"obs: expected one compile.plan_build span of {n}^3, got "
             f"{[s.args for s in spans]}")
    full = sp.Scaling.FULL
    pair_phase(sp, "c2c obs", plan, values,
               c2c_oracle_rel(plan, trip, values, device), device, counters,
               C2C_LAUNCHES)
    text = obs.prometheus_text()
    parsed = obs.parse_prometheus_text(text)
    with obs.MetricsServer(port=0) as srv:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            scraped = obs.parse_prometheus_text(r.read().decode())
    if scraped != parsed:
        fail("obs: the /metrics scrape differs from prometheus_text()")
    payload = obs.export_trace(str(out / "trace.json"))
    with open(out / "trace.json") as f:
        back = json.load(f)
    names = {e.get("name") for e in back["traceEvents"]}
    if back != json.loads(json.dumps(payload)) \
            or "compile.plan_build" not in names:
        fail("obs: the exported trace is not the tracer's")
    bundle = obs.build_incident_bundle("manual:chip_smoke")
    bad = obs.validate_bundle(bundle)
    if bad:
        fail(f"obs: the incident bundle does not validate: {bad}")
    dplan, _ = dist_plan(sp, n, trip, values, device)
    ex = [e for e in obs.GLOBAL_TRACER.events()
          if getattr(e, "name", "") == "exchange.plan_build"]
    if not ex or ex[-1].args["wire_bytes"] != dplan.exchange_wire_bytes():
        fail(f"obs: exchange.plan_build does not carry the 4-shard plan's "
             f"exchange_wire_bytes {dplan.exchange_wire_bytes()}")
    del dplan
    on_ms = timed_ms(lambda: plan.forward(plan.backward(values), full),
                     device)
    obs.disable_recorder()
    obs.disable()
    off_ms = timed_ms(lambda: plan.forward(plan.backward(values), full),
                      device)
    obs.enable()
    obs.enable_recorder(incident_dir=str(out / "incidents"), auto=False)
    on_ms2 = timed_ms(lambda: plan.forward(plan.backward(values), full),
                      device)
    obs.disable_recorder()
    obs.disable()
    probe = obs.overhead_probe()
    OBS_ROWS.update({
        "card": CARD, "pair_ms_obs_off": off_ms,
        "pair_ms_obs_on": [on_ms, on_ms2],
        "overhead_probe_off_us": probe["off_us"],
        "overhead_probe_on_us": probe["on_us"],
        "prometheus_series": len(parsed),
        "trace_events": len(back["traceEvents"]),
        "bundle_events": len(bundle["events"])})
    print(f"obs phase: {n}^3 C2C pair {off_ms:.4f} ms/call obs off, "
          f"{on_ms:.4f} / {on_ms2:.4f} ms/call tracing + recorder on; "
          f"overhead_probe {probe['off_us']:.4f} us/request off, "
          f"{probe['on_us']:.4f} on; {len(parsed)} Prometheus series, the "
          f"scrape equal; trace and bundle valid ({CARD})", flush=True)
    return plan, trip, values


def faults_phase(sp, plan, trip, values, device, counters, n=N):
    """The demotion ladder on the card: ``kernel.launch@1`` demotes the
    backward (``dec``) to the two-kernel route's kernels (a gather and a
    ``pdft_last``, no fused z kernel), bit for bit a ``fused=False``
    plan's backward; after ``FUSED_REPROBE_AFTER`` calls the re-probe
    launches the fused kernel and readmits; ``kernel.launch@*`` ends
    permanent; ``exchange.quantize@1`` declines the 4-shard plan's int8
    rung. The counters are reset after: every other phase must leave
    ``spfft_fused_demotions_total`` at 0."""
    from spfft_tpu_torch import faults, obs
    no_demotions("the phases before the fault phase")
    after = plan.FUSED_REPROBE_AFTER
    plan = sp.TransformPlan(plan.index_plan, device=device)
    ref = sp.TransformPlan(plan.index_plan, device=device, fused=False)
    want = ref.backward(values)
    fused_want = plan.backward(values)
    reset_launches(counters)
    faults.arm(faults.FaultPlan(script="kernel.launch@1"))
    try:
        got = plan.backward(values)
    finally:
        faults.disarm()
    read_launches("fault kernel.launch@1 backward", counters,
                  DEMOTED_BWD_LAUNCHES)
    if not torch.equal(got, want):
        fail("faults: the demoted backward differs from the two-kernel "
             "plan's")
    dem = plan.fused_demotions()
    if set(dem) != {"dec"} or "InjectedFault" not in dem["dec"]["reason"]:
        fail(f"faults: expected dec demoted, got {dem}")
    for _ in range(after - 1):
        plan.backward(values)
    rec = plan.fused_demotions()["dec"]
    if rec["unfused_ok"] != after - 1 or rec["probing"]:
        fail(f"faults: after {after - 1} demoted calls: {rec}")
    plan.backward(values)
    if not plan.fused_demotions()["dec"]["probing"]:
        fail("faults: the re-probe is not armed after "
             f"{after} demoted calls")
    reset_launches(counters)
    got = plan.backward(values)
    read_launches("fault re-probe backward", counters, FUSED_BWD_LAUNCHES)
    if plan.fused_demotions() != {} or not torch.equal(got, fused_want):
        fail("faults: the re-probe did not readmit the fused kernel")
    c = obs.GLOBAL_COUNTERS
    seq = (c.get("spfft_fused_demotions_total", which="dec"),
           c.get("spfft_fused_reprobes_total", which="dec",
                 outcome="readmitted"))
    if seq != (1, 1):
        fail(f"faults: demotions / readmissions {seq}, expected (1, 1)")
    faults.arm(faults.FaultPlan(script="kernel.launch@*"))
    try:
        for _ in range(1 + plan.FUSED_REPROBE_MAX * (after + 1)):
            if not torch.equal(plan.backward(values), want):
                fail("faults: a demoted backward differs from the "
                     "two-kernel plan's")
    finally:
        faults.disarm()
    rec = plan.fused_demotions()["dec"]
    if not rec["permanent"] or rec["probes"] != plan.FUSED_REPROBE_MAX:
        fail(f"faults: kernel.launch@* did not end permanent: {rec}")
    demoted = demotions_total()
    from spfft_tpu_torch.utils.workloads import (even_plane_split,
                                                 round_robin_stick_partition)
    parts = round_robin_stick_partition(trip, (n, n, n), _S)
    faults.arm(faults.FaultPlan(script="exchange.quantize@1"))
    try:
        dplan = sp.make_distributed_plan(
            sp.TransformType.C2C, n, n, n, parts, even_plane_split(n, _S),
            mesh=sp.make_mesh(_S, device), wire_precision=3,
            exchange=sp.ExchangeType.BUFFERED)
    finally:
        faults.disarm()
    if dplan.wire_declines[:1] != (("int8", "fault_injected"),) \
            or dplan.wire_rung_name != "bf16":
        fail(f"faults: exchange.quantize@1 resolved {dplan.wire_rung_name} "
             f"with declines {dplan.wire_declines}, expected int8 "
             f"fault_injected then bf16")
    if c.get("spfft_wire_rung_declined_total", reason="fault_injected") != 1:
        fail("faults: the int8 decline was not counted")
    OBS_ROWS["faults"] = {"demotions": demoted,
                          "wire_declines": [list(d) for d in
                                            dplan.wire_declines],
                          "wire_rung": dplan.wire_rung_name}
    print(f"faults phase: kernel.launch@1 demoted dec to the two-kernel "
          f"route (bit for bit), re-probe after {after} calls readmitted, "
          f"kernel.launch@* permanent after {plan.FUSED_REPROBE_MAX} probes "
          f"({demoted:.0f} demotions); exchange.quantize@1 declined int8 "
          f"(fault_injected) to {dplan.wire_rung_name}", flush=True)
    del dplan, plan, ref
    c.reset()


def surface_phase(sp, plan, values, device, n=N):
    """The local plan surface on the card: ``export_tables`` ->
    ``restore_plan`` bit for bit, with the construction's host seconds
    built and restored; ``estimated_device_bytes()`` beside the growth of
    ``torch.cuda.memory_allocated()`` over a construction (within
    ``EST_BYTES_REL`` + ``EST_BYTES_ABS``); ``donate_inputs=True`` round
    trips bit for bit the non-donating plan's, written into the values
    tensor, with each one's peak memory; ``device=cuda:0`` on the four
    entries bit for bit the default; ``max_rel_error`` below the
    prediction raising ``PrecisionContractError`` in single and double."""
    full = sp.Scaling.FULL
    ip = plan.index_plan
    card = device.type == "cuda"  # memory statistics: the card's only

    def sync():
        if card:
            torch.cuda.synchronize()

    def allocated():
        return torch.cuda.memory_allocated(device) if card else 0

    sync()
    m0 = allocated()
    t0 = time.perf_counter()
    built = sp.TransformPlan(ip, device=device)
    sync()
    built_s = time.perf_counter() - t0
    grown = allocated() - m0
    est = built.estimated_device_bytes()
    if card and abs(grown - est) > EST_BYTES_REL * est + EST_BYTES_ABS:
        fail(f"surface: estimated_device_bytes {est} vs memory growth "
             f"{grown} over the construction")
    tables = built.export_tables()
    t0 = time.perf_counter()
    back = sp.restore_plan(ip, tables, device=device)
    sync()
    restored_s = time.perf_counter() - t0
    a, b = built.backward(values), back.backward(values)
    if not (torch.equal(a, b) and torch.equal(built.forward(a, full),
                                              back.forward(b, full))):
        fail("surface: the restored plan's pair differs from the original's")
    dev0 = torch.device("cuda:0") if card else device
    batch = torch.stack([values, values])
    if not (torch.equal(built.backward(values, device=dev0), a)
            and torch.equal(built.forward(a, full, device=dev0),
                            built.forward(a, full))
            and torch.equal(built.backward_batched(batch, device=dev0),
                            built.backward_batched(batch))
            and torch.equal(built.forward_batched(
                torch.stack([a, a]), full, device=dev0),
                built.forward_batched(torch.stack([a, a]), full))):
        fail("surface: device=cuda:0 differs from the default placement")
    give = sp.TransformPlan(ip, device=device, donate_inputs=True)
    peaks = {}
    for name, p in (("keep", built), ("donate", give)):
        v = values.clone()
        sync()
        if card:
            torch.cuda.reset_peak_memory_stats(device)
        base = allocated()
        out = p.apply_pointwise(v, scaling=full)
        sync()
        peaks[name] = (torch.cuda.max_memory_allocated(device) if card
                       else 0) - base
        if name == "donate" and out.data_ptr() != v.data_ptr():
            fail("surface: the donating round trip did not write into the "
                 "values tensor")
        peaks[name + "_out"] = out
        it = p.iterate_pointwise(values.clone(), None, steps=3)
        peaks[name + "_it"] = it
    if not (torch.equal(peaks.pop("keep_out"), peaks.pop("donate_out"))
            and torch.equal(peaks.pop("keep_it"), peaks.pop("donate_it"))):
        fail("surface: donate_inputs changed a round trip's result")
    for precision in ("single", "double"):
        pred = sp.predicted_rel_error(precision, n)
        try:
            sp.TransformPlan(ip, precision=precision, device=device,
                             max_rel_error=pred / 2)
        except sp.PrecisionContractError:
            pass
        else:
            fail(f"surface: max_rel_error below the {precision} prediction "
                 f"{pred:.3g} did not raise")
    OBS_ROWS["surface"] = {"card": CARD, "built_s": built_s,
                           "restored_s": restored_s,
                           "estimated_device_bytes": est,
                           "memory_growth_bytes": grown,
                           "pointwise_peak_bytes": peaks}
    print(f"surface phase: export_tables -> restore_plan bit for bit; "
          f"construction {built_s:.4f} s built, {restored_s:.4f} s restored "
          f"(host); estimated_device_bytes {est} vs memory growth {grown}; "
          f"apply_pointwise peak {peaks['keep']} bytes, {peaks['donate']} "
          f"donating (bit for bit); device=cuda:0 equal on four entries; "
          f"max_rel_error raises in single and double ({CARD})", flush=True)


# -- the serving layer ----------------------------------------------------------

#: the serve phase's load: submitting threads, the requests each
#: direction carries on the C2C signature and on the two-kernel R2C one,
#: and the C2C bursts timed (their spread beside each figure); the R2C
#: bursts are too short to time and check launches and bits only
SERVE_THREADS = 4
SERVE_REQUESTS = 32
SERVE_2K_REQUESTS = 8
SERVE_BURSTS = 3
#: the CLI run of the serve phase: --serve and --store-dir in one call
SERVE_CLI = ["-d", "256", "-r", "3", "-m", "4", "--serve"]
#: the serve phase's numbers, printed as ``{"serve": ...}``
SERVE_ROWS = {}


def _submit_all(ex, sig, payloads, kind, scaling):
    """Submit ``payloads`` from ``SERVE_THREADS`` threads (request i from
    thread i mod SERVE_THREADS); returns the futures in request order."""
    import threading
    futs = [None] * len(payloads)
    errors = []

    def worker(k):
        for i in range(k, len(payloads), SERVE_THREADS):
            try:
                futs[i] = ex.submit(sig, payloads[i], kind, scaling=scaling)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(SERVE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        fail(f"serve: submit raised {errors[0]!r}")
    return futs


def _bucket_rows(before, after):
    """(batched buckets, rows served serially, pin prewarms) between two
    metrics snapshots."""
    def serial_rows(s):
        return sum(int(k) * v for k, v in s["serial_batch_histogram"].items())
    return (after["fused_batches"] - before["fused_batches"],
            serial_rows(after) - serial_rows(before),
            after["health"]["pin_prewarms"] - before["health"]["pin_prewarms"])


def serve_direction(path, ex, sig, payloads, kind, scaling, counters,
                    per_bucket, zero):
    """One direction of the served path, counted: every launch counter set
    to 0 just before the submits, read after every result and every
    prewarm-on-pin run; each wrapper of ``per_bucket`` (name -> its
    launches per call) must have launched that many times per batched
    bucket, per request served serially and per pin prewarm (and no
    other time), each of ``zero`` never. Returns the results, the seconds
    from the first submit to the last result, and the launches."""
    from spfft_tpu_torch.timing import wait_ready
    before = ex.metrics.snapshot()
    reset_launches(counters)
    t0 = time.perf_counter()
    futs = _submit_all(ex, sig, payloads, kind, scaling)
    out = [f.result(timeout=300) for f in futs]
    wait_ready(out)
    secs = time.perf_counter() - t0
    for th in list(ex._prewarm_threads.values()):
        th.join()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    buckets, serial, pins = _bucket_rows(before, ex.metrics.snapshot())
    want = buckets + serial + pins
    print(f"serve {path} {kind}: {len(payloads)} requests, {buckets} batched "
          f"buckets, {serial} served serially, {pins} pin prewarms; "
          f"launches {launches} ({CARD})", flush=True)
    if buckets < 1:
        fail(f"serve {path} {kind}: no batched bucket formed")
    for name, per_call in per_bucket.items():
        if launches[name] != per_call * want:
            fail(f"serve {path} {kind}: {name} launched {launches[name]} "
                 f"times, expected {per_call} per bucket: {per_call * want}")
    if "decompress_zdft" in per_bucket or "zdft_compress" in per_bucket:
        z = "decompress_zdft" if kind == "backward" else "zdft_compress"
        forms = {f: k for f, k in counters[z].form_launches.items() if k}
        if forms != {"fft": want}:
            fail(f"serve {path} {kind}: {z} by form {forms}, expected "
                 f"{{'fft': {want}}}")
    for name in zero:
        if launches[name]:
            fail(f"serve {path} {kind}: {name} launched {launches[name]} "
                 f"times, expected 0")
    return out, secs, launches


def serve_path(sp, path, ex, sig, plan, payloads, counters, bwd, fwd,
               bursts=1, timed=True):
    """The served pair of ``path`` (``bwd`` / ``fwd``: (launched once per
    bucket, never launched)), ``bursts`` times: the backward requests of
    host numpy payloads, then forward(FULL) requests of the device slabs
    they returned; each result bit for bit against the plan's serial
    call (a serial loop over the same requests, timed: req/s beside the
    executor's, each burst's). Returns the row: with ``timed``, the
    rates of every burst and the latency percentiles over all of them;
    without, the buckets and launches alone."""
    from spfft_tpu_torch.timing import wait_ready
    full = sp.Scaling.FULL
    ex.metrics.reset()
    served, serial = [], []
    for burst in range(bursts):
        spaces, t_b, lb = serve_direction(path, ex, sig, payloads,
                                          "backward", sp.Scaling.NONE,
                                          counters, *bwd)
        outs, t_f, lf = serve_direction(path, ex, sig, spaces, "forward",
                                        full, counters, *fwd)
        t0 = time.perf_counter()
        want_b = [plan.backward(v) for v in payloads]
        wait_ready(want_b)
        t_sb = time.perf_counter() - t0
        want_f = [plan.forward(s, full) for s in want_b]
        wait_ready(want_f)
        t_serial = time.perf_counter() - t0
        for i in range(len(payloads)):
            if not torch.equal(spaces[i], want_b[i]):
                fail(f"serve {path}: backward request {i} of burst {burst} "
                     f"differs from the plan's serial call")
            if not torch.equal(outs[i], want_f[i]):
                fail(f"serve {path}: forward request {i} of burst {burst} "
                     f"differs from the plan's serial call")
        del spaces, outs, want_b, want_f
        served.append({"backward_s": t_b, "forward_s": t_f})
        serial.append({"backward_s": t_sb, "forward_s": t_serial - t_sb})
    snap = ex.metrics.snapshot()
    h = snap["health"]
    if snap["failed"] or h["bucket_fallbacks"] or h["retries"]:
        fail(f"serve {path}: failures or fallbacks outside the fault case: "
             f"{h}")
    n = 2 * len(payloads)
    row = {"card": CARD, "requests": n, "bursts": bursts,
           "threads": SERVE_THREADS,
           "fused_batches": snap["fused_batches"],
           "batch_histogram": snap["fused_batch_histogram"],
           "serial_batches": snap["serial_batches"],
           "pinned_batches": snap["pinned_batches"],
           "padded_rows": snap["padded_rows"],
           "launches_backward": lb, "launches_forward": lf}
    done = (f"serve {path}: {bursts} x {n} requests from {SERVE_THREADS} "
            f"threads, all bit for bit the serial calls; "
            f"{row['fused_batches']} batched buckets "
            f"{row['batch_histogram']}, {row['pinned_batches']} pinned, "
            f"{row['padded_rows']} pad rows")
    if not timed:
        print(f"{done} (launches and bits only; {CARD})", flush=True)
        return row
    lat = snap["latency_seconds"]
    rates = [n / (a["backward_s"] + a["forward_s"]) for a in served]
    base = [n / (a["backward_s"] + a["forward_s"]) for a in serial]
    row.update({
        "batch_window_s": ex.config.batch_window,
        "latency_samples": snap["completed"],
        "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3,
        "served_req_per_s": float(np.median(rates)),
        "serial_req_per_s": float(np.median(base)),
        "served_req_per_s_bursts": rates, "serial_req_per_s_bursts": base,
        "served_s_bursts": served, "serial_s_bursts": serial,
        "stage_s": snap["overhead_seconds"]["stage_total"],
        "dispatch_s": snap["overhead_seconds"]["dispatch_total"]})

    def spread(xs):
        return f"{np.median(xs):.1f} ({min(xs):.1f}-{max(xs):.1f})"

    print(f"{done}; p50 {row['p50_ms']:.3f} ms, p99 {row['p99_ms']:.3f} ms "
          f"over {row['latency_samples']} requests (batch window "
          f"{row['batch_window_s'] * 1e3:g} ms); req/s, median (range) of "
          f"the bursts: {spread(rates)} served against {spread(base)} in a "
          f"serial loop; staging {row['stage_s']:.3f} s in all ({CARD})",
          flush=True)
    return row


def staging_rates(plan, rows, device, reps=5):
    """GB/s of one bucket's host -> card copy (``rows`` rows of the
    plan's values): from a pinned buffer (``non_blocking``, what the
    executor stages through) and from pageable memory, each the median
    of ``reps`` copies timed with CUDA events."""
    shape, dtype = plan.batch_row_template("values")
    host = np.random.default_rng(SEED).standard_normal(
        (rows,) + shape).astype(dtype)
    pinned = torch.from_numpy(host).pin_memory()
    dev = torch.empty(pinned.shape, dtype=pinned.dtype, device=device)

    def time_copy(src, non_blocking):
        ts = []
        for _ in range(reps + 1):
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            dev.copy_(src, non_blocking=non_blocking)
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts[1:]))

    nbytes = host.nbytes
    pin_ms = time_copy(pinned, True)
    page_ms = time_copy(torch.from_numpy(host), False)
    return {"bucket_bytes": nbytes, "pinned_ms": pin_ms,
            "pageable_ms": page_ms,
            "pinned_gb_s": nbytes / pin_ms / 1e6,
            "pageable_gb_s": nbytes / page_ms / 1e6}


def serve_fault_case(sp, reg, sig, plan, payloads):
    """``dispatch@1`` on a staged bucket of four: the batched dispatch
    fails, the bucket falls back to serial calls and every request is
    bit for bit its serial call; then a bucket of three healthy requests
    and one poisoned (a payload of the wrong length): only the poisoned
    one fails, typed."""
    from spfft_tpu_torch.serve import FaultPlan, ServeExecutor
    ex = ServeExecutor(reg, autostart=False, batch_window=0.0,
                       fault_plan=FaultPlan(script="dispatch@1"))
    futs = [ex.submit(sig, v) for v in payloads[:4]]
    ex._drain_once()
    for f, v in zip(futs, payloads[:4]):
        if not torch.equal(f.result(timeout=120), plan.backward(v)):
            fail("serve fault case: a recovered request differs from its "
                 "serial call")
    good = payloads[4:7]
    futs = [ex.submit(sig, v) for v in good[:2]]
    poisoned = ex.submit(sig, np.zeros(3, np.float32))
    futs.append(ex.submit(sig, good[2]))
    ex._drain_once()
    for f, v in zip(futs, good):
        if not torch.equal(f.result(timeout=120), plan.backward(v)):
            fail("serve fault case: a healthy co-batched request differs "
                 "from its serial call")
    try:
        poisoned.result(timeout=120)
    except sp.InvalidParameterError:
        pass
    else:
        fail("serve fault case: the poisoned request did not fail")
    h = ex.health()
    ex.close()
    if h["bucket_fallbacks"] != 2 or h["retries"] != 8 \
            or h["retries_exhausted"] or ex.metrics.snapshot()["failed"] != 1:
        fail(f"serve fault case: health {h}")
    print(f"serve fault case (dispatch@1, then one poisoned request): 2 "
          f"bucket fallbacks, {h['retries']} serial re-executions, only the "
          f"poisoned request failed; healthy results bit for bit ({CARD})",
          flush=True)
    return {"bucket_fallbacks": h["bucket_fallbacks"],
            "retries": h["retries"], "failed": 1}


def serve_store_case(trip, device, n=N):
    """The store's cold and warm boot, each in a fresh process, so that
    both pay the CUDA context's start and the kernel libraries' loading
    alike. Cold: ``python -m spfft_tpu_torch.serve.store seed DIR --dim n
    --sparsity 1.0 --reference`` resolves the n^3 sphere (``trip``'s set)
    over an empty store (build, spill) and runs its first backward
    (``cold_resolve_ms`` + ``first_backward_ms``). Warm: ``prewarm DIR
    --compile --check-reference --strict`` loads the artifact and runs it
    once (``warm_resolve_ms``, of it ``store_load_ms``), then resolves
    the seeded request with no build, its backward bit for bit the
    seeding process's."""
    import shutil
    from pathlib import Path

    from spfft_tpu_torch.serve import store as st
    here = Path(__file__).resolve().parent
    root = here / "build" / "serve_store"
    shutil.rmtree(root, ignore_errors=True)
    cpu = ["--device", "cpu"] if device.type == "cpu" else []

    def cli(*args):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "spfft_tpu_torch.serve.store", *args,
             str(root), "--json"] + cpu,
            capture_output=True, text=True, timeout=600, cwd=str(here))
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"serve store case: {args[0]} exited {proc.returncode}:\n"
                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1]), secs

    cold, cold_s = cli("seed", "--dim", str(n), "--sparsity", "1.0",
                       "--reference")
    if cold["builds"] != 1 or cold["store"]["spills"] != 1 \
            or cold["num_values"] != len(trip):
        fail(f"serve store case: cold seed {cold}")
    key = json.loads((root / st.LOCAL_DIR / "reference.json")
                     .read_text())["artifact"]
    art_bytes = os.path.getsize(st.PlanArtifactStore(str(root))
                                .artifact_path(key))
    warm, warm_s = cli("prewarm", "--compile", "--check-reference",
                       "--strict")
    if warm["builds"] != 0 or not warm["reference_bit_exact"]:
        fail(f"serve store case: warm boot {warm}")
    cold_ms = cold["cold_resolve_ms"] + cold["first_backward_ms"]
    row = {"card": CARD, "cold_ms": cold_ms,
           "cold_resolve_ms": cold["cold_resolve_ms"],
           "cold_first_backward_ms": cold["first_backward_ms"],
           "warm_ms": warm["warm_resolve_ms"],
           "warm_store_load_ms": warm["store_load_ms"],
           "warm_reference_resolve_ms": warm["reference_resolve_ms"],
           "cold_process_s": cold_s, "warm_process_s": warm_s,
           "artifact_bytes": art_bytes, "warm_builds": warm["builds"],
           "warm_compile_events": warm["compile_events"]}
    print(f"serve store case, each boot in a fresh process: cold "
          f"{cold_ms:.1f} ms (resolve {cold['cold_resolve_ms']:.1f}: build, "
          f"spill of a {art_bytes} byte artifact; first backward "
          f"{cold['first_backward_ms']:.1f}); warm {row['warm_ms']:.1f} ms "
          f"(of it the artifact's load {warm['store_load_ms']:.1f}: read, "
          f"hash, range checks, upload; then the first backward), builds 0, "
          f"bit for bit the cold process's; the processes {cold_s:.1f} s "
          f"and {warm_s:.1f} s with their start ({CARD})", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return row


def serve_cli_case(card: str, device, n=N) -> dict:
    """``python -m spfft_tpu_torch.benchmark`` with ``--serve`` and
    ``--store-dir`` in one call, in this process: exit 0, the serving
    snapshot with batched buckets and no failure or fallback, and a warm
    boot with no build."""
    import contextlib
    import io
    import shutil
    from pathlib import Path

    from spfft_tpu_torch import benchmark
    root = Path(__file__).resolve().parent / "build" / "serve_cli_store"
    shutil.rmtree(root, ignore_errors=True)
    argv = SERVE_CLI + ["--store-dir", str(root)]
    if device.type == "cpu":  # a CPU rehearsal
        argv = ["--cpu", "-d", str(n)] + argv[2:]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = benchmark.main(argv)
    text = buf.getvalue()
    if rc != 0:
        fail(f"benchmark {' '.join(argv)} exited {rc}:\n{text[-2000:]}")
    params = json.loads(text[:text.index("\n}\n") + 2])
    serve = params.get("serve", {})
    if params["backend"] != device.type or not serve.get("fused_batches") \
            or serve.get("failed") or serve["health"]["bucket_fallbacks"] \
            or params.get("warm_builds") != 0 \
            or not params.get("store_was_cold"):
        fail(f"benchmark {' '.join(argv)}: {params}")
    lat = serve["latency_seconds"]
    print(f"benchmark {' '.join(SERVE_CLI)} --store-dir ({card}; "
          f"{time.perf_counter() - t0:.1f} s): pair_seconds "
          f"{params['pair_seconds']}, served p50 {lat['p50'] * 1e3:.3f} ms "
          f"p99 {lat['p99'] * 1e3:.3f} ms, {serve['fused_batches']} batched "
          f"buckets; cold_start_ms {params['cold_start_ms']['value']}, "
          f"warm_start_ms {params['warm_start_ms']['value']}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return {"pair_seconds": params["pair_seconds"],
            "p50_ms": lat["p50"] * 1e3, "p99_ms": lat["p99"] * 1e3,
            "fused_batches": serve["fused_batches"],
            "cold_start_ms": params["cold_start_ms"]["value"],
            "warm_start_ms": params["warm_start_ms"]["value"]}


def serve_phase(sp, device, counters, n=N):
    """The single-host serving layer on the card (``spfft_tpu_torch.serve``)
    at full width: the 256^3 C2C sphere (numpy seed 0, float32) resolved
    through a ``PlanRegistry`` and served by a ``ServeExecutor``
    (prewarmed), ``SERVE_REQUESTS`` backward requests of host numpy values
    (distinct: seed 0's values times 1 + i/64) from ``SERVE_THREADS``
    threads, then forward(FULL) requests of the device slabs they
    returned — every result bit for bit the plan's serial call, each
    fused z kernel and ``pdft2`` launched once per batched bucket; then a
    ``fused=False`` signature on the R2C half sphere, its buckets launching
    ``gather.cu``, ``pdft_last`` and the real xy stages once each and no
    fused z kernel; the staging copy's rate pinned against pageable; the
    fault case; the store's cold and warm boot; the CLI's ``--serve`` and
    ``--store-dir``."""
    from spfft_tpu_torch.serve import PlanRegistry, ServeExecutor
    trip, values = c2c_inputs(n, device)
    base = values.cpu().numpy()
    payloads = [base * np.float32(1 + i / 64) for i in range(SERVE_REQUESTS)]
    del values
    reg = PlanRegistry(store=False)
    t0 = time.perf_counter()
    sig, plan = reg.get_or_build(sp.TransformType.C2C, n, n, n, trip,
                                 device=device)
    resolve_s = time.perf_counter() - t0
    ex = ServeExecutor(reg)
    t0 = time.perf_counter()
    ex.prewarm(sig, scaling=sp.Scaling.FULL)
    prewarm_s = time.perf_counter() - t0
    print(f"serve: the 256^3 C2C request resolved in {resolve_s:.2f} s "
          f"(index plan and tables), the executor prewarmed in "
          f"{prewarm_s:.2f} s (ladder {sorted({ex._padded_size(b) for b in range(2, ex.config.max_batch + 1)})}) "
          f"({CARD})", flush=True)
    z0 = ("gather", "pdft_last", "prdft2", "pdft2_cr", "pdft2_swapped")
    row = serve_path(sp, "c2c", ex, sig, plan, payloads, counters,
                     ({"decompress_zdft": 1, "pdft2": 1},
                      ("zdft_compress",) + z0),
                     ({"zdft_compress": 1, "pdft2": 1},
                      ("decompress_zdft",) + z0), bursts=SERVE_BURSTS)
    ex.close()
    SERVE_ROWS["c2c"] = row
    if device.type == "cuda":  # (a CPU rehearsal copies to no card)
        fill = SERVE_BURSTS * sum(p.nbytes for p in payloads) \
            / row["stage_s"] / 1e9 if row["stage_s"] else None
        st = SERVE_ROWS["staging"] = dict(staging_rates(plan, 8, device),
                                          card=CARD, host_fill_gb_s=fill)
        print(f"serve staging: one bucket of 8 rows ({st['bucket_bytes']} "
              f"bytes) to the card at {st['pinned_gb_s']:.2f} GB/s from "
              f"pinned memory, {st['pageable_gb_s']:.2f} GB/s from "
              f"pageable; the executor's host fill of its staging buffers "
              f"{fill} GB/s ({CARD})", flush=True)
    SERVE_ROWS["fault_case"] = serve_fault_case(sp, reg, sig, plan, payloads)
    SERVE_ROWS["store"] = serve_store_case(trip, device, n)
    del plan, reg, payloads, base
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rtrip, rvalues, _ = r2c_inputs(n, device)
    rbase = rvalues.cpu().numpy()
    rpay = [rbase * np.float32(1 + i / 64) for i in range(SERVE_2K_REQUESTS)]
    del rvalues
    reg = PlanRegistry(store=False)
    rsig, rplan = reg.get_or_build(sp.TransformType.R2C, n, n, n, rtrip,
                                   device=device, fused=False)
    ex = ServeExecutor(reg)
    ex.prewarm(rsig, scaling=sp.Scaling.FULL)
    zf = ("decompress_zdft", "zdft_compress", "pdft2", "pdft2_swapped")
    # the real xy stages launch twice a call: the real half and the
    # complex half
    SERVE_ROWS["r2c_two_kernel"] = serve_path(
        sp, "r2c two-kernel", ex, rsig, rplan, rpay, counters,
        ({"gather": 1, "pdft_last": 1, "pdft2_cr": 2}, ("prdft2",) + zf),
        ({"gather": 1, "pdft_last": 1, "prdft2": 2}, ("pdft2_cr",) + zf),
        timed=False)
    ex.close()
    del rplan, reg, rpay, rbase
    if device.type == "cuda":
        torch.cuda.empty_cache()
    SERVE_ROWS["cli"] = serve_cli_case(CARD, device, n)


# -- the pod ---------------------------------------------------------------------

POD_THREADS = 4
POD_SINGLES = 32
POD_DIST = 16
POD_BURSTS = 3
#: the coalescing window of the loopback pod's SPMD lane (seconds): long
#: enough that the 16 distributed requests of a burst, submitted from 4
#: threads, meet in full rounds of ``spmd_max_batch``
POD_SPMD_WINDOW = 0.05
#: the n of the TCP pod's join / kill / self-heal requests: the trace
#: (the JAX smoke's 24 singles and one distributed request) and the
#: coalesced pair are at 256^3, these steps' requests (the JAX smoke's
#: counts) at this n, which keeps the phase near its budget
POD_HEAL_N = 32
#: single requests of the trace's size sent one at a time after it, each
#: timed apart (``net.smoke._solo_requests``)
POD_SOLO = 1
#: the TCP pod's leases (ms): the knobs' default TTL, where the JAX
#: smoke's 300 ms lets an agent busy with 200 MB frames miss renewals
#: (each suspicion bumps the view epoch twice, and a frontend's fenced
#: retry can meet a second bump)
POD_LEASE_TTL_MS = 1500
POD_HEARTBEAT_MS = 250
#: the pod phase's numbers, printed as ``{"pod": ...}``
POD_ROWS = {}


def _pod_submit_all(pod, requests, kind, scaling, done):
    """Submit ``requests`` ((signature, payload) pairs) to ``pod`` from
    ``POD_THREADS`` threads (request i from thread i mod POD_THREADS);
    ``done[i]`` gets (submit time, resolve time). Returns the futures in
    request order."""
    import threading
    futs = [None] * len(requests)
    errors = []

    def worker(k):
        for i in range(k, len(requests), POD_THREADS):
            sig, payload = requests[i]
            try:
                t0 = time.perf_counter()
                f = pod.submit(sig, payload, kind, scaling=scaling)
                f.add_done_callback(
                    lambda _f, i=i, t0=t0: done.__setitem__(
                        i, (t0, time.perf_counter())))
                futs[i] = f
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(POD_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if errors or any(th.is_alive() for th in threads):
        fail(f"pod: submit raised {errors[:1]!r} or hung")
    return futs


def _pod_units(lanes, before):
    """Local plan calls since ``before`` (one per batched bucket, per
    request served serially and per pin prewarm), over every lane."""
    def units(snap):
        serial = sum(int(k) * v
                     for k, v in snap["serial_batch_histogram"].items())
        return snap["fused_batches"] + serial + snap["health"]["pin_prewarms"]
    return sum(units(ln.executor.metrics.snapshot()) - units(b)
               for ln, b in zip(lanes, before))


def pod_direction(pod, requests, kind, scaling, counters, done):
    """One direction of the pod's trace, counted: the launch counters set
    to 0 just before the submits and read after every result. Each local
    bucket (or serial call, or pin prewarm) launches the direction's
    fused z kernel and ``pdft2`` once; each coalesced round of the
    distributed plan launches the fused z kernel once per shard and
    ``pdft2_swapped`` once, whatever its size. Returns the results, the
    seconds, and (local calls, rounds, launches)."""
    from spfft_tpu_torch.timing import wait_ready
    lanes = pod._lanes
    before = [ln.executor.metrics.snapshot() for ln in lanes]
    rounds0 = pod._spmd.signals()["spmd_launches"]
    reset_launches(counters)
    t0 = time.perf_counter()
    futs = _pod_submit_all(pod, requests, kind, scaling, done)
    out = [f.result(timeout=300) for f in futs]
    wait_ready(out)
    secs = time.perf_counter() - t0
    for ln in lanes:
        for th in list(ln.executor._prewarm_threads.values()):
            th.join(timeout=300)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    local = _pod_units(lanes, before)
    rounds = pod._spmd.signals()["spmd_launches"] - rounds0
    z, other = (("decompress_zdft", "zdft_compress") if kind == "backward"
                else ("zdft_compress", "decompress_zdft"))
    want = {z: local + DIST_SHARDS * rounds, "pdft2": local,
            "pdft2_swapped": rounds, other: 0, "gather": 0,
            "pdft_last": 0, "prdft2": 0, "pdft2_cr": 0}
    print(f"pod {kind}: {len(requests)} requests, {local} local plan calls "
          f"on the lanes, {rounds} coalesced distributed rounds; launches "
          f"{launches} ({CARD})", flush=True)
    for name, k in want.items():
        if launches[name] != k:
            fail(f"pod {kind}: {name} launched {launches[name]} times, "
                 f"expected {k} ({local} local calls, {rounds} rounds)")
    n_dist = sum(1 for sig, _ in requests if sig.device_count > 1)
    if n_dist and rounds >= n_dist:
        fail(f"pod {kind}: {n_dist} distributed requests ran in {rounds} "
             f"rounds: none coalesced")
    return out, secs, (local, rounds, launches)


def pod_loopback_case(sp, device, counters, n=N):
    """(a) The loopback pod: two ``HostLane``s, each a prewarmed
    ``ServeExecutor`` whose registry holds the n^3 C2C sphere's local plan
    and its 4-shard one-card distributed plan (the same plan objects),
    behind a p2c ``PodFrontend``. ``POD_BURSTS`` bursts of POD_SINGLES
    single backward requests of host values and POD_DIST distributed
    backward requests of stacked values on the card, from POD_THREADS
    threads, then their forward(FULL) of the returned spaces: every result
    bit for bit its direct plan call (a serial loop over the same
    requests, timed), the launches of :func:`pod_direction`, the routed
    count per host, the coalesced batch sizes, latency percentiles over
    every request, and the federated ``/metrics`` re-parsed."""
    from spfft_tpu_torch import obs
    from spfft_tpu_torch.control.config import global_config
    from spfft_tpu_torch.serve import (HostLane, PlanRegistry, PodFrontend,
                                       ServeExecutor, load_score,
                                       signature_for)
    from spfft_tpu_torch.timing import wait_ready
    trip, values = c2c_inputs(n, device)
    base = values.cpu().numpy()
    payloads = [base * np.float32(1 + i / 64) for i in range(POD_SINGLES)]
    dplan, stacked = dist_plan(sp, n, trip, values, device)
    dpay = [stacked * (1 + i / 64) for i in range(POD_DIST)]
    del values
    reg = PlanRegistry(store=False)
    sig, plan = reg.get_or_build(sp.TransformType.C2C, n, n, n, trip,
                                 device=device)
    dsig = signature_for(sp.TransformType.C2C, n, n, n, trip,
                         device_count=DIST_SHARDS)
    cfg = global_config()
    old_window = cfg.spmd_batch_window
    cfg.set("spmd_batch_window", POD_SPMD_WINDOW, source="chip_smoke",
            reason="the pod phase's coalescing window")
    lanes = []
    for host in ("h0", "h1"):
        r = PlanRegistry(store=False)
        r.put(sig, plan)
        r.put(dsig, dplan)
        ex = ServeExecutor(r)
        ex.prewarm(sig, scaling=sp.Scaling.FULL)
        lanes.append(HostLane(host, ex))
    full = sp.Scaling.FULL
    for b in (1, 2, 4, 8):  # the rounds' batch shapes, warm
        wait_ready(dplan.coalesce_forward(
            dplan.coalesce_backward([stacked] * b), full))
    obs.GLOBAL_COUNTERS.reset()
    pod = PodFrontend(lanes, policy="p2c", seed=SEED)
    try:
        # singles and distributed requests interleaved: every third one
        # distributed
        order = []
        si, di = iter(range(POD_SINGLES)), iter(range(POD_DIST))
        for k in range(POD_SINGLES + POD_DIST):
            j = next(di, None) if k % 3 == 2 else None
            if j is not None:
                order.append((dsig, j))
            else:
                order.append((sig, next(si)))
        bwd_req = [(s, dpay[j] if s is dsig else payloads[j])
                   for s, j in order]
        served, serial, lat = [], [], []
        for burst in range(POD_BURSTS):
            done_b, done_f = {}, {}
            spaces, t_b, cb = pod_direction(pod, bwd_req, "backward",
                                            sp.Scaling.NONE, counters,
                                            done_b)
            fwd_req = [(s, sp_) for (s, _), sp_ in zip(bwd_req, spaces)]
            outs, t_f, cf = pod_direction(pod, fwd_req, "forward", full,
                                          counters, done_f)
            t0 = time.perf_counter()
            want_b = [(dplan if s is dsig else plan).backward(v)
                      for s, v in bwd_req]
            wait_ready(want_b)
            t_sb = time.perf_counter() - t0
            want_f = [(dplan if s is dsig else plan).forward(w, full)
                      for (s, _), w in zip(bwd_req, want_b)]
            wait_ready(want_f)
            t_serial = time.perf_counter() - t0
            for i, (s, _) in enumerate(bwd_req):
                what = "distributed" if s is dsig else "single"
                if not torch.equal(spaces[i], want_b[i]):
                    fail(f"pod: {what} backward request {i} of burst "
                         f"{burst} differs from its direct plan call")
                if not torch.equal(outs[i], want_f[i]):
                    fail(f"pod: {what} forward request {i} of burst "
                         f"{burst} differs from its direct plan call")
            del spaces, outs, want_b, want_f, fwd_req
            lat += [t1 - t0 for t0, t1 in list(done_b.values())
                    + list(done_f.values())]
            served.append({"backward_s": t_b, "forward_s": t_f,
                           "local_calls": [cb[0], cf[0]],
                           "rounds": [cb[1], cf[1]]})
            serial.append({"backward_s": t_sb, "forward_s": t_serial - t_sb})
        coalesced = obs.GLOBAL_COUNTERS.get(
            "spfft_cluster_spmd_coalesced_total")
        if not coalesced:
            fail("pod: spfft_cluster_spmd_coalesced_total did not move")
        routed = {dict(k).get("host") + "/" + dict(k).get("kind"): v
                  for k, v in obs.GLOBAL_COUNTERS.snapshot()
                  ["spfft_cluster_routed_total"]["samples"].items()}
        signals = {ln.host: ln.rpc_signals() for ln in lanes}
        scores = {h: list(load_score(s)) for h, s in signals.items()}
        parsed = obs.parse_prometheus_text(pod.metrics_text())
        hosts = {dict(lb).get("host") for (name, lb) in parsed
                 if name == "spfft_serve_completed_total"}
        if not {"h0", "h1"} <= hosts or not any(
                name == "spfft_cluster_routed_total" for name, _ in parsed):
            fail(f"pod: the federated /metrics lacks a host's series "
                 f"({hosts})")
        health = pod.health()
        if health["state"] != "healthy":
            fail(f"pod: health {health['state']}")
        hist = pod._spmd.signals()["spmd_batch_hist"]
    finally:
        pod.close()
        cfg.set("spmd_batch_window", old_window, source="chip_smoke",
                reason="restore after the pod phase")
    n_req = 2 * len(bwd_req)
    rates = [n_req / (a["backward_s"] + a["forward_s"]) for a in served]
    base_r = [n_req / (a["backward_s"] + a["forward_s"]) for a in serial]
    lat.sort()
    row = {"card": CARD, "requests": n_req, "bursts": POD_BURSTS,
           "threads": POD_THREADS, "singles": POD_SINGLES,
           "distributed": POD_DIST, "spmd_batch_window_s": POD_SPMD_WINDOW,
           "served_req_per_s": float(np.median(rates)),
           "serial_req_per_s": float(np.median(base_r)),
           "served_req_per_s_bursts": rates,
           "serial_req_per_s_bursts": base_r,
           "p50_ms": lat[len(lat) // 2] * 1e3,
           "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3,
           "latency_samples": len(lat), "routed": routed,
           "spmd_batch_hist": {str(k): v for k, v in hist.items()},
           "spmd_coalesced": coalesced, "load_scores": scores,
           "served_s_bursts": served, "serial_s_bursts": serial,
           "metrics_series": len(parsed)}

    def spread(xs):
        return f"{np.median(xs):.1f} ({min(xs):.1f}-{max(xs):.1f})"

    print(f"pod (a) loopback, 2 lanes: {POD_BURSTS} x {n_req} requests "
          f"({POD_SINGLES} single + {POD_DIST} distributed backward, then "
          f"their forward(FULL)) from {POD_THREADS} threads, all bit for bit "
          f"the direct calls; req/s, median (range) of the bursts: "
          f"{spread(rates)} served against {spread(base_r)} in a serial "
          f"loop; p50 {row['p50_ms']:.3f} ms, p99 {row['p99_ms']:.3f} ms "
          f"over {len(lat)} requests; routed {routed}; coalesced rounds by "
          f"size {row['spmd_batch_hist']}; load scores {scores}; /metrics "
          f"{len(parsed)} series ({CARD})", flush=True)
    for ln in lanes:
        ln.executor.close()
    del plan, dplan, reg, payloads, dpay, stacked, base, lanes
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def pod_tcp_case(sp, device, n=N):
    """(b) The TCP pod: ``net.smoke.run_pod_smoke`` at the n^3 sphere,
    float32, 4 shards, agents as subprocesses holding the n^3 and the
    POD_HEAL_N^3 sets (``--demo-warm
    n,sphere,4,full,single;32,sphere,4,full,single --device cuda:k``,
    agent k on card k mod the visible count, their stderr in
    ``build/pod/agents.log``): the JAX smoke's trace (24 singles and one
    distributed request) at n^3 bit for bit against plans built in this
    process, agent-side coalescing of a concurrent n^3 pair, POD_SOLO
    n^3 requests one at a time with their steps timed apart, then at
    POD_HEAL_N^3 with the JAX smoke's counts the warm join with ``builds
    == 0``, ``kill -9`` failover, self-heal and readmission, the
    drain-leave; then ``wire_overhead_probe`` on the card."""
    import shutil
    from pathlib import Path

    from spfft_tpu_torch.net import smoke
    from spfft_tpu_torch.net.transport import wire_overhead_probe
    logs = Path(__file__).resolve().parent / "build" / "pod"
    shutil.rmtree(logs, ignore_errors=True)
    logs.mkdir(parents=True)
    agent_device = "cuda" if device.type == "cuda" else "cpu"
    failures, row = smoke.run_pod_smoke(
        SEED, agent_device, n=n, cutoff="sphere", shards=DIST_SHARDS,
        precision="single", log_dir=str(logs), heal_n=POD_HEAL_N,
        solo=POD_SOLO, lease_ttl_ms=POD_LEASE_TTL_MS,
        heartbeat_interval_ms=POD_HEARTBEAT_MS)
    if failures:
        fail("pod (b) TCP pod: " + "\n".join(failures))
    row["card"] = CARD
    row["wire_overhead"] = wire_overhead_probe(device=device)
    mb = 1e6
    solo = row["solo"]
    print(f"pod (b) TCP, agents as processes on {agent_device}: "
          f"{row['trace_requests']} requests at {n}^3 submitted back to "
          f"back from one thread, bit for bit, in {row['trace_s']:.2f} s "
          f"({row['s_per_request']:.3f} s a request), wire "
          f"{row['wire_bytes_per_request_sent'] / mb:.1f} MB sent and "
          f"{row['wire_bytes_per_request_received'] / mb:.1f} MB received a "
          f"request, RPC RTT EWMA after the burst (queueing inside it "
          f"included) {row['rtt_ewma_s']}; {solo['requests']} requests one "
          f"at a time, medians: wall {solo['wall_s']:.4f} s = submit "
          f"(pack, connect, send) {solo['submit_s']:.4f} + reply "
          f"{solo['reply_s']:.4f}; the steps' calls in this process: "
          f"pack values {solo['pack_values_s']:.4f}, unpack values "
          f"{solo['unpack_values_s']:.4f}, plan call host to host "
          f"{solo['plan_s']:.4f}, pack space {solo['pack_space_s']:.4f}, "
          f"unpack space {solo['unpack_space_s']:.4f}, the rest (sockets "
          f"both ways and the ends' other work) {solo['rest_s']:.4f}; "
          f"agents up in {row['agent_start_s']} s; join, kill and heal at "
          f"{row['heal_n']}^3: join {row['join_s']:.2f} s "
          f"(builds 0); kill -9 to typed failover "
          f"{row['kill_to_failover_s']} s, to eviction "
          f"{row.get('kill_to_eviction_s')} s; restart to readmission "
          f"{row['restart_to_readmission_s']:.2f} s; wire overhead "
          f"{row['wire_overhead']} ({CARD})", flush=True)
    return row


def pod_phase(sp, device, counters, n=N):
    """The pod on the card: (a) the loopback pod, (b) the TCP pod."""
    t0 = time.perf_counter()
    POD_ROWS["loopback"] = pod_loopback_case(sp, device, counters, n)
    POD_ROWS["loopback"]["seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    POD_ROWS["tcp"] = pod_tcp_case(sp, device, n)
    POD_ROWS["tcp"]["seconds"] = time.perf_counter() - t1


# -- the control loop and the CLIs over everything ---------------------------

#: the replay of ``control_phase`` (a): ``serve.bench`` at the N^3 grid,
#: the JAX CLI's three signatures (sparsities 1, 11/12, 5/6), 48 requests
#: from 4 threads, the controller on, seed 42 (the CLI's default); the
#: trace's draw, 0.7 s of one core a request, sets the phase's pace
CONTROL_REQUESTS = 48
CONTROL_SIGNATURES = 3
CONTROL_THREADS = 4
CONTROL_SLO = "p99_ms=60000,error_rate=0.5"
#: requests of the replay held bit for bit against the serial calls of
#: their plans (8 a signature: each signature's first in the trace)
CONTROL_VERIFY = 24
#: the tuner's two grid cells replay 32 requests each, not 96, at 128^3,
#: not N^3 (the budget: at N^3 each request's values take 0.7-0.9 s of one
#: core to draw)
CONTROL_TUNE_REQUESTS = 32
CONTROL_TUNE_DIM = 128
#: the tuner's artifact boots a ``--config`` replay at this side (128^3,
#: not N^3: the budget)
CONTROL_CONFIG_DIM = 128
CONTROL_ROWS = {}


def _control_dir():
    from pathlib import Path
    out = Path(__file__).resolve().parent / "build" / "control"
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    return out


def _cli(argv, log, timeout=600):
    """``python -m argv`` from the repository root, its output kept in
    ``log``; fails the script on a nonzero exit. Returns (stdout, s)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + list(argv), cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    with open(log, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        fail(f"control: python -m {' '.join(argv)} exited "
             f"{proc.returncode}:\n{proc.stdout[-2500:]}\n"
             f"{proc.stderr[-2500:]}")
    return proc.stdout, secs


def _cli_json(text):
    return json.loads(next(ln for ln in reversed(text.splitlines())
                           if ln.startswith("{")))


def _cli_start(argv, log):
    """``python -m argv`` in the background, output into ``log``."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m"] + list(argv),
                                cwd=root, stdout=f,
                                stderr=subprocess.STDOUT, text=True)


def _stderr_seconds(log, prefix):
    """The seconds a CLI reported on a ``prefix...in X.XXs`` line."""
    for line in log.read_text().splitlines():
        if line.startswith(prefix):
            return float(line.rsplit(" ", 1)[-1].rstrip("s"))
    return None


def _decisions_summary(decisions, keep=6):
    """The controller's decisions in a line: the first ``keep``, then
    each knob's count and last value."""
    if not decisions:
        return "none"
    head = "; ".join(f"step {d['step']}: {d['knob']} {d['old']:g} -> "
                     f"{d['new']:g} ({d['reason']})"
                     for d in decisions[:keep])
    by = {}
    for d in decisions:
        by.setdefault(d["knob"], []).append(d)
    tail = ", ".join(f"{k} {len(v)}x (last step {v[-1]['step']}: -> "
                     f"{v[-1]['new']:g})" for k, v in by.items())
    return f"{head}; in all {len(decisions)}: {tail}"


def _replay_start(out, device, n=N):
    """Start (a)'s replay process; a thread notes when its trace is
    drawn (the ``trace:`` line on its stderr), the point after which it
    measures."""
    import threading
    argv = (["spfft_tpu_torch.serve.bench", "--dim", str(n),
             "--signatures", str(CONTROL_SIGNATURES), "--requests",
             str(CONTROL_REQUESTS), "--threads", str(CONTROL_THREADS),
             "--control", "--slo", CONTROL_SLO, "--trace-out",
             str(out / "replay.trace.json"), "--prom-out",
             str(out / "replay.prom"), "--verify-sample",
             str(CONTROL_VERIFY), "-o", str(out / "replay.json")]
            + _on(device))
    log = out / "replay.log"
    proc = _cli_start(argv, log)
    state = {"argv": argv, "t0": time.perf_counter(), "drawn_at": None}

    def watch():
        while proc.poll() is None and state["drawn_at"] is None:
            if "trace: " in log.read_text(errors="replace"):
                state["drawn_at"] = time.perf_counter()
            time.sleep(0.1)
    state["watcher"] = threading.Thread(target=watch, daemon=True)
    state["watcher"].start()
    return proc, state


def control_replay_case(out, device, n, proc, state, others_done_at):
    """(a) The replay at N^3 with the controller and the SLO watchdog on
    (started by :func:`_replay_start`): req/s against the serial and warm
    loops, p50 / p99, the fused-batch histogram, the decisions and the
    knobs after; ``--verify-sample``: 24 requests over the three
    signatures bit for bit the serial call of their plans, and the
    replay's launches — each batched bucket, each serial request and
    each pin prewarm one ``decompress_zdft`` and one ``pdft2``, no other
    kernel. The other checks of the phase ran while it built its plans
    and drew its trace; ``others_done_at`` must precede the draw's end,
    so that nothing else ran while it measured (else it says so)."""
    res = out / "replay.json"
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("control (a): the replay ran past 900 s")
    secs = time.perf_counter() - state["t0"]
    state["watcher"].join(timeout=5)
    if rc != 0:
        fail(f"control (a): python -m {' '.join(state['argv'])} exited "
             f"{rc}:\n{(out / 'replay.log').read_text()[-4000:]}")
    drawn = state["drawn_at"]
    overlap = None if drawn is None else max(0.0, others_done_at - drawn)
    if overlap:
        print(f"control (a): WARNING: the other checks ended "
              f"{overlap:.1f} s after the replay's trace was drawn, so "
              f"they ran beside its measurement", flush=True)
    payload = json.loads(res.read_text())
    v = payload["verify"]
    if not v["ok"] or v["launch_check"] != ("checked" if device.type
                                              == "cuda" else
                                              "not on the card") \
            or len(v["requests"]) < 16 or v["signatures"] != 3:
        fail(f"control (a): the replay's verification: {v}")
    if payload["failed_requests"] or payload["obs"]["open_spans"] \
            or payload["obs_failures"]:
        fail(f"control (a): failed {payload['failed_requests']}, open "
             f"spans {payload['obs']['open_spans']}, obs "
             f"{payload['obs_failures']}")
    if payload["platform"]["backend"] != device.type:
        fail(f"control (a): ran on {payload['platform']}")
    if json.loads((out / "replay.trace.json").read_text())["otherData"][
            "tracer"]["open"]:
        fail("control (a): the trace holds open spans")
    snap = payload["serve_metrics"]
    lat = snap["latency_seconds"]
    ctl = payload["control"]
    row = {"card": CARD, "seconds": secs, "dim": n,
           "requests": CONTROL_REQUESTS, "signatures": CONTROL_SIGNATURES,
           "threads": CONTROL_THREADS,
           "served_req_per_s": payload["throughput_rps"],
           "serial_req_per_s": payload["serial_throughput_rps"],
           "warm_loop_req_per_s": payload["warm_loop_throughput_rps"],
           "p50_ms": lat["p50"] * 1e3, "p95_ms": lat["p95"] * 1e3,
           "p99_ms": lat["p99"] * 1e3,
           "fused_batches": snap["fused_batches"],
           "serial_batches": snap["serial_batches"],
           "pinned_batches": snap["pinned_batches"],
           "padded_rows": snap["padded_rows"],
           "batch_size_histogram": snap["batch_size_histogram"],
           "pin_prewarms": snap["health"]["pin_prewarms"],
           "controller_steps": ctl["steps"],
           "decisions": ctl["decisions"], "knobs_after": ctl["knobs"],
           "slo_violations": payload["slo"]["violations"],
           "verified_requests": len(v["requests"]),
           "launches": v["launches"], "executions": v["executions"],
           "trace_events": payload["obs"]["trace_events"],
           "prom_series": payload["obs"]["prom_series"],
           "trace_s": _stderr_seconds(out / "replay.log", "trace: "),
           "overlap_s": overlap}
    moved = _decisions_summary(ctl["decisions"])
    print(f"control (a) serve.bench replay at {n}^3, {CONTROL_REQUESTS} "
          f"requests over {CONTROL_SIGNATURES} signatures from "
          f"{CONTROL_THREADS} threads, the controller on: "
          f"{row['served_req_per_s']:.1f} req/s served against "
          f"{row['serial_req_per_s']:.1f} in the serial loop and "
          f"{row['warm_loop_req_per_s']:.1f} warm; p50 {row['p50_ms']:.1f} "
          f"ms, p99 {row['p99_ms']:.1f}; buckets {snap['fused_batches']} "
          f"fused + {snap['serial_batches']} serial, histogram "
          f"{snap['batch_size_histogram']}, pinned {snap['pinned_batches']}, "
          f"pad rows {snap['padded_rows']}; {len(v['requests'])} requests "
          f"bit for bit; launches {v['launches']} for {v['executions']} "
          f"plan executions; controller {ctl['steps']} steps, decisions: "
          f"{moved}; knobs after: batch_window {ctl['knobs']['batch_window']}"
          f" max_batch {ctl['knobs']['max_batch']} pin_after "
          f"{ctl['knobs']['pin_after']} pipeline_depth "
          f"{ctl['knobs']['pipeline_depth']}; SLO violations "
          f"{row['slo_violations'] or 'none'}; the trace drawn in "
          f"{row['trace_s']} s; {secs:.1f} s ({CARD})", flush=True)
    return row


def control_tune_case(out, device, n=N):
    """(b) ``control tune --quick`` at CONTROL_TUNE_DIM^3 (two grid cells
    of CONTROL_TUNE_REQUESTS requests), then a ``serve.bench --config``
    replay booted from its artifact (at CONTROL_CONFIG_DIM^3), whose
    knobs must be the artifact's (``control check`` reads the artifact
    in :func:`control_files_case`)."""
    art = out / "tuned.json"
    tdim = min(n, CONTROL_TUNE_DIM)
    _, secs = _cli(["spfft_tpu_torch.control", "tune", "--quick",
                       "--dim", str(tdim), "--requests",
                       str(CONTROL_TUNE_REQUESTS), "-o", str(art)]
                      + _on(device),
                      out / "tune.log", timeout=900)
    artifact = json.loads(art.read_text())
    prov = artifact["provenance"]
    cells = prov["grid"]
    if len(cells) != 2 or not all(c["result"] for c in cells) \
            or prov["platform"]["backend"] != device.type:
        fail(f"control (b): the tuner's grid: {cells}, "
             f"{prov.get('platform')}")
    values = artifact["values"]
    cdim = min(n, CONTROL_CONFIG_DIM)
    bt, csecs = _cli(["spfft_tpu_torch.serve.bench", "--dim", str(cdim),
                      "--signatures", str(CONTROL_SIGNATURES),
                      "--requests", str(CONTROL_REQUESTS), "--threads",
                      str(CONTROL_THREADS), "--config", str(art)]
                     + _on(device),
                     out / "config_replay.log", timeout=600)
    want = f"window={values['batch_window'] * 1e3:.1f}ms " \
           f"max_batch={values['max_batch']} " \
           f"pin_after={values['pin_after']}"
    head = next(ln for ln in bt.splitlines() if ln.startswith("signatures="))
    if want not in head:
        fail(f"control (b): the --config replay did not boot the "
             f"artifact's knobs ({want!r} not in {head!r})")
    boot = _cli_json(bt)
    row = {"card": CARD, "tune_seconds": secs, "requests":
           CONTROL_TUNE_REQUESTS, "dim": tdim,
           "cells": [{"batch_window_ms": c["batch_window_ms"],
                      "max_batch": c["max_batch"],
                      "req_per_s": c["result"]["throughput_rps"],
                      "speedup_vs_serial":
                          c["result"]["speedup_vs_serial"],
                      "p99_ms": c["result"]["serve_metrics"]
                      ["latency_seconds"]["p99"] * 1e3} for c in cells],
           "best": prov["best"],
           "config_replay": {"dim": cdim, "seconds": csecs,
                             "knobs": head,
                             "req_per_s": boot["throughput_rps"],
                             "serial_req_per_s":
                                 boot["serial_throughput_rps"]}}
    print(f"control (b) tune --quick at {tdim}^3, {CONTROL_TUNE_REQUESTS} "
          f"requests a cell: "
          + ", ".join(f"window {c['batch_window_ms']} ms max_batch "
                      f"{c['max_batch']}: {c['req_per_s']:.1f} req/s "
                      f"({c['speedup_vs_serial']:.2f}x serial), p99 "
                      f"{c['p99_ms']:.1f} ms" for c in row["cells"])
          + f"; best {prov['best']} in {secs:.1f} s; the "
          f"--config replay at {cdim}^3 booted with {want} "
          f"({boot['throughput_rps']:.1f} req/s against "
          f"{boot['serial_throughput_rps']:.1f} serial, {csecs:.1f} s) "
          f"({CARD})", flush=True)
    return row


def control_modes_case(out, device, n=N, after_smoke=None):
    """(c) the deterministic modes on the card, at the JAX harness's sizes
    (checks of semantics, not measurements): ``--smoke --control`` first
    (its scripted buildup compares queue waits with execute times), then
    ``--fault-smoke --devices 2`` (two slots of the one card) and
    ``--chaos 7`` side by side with (d): ``obs demo --dim N`` on the
    card, ``validate`` on its trace, and ``incident --peer`` against a
    port ``HostAgent`` process on the card (started beside the smoke),
    its bundle through ``incident --validate``. Each exits 0; chaos fires
    at least 8 sites in at least 4 subsystems. ``after_smoke`` is called
    once the smoke has ended, before the others start."""
    from spfft_tpu_torch.net import smoke as net_smoke
    t0 = time.perf_counter()
    agent_log = str(out / "agent.log")
    agent = net_smoke._start_agent(
        "obs-peer", "", "", "", "cuda:0" if device.type == "cuda"
        else "cpu", agent_log)
    _cli(["spfft_tpu_torch.serve.bench", "--smoke", "--control", "-o",
          str(out / "smoke.json")] + _on(device), out / "smoke_control.log")
    took = {"smoke_control": time.perf_counter() - t0}
    if after_smoke is not None:
        after_smoke()
    demo_trace = out / "demo.trace.json"
    runs = {
        "fault_smoke": ["spfft_tpu_torch.serve.bench", "--fault-smoke",
                        "--devices", "2", "-o", str(out / "fault.json")]
        + _on(device),
        "chaos": ["spfft_tpu_torch.serve.bench", "--chaos", "7", "-o",
                  str(out / "chaos.json")] + _on(device),
        "demo": ["spfft_tpu_torch.obs", "demo", "--dim", str(n),
                 "--trace-out", str(demo_trace), "--prom-out",
                 str(out / "demo.prom")] + _on(device),
    }
    t1 = time.perf_counter()
    procs = {k: _cli_start(a, out / f"{k}.log") for k, a in runs.items()}
    try:
        port = net_smoke._await_port(agent, "obs-peer", agent_log)
        took["agent_up"] = time.perf_counter() - t0
        it, took["incident"] = _cli(
            ["spfft_tpu_torch.obs", "incident", "--dir",
             str(out / "incidents"), "--reason", "chip_smoke", "--host",
             "frontend", "--peer", f"obs-peer=127.0.0.1:{port}"],
            out / "incident.log")
        runs["incident_validate"] = [
            "spfft_tpu_torch.obs", "incident", "--validate",
            it.strip().splitlines()[-1].split("wrote ", 1)[1]]
        procs["incident_validate"] = _cli_start(
            runs["incident_validate"], out / "incident_validate.log")
    finally:
        agent.terminate()
        try:
            agent.wait(timeout=60)
        except subprocess.TimeoutExpired:
            agent.kill()
            agent.wait(timeout=60)
    left = dict(procs)
    while left:
        for k, p in list(left.items()):
            if p.poll() is not None:
                took[k] = time.perf_counter() - t1
                del left[k]
                if k == "demo" and p.returncode == 0:  # its validate now
                    runs["demo_validate"] = [
                        "spfft_tpu_torch.obs", "validate", str(demo_trace),
                        "--require-request-stages", "--require-stage",
                        "exchange.plan_build"]
                    procs["demo_validate"] = left["demo_validate"] = \
                        _cli_start(runs["demo_validate"],
                                   out / "demo_validate.log")
        if left:
            if time.perf_counter() - t1 > 900:
                for p in left.values():
                    p.kill()
                fail(f"control (c/d): {sorted(left)} still running after "
                     f"900 s")
            time.sleep(0.2)
    for k, p in procs.items():
        if p.returncode != 0:
            fail(f"control (c/d): python -m {' '.join(runs[k])} exited "
                 f"{p.returncode}:\n"
                 f"{(out / f'{k}.log').read_text()[-3000:]}")
    bundle_path = (out / "incident.log").read_text().split(
        "--- stderr ---")[0].strip().splitlines()[-1].split("wrote ", 1)[1]
    bundle = json.loads(open(bundle_path).read())
    if bundle.get("kind") != "pod" or "error" in (
            bundle.get("hosts", {}).get("obs-peer") or {"error": 1}):
        fail(f"control (d): the pod bundle lacks the agent's: "
             f"{list(bundle.get('hosts', {}))}")
    smoke = json.loads((out / "smoke.json").read_text())
    fault = json.loads((out / "fault.json").read_text())
    chaos = json.loads((out / "chaos.json").read_text())
    for name, p in (("smoke --control", smoke), ("fault-smoke", fault),
                    ("chaos 7", chaos)):
        if not p["ok"] or p["failures"]:
            fail(f"control (c): {name}: {p['failures']}")
    if any(isinstance(fault["phases"][k], str)
           for k in ("3_quarantine", "4_readmission")):
        fail(f"control (c): fault-smoke skipped its pool phases: "
             f"{fault['phases']}")
    if len(chaos["fired_sites"]) < 8 or len(chaos["subsystems"]) < 4:
        fail(f"control (c): chaos fired {len(chaos['fired_sites'])} sites "
             f"in {chaos['subsystems']}")
    if not [d for d in smoke["control"]["decisions"]
            if d["knob"] == "batch_window"] \
            or smoke["slo"]["violations"]:
        fail(f"control (c): smoke --control: {smoke['control']}, "
             f"{smoke['slo']}")

    def last(name):
        return (out / f"{name}.log").read_text().strip().splitlines()[-1]
    secs = time.perf_counter() - t0
    row = {"card": CARD, "seconds": secs,
           "process_seconds": {k: round(v, 1) for k, v in took.items()},
           "smoke_control": {"decisions": smoke["control"]["decisions"],
                             "pinned_batches": smoke["pinned_batches"]},
           "fault_smoke": {k: (v if isinstance(v, str) else v.get("state"))
                           for k, v in fault["phases"].items()},
           "chaos": {"fired_sites": len(chaos["fired_sites"]),
                     "subsystems": chaos["subsystems"],
                     "phases": list(chaos["phases"])},
           "demo": last("demo_validate"),
           "incident": {"hosts": sorted(bundle["hosts"]),
                        "validate": last("incident_validate")}}
    print(f"control (c) on the card: smoke --control "
          f"{len(smoke['control']['decisions'])} decisions (batch_window "
          f"{smoke['control']['window_before']} -> "
          f"{smoke['control']['window_after']}), fault-smoke over two slots "
          f"{row['fault_smoke']}, chaos 7 {len(chaos['fired_sites'])} sites "
          f"in {len(chaos['subsystems'])} subsystems, every phase ok; (d) "
          f"obs demo at {n}^3: {row['demo']}; incident --peer: "
          f"{row['incident']}; {secs:.1f} s (by process: "
          f"{row['process_seconds']}) ({CARD})", flush=True)
    return row


def _on(device) -> list:
    """The CLIs' device flag: none on the card (their default), ``--cpu``
    for a rehearsal on the host."""
    return [] if device.type == "cuda" else ["--cpu"]


def control_phase(device, n=N):
    """The control loop and the two CLIs on the card, each CLI in
    a process of its own, as a user runs it: (a) the replay, (b) the
    tuner and a ``--config`` boot, (c) the deterministic modes and (d)
    the obs CLI (``control_*_case``). Prints ``{"control": ...}``."""
    out = _control_dir()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # (c) and (d) run while (a) builds its plans and draws its trace (a
    # minute of one core at N^3), and (b) beside them once (c)'s smoke
    # (whose decisions read its own timings) has ended; then (a)
    # measures alone
    from concurrent.futures import ThreadPoolExecutor
    proc, state = _replay_start(out, device, n)
    try:
        with ThreadPoolExecutor(1) as pool:
            tune = []
            CONTROL_ROWS["modes"] = control_modes_case(
                out, device, n, after_smoke=lambda: tune.append(
                    pool.submit(control_tune_case, out, device, n)))
            CONTROL_ROWS["tune"] = tune[0].result()
        CONTROL_ROWS["replay"] = control_replay_case(
            out, device, n, proc, state, time.perf_counter())
    finally:
        if proc.poll() is None:  # a check failed: stop the replay too
            proc.kill()
            proc.wait(timeout=60)
    CONTROL_ROWS["files"] = control_files_case(out)
    CONTROL_ROWS["seconds"] = time.perf_counter() - t0


def control_files_case(out):
    """(a)'s trace through ``obs validate --require-request-stages``, its
    Prometheus text through ``obs prom``, (b)'s artifact through
    ``control check``, side by side."""
    runs = {"validate": ["spfft_tpu_torch.obs", "validate",
                         str(out / "replay.trace.json"),
                         "--require-request-stages"],
            "prom": ["spfft_tpu_torch.obs", "prom",
                     str(out / "replay.prom")],
            "check": ["spfft_tpu_torch.control", "check",
                      str(out / "tuned.json")]}
    procs = {k: _cli_start(a, out / f"{k}.log") for k, a in runs.items()}
    row = {}
    for k, p in procs.items():
        text = (out / f"{k}.log")
        if p.wait(timeout=300) != 0:
            fail(f"control: python -m {' '.join(runs[k])} exited "
                 f"{p.returncode}:\n{text.read_text()[-2000:]}")
        lines = text.read_text().strip().splitlines()
        row[k] = lines[0] if k == "check" else lines[-1]
    if not _cli_json((out / "check.log").read_text())["ok"]:
        fail("control (b): check did not accept the tuner's artifact")
    print(f"control files: (a) {row['validate']}; {row['prom']}; (b) "
          f"{row['check']} ({CARD})", flush=True)
    return row


# -- the example programs and the make-ci programs over the port -------------

#: (a) and (b): each program run as a process on the card, by label: its
#: path from the repository root and its arguments (the two-process
#: multihost run's coordinator port is filled in at the start)
EXAMPLE_RUNS = {
    "example": ["examples_torch/example.py"],
    "example_scf": ["examples_torch/example_scf.py"],
    "example_poisson": ["examples_torch/example_poisson.py"],
    "example_distributed": ["examples_torch/example_distributed.py"],
    "example_multihost": ["examples_torch/example_multihost.py"],
    "example_multihost 0/2": ["examples_torch/example_multihost.py",
                              "--num-processes", "2", "--process-id", "0"],
    "example_multihost 1/2": ["examples_torch/example_multihost.py",
                              "--num-processes", "2", "--process-id", "1"],
    "torch_multihost_smoke": ["scripts/torch_multihost_smoke.py"],
}
#: the last line each program must print (None: example.py, whose
#: forward values are checked instead; the distributed example's round
#: trip is read from its last line)
EXAMPLE_LAST = {"example": None, "example_scf": "OK",
                "example_poisson": "OK", "example_distributed": None,
                "example_multihost": "OK", "example_multihost 0/2": "OK",
                "example_multihost 1/2": "OK",
                "torch_multihost_smoke": "MULTIHOST SMOKE: OK"}
#: the distributed example's round trip, max abs over 8 shards
EXAMPLE_ROUNDTRIP = 1e-6
EXAMPLE_TIMEOUT_S = 300
#: (c): SCF steps at the main path's size, and the steps held against the
#: complex128 oracle
SCF_STEPS = 5
SCF_ORACLE_STEPS = (0, 1)
#: the launches of each step on the card: the main path's C2C pair
SCF_LAUNCHES = {"decompress_zdft": 1, "pdft2": 2, "zdft_compress": 1}
#: (d): the precision matrix's rows on the card
MATRIX_DIMS = (64, 128, 256)
MATRIX_DOUBLE_DIMS = (64, 128)
EXAMPLE_ROWS = {}


def _load_by_path(name: str, rel: str):
    """The module of the repository file ``rel`` (a program of
    ``examples_torch/`` or ``scripts/``, which are not packages)."""
    import importlib.util
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(name, os.path.join(root,
                                                                     rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_log(out, label):
    """The log file of the program ``label`` under ``out``."""
    return out / (label.replace("/", "-").replace(" ", "_") + ".log")


def _start_examples(out):
    """Start every program of :data:`EXAMPLE_RUNS` as a process on the card,
    each with its output in :func:`_example_log`; label -> (process,
    start, finish box), the box filled by a thread when it exits."""
    import threading
    root = os.path.dirname(os.path.abspath(__file__))
    coordinator = ["--coordinator", f"127.0.0.1:{_free_port()}"]
    jobs = {}
    for label, argv in EXAMPLE_RUNS.items():
        argv = argv + (coordinator if "/2" in label else [])
        with open(_example_log(out, label), "w") as log:
            proc = subprocess.Popen([sys.executable, *argv], cwd=root,
                                    stdout=log, stderr=subprocess.STDOUT)
        box = []
        threading.Thread(target=lambda p=proc, b=box: (
            p.wait(), b.append(time.perf_counter())), daemon=True).start()
        jobs[label] = (proc, time.perf_counter(), box)
    return jobs


def _finish_examples(out, jobs, t0):
    """Wait for (a) and (b) (all gone by ``EXAMPLE_TIMEOUT_S`` after
    ``t0``), relay each program's lines and seconds, and hold each to its
    exit code and last line; returns label -> seconds."""
    try:
        for proc, _, _ in jobs.values():
            try:
                proc.wait(timeout=max(
                    1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = {}
    for label, (proc, start, box) in jobs.items():
        lines = [ln for ln in _example_log(out, label).read_text()
                 .splitlines() if "socket.cpp" not in ln]
        secs[label] = (box[0] if box else time.perf_counter()) - start
        for ln in lines:
            print(f"examples {label}: {ln}", flush=True)
        print(f"examples {label}: exit {proc.returncode} after "
              f"{secs[label]:.1f} s ({CARD})", flush=True)
        if proc.returncode != 0:
            fail(f"examples: {label} exited {proc.returncode}")
        last = lines[-1].strip() if lines else ""
        want = EXAMPLE_LAST[label]
        if want is not None and last != want:
            fail(f"examples: {label}'s last line is {last!r}, not {want!r}")
        if label == "example":
            fwd = [tuple(map(float, ln.split(",")))
                   for ln in lines[-8:]]
            err = max(abs(re - 8 * k) + abs(im + 8 * k)
                      for k, (re, im) in enumerate(fwd))
            print(f"examples example: unscaled forward of the backward "
                  f"against 8 x the input: max abs error {err:.3e}",
                  flush=True)
            if not err <= 1e-5 * 56:
                fail(f"examples: example.py's forward is {err:.3e} from 8 "
                     f"x its input")
        if label == "example_distributed":
            err = float(last.rsplit(" ", 1)[-1])
            if not last.startswith("round-trip max error:") \
                    or not err <= EXAMPLE_ROUNDTRIP:
                fail(f"examples: example_distributed's round trip "
                     f"{last!r} above {EXAMPLE_ROUNDTRIP}")
    return secs


def scf_oracle_rel(trip, n, coeffs, potential, result) -> float:
    """Relative l2 of one SCF step's ``result`` against the same step in
    complex128 on the host: the coefficients on the sphere's
    ``trip``, the inverse DFT, the potential, the DFT, 1/N."""
    from scipy import fft as sfft

    def host(values):
        v = values.double().cpu()
        v = v.t() if v.shape[-1] != 2 else v
        return v[:, 0].numpy() + 1j * v[:, 1].numpy()

    st = np.where(trip < 0, trip + n, trip)
    cube = np.zeros((n, n, n), np.complex128)
    cube[st[:, 2], st[:, 1], st[:, 0]] = host(coeffs)
    space = sfft.ifftn(cube, workers=-1, overwrite_x=True)
    space *= potential.double().cpu().numpy()
    want = sfft.fftn(space, workers=-1,
                     overwrite_x=True)[st[:, 2], st[:, 1], st[:, 0]]
    got = host(result)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def scf_case(sp, device, n=N):
    """(c): ``examples_torch/example_scf.py``'s loop at ``n``^3 in this
    process, each step's launches printed and held to ``SCF_LAUNCHES`` on
    the card, steps ``SCF_ORACLE_STEPS`` held against the complex128
    oracle at ``predicted_rel_error``; the example itself fails when a
    step after the first builds anything or launches differently."""
    from spfft_tpu_torch.utils.workloads import spherical_cutoff_triplets
    scf = _load_by_path("example_scf", "examples_torch/example_scf.py")
    trip = spherical_cutoff_triplets(n)
    pred = sp.predicted_rel_error("single", n)
    rels = {}

    def on_step(it, coeffs, potential, result):
        if it in SCF_ORACLE_STEPS:
            rels[it] = scf_oracle_rel(trip, n, coeffs, potential, result)

    t0 = time.perf_counter()
    records = scf.main(n=n, device=device, steps=SCF_STEPS, on_step=on_step)
    secs = time.perf_counter() - t0
    for it, rec in enumerate(records):
        print(f"examples scf {n}^3 step {it}: |coeffs| = {rec['norm']:.6f}, "
              f"launches {rec['launches']}, builds {rec['builds']}"
              + (f", rel_l2 against the complex128 oracle {rels[it]:.3e}"
                 if it in rels else "") + f" ({CARD})", flush=True)
        # only a CUDA tensor launches a kernel: a rehearsal on the host
        # counts none
        if device.type == "cuda" and rec["launches"] != SCF_LAUNCHES:
            fail(f"examples scf step {it}: launches {rec['launches']}, "
                 f"expected {SCF_LAUNCHES}")
    for it, rel in rels.items():
        if not rel <= pred:
            fail(f"examples scf step {it}: rel_l2 {rel:.3e} against the "
                 f"oracle above predicted_rel_error {pred:.3e}")
    print(f"examples scf {n}^3: {len(trip)} values, {SCF_STEPS} steps in "
          f"{secs:.1f} s with the oracle (predicted_rel_error {pred:.3e}) "
          f"({CARD})", flush=True)
    return {"values": len(trip), "seconds": secs, "predicted": pred,
            "oracle_rel": rels,
            "steps": [{"norm": r["norm"], "builds": r["builds"],
                       "launches": r["launches"]} for r in records]}


def matrix_case(sp, device):
    """(d): the precision matrix on the card (``scripts/
    torch_precision_matrix.py``'s ``measure`` and ``measure_adversarial``
    in this process): single at ``MATRIX_DIMS`` (both indexings up to
    128), double at ``MATRIX_DOUBLE_DIMS``, the adversarial cases. Every
    row at or under its bar; a row above ``predicted_rel_error`` (but
    under the bar) is printed as such."""
    pm = _load_by_path("torch_precision_matrix",
                       "scripts/torch_precision_matrix.py")
    rows = []

    def row(label, precision, dim, err):
        bar, pred = pm.BARS[precision], sp.predicted_rel_error(precision, dim)
        rows.append({"row": label, "precision": precision, "rel_l2": err,
                     "bar": bar, "predicted": pred})
        note = " ABOVE predicted_rel_error" if err > pred else ""
        print(f"examples matrix {label} {precision}: rel_l2 {err:.3e} (bar "
              f"{bar:.0e}, predicted {pred:.3e}){note} ({CARD})", flush=True)
        if not err <= bar:
            fail(f"examples matrix {label} {precision}: rel_l2 {err:.3e} "
                 f"above the bar {bar:.0e}")

    for precision, dims in (("single", MATRIX_DIMS),
                            ("double", MATRIX_DOUBLE_DIMS)):
        for n in dims:
            for transform in ("c2c", "r2c"):
                for centered in ((False, True) if n <= 128 else (True,)):
                    label = (f"{n} {transform} "
                             f"{'centered' if centered else 'positive'}")
                    row(label, precision, n,
                        pm.measure(n, transform, centered, precision, device))
    for case in pm.ADVERSARIAL_CASES:
        label, err = pm.measure_adversarial(case, device)
        row(label, "single", max(pm.adversarial_dims(case)), err)
    return rows


def examples_phase(sp, device):
    """The example programs and the ``make ci`` programs over the port:
    (a) each of ``examples_torch/`` as a process on the card, the
    multihost example also as two processes over a localhost coordinator
    (one card, gloo), and (b) ``scripts/torch_multihost_smoke.py``, all
    started together, while this process runs (c) the SCF loop at the
    main path's size (:func:`scf_case`) and (d) the precision matrix
    (:func:`matrix_case`); then the processes' lines, seconds and checks.
    The processes load the libraries this script built: none is built
    again."""
    from pathlib import Path
    from spfft_tpu_torch.ops import _build
    out = Path(__file__).resolve().parent / "build" / "examples"
    out.mkdir(parents=True, exist_ok=True)
    libs = sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))
    t0 = time.perf_counter()
    jobs = _start_examples(out)
    try:
        try:
            scf = scf_case(sp, device)
        except RuntimeError as exc:  # the example's own build / launch check
            fail(f"examples scf: {exc}")
        t_matrix = time.perf_counter()
        matrix = matrix_case(sp, device)
        matrix_s = time.perf_counter() - t_matrix
    finally:
        secs = _finish_examples(out, jobs, t0)
    if sorted(p.name for p in _build.BUILD_DIR.glob("*.so")) != libs:
        fail("examples: a program built a kernel library of its own")
    worst = {p: max(r["rel_l2"] for r in matrix if r["precision"] == p)
             for p in ("single", "double")}
    print(f"examples matrix: {len(matrix)} rows in {matrix_s:.1f} s, worst "
          f"single {worst['single']:.3e}, double {worst['double']:.3e} "
          f"({CARD})", flush=True)
    EXAMPLE_ROWS.update({"card": CARD, "seconds": secs, "scf": scf,
                         "matrix": matrix})


def examples_only() -> int:
    """``chip_smoke.py --examples``: the examples phase alone, after the
    kernels' build."""
    sp = _card_and_build()
    t0 = time.perf_counter()
    examples_phase(sp, torch.device("cuda", torch.cuda.current_device()))
    print(f"examples phase: {time.perf_counter() - t0:.1f} s ({CARD})",
          flush=True)
    no_demotions("the examples phase")
    print(json.dumps({"examples": EXAMPLE_ROWS}), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--ptxas-of"] and len(sys.argv) == 3:
        return ptxas_of(sys.argv[2])
    if sys.argv[1:2] == ["--rank-worker"] and len(sys.argv) == 4:
        return rank_worker(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--ranks"] and len(sys.argv) == 4:
        return ranks_only(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:] == ["--examples"]:
        return examples_only()
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
    global CARD
    CARD = card
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
    spill_check(_build.build_log)
    import spfft_tpu_torch as sp
    t_plan = time.perf_counter()
    planner_phase(sp)
    print(f"planner phase: {time.perf_counter() - t_plan:.1f} s ({card})",
          flush=True)

    device = torch.device("cuda", torch.cuda.current_device())
    t_run = time.perf_counter()
    recs, sweep = run(device)
    print(f"256^3 paths, odd shapes and double: "
          f"{time.perf_counter() - t_run:.1f} s ({card})", flush=True)
    no_demotions("the 256^3 paths")
    t_obs = time.perf_counter()
    plan, trip, values = obs_phase(sp, device, launch_counters())
    faults_phase(sp, plan, trip, values, device, launch_counters())
    surface_phase(sp, plan, values, device)
    del plan, trip, values
    no_demotions("the obs and surface phases")
    print(f"obs, faults and plan surface: {time.perf_counter() - t_obs:.1f} "
          f"s ({card})", flush=True)
    t_serve = time.perf_counter()
    serve_phase(sp, device, launch_counters())
    print(f"serving phase: {time.perf_counter() - t_serve:.1f} s ({card})",
          flush=True)
    no_demotions("the serving phase")
    torch.cuda.empty_cache()
    t_pod = time.perf_counter()
    pod_phase(sp, device, launch_counters())
    print(f"pod phase: {time.perf_counter() - t_pod:.1f} s ({card})",
          flush=True)
    no_demotions("the pod phase")
    torch.cuda.empty_cache()
    t_ctl = time.perf_counter()
    control_phase(device)
    print(f"control phase: {time.perf_counter() - t_ctl:.1f} s ({card})",
          flush=True)
    no_demotions("the control phase")
    t_ranks = time.perf_counter()
    ranks = ranks_phase(sp, device)
    print(f"ranks phase: {time.perf_counter() - t_ranks:.1f} s ({card})",
          flush=True)
    no_demotions("the ranks phase")
    t_long = time.perf_counter()
    recs += long_axes_phase(sp, device, launch_counters())
    for dtype in (torch.float32, torch.float64):
        long_odd_shapes_phase(sp, device, launch_counters(), dtype)
    recs += long_plans_phase(sp, device, launch_counters())
    recs += long_f64_records(device)
    print(f"long-axis phases: {time.perf_counter() - t_long:.1f} s "
          f"({card})", flush=True)
    no_demotions("the long-axis phases")
    t_len = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        recs += radix_records(device, dtype)
        recs += bluestein_small_records(device, dtype)
    t_prime = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        recs += fused_prime_records(device, dtype)
    prime_path_phase(sp, device, launch_counters())
    prime_small_phase(sp, device)
    print(f"fused z kernels at a prime dim_z (records, the {PRIME_N}^3 "
          f"pair): {time.perf_counter() - t_prime:.1f} s ({card})",
          flush=True)
    print(f"stage records up to 512: {time.perf_counter() - t_len:.1f} s "
          f"({card})", flush=True)
    recs += length_phases(sp, device, launch_counters())
    matrix = next(r for r in recs if (r["path"], r["name"]) == (
        "radix", f"pdft_last {MATRIX_N}"))
    print(f"lengths up to 512 (radix 7 and 11, Bluestein, the {MATRIX_N}^3 "
          f"and {R2C375_N}^3 paths): {time.perf_counter() - t_len:.1f} s "
          f"({card})", flush=True)
    no_demotions("the lengths up to 512")
    t_cli = time.perf_counter()
    bench = benchmark_phase(card)
    print(f"benchmark CLI: {time.perf_counter() - t_cli:.1f} s ({card})",
          flush=True)
    no_demotions("the benchmark CLI")
    t_cli = time.perf_counter()
    capi = capi_phase(sp, device, launch_counters(), card)
    print(f"C ABI: {time.perf_counter() - t_cli:.1f} s ({card})", flush=True)
    no_demotions("the C ABI")
    t_ex = time.perf_counter()
    examples_phase(sp, device)
    print(f"examples phase: {time.perf_counter() - t_ex:.1f} s ({card})",
          flush=True)
    no_demotions("the examples phase")
    print(json.dumps({"batched_sweep": sweep}), flush=True)
    print(json.dumps({"dist_batched_sweep": DIST_SWEEP}), flush=True)
    print(json.dumps({"exchange": EXCHANGE_ROWS}), flush=True)
    print(json.dumps({"benchmark": bench}), flush=True)
    print(json.dumps({"capi": capi}), flush=True)
    print(json.dumps({"planner": PLANNER_ROWS}), flush=True)
    print(json.dumps({"ranks": ranks}), flush=True)
    print(json.dumps({"matrix_length": matrix}), flush=True)
    print(json.dumps({"design_bound_ms": DESIGN_BOUND_MS}), flush=True)
    print(json.dumps({"obs": OBS_ROWS}), flush=True)
    print(json.dumps({"serve": SERVE_ROWS}), flush=True)
    print(json.dumps({"pod": POD_ROWS}), flush=True)
    print(json.dumps({"control": CONTROL_ROWS}), flush=True)
    print(json.dumps({"examples": EXAMPLE_ROWS}), flush=True)
    print(f"chip_smoke: wall time {time.perf_counter() - T_START:.1f} s "
          f"({card})", flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
