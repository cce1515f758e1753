# Native components of spfft_tpu.
#
# `make native` builds the plan-time planner kernels (also auto-built on
# first import, see spfft_tpu/native/__init__.py); `make capi` builds the
# embeddable C API library libspfft_tpu.so (include/spfft_tpu.h);
# `make example-c` builds and runs the C example against it.
# `make capi-torch` builds the PyTorch / CUDA port's drop-in library,
# build/torch_capi/libspfft_tpu_torch.so (include/spfft_tpu_torch.h).

PY_INCLUDES := $(shell python3-config --includes)
PY_LDFLAGS  := $(shell python3-config --ldflags --embed)
CXX         ?= g++
CXXFLAGS    ?= -O3 -std=c++17 -Wall -fPIC

NATIVE_DIR  := spfft_tpu/native
CACHE_TAG   := $(shell python3 -c "import sys; print(sys.implementation.cache_tag)")
PLANNER_SO  := $(NATIVE_DIR)/_planner_$(CACHE_TAG).so
CAPI_SO     := lib/libspfft_tpu.so

.PHONY: all native capi capi-torch example-c test ci ci-tpu trace-smoke \
        control-smoke fused-smoke store-smoke chaos-smoke \
        cluster-smoke pod-smoke bench-check lint analyze clean

# One-command CI (reference: .github/workflows/ci.yml builds + runs the
# local test matrix): full CPU suite (8-device virtual mesh; includes the
# capi build, C feature drive, Fortran-width execution and the in-suite
# multihost smoke), the compiled C example, the standalone 2-process
# multihost smoke, and the precision matrix in CPU mode. Record with
#   make ci 2>&1 | tee docs/ci_r05.log
ci: native capi
	@echo "== CI 1/4: test suite (CPU, virtual 8-device mesh) =="
	python -m pytest tests/ -q
	@echo "== CI 2/4: compiled C example =="
	$(MAKE) example-c
	@echo "== CI 3/4: 2-process multihost smoke =="
	python scripts/multihost_smoke.py
	@echo "== CI 4/4: precision matrix (CPU mode) =="
	JAX_PLATFORMS=cpu DIMS="32 64" python scripts/precision_matrix.py
	@echo "CI GREEN"

# Baseline lint (docs/static_analysis.md): pyflakes-family rules only
# (unused imports, undefined names; config under [tool.ruff] in
# pyproject.toml, scripts/probe_* excluded there). Uses a real ruff
# when the environment has one; otherwise the dependency-free built-in
# twin runs the same two rule families, so the gate never silently
# degrades to a no-op on a machine without ruff.
lint:
	@echo "== lint: baseline (ruff, or the built-in pyflakes-lite twin) =="
	@if command -v ruff >/dev/null 2>&1; then \
	  ruff check spfft_tpu/; \
	else \
	  echo "(ruff not installed; running python -m spfft_tpu.analysis --baseline-only)"; \
	  python -m spfft_tpu.analysis --baseline-only -q; \
	fi
	@echo "LINT GREEN"

# Project lint engine (docs/static_analysis.md): the AST-based checkers
# that enforce the contracts the code claims — lock-discipline over
# `#: guarded by _lock` fields + the lock-acquisition-order graph
# (deadlock-shape cycles fail), span-closure for every obs span open
# site, the spfft_* counter/series registry, the error taxonomy and the
# control-plane knob registry. Zero unwaived findings required; every
# waiver is listed in the report with its reason. The same checks run
# in tier-1 (tests/test_analysis.py::test_real_package_analysis_is_clean
# and the fixture suite around it).
analyze:
	@echo "== analyze: project static-analysis pass =="
	@mkdir -p build
	python -m spfft_tpu.analysis --json build/analysis_report.json
	@echo "ANALYZE GREEN"

# On-TPU regression lane (tests_tpu/): oracle matrix, forced Pallas,
# the segmented aliased-carry accumulate, split-x, pair-IO, two-stage
# axes and repeated-backward — the silent-corruption bug classes the
# CPU-pinned suite cannot see — plus the serving smokes (pinning +
# fault-injection: bucket isolation, device quarantine over the real
# chip pool, crash-proof dispatch). Needs the real chip; record with
#   make ci-tpu 2>&1 | tee docs/ci_tpu_r05.log
# lint + analyze + chaos-smoke + cluster-smoke + pod-smoke run first:
# the chip lane is expensive, so it never starts on a tree the static
# passes already know is dirty or whose failure semantics the CPU
# chaos harness / emulated pod / real-TCP pod can already break.
ci-tpu: lint analyze chaos-smoke cluster-smoke pod-smoke
	@echo "== CI-TPU: on-device regression lane =="
	python -m pytest tests_tpu/ -q -rA
	@echo "CI-TPU GREEN"

# Observability smoke (docs/observability.md): the deterministic serving
# smoke with request tracing on, exporting + validating both artifact
# formats — the Chrome trace JSON (all eight request stages + compile +
# exchange events, zero unclosed spans; open build/trace_smoke.json in
# https://ui.perfetto.dev) and the Prometheus text exposition
# (round-tripped through the validating parser). The same checks run in
# tier-1 (tests/test_serve_bench_cli.py::test_serve_bench_smoke_trace_artifacts).
trace-smoke:
	@echo "== trace-smoke: traced serve.bench --smoke + artifact validation =="
	@mkdir -p build
	python -m spfft_tpu.serve.bench --smoke --cpu --devices 2 \
	  --trace-out build/trace_smoke.json --prom-out build/trace_smoke.prom
	python -m spfft_tpu.obs validate build/trace_smoke.json --require-request-stages
	python -m spfft_tpu.obs prom build/trace_smoke.prom
	@echo "TRACE-SMOKE GREEN"

# Control-plane smoke (docs/control_plane.md): the traced deterministic
# serving smoke WITH the feedback controller on — the scripted
# queue-buildup trace must produce >= 1 recorded, bounds-clamped knob
# decision (the CLI exits 1 otherwise), zero unclosed spans, bit-exact
# results through a mid-stream retune, no SLO false positives, and the
# Prometheus text must expose the spfft_control_* / spfft_slo_* series.
# The same checks run in tier-1
# (tests/test_serve_bench_cli.py::test_serve_bench_smoke_control_closes_the_loop).
control-smoke:
	@echo "== control-smoke: traced serve.bench --smoke --control + assertions =="
	@mkdir -p build
	python -m spfft_tpu.serve.bench --smoke --control --cpu --devices 2 \
	  --trace-out build/control_smoke.json --prom-out build/control_smoke.prom
	grep -q "spfft_control_decisions_total" build/control_smoke.prom
	grep -q "spfft_slo_burn_rate" build/control_smoke.prom
	grep -q "spfft_control_knob" build/control_smoke.prom
	python -m spfft_tpu.obs validate build/control_smoke.json --require-request-stages
	@echo "CONTROL-SMOKE GREEN"

# Fused compression+DFT smoke (docs/kernels.md): the interpret-mode
# bit-exactness + fallback-gate suite for ops/fused_kernel.py, then a
# benchmark.py --fused run whose JSON must report the fused path ACTIVE
# with no gate declines, then the distributed twin under the overlap
# pipeline (K=2 compact exchange, r2c-trimmed stick set) which must
# report BOTH fused directions active with no per-direction declines.
# The same coverage runs in tier-1 (tests/test_fused_kernel.py,
# tests/test_fused_dist.py, tests/test_benchmark_cli.py::
# test_cli_fused_ab); on-chip bit-exactness + the profile evidence that
# the dense stick intermediate is gone live in `make ci-tpu`
# (test_fused_compression_dft_on_tpu, test_fused_overlap_on_tpu).
fused-smoke:
	@echo "== fused-smoke: interpret-mode fused compression+DFT checks =="
	@mkdir -p build
	python -m pytest tests/test_fused_kernel.py -q
	python -m spfft_tpu.benchmark -d 8 6 128 -r 1 --fused \
	  -o build/fused_smoke.json
	python -c "import json; p = json.load(open('build/fused_smoke.json'))['parameters']; assert p['fused'] and not p['fused_fallback'], p"
	SPFFT_TPU_COMPACT_PPERMUTE=1 SPFFT_TPU_FUSED_RECOMPUTE_LIMIT=16 \
	  python -m spfft_tpu.benchmark -d 8 6 128 -r 1 --fused --cpu \
	  --shards 2 -e compact --overlap-chunks 2 --transform r2c \
	  -o build/fused_dist_smoke.json
	python -c "import json; p = json.load(open('build/fused_dist_smoke.json'))['parameters']; assert p['fused_dist'] and not p['fused_dist_fallback'] and p['overlap_chunks'] == 2, p"
	@echo "FUSED-SMOKE GREEN"

# Plan-artifact store smoke (docs/artifact_cache.md): the zero-cold-
# start contract across REAL process boundaries — process A builds one
# canonical workload into a store (index tables + kernel tables + AOT
# executables, async-spilled), records a manifest and a backward-
# execution reference; process B (a fresh interpreter) prewarms from
# the manifest and must resolve the same request with builds==0, no
# registry-build/table-build compile events, and a bit-exact backward
# vs process A's recorded output (--strict exits 1 on any of those
# failing). The same checks run in tier-1
# (tests/test_plan_store.py::test_store_smoke_cross_process); the
# on-chip AOT-beats-fresh-compile assertion is staged in `make ci-tpu`
# (test_plan_store_on_tpu).
store-smoke:
	@echo "== store-smoke: cross-process plan-artifact warm boot =="
	@mkdir -p build; rm -rf build/store_smoke
	env JAX_PLATFORMS=cpu python -m spfft_tpu.serve.store seed \
	  build/store_smoke --dim 24 --use-pallas --reference --json
	env JAX_PLATFORMS=cpu python -m spfft_tpu.serve.store manifest \
	  build/store_smoke
	env JAX_PLATFORMS=cpu python -m spfft_tpu.serve.store prewarm \
	  build/store_smoke --manifest build/store_smoke/manifest.json \
	  --compile --check-reference --strict --json
	env JAX_PLATFORMS=cpu python -m spfft_tpu.serve.store verify \
	  build/store_smoke --json > /dev/null
	@echo "STORE-SMOKE GREEN"

# Chaos smoke (docs/serving.md "Failure semantics"): the seeded chaos
# harness on two deterministic seeds — the four degradation-ladder
# acceptance phases (runtime fused demotion, ENOSPC -> memory-only
# store, execute-timeout watchdog, pod lane death mid-trace) plus 16
# seeded multi-seam fault
# storms per seed across executor/plan/registry/store, asserting zero
# hangs, typed failures only, bit-exact healthy requests, zero
# unclosed spans and no torn store artifacts. Exit 1 on any violation.
# The same harness runs in tier-1
# (tests/test_serve_bench_cli.py::test_serve_bench_chaos_harness);
# the on-chip twin is staged in tests_tpu/test_chaos_on_tpu.py.
chaos-smoke:
	@echo "== chaos-smoke: seeded multi-seam fault storms =="
	@mkdir -p build
	env JAX_PLATFORMS=cpu python -m spfft_tpu.serve.bench --chaos 7 \
	  -o build/chaos_smoke_s7.json > /dev/null
	env JAX_PLATFORMS=cpu python -m spfft_tpu.serve.bench --chaos 1234 \
	  -o build/chaos_smoke_s1234.json > /dev/null
	@echo "CHAOS-SMOKE GREEN"

# Pod smoke (docs/cluster.md): the in-process 2-host emulated pod —
# 25 requests (single-device routed power-of-two-choices + one
# DistributedTransformPlan through the pod-wide SPMD lane) bit-exact
# vs direct plan execution, both hosts exercised, one trace id
# end-to-end across the host boundary with zero unclosed spans, the
# federated /metrics exposition re-parsed by the validating parser,
# host-death failover, and the routing-policy simulation gates
# (round-robin skew >= 4x, p2c <= 2x). Exit 1 on any violation. The
# same checks run in tier-1 (tests/test_cluster.py); the on-chip twin
# is staged in tests_tpu/test_pod_serve_on_tpu.py.
cluster-smoke:
	@echo "== cluster-smoke: emulated 2-host pod + routing simulation =="
	env JAX_PLATFORMS=cpu \
	  XLA_FLAGS="--xla_force_host_platform_device_count=8" \
	  python -m spfft_tpu.serve.cluster --smoke
	@echo "CLUSTER-SMOKE GREEN"

# Real-wire pod smoke (docs/cluster.md "Deployment"): two AGENT
# PROCESSES over localhost TCP behind a PodFrontend of TcpHostLanes —
# a mixed single+distributed trace bit-exact vs a serial oracle built
# in the parent, one trace id across the process boundary (asserted
# via the agents' `spans` RPC), a mid-stream join that boots warm off
# the shared blob tier (joiner registry builds == 0), kill -9 failover
# with bit-exact survivors, and a drain-leave walking the membership
# ladder. Exit 1 on any violation.
pod-smoke:
	@echo "== pod-smoke: real two-process pod over localhost TCP =="
	env JAX_PLATFORMS=cpu \
	  XLA_FLAGS="--xla_force_host_platform_device_count=8" \
	  python -m spfft_tpu.net.smoke
	@echo "POD-SMOKE GREEN"

# Perf-trajectory guard (scripts/bench_regress.py): run the north-star
# benchmark fresh and compare against the latest recorded BENCH_r*.json
# with a noise threshold — nonzero exit on regression, so the perf
# trajectory is machine-checked instead of eyeballed. Record with
#   make bench-check 2>&1 | tee docs/bench_check_rNN.log
bench-check:
	@echo "== bench-check: fresh benchmark vs latest BENCH_r*.json =="
	@mkdir -p build
	python bench.py | tee build/bench_fresh.log
	grep '^{' build/bench_fresh.log | tail -1 > build/bench_fresh.json
	python scripts/bench_regress.py --fresh build/bench_fresh.json
	@echo "BENCH-CHECK GREEN"

all: native capi

native: $(PLANNER_SO)

$(PLANNER_SO): $(NATIVE_DIR)/planner.cpp
	$(CXX) $(CXXFLAGS) -fopenmp -shared $< -o $@

capi: $(CAPI_SO)

$(CAPI_SO): $(NATIVE_DIR)/capi.cpp include/spfft_tpu.h
	@mkdir -p lib
	$(CXX) $(CXXFLAGS) -shared -Iinclude $(PY_INCLUDES) $< -o $@ $(PY_LDFLAGS)

# The port's library (spfft_tpu_torch/native/capi.cpp): built by the
# package's own build function, which rebuilds only when it is stale.
capi-torch:
	python3 -c "from spfft_tpu_torch.native import build_capi; print(build_capi())"

example-c: $(CAPI_SO)
	@mkdir -p build
	$(CXX) -O2 -Iinclude examples/example.c -o build/example_c -Llib \
	  -lspfft_tpu -Wl,-rpath,'$$ORIGIN/../lib'
	SPFFT_TPU_PACKAGE_PATH=$(CURDIR) ./build/example_c

test:
	python -m pytest tests/ -q

clean:
	rm -rf lib build $(NATIVE_DIR)/_planner_*.so
