/*
 * capi_drive: runs cases of the port's C ABI from files and times each
 * call on the host clock.
 *
 *   capi_drive CASE_DIR [CASE_DIR ...]
 *
 * Each CASE_DIR holds
 *   case.txt     one line of integers: transform_type dim_x dim_y dim_z
 *                precision use_pallas num_shards batch (num_shards 0: a
 *                local plan, else a distributed one over that many shards)
 *   triplets.bin int32 x, y, z per value (per-shard lists concatenated)
 *   shards.bin   num_shards int64 values per shard, then num_shards int32
 *                planes per shard (distributed cases only)
 *   values.bin   batch sets of interleaved values, reals of the precision
 * and gets, from the first value set, backward.bin (spfft_tpu_backward),
 * forward.bin (spfft_tpu_forward with FULL scaling of that space) and
 * pair.bin (spfft_tpu_execute_pair with FULL scaling); for batch > 1,
 * multi_backward.bin and multi_forward.bin (spfft_tpu_multi_backward of
 * every set with one handle, then spfft_tpu_multi_forward, FULL, of those
 * spaces). Each call runs 2 times untimed, then 5 timed; the case's line
 * gives the medians in ms (multi: per transform) and the plan creation's
 * seconds. Exits 1 on the first call that returns an error.
 *
 * Built by spfft_tpu_torch.native.build_program against
 * libspfft_tpu_torch.so; SPFFT_TPU_PACKAGE_PATH names the directory to
 * import spfft_tpu_torch from.
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include <spfft_tpu_torch.h>

#define WARMUP 2
#define TIMED 5
#define CHECK(expr)                                                        \
  do {                                                                     \
    int code_ = (expr);                                                    \
    if (code_ != SPFFT_TPU_SUCCESS) {                                      \
      fprintf(stderr, "capi_drive: %s -> %d (%s)\n", #expr, code_,         \
              spfft_tpu_error_string(code_));                              \
      exit(1);                                                             \
    }                                                                      \
  } while (0)

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static char* path_of(const char* dir, const char* name) {
  size_t n = strlen(dir) + strlen(name) + 2;
  char* p = (char*)malloc(n);
  snprintf(p, n, "%s/%s", dir, name);
  return p;
}

/* The whole file dir/name; its size in *size. */
static void* read_file(const char* dir, const char* name, size_t* size) {
  char* p = path_of(dir, name);
  FILE* f = fopen(p, "rb");
  if (f == NULL) {
    fprintf(stderr, "capi_drive: cannot open %s\n", p);
    exit(1);
  }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  void* buf = malloc(n > 0 ? (size_t)n : 1);
  if (buf == NULL || fread(buf, 1, (size_t)n, f) != (size_t)n) {
    fprintf(stderr, "capi_drive: cannot read %s\n", p);
    exit(1);
  }
  fclose(f);
  free(p);
  *size = (size_t)n;
  return buf;
}

static void write_file(const char* dir, const char* name, const void* buf,
                       size_t size) {
  char* p = path_of(dir, name);
  FILE* f = fopen(p, "wb");
  if (f == NULL || fwrite(buf, 1, size, f) != size || fclose(f) != 0) {
    fprintf(stderr, "capi_drive: cannot write %s\n", p);
    exit(1);
  }
  free(p);
}

static int cmp_double(const void* a, const void* b) {
  double x = *(const double*)a, y = *(const double*)b;
  return (x > y) - (x < y);
}

static double median_ms(double* t) {
  qsort(t, TIMED, sizeof(double), cmp_double);
  return 1e3 * 0.5 * (t[(TIMED - 1) / 2] + t[TIMED / 2]);
}

enum { BACKWARD, FORWARD, PAIR, MULTI_BACKWARD, MULTI_FORWARD };

struct Case {
  SpfftTpuPlan plan;
  void *values, *space, *out;
  void **values_b, **spaces_b, **outs_b;
  SpfftTpuPlan* plans_b;
  int batch;
};

static void call(struct Case* c, int which) {
  switch (which) {
    case BACKWARD:
      CHECK(spfft_tpu_backward(c->plan, c->values, c->space));
      break;
    case FORWARD:
      CHECK(spfft_tpu_forward(c->plan, c->space, SPFFT_TPU_FULL_SCALING,
                              c->out));
      break;
    case PAIR:
      CHECK(spfft_tpu_execute_pair(c->plan, c->values,
                                   SPFFT_TPU_FULL_SCALING, c->out));
      break;
    case MULTI_BACKWARD:
      CHECK(spfft_tpu_multi_backward(c->batch, c->plans_b,
                                     (const void* const*)c->values_b,
                                     c->spaces_b));
      break;
    default:
      CHECK(spfft_tpu_multi_forward(c->batch, c->plans_b,
                                    (const void* const*)c->spaces_b,
                                    SPFFT_TPU_FULL_SCALING, c->outs_b));
  }
}

/* The median ms of one call of `which` over TIMED runs after WARMUP. */
static double timed(struct Case* c, int which) {
  double t[TIMED];
  for (int i = 0; i < WARMUP; ++i) call(c, which);
  for (int i = 0; i < TIMED; ++i) {
    double t0 = now_s();
    call(c, which);
    t[i] = now_s() - t0;
  }
  return median_ms(t);
}

static void run_case(const char* dir) {
  int kind, dx, dy, dz, prec, pallas, shards, batch;
  size_t size;
  char* txt = (char*)read_file(dir, "case.txt", &size);
  txt = (char*)realloc(txt, size + 1);
  txt[size] = '\0';
  if (sscanf(txt, "%d %d %d %d %d %d %d %d", &kind, &dx, &dy, &dz, &prec,
             &pallas, &shards, &batch) != 8 || batch < 1) {
    fprintf(stderr, "capi_drive: bad %s/case.txt\n", dir);
    exit(1);
  }
  free(txt);
  int* trip = (int*)read_file(dir, "triplets.bin", &size);
  long long num_values = (long long)(size / (3 * sizeof(int)));
  size_t real = prec == SPFFT_TPU_PREC_SINGLE ? sizeof(float) : sizeof(double);
  size_t values_bytes = 2 * (size_t)num_values * real;
  size_t space_bytes = (size_t)dx * dy * dz * real *
                       (kind == SPFFT_TPU_TRANS_C2C ? 2 : 1);
  unsigned char* values_all = (unsigned char*)read_file(dir, "values.bin",
                                                        &size);
  if (size != values_bytes * batch) {
    fprintf(stderr, "capi_drive: %s/values.bin holds %zu bytes, not %zu\n",
            dir, size, values_bytes * batch);
    exit(1);
  }

  struct Case c;
  memset(&c, 0, sizeof c);
  c.batch = batch;
  double t0 = now_s();
  if (shards == 0) {
    CHECK(spfft_tpu_plan_create(&c.plan, kind, dx, dy, dz, num_values, trip,
                                prec, pallas));
  } else {
    long long* vps = (long long*)read_file(dir, "shards.bin", &size);
    const int* pps = (const int*)(vps + shards);
    CHECK(spfft_tpu_plan_create_distributed(&c.plan, kind, dx, dy, dz,
                                            shards, vps, trip, pps, prec,
                                            SPFFT_TPU_EXCH_DEFAULT, pallas));
    free(vps);
  }
  double create_s = now_s() - t0;
  free(trip);

  c.values = values_all;
  c.space = malloc(space_bytes);
  c.out = malloc(values_bytes);
  double ms[5] = {0, 0, 0, 0, 0};
  ms[BACKWARD] = timed(&c, BACKWARD);
  write_file(dir, "backward.bin", c.space, space_bytes);
  ms[FORWARD] = timed(&c, FORWARD);
  write_file(dir, "forward.bin", c.out, values_bytes);
  ms[PAIR] = timed(&c, PAIR);
  write_file(dir, "pair.bin", c.out, values_bytes);

  if (batch > 1) {
    c.plans_b = (SpfftTpuPlan*)malloc(batch * sizeof(SpfftTpuPlan));
    c.values_b = (void**)malloc(batch * sizeof(void*));
    c.spaces_b = (void**)malloc(batch * sizeof(void*));
    c.outs_b = (void**)malloc(batch * sizeof(void*));
    unsigned char* spaces = (unsigned char*)malloc(space_bytes * batch);
    unsigned char* outs = (unsigned char*)malloc(values_bytes * batch);
    for (int b = 0; b < batch; ++b) {
      c.plans_b[b] = c.plan;
      c.values_b[b] = values_all + b * values_bytes;
      c.spaces_b[b] = spaces + b * space_bytes;
      c.outs_b[b] = outs + b * values_bytes;
    }
    ms[MULTI_BACKWARD] = timed(&c, MULTI_BACKWARD) / batch;
    write_file(dir, "multi_backward.bin", spaces, space_bytes * batch);
    ms[MULTI_FORWARD] = timed(&c, MULTI_FORWARD) / batch;
    write_file(dir, "multi_forward.bin", outs, values_bytes * batch);
    free(spaces);
    free(outs);
    free(c.plans_b);
    free(c.values_b);
    free(c.spaces_b);
    free(c.outs_b);
  }
  CHECK(spfft_tpu_plan_destroy(c.plan));
  printf("capi_drive %s: create_s=%.4f backward_ms=%.4f forward_ms=%.4f "
         "pair_ms=%.4f multi_backward_ms=%.4f multi_forward_ms=%.4f "
         "batch=%d\n",
         dir, create_s, ms[BACKWARD], ms[FORWARD], ms[PAIR],
         ms[MULTI_BACKWARD], ms[MULTI_FORWARD], batch);
  fflush(stdout);
  free(values_all);
  free(c.space);
  free(c.out);
}

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: capi_drive CASE_DIR [CASE_DIR ...]\n");
    return 2;
  }
  if (spfft_tpu_abi_version() != SPFFT_TPU_ABI_VERSION) {
    fprintf(stderr, "capi_drive: library ABI %d, header ABI %d\n",
            spfft_tpu_abi_version(), SPFFT_TPU_ABI_VERSION);
    return 1;
  }
  CHECK(spfft_tpu_init(getenv("SPFFT_TPU_PACKAGE_PATH")));
  for (int i = 1; i < argc; ++i) run_case(argv[i]);
  return 0;
}
