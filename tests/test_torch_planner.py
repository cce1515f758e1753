"""The port's native index planner (``spfft_tpu_torch/native/planner.cpp``
through ``native/planner.py``) against the port's numpy path and against
the JAX package's native planner (``spfft_tpu.native.plan_indices`` /
``inverse_map``) and index plans, in this process.

* the tables exactly, on random sets: C2C and hermitian, storage and
  centered indexing, shuffled rows, duplicate triplets, the empty set;
  every dtype as the numpy path returns it;
* the same error class and message on either path for out-of-bounds
  triplets and for more values than grid elements;
* the inverse maps (last duplicate wins) against numpy and the JAX
  package's native scatter, and their out-of-range refusal;
* which planner built each plan: ``IndexPlan.planner`` and its reason
  for the numpy path (asked for, a folded hermitian set), through
  ``build_index_plan``, the local and distributed plans and
  ``convert``'s given tables; the library under ``build/torch_native/``.
"""

import numpy as np
import pytest

import spfft_tpu
from spfft_tpu import native as jnative

import spfft_tpu_torch as sp
from spfft_tpu_torch import convert
from spfft_tpu_torch import indexing as ti
from spfft_tpu_torch.native import planner

from test_util import center_triplets, random_sparse_triplets

DIMS = [(1, 1, 1), (2, 3, 4), (11, 12, 13), (13, 11, 12), (16, 16, 16),
        (100, 13, 2)]


def _triplets(rng, dims, centered, hermitian):
    """A random valid set: hermitian keeps storage x in [0, dim_x // 2]
    (x stays non-negative when centered)."""
    t = random_sparse_triplets(rng, dims)
    if hermitian:
        t = t[t[:, 0] <= dims[0] // 2]
        if t.shape[0] == 0:
            t = np.array([[0, 0, 0]], np.int32)
    if centered:
        c = center_triplets(t, dims)
        if hermitian:
            c[:, 0] = t[:, 0]
        t = c
    return t


def _same_tables(a, b):
    for f in ("value_indices", "stick_keys"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype == np.int32, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.centered == b.centered


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("hermitian", [False, True])
def test_native_tables_equal_numpy_and_jax(dims, centered, hermitian):
    """The native plan equals the numpy plan and the JAX package's native
    conversion and index plan, table for table."""
    rng = np.random.default_rng(
        [dims[0], dims[1], dims[2], int(centered), int(hermitian)])
    trip = _triplets(rng, dims, centered, hermitian)
    kind = sp.TransformType.R2C if hermitian else sp.TransformType.C2C
    nat = ti.build_index_plan(kind, *dims, trip)
    ref = ti.build_index_plan(kind, *dims, trip, native=False)
    assert (nat.planner, nat.planner_reason) == ("native", None)
    assert (ref.planner, ref.planner_reason) == ("numpy", ti.NUMPY_ASKED)
    _same_tables(nat, ref)
    jvi, jkeys, jcen = jnative.plan_indices(hermitian, *dims, trip)
    np.testing.assert_array_equal(nat.value_indices, jvi)
    np.testing.assert_array_equal(nat.stick_keys, jkeys)
    assert nat.centered == jcen
    jp = spfft_tpu.indexing.build_index_plan(
        spfft_tpu.TransformType(kind.value), *dims, trip)
    _same_tables(nat, jp)
    np.testing.assert_array_equal(nat.slot_src, jp.slot_src)
    np.testing.assert_array_equal(nat.col_inv_t, jp.col_inv_t)


@pytest.mark.parametrize("case", ["shuffled", "duplicates", "int64_rows",
                                  "empty"])
def test_native_tables_on_awkward_sets(case):
    """Rows in any order, duplicate triplets (the last duplicate wins the
    slot), int64 input and the empty set: both paths and the JAX
    package's native planner agree."""
    rng = np.random.default_rng(5)
    dims = (11, 12, 13)
    trip = random_sparse_triplets(rng, dims)
    if case == "shuffled":
        trip = trip[rng.permutation(len(trip))]
    elif case == "duplicates":
        trip = np.concatenate([trip, trip[rng.integers(0, len(trip), 40)]])
    elif case == "int64_rows":
        trip = center_triplets(trip, dims).astype(np.int64)
    else:
        trip = np.zeros((0, 3), np.int32)
    nat = ti.build_index_plan("c2c", *dims, trip)
    ref = ti.build_index_plan("c2c", *dims, trip, native=False)
    assert nat.planner == "native"
    _same_tables(nat, ref)
    np.testing.assert_array_equal(
        nat.slot_src, ti.inverse_slot_map(nat.value_indices,
                                          nat.num_sticks * dims[2],
                                          nat.num_values, native=False))
    jvi, jkeys, _ = jnative.plan_indices(False, *dims, trip)
    np.testing.assert_array_equal(nat.value_indices, jvi)
    np.testing.assert_array_equal(nat.stick_keys, jkeys)


@pytest.mark.parametrize("hermitian", [False, True])
@pytest.mark.parametrize("where", ["x", "y", "z", "negative_x"])
def test_out_of_bounds_raises_alike(hermitian, where):
    """An index out of bounds raises the same class with the same message
    on both paths, and the JAX package raises its class of that name."""
    dims = (8, 9, 10)
    trip = np.array([[0, 0, 0], [1, 2, 3]], np.int64)
    bad = {"x": [dims[0], 0, 0], "y": [0, dims[1], 0], "z": [0, 0, dims[2]],
           "negative_x": [-dims[0], 0, 0]}[where]
    trip = np.concatenate([trip, [bad]])
    kind = "r2c" if hermitian else "c2c"
    errs = []
    for native in (True, False):
        with pytest.raises(sp.InvalidIndicesError) as exc:
            ti.build_index_plan(kind, *dims, trip, native=native)
        errs.append(str(exc.value))
    if not (hermitian and where == "negative_x"):
        # a hermitian x < 0 row is folded on the numpy path, whose bounds
        # name the folded set
        assert errs[0] == errs[1]
    with pytest.raises(Exception) as jexc:
        spfft_tpu.indexing.build_index_plan(kind, *dims, trip)
    assert type(jexc.value).__name__ == "InvalidIndicesError"


def test_too_many_values_and_bad_shapes_raise_alike():
    for native in (True, False):
        with pytest.raises(sp.InvalidParameterError, match="more frequency"):
            ti.build_index_plan("c2c", 1, 1, 2,
                                np.zeros((3, 3), np.int64), native=native)
        with pytest.raises(sp.InvalidParameterError, match=r"\(n, 3\)"):
            ti.build_index_plan("c2c", 4, 4, 4, np.zeros((3, 2), np.int64),
                                native=native)
        with pytest.raises(sp.InvalidParameterError, match="integers"):
            ti.build_index_plan("c2c", 4, 4, 4, np.zeros((3, 3)),
                                native=native)


def test_folded_hermitian_set_takes_numpy_and_says_why():
    """A hermitian set carrying its x < 0 half is folded on the numpy path
    (as in the JAX package), recorded as such; its tables and conjugate
    mask equal the JAX package's."""
    rng = np.random.default_rng(9)
    dims = (11, 9, 7)
    trip = center_triplets(random_sparse_triplets(rng, dims), dims)
    plan = ti.build_index_plan("r2c", *dims, trip)
    assert (plan.planner, plan.planner_reason) == ("numpy", ti.NUMPY_FOLDED)
    jp = spfft_tpu.indexing.build_index_plan(spfft_tpu.TransformType.R2C,
                                             *dims, trip)
    _same_tables(plan, jp)
    np.testing.assert_array_equal(plan.value_conj, jp.value_conj)


@pytest.mark.parametrize("n,slots", [(0, 5), (1, 1), (500, 700),
                                     (500, 500)])
def test_inverse_maps_equal_numpy_and_jax(n, slots):
    """The native inverse maps (last duplicate wins) against numpy and the
    JAX package's native scatter; both entry points of the port."""
    rng = np.random.default_rng(n + slots)
    idx = rng.integers(0, slots, n).astype(np.int32)
    for fn in (ti.inverse_slot_map, ti.inverse_col_map):
        nat = fn(idx, slots, n)
        ref = fn(idx, slots, n, native=False)
        assert nat.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(nat, ref)
        np.testing.assert_array_equal(nat, jnative.inverse_map(idx, slots,
                                                               n))
    with pytest.raises(IndexError):
        planner.inverse_map(np.array([0, slots], np.int32), slots, 0)


def test_every_plan_records_its_planner():
    """Local and distributed plans built from triplets say "native"; a
    plan of given tables says "given"; the library lies under
    build/torch_native/ and loads."""
    rng = np.random.default_rng(11)
    dims = (8, 8, 8)
    trip = random_sparse_triplets(rng, dims)
    assert planner.unavailable_reason() is None
    assert planner.LIBRARY.exists()
    assert planner.LIBRARY.parent.name == "torch_native"
    plan = sp.make_local_plan(sp.TransformType.C2C, *dims, trip,
                              device="cpu")
    assert plan.index_plan.planner == "native"
    half = len(trip) // 2
    keys = trip[:, 0] * 8 + trip[:, 1]
    cut = keys[half]
    parts = [trip[keys < cut], trip[keys >= cut]]
    dplan = sp.make_distributed_plan(sp.TransformType.C2C, *dims, parts,
                                     [4, 4], device="cpu")
    assert {p.planner for p in dplan.dist_plan.shard_plans} == {"native"}
    given = convert.index_plan_from_arrays({
        "transform_type": "c2c", "dim_x": 8, "dim_y": 8, "dim_z": 8,
        "centered": False, "value_indices": plan.index_plan.value_indices,
        "stick_keys": plan.index_plan.stick_keys})
    assert (given.planner, given.planner_reason) == ("given", None)
