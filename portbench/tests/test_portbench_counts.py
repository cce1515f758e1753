"""The yardstick's frozen pieces: the triplet counts at 256^3 and the
stage byte and operation counts, worked by hand at 16^3."""

import math

import numpy as np
import pytest

from portbench_support import load_config, small_config
from portbench import counts, workload


@pytest.mark.parametrize("name, values, sticks, columns", [
    ("c2c256_f32", 16_777_216, 65_536, 256),
    ("r2c256_f64", 8_454_144, 33_024, 129)])
def test_pinned_256_counts(name, values, sticks, columns):
    cfg = load_config(name)
    trip = workload.config_triplets(cfg)
    assert trip.shape == (values, 3)
    assert workload.stick_count(trip, cfg["dims"]) == sticks
    assert workload.column_count(trip, cfg["dims"]) == columns
    assert (cfg["values"], cfg["sticks"], cfg["columns"]) == \
        (values, sticks, columns)


@pytest.mark.parametrize("transform, sparsity, num_x", [
    ("c2c", 1.0, 16), ("c2c", 0.5, 8), ("r2c", 1.0, 9), ("r2c", 0.5, 5),
    ("r2c", 0.3, 3)])
def test_cutoff_sticks_below_x(transform, sparsity, num_x):
    """The source's stick set: every (x, y) with x below
    dim_x_freq * sparsity (9 * 0.5 = 4.5: x 0..4), full z, x-major, then
    y, then z."""
    trip = workload.cutoff_stick_triplets([16, 12, 10], transform, sparsity)
    assert trip.shape == (num_x * 12 * 10, 3)
    assert trip[:, 0].max() == num_x - 1 and trip.min() == 0
    key = (trip[:, 0].astype(np.int64) * 12 + trip[:, 1]) * 10 + trip[:, 2]
    assert (np.diff(key) == 1).all()


def test_hermitian_pairs_of_the_r2c_planes():
    """At x = 0 and x = n / 2 every value has its mirror in the set; the
    eight self-mirrored values are the corners of those planes."""
    trip = workload.cutoff_stick_triplets([16] * 3, "r2c", 1.0)
    src, dst, selfs = workload.hermitian_pairs(trip, [16] * 3)
    assert len(src) == (2 * 256 - 8) // 2 and len(selfs) == 8
    assert set(trip[selfs].ravel().tolist()) == {0, 8}
    assert set(trip[np.concatenate([src, dst]), 0].tolist()) == {0, 8}


def test_hand_worked_16_c2c_single():
    cfg = small_config("c2c256_f32")
    trip = workload.config_triplets(cfg)
    n, s, c = trip.shape[0], workload.stick_count(trip, cfg["dims"]), \
        workload.column_count(trip, cfg["dims"])
    assert (n, s, c) == (4096, 256, 16)
    got = counts.pair_counts("c2c", "single", [16] * 3, n, s, c)
    # values 4096 x 8 B, sticks 256 x 16 x 8 B, slab 16^3 x 8 B, each
    # direction; FFTs 5 n log2 n a line
    assert got["z"] == (2 * (32768 + 32768), 2 * 5 * 256 * 16 * 4)
    assert got["xy"] == (2 * (32768 + 32768),
                         2 * (5 * 256 * 16 * 4 + 5 * 256 * 16 * 4))
    assert got["pair"] == (2 * (32768 + 32768),
                           got["z"][1] + got["xy"][1])


def test_hand_worked_16_r2c_double_half_sparse():
    cfg = small_config("r2c256_f64", sparsity=0.5)
    trip = workload.config_triplets(cfg)
    n, s, c = trip.shape[0], workload.stick_count(trip, cfg["dims"]), \
        workload.column_count(trip, cfg["dims"])
    # x below 9 * 0.5 = 4.5: 5 x columns (0..4) of 16 sticks of 16
    assert (n, s, c) == (1280, 80, 5)
    got = counts.pair_counts("r2c", "double", [16] * 3, n, s, c)
    # values 1280 x 16 B, sticks 80 x 16 x 16 B, the real slab 16^3 x 8 B
    assert got["z"] == (2 * (20480 + 20480), 2 * 5 * 80 * 16 * 4)
    assert got["xy"] == (2 * (20480 + 32768),
                         2 * (5 * 80 * 16 * 4 + 5 * 256 * 16 * 4 / 2))
    assert got["pair"] == (2 * (20480 + 32768),
                           got["z"][1] + got["xy"][1])


def test_bound_takes_the_larger():
    peaks = counts.load_peaks()
    assert peaks["memory_bytes_per_s"] == 3.35e12
    assert counts.bound_seconds(3.35e12, 0, "single", peaks) == 1.0
    assert counts.bound_seconds(0, 34e12, "double", peaks) == 1.0
    assert math.isclose(counts.fft_flops(1, 8), 120.0)
