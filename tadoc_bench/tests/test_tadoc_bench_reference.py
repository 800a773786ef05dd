"""The plain reference against answers counted by hand."""

import numpy as np
import pytest

from tadoc_bench import harness
from tadoc_bench.reference import Partition, bad_entries, bf16

FILES = [np.array([0, 1, 1, 2]), np.array([1, 2, 3, 1, 2])]
VOCAB = 5
ROOT = harness.BENCH.parent


def kind(name):
    cell = harness.Cell(name="x", root=ROOT, chips=1, config={}, mix={},
                        end_to_end=[], per_layer=[])
    return harness.kind_module(cell, name)


def test_counts_by_hand():
    part = Partition(FILES, VOCAB)
    np.testing.assert_array_equal(kind("word_count").reference(part, {}),
                                  np.float32([1, 4, 3, 1, 0]))
    tv = kind("term_vector").reference(part, {})
    np.testing.assert_array_equal(tv, np.float32([[1, 2, 1, 0, 0],
                                                  [0, 2, 2, 1, 0]]))
    assert tv.dtype == np.float32
    np.testing.assert_array_equal(kind("inverted_index").reference(part, {}),
                                  tv > 0)
    order, counts = kind("sort").reference(part, {})
    np.testing.assert_array_equal(order, np.int32([1, 2, 0, 3, 4]))
    np.testing.assert_array_equal(counts, np.float32([4, 3, 1, 1, 0]))


def test_ranked_by_hand():
    files, counts = kind("ranked_inverted_index").reference(
        Partition(FILES, VOCAB), {})
    # word 0 only in file 0; word 1 twice in both (tie -> lower file);
    # word 2 once in file 0, twice in file 1
    np.testing.assert_array_equal(files[:3], np.int32([[0, 1], [0, 1],
                                                       [1, 0]]))
    np.testing.assert_array_equal(counts[:3], np.float32([[1, 0], [2, 2],
                                                          [2, 1]]))


def test_sequence_count_by_hand():
    grams, counts = kind("sequence_count").reference(
        Partition(FILES, VOCAB), {"l": 2})
    # file 0: 01 11 12; file 1: 12 23 31 12 -> 01:1 11:1 12:3 23:1 31:1
    np.testing.assert_array_equal(grams, np.int32([[0, 1], [1, 1], [1, 2],
                                                   [2, 3], [3, 1]]))
    np.testing.assert_array_equal(counts, np.float32([1, 1, 3, 1, 1]))


def test_ranked_words_no_file_holds():
    files, counts = kind("ranked_inverted_index").reference(
        Partition(FILES, VOCAB), {})
    # word 3 only in file 1; word 4 in no file: the files in their order
    np.testing.assert_array_equal(files[3:], np.int32([[1, 0], [0, 1]]))
    np.testing.assert_array_equal(counts[3:], np.float32([[1, 0], [0, 0]]))
    assert files.dtype == np.int32 and counts.dtype == np.float32


def test_bf16_rounding():
    x = np.float32([1, 255, 256, 257, 258, 259, 1000.5])
    np.testing.assert_array_equal(bf16(x), np.float32([1, 255, 256, 256,
                                                       258, 260, 1000]))


def test_low_precision_control_differs_above_256():
    files = [np.zeros(301, np.int64), np.ones(3, np.int64)]
    assert bad_entries(Partition(files, 2, low=True).word_count,
                       Partition(files, 2).word_count) == 1


@pytest.mark.parametrize("got,want,bad", [
    (np.float32([1, 2]), np.float32([1, 2]), 0),
    (np.float32([1, 3]), np.float32([1, 2]), 1),
    (np.float64([1, 2]), np.float32([1, 2]), 2),      # dtype
    (np.float32([1, 2, 3]), np.float32([1, 2]), 2),   # shape
    ([np.int32([0]), np.float32([1])], (np.int32([0]), np.float32([2])), 1),
    ((np.int32([0]),), (np.int32([0]), np.float32([2])), 2),   # arity
    (np.float32([np.nan]), np.float32([0]), 1),
])
def test_bad_entries(got, want, bad):
    assert bad_entries(got, want) == bad
