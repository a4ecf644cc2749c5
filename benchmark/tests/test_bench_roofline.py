"""The bytes and operations of select_roofline and hilbert.step_mfu at the
cells' shapes."""

import pytest

from benchmark import roofline


@pytest.mark.parametrize("n, bound_us", [(100_000, 15.31), (8_000_000, 1225.1)])
def test_int8_select_at_the_cells_shapes(n, bound_us):
    nbytes, ops = roofline.select_work(n, 512, 500, "int8")
    assert nbytes == n * 512 + n + 500 * 2 * 4 + 8
    assert ops == 4 * n * 512
    least, by = roofline.bound(nbytes, ops, "int8")
    assert by == "bytes"
    assert 1e6 * least == pytest.approx(bound_us, rel=1e-3)


def test_float32_select_reads_the_norms_too():
    nbytes, _ = roofline.select_work(1000, 512, 500, "float32")
    assert nbytes == 1000 * 512 * 4 + 1000 + 4 * 1000 + 500 * 2 * 4 + 8


@pytest.mark.parametrize("n", [100_000, 8_000_000])
def test_giga_iteration_is_its_select_and_the_o_s_rest(n):
    sel_b, sel_ops = roofline.select_work(n, 512, 500, "int8")
    nbytes, ops = roofline.giga_iteration_work(n, 512, 500, "int8")
    assert nbytes == sel_b + 16 * 500 and ops == sel_ops + 32 * 500
    least, by = roofline.bound(nbytes, ops, "int8")
    assert by == "bytes" and least == pytest.approx(nbytes / 3.35e12)


def test_operations_bound_where_the_rate_is_low():
    least, by = roofline.bound(1.0, 67e12, "float32")
    assert by == "operations" and least == pytest.approx(1.0)
