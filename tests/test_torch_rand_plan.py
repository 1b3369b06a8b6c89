"""The launch plan of K3a rand_h and K3b rand_yt (ops/kernels.rand_plan):
tile width, slices of the summed axis and scratch sizes, at the shapes the
port launches them at and at the ragged ones a 128-row, 64-deep tile
makes. Pure Python: the SM count is an argument."""

import itertools

import pytest

from snprelate_tpu_torch.ops.kernels import (RAND_DEPTH, RAND_PER_SM,
                                             RAND_ROWS, rand_plan)

WIDTHS = (1, 31, 32, 33, 64, 320, 704, 705)
SNPS = (1, 4_000, 4_096, 131_072)
SAMPLES = (128, 192, 7_936, 100_096)
SMS = (132, 114, 1)


def _check(plan, length: int, rows: int, c: int, sms: int) -> None:
    assert plan.width in RAND_PER_SM
    # the width: 32 only for c <= 32 (no masked work at 32), tiles cover c
    assert (plan.width == 32) == (c <= 32)
    assert (plan.col_tiles - 1) * plan.width < c <= plan.col_tiles * plan.width
    assert (plan.row_tiles - 1) * RAND_ROWS < rows <= plan.row_tiles * RAND_ROWS
    # slices: a multiple of the stage depth, covering the axis exactly once
    assert plan.slice_len > 0 and plan.slice_len % RAND_DEPTH == 0
    assert plan.nslice >= 1
    assert (plan.nslice - 1) * plan.slice_len < length
    assert plan.nslice * plan.slice_len >= length
    assert plan.nslice == -(-length // plan.slice_len)  # the C side's count
    if plan.nslice > 1:  # slices only where the tiles leave the card idle
        assert plan.slice_len >= 512
        assert plan.row_tiles * plan.col_tiles < 10 * RAND_PER_SM[plan.width] * sms
    # scratch sized for the slices; one slice, none
    many = plan.nslice > 1
    assert plan.part == (plan.nslice * rows * c if many else 0)
    assert plan.y2part == (plan.nslice * rows if many else 0)


@pytest.mark.parametrize("c", WIDTHS)
def test_rand_h_plan(c):
    """rand_h: the summed axis is the N samples, the rows the S SNPs."""
    for S, N, sms in itertools.product(SNPS, SAMPLES, SMS):
        _check(rand_plan(N, S, c, sms), N, S, c, sms)


@pytest.mark.parametrize("c", WIDTHS)
def test_rand_yt_plan(c):
    """rand_yt: the summed axis is the S SNPs, the rows the N samples."""
    for S, N, sms in itertools.product(SNPS, SAMPLES, SMS):
        _check(rand_plan(S, N, c, sms), S, N, c, sms)


def test_rand_plan_main_shapes():
    """The main path's launches on an H100 (132 SMs): a 100k chunk's 32 row
    tiles of rand_h cut into slices that fill one wave, rand_yt's 782 row
    tiles in one slice, c = 704 and 320 on 64-wide tiles (no padded
    columns), and a slab's 62 row tiles of rand_yt cut into slices."""
    p = rand_plan(100_096, 4_096, 64, 132)
    assert (p.width, p.row_tiles, p.nslice) == (64, 32, 8)
    p = rand_plan(100_096, 4_096, 32, 132)
    assert (p.width, p.row_tiles) == (32, 32) and p.nslice > 1
    for c in (64, 704):
        p = rand_plan(4_096, 100_096, c, 132)
        assert p.nslice == 1 and p.part == 0 and p.width == 64
    p = rand_plan(131_072, 7_936, 320, 132)
    assert (p.width, p.col_tiles, p.row_tiles) == (64, 5, 62)
    p = rand_plan(131_072, 7_936, 64, 132)
    assert p.row_tiles == 62 and p.nslice == 4
    p = rand_plan(7_936, 131_072, 64, 132)
    assert p.row_tiles == 1_024 and p.nslice == 1 and p.y2part == 0
