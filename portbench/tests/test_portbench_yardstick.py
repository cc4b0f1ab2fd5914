"""The frozen work counts, checked on shapes small enough to count by hand."""

import pytest

from portbench import yardstick as Y


def test_fno_block_macs_by_hand():
    # b=1, w=2, v=1, nx=ny=4, m=1 (K = 2): planes 2, pixels 16
    # dft = 2 * (16*1*2 + 1*2*4*4) = 128; mix = 1*1*2*1*2*2*4 = 32
    # inv = 1*1*4*2*1*2*2 + 16*2*1*2 = 32 + 64 = 96; pointwise = 16*3*4 = 192
    assert Y.fno_block_macs(1, 2, 1, 4, 4, 1) == 128 + 32 + 96 + 192
    # backward: fwd + dft + 2 mix + inv + 16*6*4
    assert Y.fno_block_macs(1, 2, 1, 4, 4, 1, backward=True) == 448 + 128 + 64 + 96 + 384


def test_kernel_costs_by_hand():
    act, x3 = 1 * 2 * 1 * 4 * 4, 2 * 1 * 4 * 4
    assert Y.k4_cost(1, 2, 1, 4, 4, 1) == (4 * (2 * act + x3), 2 * 448)
    # K5: 16 pixels, W 2, step 1: bytes 4*16*3, flops 2*16*256*3
    assert Y.k5_cost(1, 2, 1, 4, 4, 1) == (4 * 16 * 3, 2 * 16 * 256 * 3)
    assert Y.k6_cost(1, 2, 1, 4, 4, 1) == (4 * (3 * act + 2 * x3), 2 * 1120)
    assert Y.k7_cost(1, 2, 1, 4, 4, 1) == (4 * 16 * 5, 2 * 16 * 256 * 8)
    # K2 on [1, 3, 4, 4, 4]: 8 interior cells, 45 flops each
    assert Y.k2_ns_cost(1, 4, 4, 4) == (4 * (3 * 64 + 8), 45 * 8)


def test_bound_takes_the_larger_side():
    assert Y.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert Y.bound_s(0, 67e12) == pytest.approx(1.0)
    assert Y.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_forward_and_train_step_sums():
    shape = (1, 2, 1, 4, 4, 1)
    fwd = 6 * Y.bound_s(*Y.k4_cost(*shape)) + Y.bound_s(*Y.k5_cost(*shape[:5], 1))
    assert Y.fno_forward_bound_s(*shape, 1) == pytest.approx(fwd)
    bwd = 6 * Y.bound_s(*Y.k6_cost(*shape)) + Y.bound_s(*Y.k7_cost(*shape[:5], 1))
    assert Y.fno_train_step_bound_s(*shape, 1, 3) == pytest.approx(3 * (2 * fwd + bwd))
    # lift: 16 pixels * (1 + 2) inputs * W 2 * 2 flops
    assert Y.fno_forward_flops(*shape, 1, 1) == 2 * 16 * 3 * 2 + 6 * 2 * 448 + 2 * 16 * 256 * 3


def test_mfu_arithmetic():
    from portbench.core import HERE, Run, load_module

    m = load_module(HERE / "metrics" / "mfu.serve.py", "metric")

    class T:
        busy_s = 1.0

    run = Run(cell=None, setup_s=0.0, window_s=2.0, latencies=[0.1] * 4, trace=T(),
              work={"model_flops": 67e12 / 4})
    # 4 requests of a quarter second's peak work in 2 s: 50 %
    assert m.read(run) == pytest.approx(50.0)


def test_kernel_names():
    assert Y.base_name("void block_out_tile_kernel<16>(float const*, int)") == "block_out_tile_kernel"
    assert Y.base_name("(anonymous namespace)::dft_fwd_kernel(Args)") == "dft_fwd_kernel"
    assert Y.names_of("K4", "K5") >= {"dft_fwd_kernel", "projection_tile_kernel"}
    assert "residual_window_kernel" in Y.names_of("K2")
