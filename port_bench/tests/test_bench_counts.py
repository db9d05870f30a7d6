"""The shape arithmetic against hand-worked shapes."""

import json

import pytest

from port_bench.count import peaks
from port_bench.count import scan as scan_count
from port_bench.count.step import _conv_backward_flops, step_cost


def test_scan_flops_by_hand():
    # 9 B L D N + B D L
    assert scan_count.selective_scan_flops(2, 3, 4, 5) == 9 * 120 + 24
    # four directions per bidirectional call; a backward counts twice
    assert scan_count.flops(1, 3, 4, 5, False) == 9 * 4 * 60 + 48
    assert scan_count.flops(1, 3, 4, 5, True) == 2 * (9 * 4 * 60 + 48)


def test_scan_least_time_by_hand():
    # B 1, L 2, d 1, N 1, bf16: u2 4 + delta4 8 + B4, C4 16 values of 2
    # bytes in, A, D, bias 4 * 1 * 3 fp32, y 4 fp32 out
    fwd_bytes = (4 + 8 + 16) * 2 + 4 * 3 * 4 + 4 * 4
    assert scan_count.least_s(1, 2, 1, 1, 2, False) == pytest.approx(
        max(fwd_bytes / peaks.HBM_BYTES_PER_S, 8 * 3 / peaks.SFU_PER_S,
            8 * 6 / peaks.FP32_FLOP_PER_S))
    bwd_bytes = 2 * (4 + 8 + 16) * 2 + 2 * 4 * 3 * 4 + 4 * 4
    assert scan_count.least_s(1, 2, 1, 1, 2, True) == pytest.approx(
        max(bwd_bytes / peaks.HBM_BYTES_PER_S, 8 * 6 / peaks.SFU_PER_S,
            8 * 20 / peaks.FP32_FLOP_PER_S))
    # a large call is bound by its bytes
    big = scan_count.least_s(24, 3136, 192, 16, 2, False)
    trip = 24 * 4 * 3136 * 192
    assert big >= trip * 17 / peaks.SFU_PER_S


def test_depthwise_conv_backward_counts_groups():
    # (B 2, C 8, 4 x 4) out, 3 x 3 depthwise: 2 * 256 * 9 per gradient
    out = (2, 8, 4, 4)
    w = (8, 1, 3, 3)
    assert _conv_backward_flops(out, out, w, None, 1, 1, 1, False, 0, 8,
                                [True, True, False]) == 2 * 2 * 256 * 9
    assert _conv_backward_flops(out, out, w, None, 1, 1, 1, False, 0, 8,
                                [False, True, False]) == 2 * 256 * 9


def test_step_cost_of_a_linear_model_by_hand(tiny_root):
    cfg = json.load(open(tiny_root / "port_bench/configs/tiny.json"))
    traffic = json.load(open(tiny_root / "port_bench/traffic/sup.json"))
    cost = step_cost(cfg, traffic)
    assert cost["scan_calls"] == 7  # 4 encoder + 3 decoder blocks
    # every scan under grad: forward plus a backward of twice its FLOPs
    L = [(32 // 4) ** 2 // 4 ** i for i in range(4)]
    dims = cfg["dims"]
    calls = [(L[i], 2 * dims[i]) for i in range(4)] + [
        (L[i], 2 * dims[i]) for i in range(3)]
    want = sum(3 * scan_count.selective_scan_flops(4 * 4, l, d, 16)
               for l, d in calls)
    assert cost["scan_flops"] == want
    assert cost["flops"] > cost["scan_flops"]
