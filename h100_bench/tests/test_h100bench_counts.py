"""The yardstick's arithmetic against numbers worked out by hand for
Qwen3-8B's published sizes, and the trace reduction's interval union."""

import json
import os

import pytest

from h100_bench import counts, trace

HERE = os.path.dirname(os.path.abspath(__file__))
QWEN3_8B = json.load(open(os.path.join(HERE, "..", "configs", "qwen3-8b-w4a16.json")))


def test_layer_params_of_qwen3_8b():
    # q 4096x4096, k and v 4096x1024, o 4096x4096, gate/up/down 3 x 4096x12288
    assert counts.layer_matmul_params(QWEN3_8B) == (
        16_777_216 + 2 * 4_194_304 + 16_777_216 + 3 * 50_331_648)
    assert counts.layer_matmul_params(QWEN3_8B) == 192_937_984


def test_request_flops_by_hand():
    # 1000 prompt tokens, 101 served (the last never fed): 1100 fed tokens.
    layers = 36 * 192_937_984
    mm = 2 * layers * 1100
    head = 2 * 4096 * 151_936 * 101
    attn = 4 * 36 * 32 * 128 * (1100 * 1101 // 2)
    assert counts.request_flops(QWEN3_8B, 1000, 101) == pytest.approx(mm + head + attn, rel=1e-12)
    assert mm == 15_280_688_332_800
    assert head == 1_244_659_712 * 101 == 125_710_630_912
    assert attn == 589_824 * 605_550 == 357_167_923_200


def test_decode_kv_bytes_by_hand():
    # Two decode steps after a 1000-token prompt attend 1001 and 1002
    # positions; a position is k and v over 36 layers x 8 kv heads x 128, bf16.
    per_position = 2 * 36 * 8 * 128 * 2
    assert per_position == 147_456
    assert counts.decode_kv_bytes(QWEN3_8B, 1000, 3, 2) == (1001 + 1002) * per_position
    assert counts.decode_kv_bytes(QWEN3_8B, 1000, 1, 2) == 0


def test_int4_pass_bytes_by_hand():
    weights = 36 * 192_937_984 + 4096 * 151_936
    assert weights == 7_568_097_280
    assert counts.int4_pass_bytes(QWEN3_8B, 128) == 3_784_048_640 + 118_251_520
    assert counts.int4_head_bytes(QWEN3_8B, 128) == 311_164_928 + 9_723_904


def test_w4_roofline_counts_steps_and_prefill_heads():
    """B5's yardstick: the engine's decode steps times a whole pass, and
    one LM head per engine call's prefill, over B5's time alone (another
    kernel's launches do not enter)."""
    from types import SimpleNamespace

    from h100_bench.registry import Registry

    mod = Registry().metric("w4_matmul_roofline")
    trace = SimpleNamespace(kernel_seconds=lambda names: (
        (2.0, 500) if names == ("w4a16_kernel",) else (99.0, 12345)))
    run = SimpleNamespace(device_name="NVIDIA H100 80GB HBM3", bench={"int4_group": 128},
                          model=QWEN3_8B, trace=trace, engine={"decode_steps": 300}, calls=4)
    need = 300 * (3_784_048_640 + 118_251_520) + 4 * (311_164_928 + 9_723_904)
    assert mod.read(run) == pytest.approx(100.0 * need / 3.35e12 / 2.0)
    assert mod.read(SimpleNamespace(**{**vars(run), "engine": {"decode_steps": 0}})) is None


def test_peaks_table():
    assert counts.peaks_for("NVIDIA H100 80GB HBM3") == {"bf16_flops": 989e12,
                                                         "hbm_bytes_per_s": 3.35e12}
    assert counts.peaks_for("cpu") is None


@pytest.mark.parametrize("intervals,merged,busy", [
    ([(0, 10), (5, 20), (30, 40)], [(0, 20), (30, 40)], 30),         # overlap, then a gap
    ([(30, 40), (0, 10), (10, 15)], [(0, 15), (30, 40)], 25),        # unsorted, touching
    ([(0, 100), (10, 20), (30, 40)], [(0, 100)], 100),               # nested
    ([], [], 0),
])
def test_union_of_device_intervals(intervals, merged, busy):
    assert trace.union(intervals) == merged
    assert sum(e - s for s, e in trace.union(intervals)) == busy


def test_gaps_and_their_labels():
    merged = [(0, 10), (20, 30), (40, 50), (100, 110)]
    idle = trace.gaps(merged)
    assert idle == [(10, 20), (30, 40), (50, 100)]
    host = [(8, 19, "cudaStreamSynchronize"),      # covers the first gap
            (38, 39, "cudaLaunchKernel"),          # a sliver of the second
            (0, 2, "cudaMemcpyAsync")]
    labels = trace.label_gaps(idle, host)
    assert labels[0] == ("host waits: cudaStreamSynchronize", 10)
    assert labels[1] == ("host dispatch before cudaLaunchKernel", 10)
    assert labels[2] == ("host, no CUDA call", 50)


class _Evt:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_summary_of_a_trace():
    events = [_Evt("decode_attention_kernel", 0, 1_000_000_000, True),
              _Evt("nvjet_gemm", 500_000_000, 1_000_000_000, True),    # overlaps the first
              _Evt("w4a16_kernel", 2_000_000_000, 500_000_000, True),
              _Evt("cudaStreamSynchronize", 1_400_000_000, 700_000_000, False)]
    s = trace.summarize(events, window_s=4.0)
    assert s.busy_s == pytest.approx(2.0)
    assert s.kernel_seconds(("decode_attention_kernel",)) == (1.0, 1)
    assert s.kernel_seconds(("w4a16", "nvjet")) == (1.5, 2)
    b = s.breakdown()
    assert b["device_ops"][0] == ["nvjet_gemm", 1.0] or b["device_ops"][0][1] == 1.0
    assert b["idle_gaps"] == [["host waits: cudaStreamSynchronize (1 gaps, longest 0.500000 s)",
                               0.5]]
    assert trace.kernel_kind("w4a16_kernel<...>") == "w4a16_matmul"
    assert trace.kernel_kind("nvjet_hsh_128x64") == "matmul"
