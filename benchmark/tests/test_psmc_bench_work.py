"""Pass 1's frozen work count and the card's peaks, by hand for each cell's
shapes, and the roofline reader on a hand-written trace."""
import pytest

from benchmark import peaks, trace, work
from benchmark.harness import _load

MB, GB = 1e6, 1e9


def test_peaks():
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.FP32_CLASS_FLOPS == pytest.approx(989e12 / 3)


def test_backtest_chunk():
    # 32,768 x 4,096 returns, Identity(20), horizon 20, 64 contexts
    R, T, w, h, B = 32768, 4096, 20, 20, 64
    n_out = T - w - h + 1
    assert n_out == 4057
    nbytes, flops = work.pass1(R, 1, T, n_out, B, w, 20)
    y, norms, ctx, out = R * T * 4, R * n_out * 4, B * w * 4, B * R * 32 * 4
    assert nbytes == y + norms + ctx + out
    assert nbytes == pytest.approx(1.337 * GB, rel=1e-3)
    # B C w = 1,280 multiply-adds per window beats d C w + B d = 1,680
    assert flops == 2 * R * n_out * B * w
    assert flops == pytest.approx(340.3e9, rel=1e-3)
    t, by = work.bound_seconds(nbytes, flops)
    assert by == "operations" and t == pytest.approx(1.032e-3, rel=1e-3)


def test_the_count_leaves_out_any_cache():
    """The factored route's E (R, d, nblk * 128) is 10.7 GB at the backtest
    shape; the layer's count is the same whichever route runs."""
    R, T, n_out, d = 32768, 4096, 4057, 20
    e_bytes = R * d * 32 * 128 * 4
    assert e_bytes == pytest.approx(10.74 * GB, rel=1e-3)
    counts = {work.pass1(R, 1, T, n_out, 64, 20, d) for _ in ("factored", "toeplitz")}
    assert len(counts) == 1 and counts.pop()[0] < e_bytes / 8


def test_reference_cell_query():
    # 131,072 x 4,096 normal, Foveal(1.15, 0.9, 126): d = 34, horizon 252
    R, T, w, h, d = 131072, 4096, 126, 252, 34
    n_out = T - w - h + 1
    assert n_out == 3719
    nbytes, flops = work.pass1(R, 1, T, n_out, 1, w, d)
    assert nbytes == pytest.approx(4.114 * GB, rel=1e-3)
    assert flops == 2 * R * n_out * w                       # 126 < 34 * 126 + 34
    assert flops == pytest.approx(122.8e9, rel=1e-3)
    t, by = work.bound_seconds(nbytes, flops)
    assert by == "bytes" and t == pytest.approx(1.228e-3, rel=1e-3)


def test_one_identity20_context():
    R, T, n_out = 32768, 4096, 4057
    nbytes, flops = work.pass1(R, 1, T, n_out, 1, 20, 20)
    assert nbytes == pytest.approx((R * T + R * n_out + 20 + R * 32) * 4)
    assert flops == 2 * R * n_out * 20
    assert work.bound_seconds(nbytes, flops)[0] == pytest.approx(0.320e-3, rel=2e-3)


def _reading(unit="chunk", units=2):
    """Two chunks: each one pass-1 kernel of 2 ms and two others of 1 ms,
    with 1 ms idle between; untraced 6 ms per chunk."""
    ops, t = [], 0.0
    for _ in range(units):
        for name, dur in (("void blockmin_factored_kernel<64>", 2000.0),
                          ("at::native::sort", 1000.0), ("Memcpy DtoH", 1000.0)):
            ops.append((name, "gpu_memcpy" if "Memcpy" in name else "kernel", t, dur))
            t += dur + 1000.0
    return trace.Reading(ops=ops, host=[("aten::item", 2000.0, 1000.0)],
                         window_s=t / 1e6, units=units, unit=unit,
                         untraced_s_per_unit=6e-3,
                         pass1_bytes=3.35e12 * 1e-3, pass1_flops=0.0)


def test_roofline_reader_on_a_hand_written_trace():
    r = _reading()
    assert r.busy_s == pytest.approx(8e-3)
    # bound 1 ms against 2 ms of pass-1 kernel per chunk
    assert _load("metrics", "pass1_roofline.backtest").read(r) == pytest.approx(50.0)
    assert _load("metrics", "pass1_roofline.query").read(r) is None
    assert _load("metrics", "after_pass1_device_ms.backtest").read(r) == pytest.approx(2.0)
    assert _load("metrics", "launches.backtest").read(r) == pytest.approx(2.0)
    # 4 ms busy per chunk of 6 ms untraced
    assert _load("metrics", "device_idle_pct.backtest").read(r) == pytest.approx(100 / 3)


def test_readers_return_nothing_without_device_work():
    r = trace.Reading(ops=[], host=[], window_s=1.0, units=3, unit="query",
                      untraced_s_per_unit=1.0, pass1_bytes=1e9, pass1_flops=1e9)
    for name in ("pass1_roofline.query", "after_pass1_device_ms.query",
                 "launches.query", "device_idle_pct.query", "tail_p95_ms.query"):
        assert _load("metrics", name).read(r) is None


def test_tail_reader_takes_every_call_of_the_untraced_window():
    lat = [1e-3 * (i + 1) for i in range(101)]       # 1 .. 101 ms
    r = trace.Reading(ops=[], host=[], window_s=1.0, units=3, unit="query",
                      untraced_s_per_unit=1.0, latencies_s=lat)
    assert _load("metrics", "tail_p95_ms.query").read(r) == pytest.approx(96.0)
    r.unit = "chunk"
    assert _load("metrics", "tail_p95_ms.query").read(r) is None


def test_breakdown_names_the_host_op_under_each_gap():
    b = trace.breakdown(_reading())
    assert b["device_ops"][0] == ["void blockmin_factored_kernel<64>", pytest.approx(4e-3)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(1e-3)
    assert sum(gaps.values()) == pytest.approx(5e-3)
