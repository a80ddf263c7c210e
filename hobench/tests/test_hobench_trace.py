"""The reduction of a trace, on events written by hand: the window, each
device operation's step and batch through its runtime call, busy time and
idle time by the step the host was in."""

from hobench import trace


def test_reduce_trace_attributes_and_sums():
    evs = [
        ("span", "batch", 0, 100), ("span", "salts", 0, 10),
        ("span", "engine", 10, 40), ("span", "summary", 40, 100),
        ("span", "batch", 100, 200), ("span", "salts", 100, 110),
        ("span", "engine", 110, 130), ("span", "summary", 130, 200),
        ("launch", 1, 5), ("launch", 2, 20), ("launch", 3, 45),
        ("launch", 4, 115),
        ("device", "draw", 6, 12, 1),
        ("device", "k1", 30, 90, 2),      # launched in engine, runs late
        ("device", "sum", 91, 95, 3),
        ("device", "k1", 120, 190, 4),
        ("device", "stray", 250, 260, 9),  # outside the window
    ]
    tr = trace.reduce_trace(evs)
    assert tr.window == (0, 200) and len(tr.batches) == 2
    steps = [(op.name, op.step, op.batch) for op in tr.ops]
    assert steps == [("draw", "salts", 0), ("k1", "engine", 0),
                     ("sum", "summary", 0), ("k1", "engine", 1)]
    assert tr.busy_ns == 6 + 60 + 4 + 70
    assert sum(tr.idle_by_step.values()) == 200 - tr.busy_ns
    # idle from 0 to 6 begins in salts, 12..30 in engine, and 90..91,
    # 95..120 and 190..200 in summary
    assert tr.idle_by_step == {"salts": 6, "engine": 18,
                               "summary": 1 + 25 + 10}
    assert tr.device_ops(2) == [["k1", 130e-9], ["draw", 6e-9]]


def test_reduce_trace_without_batches():
    assert trace.reduce_trace([("device", "k", 0, 1, 0)]) is None
