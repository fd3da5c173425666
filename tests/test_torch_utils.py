"""The port's `utils.timing` and `utils.logging` against the JAX
package's, on the CPU: `Timer` keeps the same summary keys and values for
the same intervals, `timed` prints or collects as the JAX one does,
`trace` writes a Chrome trace of the block (torch.profiler; CPU activity
here), and `setup_logging` configures the same handlers, quieting `torch`
where the JAX one quiets `jax`."""
import json
import logging
import os

from persian_rag_tpu.utils import logging as jlog
from persian_rag_tpu.utils import timing as jtiming
from persian_rag_tpu_torch.utils import logging as tlog
from persian_rag_tpu_torch.utils import timing as ttiming


def test_timer_and_timed_equal_jax(capsys):
    timers = (ttiming.Timer(), jtiming.Timer())
    for t in timers:
        for name, seconds in (("retrieval", 0.5), ("retrieval", 1.5),
                              ("generation", 2.0)):
            t.add(name, seconds)
        with t.section("encode"):
            pass
    got, want = (t.summary(prefix="x_") for t in timers)
    assert list(got) == list(want)
    for key in ("x_avg_retrieval_time", "x_avg_generation_time"):
        assert got[key] == want[key]
    assert timers[0].total("retrieval") == 2.0
    sink = {}
    with ttiming.timed("step", sink):
        pass
    assert list(sink) == ["step"] and sink["step"] >= 0
    with ttiming.timed("printed"):
        pass
    assert capsys.readouterr().out.startswith("[printed] ")


def test_trace_writes_a_chrome_trace(tmp_path):
    import torch

    with ttiming.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0], encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_setup_logging_equals_jax(tmp_path):
    t = tlog.setup_logging("prt_torch_test", log_dir=str(tmp_path / "t"))
    j = jlog.setup_logging("prt_jax_test", log_dir=str(tmp_path / "j"))
    assert [type(h) for h in t.handlers] == [type(h) for h in j.handlers]
    assert t.level == j.level == logging.INFO
    assert os.listdir(tmp_path / "t") == ["prt_torch_test.log"]
    assert tlog.setup_logging("prt_torch_test") is t  # idempotent
    assert tlog.get_logger("prt_torch_test") is t
    assert logging.getLogger("torch").level == logging.ERROR
