"""The readers of the program's frame-loop spans (``upload_ms``,
``prefetch_blocked_ms``, ``download_ms``) on a hand-made trace, and on the
report of the program's own recorder: each reads its ``<thread>/<span>``
line of the stage report, and nothing where the program reports none (a
program without the spans)."""

import threading

import pytest

from benchmark import cells, trace

READERS = {"upload_ms": "prefetch/upload", "prefetch_blocked_ms": "prefetch/put-wait",
           "download_ms": "download/download"}


def _trace(stages):
    return trace.Trace(stages=stages, windows=10, window_s=2.0)


@pytest.mark.parametrize("name,line", sorted(READERS.items()))
def test_reader_is_the_mean_span_ms(name, line):
    stages = {"prefetch-wait": (0.5, 11), "window": (1.0, 12), line: (0.3, 12)}
    assert cells.metric_reader(name)(_trace(stages)) == pytest.approx(25.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_nothing_without_its_span(name):
    # the stages of a program that records no thread's spans, and a line with no span
    old = {"prefetch-wait": (0.5, 11), "emit-wait": (1.0, 11), "scdet": (0.2, 10)}
    assert cells.metric_reader(name)(_trace(old)) is None
    assert cells.metric_reader(name)(_trace({**old, READERS[name]: (0.0, 0)})) is None


def test_readers_on_the_programs_report():
    """Spans recorded on threads named as the frame loop names them, through
    ``StageTimes.report`` and ``parse_stages``: each reader gives its span's
    mean; the old stages parse as before."""
    from drba_tpu_torch.utils.profiling import StageTimes

    st = StageTimes()
    for _ in range(3):
        with st.stage("prefetch-wait"):
            pass

    def thread(spans, n):
        for _ in range(n):
            for span in spans:
                with st.span(span):
                    pass

    workers = [threading.Thread(target=thread, name=name, args=a) for name, *a in
               (("prefetch", ("upload", "put-wait"), 4), ("download-0", ("download",), 5),
                ("download-1", ("download",), 5))]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    t = _trace(trace.parse_stages(st.report()))
    assert t.stages["prefetch-wait"][1] == 3 and t.stages["download/download"][1] == 10
    for name, line in READERS.items():
        total, count = st.spans[line]
        # the report rounds seconds to 1 ms
        assert cells.metric_reader(name)(t) == pytest.approx(total / count * 1e3,
                                                             abs=1.0 / count)
