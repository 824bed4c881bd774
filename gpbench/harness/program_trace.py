"""The program's own record of the traced run: gridpp_tpu_torch.tracing's
session, which holds the spans and counts the program made while the
profiler recorded (its recorded step alone), read per served cycle (the
session's `serve.cycles`). A program without the recorder, or a session
that served no cycle, reads as None."""


def session():
    """The program's newest tracing session, or None."""
    try:
        from gridpp_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.session()
    return s if s.counts.get("serve.cycles") else None


def _ns(s, test) -> int:
    return sum(t1 - t0 for name, parent, _, t0, t1 in s.spans
               if test(name, parent))


def ms_per_cycle(names) -> float | None:
    """The named spans' summed time per served cycle (ms)."""
    s = session()
    if s is None:
        return None
    return _ns(s, lambda n, p: n in names) / 1e6 / s.counts["serve.cycles"]


def self_ms_per_cycle(name: str) -> float | None:
    """The span's self time (its time less what its child spans cover) per
    served cycle (ms)."""
    s = session()
    if s is None:
        return None
    own = _ns(s, lambda n, p: n == name) - _ns(s, lambda n, p: p == name)
    return own / 1e6 / s.counts["serve.cycles"]


def per_cycle(counter: str) -> float | None:
    """The session's count per served cycle (0 where it never counted)."""
    s = session()
    if s is None:
        return None
    return s.counts.get(counter, 0) / s.counts["serve.cycles"]
