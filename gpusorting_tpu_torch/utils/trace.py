"""The port's spans and counters, on the profiler's clock.

`span(name)` marks one step of a call: it always counts `name`, and only
while a torch profiler records does it open
`torch.profiler.record_function("gst." + name)`, so the step lands in the
profiler's trace on the clock of the device work it enqueues.  With no
profiler it returns one shared null context: no `record_function`.

Names (PERF.md §3 says which metric reads each):
  dispatch.<step>       host work that decides a route (holds no engine span)
  sync.<what>           a readback that blocks the host until the card has
                        finished the work before it
  engine.<route>        the enqueue of one route; its count is the route's
  composite.<branch>    the segmented composite's branch, `u32` (one u32
                        key) or `i64` (the int64 key); its count is the
                        branch's.  Inside it `composite.build` (segment
                        ids and the key), `composite.sort` and
                        `composite.gather` (codes and payload planes read
                        out by the permutation)
  fixed.<step>          the segmented fixed-length route's steps, inside
                        `engine.fixed`: `fixed.sort` (the batched sort of
                        the (S, L) rows of codes) and `fixed.gather` (the
                        payload planes read out by its permutation; absent
                        keys only)
  payload.<step>        a segmented sort's 64-bit payload: `split` into
                        (lo, hi) int32 planes, `join` back
  dist.<step>           the distributed sort's steps: `dist.merge` (the
                        received runs merged into the padded block,
                        `parallel/dist_merge.merge_runs`)
  build.<source stem>   an `nvcc` build inside this process
  launch.<module>.<fn>  a kernel wrapper's `fn.launches` (`launch_counter`)

`counts()` is a snapshot of every counter; `reset()` zeroes them, the
wrappers' `fn.launches` included.
"""

from __future__ import annotations

import collections
import itertools

import torch

_PREFIX = "gst."
_profiling = torch.autograd._profiler_enabled
# one `itertools.count` a name: `next()` on it is a single C call, so spans
# on several threads lose no count, with no lock on the path of a call
_counts: collections.defaultdict = collections.defaultdict(itertools.count)
_launch_fns: dict[str, object] = {}


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


def span(name: str):
    """Count `name`; a profiler annotation "gst.<name>" while one records."""
    next(_counts[name])
    if _profiling():
        return torch.profiler.record_function(_PREFIX + name)
    return _NULL


def readback(what: str, t: torch.Tensor):
    """span("sync." + what) around a readback of `t` where `t` lies on a
    CUDA card, where the readback waits for the card; nothing elsewhere."""
    return span("sync." + what) if t.is_cuda else _NULL


def launch_counter(fn):
    """Register a kernel wrapper's `fn.launches` (set to 0 here) as the
    counter `launch.<module>.<fn>`; returns `fn` unchanged."""
    fn.launches = 0
    module = fn.__module__.rsplit(".", 1)[-1]
    _launch_fns[f"launch.{module}.{fn.__name__}"] = fn
    return fn


def counts() -> dict[str, int]:
    """A snapshot: every span's count and every registered launch count."""
    # a count's repr is "count(n)": n increments so far
    out = {name: int(repr(c)[6:-1]) for name, c in list(_counts.items())}
    out.update((name, fn.launches) for name, fn in _launch_fns.items())
    return out


def reset() -> None:
    _counts.clear()
    for fn in _launch_fns.values():
        fn.launches = 0
