"""Spans, device marks and counters of the port, off by default.

- ``with span(name):`` times a stretch of host work. Off, it returns a
  shared no-op after one flag test. On, it records the name, start and end
  (``time.perf_counter_ns``), its parent span and the step id
  (``set_step``: the trainer's ``global_step``, the request id of a
  training run), and, while a ``torch.profiler`` records, it is also a
  ``record_function`` range, so the profiler's trace holds the program's
  spans on the clock of its kernels.
- Device marks time the phases of a unit of device work (a train step, a
  validation batch, an inference pass) on the device's own clock, inside
  CUDA graphs too. ``open_marks(unit, device)`` starts a unit (None while
  marks are off); ``mark(name)`` closes the interval ``name`` that began
  at the unit's previous ``mark`` (or its start); ``with
  device_span(name):`` times a stretch nested in one; ``finish(m)`` ends
  the unit. Each point is one launch of ``ops/marks.py``'s ``stamp``, so
  under capture it is a node of the graph and every replay writes it anew.
  A train step hands its stamps (``Marks.columns``) to the step's metrics
  vector, which reaches the host in the copy that is made anyway; the
  host records them with ``take_marks``. Other units are recorded from the
  host (``record``, ``defer`` then ``record_pending``). Names repeated in
  one unit (a mark pair per sampled layer) are summed into one sample of
  the unit.
- ``counter(name, n)`` adds to a count while spans are on.

The registry keeps, per name, the count, the total and the self time (the
duration less what child spans cover) and a ring of the last ``RING``
durations, and a ring of the last ``RING`` raw records. ``snapshot()``
returns it, ``reset()`` clears it.

``enable(marks)`` turns host spans and counters on, and device marks too
with ``marks``; ``disable()`` turns all off. Marks are read when a step is
captured: ``train/steps.py``'s ``_Replay`` recaptures when they are turned
on or off. Between the two, host spans follow the profiler:
``follow_profiler()``, which the trainer calls each iteration and
inference each pass, turns them on while a profiler records and off after.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Dict, List, Optional

import torch

from bliss_gnn_tpu_torch.ops.marks import stamp

RING = 4096  # durations kept per name; raw records kept
MAX_MARKS = 64  # points one unit of device work may hold

_on = False  # host spans and counters
_marks = False  # device marks
_explicit = False  # set by enable(): the profiler does not switch spans
_step = 0
_stack: List["_Span"] = []  # the open host spans, innermost last
_unit: Optional["Marks"] = None  # the unit the marks go to
_pending: list = []  # finished units the host records later
_profiling = torch._C._autograd._profiler_enabled


class _Stat:
    __slots__ = ("count", "total_ns", "self_ns", "recent")

    def __init__(self):
        self.count = self.total_ns = self.self_ns = 0
        self.recent = collections.deque(maxlen=RING)


class _Registry:
    def __init__(self):
        self.stats: Dict[str, _Stat] = {}
        self.records = collections.deque(maxlen=RING)
        self.counters: Dict[str, float] = {}
        self.ids = 0

    def new_id(self) -> int:
        self.ids += 1
        return self.ids

    def add(self, name: str, dur: int, self_dur: int) -> None:
        st = self.stats.get(name)
        if st is None:
            st = self.stats[name] = _Stat()
        st.count += 1
        st.total_ns += dur
        st.self_ns += self_dur
        st.recent.append(dur)


_reg = _Registry()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "id", "parent", "start", "child_ns", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _stack[-1].id if _stack else None
        self.id = _reg.new_id()
        self.child_ns = 0
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        _stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack.pop()
        dur = end - self.start
        if _stack:
            _stack[-1].child_ns += dur
        _reg.add(self.name, dur, dur - self.child_ns)
        _reg.records.append((self.id, self.name, "host", self.start, end,
                             self.parent, _step))
        return False


def span(name: str):
    """A host span ``name`` (a context manager); the shared no-op while
    spans are off."""
    if not _on:
        return _NOOP
    return _Span(name)


def enabled() -> bool:
    return _on


def marks_enabled() -> bool:
    return _marks


def enable(marks: bool = False) -> None:
    global _on, _marks, _explicit
    _on, _marks, _explicit = True, bool(marks), True


def disable() -> None:
    global _on, _marks, _explicit, _unit
    _on = _marks = _explicit = False
    _unit = None


def follow_profiler() -> None:
    """Host spans on while a ``torch.profiler`` records, unless ``enable``
    set them (device marks stay as they are: turning them on recaptures)."""
    global _on
    if not _explicit:
        _on = _profiling()


def set_step(step: int) -> None:
    global _step
    _step = step


def counter(name: str, n: float = 1) -> None:
    if _on:
        c = _reg.counters
        c[name] = c.get(name, 0) + n


# -- device marks ------------------------------------------------------------
class Marks:
    """The stamps of one unit of device work: ``base`` int64 [1] (the
    device clock at the unit's start) and ``rel`` f64 [MAX_MARKS] (each
    point's clock less the base, ns), and each point's kind and name:
    ``|`` closes a sequential interval, ``>`` and ``<`` open and close a
    nested one, ``$`` ends the unit."""

    def __init__(self, unit: str, device: torch.device):
        self.unit = unit
        self.base = torch.empty(1, dtype=torch.int64, device=device)
        self.rel = torch.empty(MAX_MARKS, dtype=torch.float64, device=device)
        self.names: List[str] = []
        stamp(self.base, self.rel, -1)

    def point(self, kind: str, name: str) -> None:
        slot = len(self.names)
        if slot >= MAX_MARKS:
            raise RuntimeError(f"more than {MAX_MARKS} marks in one "
                               f"{self.unit!r} unit")
        self.names.append(kind + name)
        stamp(self.base, self.rel, slot)

    def columns(self) -> Dict[str, torch.Tensor]:
        """The stamps as metrics, 0-dim f64 views named ``@<slot><kind>
        <name>`` (``_pack`` stacks them with no copy of their own)."""
        return {f"@{i}{n}": self.rel[i] for i, n in enumerate(self.names)}


def open_marks(unit: str, device) -> Optional[Marks]:
    """A new unit of device work, where ``mark`` and ``device_span`` write
    until ``finish``; None while marks are off."""
    global _unit
    if not _marks:
        return None
    _unit = Marks(unit, torch.device(device))
    return _unit


def mark(name: str) -> None:
    """Closes the interval ``name`` of the open unit (none open: nothing)."""
    if _unit is not None:
        _unit.point("|", name)


class _Pair:
    __slots__ = ("unit", "name")

    def __init__(self, unit: Marks, name: str):
        self.unit, self.name = unit, name

    def __enter__(self):
        self.unit.point(">", self.name)
        return self

    def __exit__(self, *exc):
        self.unit.point("<", self.name)
        return False


def device_span(name: str):
    """A pair of marks around a stretch of device work, nested in the
    open unit's current interval; the shared no-op without a unit."""
    if _unit is None:
        return _NOOP
    return _Pair(_unit, name)


def finish(m: Optional[Marks]) -> Optional[Marks]:
    """Ends the unit ``m`` (its last point, ``$``) and returns it."""
    global _unit
    if m is not None:
        m.point("$", m.unit)
        _unit = None
    return m


def defer(unit: str, names: List[str], rel: torch.Tensor) -> None:
    """A finished unit's stamps (or their sums over several runs of one
    unit) for ``record_pending``, which reads them at a point where the
    host waits anyway."""
    _pending.append((unit, list(names), rel))


def take_pending() -> Optional[tuple]:
    """The last deferred unit, taken back (``chain_eval`` packs it)."""
    return _pending.pop() if _pending else None


def record_pending(step: Optional[int] = None) -> None:
    """Records the deferred units (a sync), those of one unit and layout
    summed into one (a validation's chains: one ``eval`` unit)."""
    sums: Dict[tuple, torch.Tensor] = {}
    for unit, names, rel in _pending:
        key = (unit, tuple(names))
        rel = rel[:len(names)]
        sums[key] = rel if key not in sums else sums[key] + rel
    _pending.clear()
    for (unit, names), rel in sums.items():
        _record_unit(unit, list(names), rel.tolist(),
                     _step if step is None else step)


def record(m: Optional[Marks], step: Optional[int] = None) -> None:
    """Reads the unit's stamps to the host (a sync) and records them."""
    if m is not None:
        _record_unit(m.unit, m.names, m.rel[:len(m.names)].tolist(),
                     _step if step is None else step)


def take_marks(metrics: Dict[str, object], unit: str,
               step: Optional[int] = None) -> None:
    """Pops a step's mark columns (``Marks.columns``, on the host now) from
    its metrics and records them."""
    slots = sorted((_slot(k), k) for k in metrics if k.startswith("@"))
    if not slots:
        return
    names = [k[len(str(i)) + 1:] for i, k in slots]
    vals = [float(metrics.pop(k)) for _, k in slots]
    _record_unit(unit, names, vals, _step if step is None else step)


def _slot(key: str) -> int:
    i = 1
    while key[i].isdigit():
        i += 1
    return int(key[1:i])


def _record_unit(unit: str, names: List[str], vals: List[float],
                 step: int) -> None:
    """One unit's intervals from its points (ns from its start): each
    sequential interval a child of the unit, each nested one a child of
    the sequential interval it falls in (of the unit past the last)."""
    ids = {unit: _reg.new_id()}
    rows = []  # [id, name, start, end, parent name]
    opened: Dict[str, list] = {}
    loose: list = []  # nested intervals whose sequential parent is next
    prev, end = 0.0, 0.0
    for kn, t in zip(names, vals):
        kind, name = kn[0], kn[1:]
        if kind == "|":
            for row in loose:
                row[4] = name
            loose = []
            rows.append([_reg.new_id(), name, prev, t, unit])
            ids[name] = rows[-1][0]
            prev = t
        elif kind == ">":
            opened.setdefault(name, []).append(t)
        elif kind == "<":
            rows.append([_reg.new_id(), name, opened[name].pop(), t, unit])
            loose.append(rows[-1])
        else:
            end = t
    dur: Dict[str, float] = collections.defaultdict(float)
    child: Dict[str, float] = collections.defaultdict(float)
    dur[unit] = end
    for rid, name, a, b, parent in rows:
        dur[name] += b - a
        child[parent] += b - a
        _reg.records.append((rid, name, "device", int(a), int(b),
                             ids.get(parent), step))
    _reg.records.append((ids[unit], unit, "device", 0, int(end), None, step))
    for name, d in dur.items():
        _reg.add(name, int(d), int(d - child[name]))


# -- the registry ------------------------------------------------------------
def snapshot() -> Dict[str, object]:
    """The registry: per name count, total, self time and the median of
    its ring of durations (ms) with the ring itself; the counters; the raw
    records, oldest first, as dicts (times in ns: host spans on
    ``perf_counter_ns``, device intervals from their unit's start)."""
    spans = {}
    for name, st in _reg.stats.items():
        recent = [d * 1e-6 for d in st.recent]
        spans[name] = {"count": st.count, "total_ms": st.total_ns * 1e-6,
                       "self_ms": st.self_ns * 1e-6,
                       "median_ms": statistics.median(recent),
                       "durations_ms": recent}
    records = [dict(zip(("id", "name", "clock", "start_ns", "end_ns",
                         "parent", "step"), r)) for r in _reg.records]
    return {"spans": spans, "counters": dict(_reg.counters),
            "records": records}


def reset() -> None:
    """Clears the registry and the deferred units."""
    global _reg
    _reg = _Registry()
    _pending.clear()
