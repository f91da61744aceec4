"""The port's span primitive and its device intervals, on the CPU.

`scope` (telemetry/spans.py rule 3) is one call at every layer boundary
below the runner: a `torch.profiler` range while a profiler records, a
span on the tracer a runner made current.  These cases hold:

- the span tree of a small PatchMatch run (tile path at 128², per-pixel
  sweeps at 64²) and of the batch runner, EM steps and matcher phases
  as live, timed spans;
- every `tlm_*` range, old and new, under a CPU profiler;
- nothing built and no event made with tracing off; B' and the field
  bit for bit with tracing on and off;
- the device clock's anchor arithmetic, on an injected fake event and
  clock (rule 4);
- the benchmark's three readers of the new spans on a hand-built
  context;
- the sentinel's em_iter check on the new trees;
- a tracer current only inside its own open span, and a lean tracer
  (the serving daemon's per-request one) recording nothing below its
  levels, whose trees keep their declared `em_iter` marks;
- a device read on one thread while another resolves.
"""

import importlib.util
import os
import threading
import types

import numpy as np
import pytest
import torch

from image_analogies_tpu_torch import SynthConfig, create_image_analogy
from image_analogies_tpu_torch.parallel.batch import synthesize_batch
from image_analogies_tpu_torch.telemetry import spans
from image_analogies_tpu_torch.telemetry.sentinel import check_span_tree

ROOT = os.path.join(os.path.dirname(__file__), "..")

# Tile path at level 0 (128²), per-pixel sweeps at level 1 (64²).
CFG = dict(device="cpu", levels=2, matcher="patchmatch", em_iters=2,
           pm_iters=2, kappa=0.5)

TILE_RANGES = {"tlm_prep", "tlm_sweep", "tlm_merge", "tlm_polish",
               "tlm_kappa", "tlm_dist"}
ALL_RANGES = TILE_RANGES | {
    "tlm_prologue", "tlm_L0", "tlm_L1", "tlm_em0", "tlm_em1",
    "tlm_assemble", "tlm_match", "tlm_render", "tlm_pixel"}


def _images(side=128, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((side, side)).astype(np.float32)
    ap = np.clip(a * 0.5 + 0.2, 0, 1).astype(np.float32)
    b = rng.random((side, side)).astype(np.float32)
    return a, ap, b


def _names(sp):
    return [c.name for c in sp.children]


def _levels(roots):
    (run,) = roots
    return {sp.attrs["level"]: sp for sp in run.children
            if sp.name == "level"}


@pytest.fixture(scope="module")
def runs():
    a, ap, b = _images()
    cfg = SynthConfig(**CFG)
    plain = create_image_analogy(a, ap, b, cfg, return_aux=True)
    tracer = spans.Tracer()
    traced = create_image_analogy(a, ap, b, cfg, return_aux=True,
                                  progress=tracer)
    return plain, traced, tracer


def test_em_steps_and_phases_are_timed_spans(runs):
    _, _, tracer = runs
    levels = _levels(tracer.roots)
    assert sorted(levels) == [0, 1]
    for lv in levels.values():
        assert lv.attrs["em_iters"] == 2
        ems = lv.children
        assert [e.name for e in ems] == ["em_iter", "em_iter"]
        assert [e.attrs["em"] for e in ems] == [0, 1]
        for em in ems:
            assert _names(em) == ["assemble", "match", "render"]
            for sp in [em] + em.children:
                assert sp.wall_ms is not None and sp.host_ms >= 0.0
                # A CPU run records no device interval.
                assert sp.device_ms is None and sp.dev_t0 is None
    # The per-pixel level: the sweeps and the kappa pass, one frame.
    for em in levels[1].children:
        match = em.children[1]
        assert _names(match) == ["pixel", "kappa"]
        assert [c.attrs["frame"] for c in match.children] == [0, 0]
    # The tile level: the polish (and with it the kappa pass and the
    # exact distance) only in the final EM step (pm_polish_final_only).
    em0, em1 = (em.children[1] for em in levels[0].children)
    assert _names(em0) == ["prep", "sweep", "merge"]
    assert _names(em1) == ["prep", "sweep", "merge", "polish", "kappa",
                           "dist"]
    assert [c.attrs.get("frame") for c in em1.children] == [
        None, None, 0, 0, 0, None]
    # Children nest inside their parents on the host clock.
    for parent in [levels[0]] + list(levels[0].children) + [em1]:
        for c in parent.children:
            assert parent.t_start <= c.t_start <= c.t_end <= parent.t_end


def test_tracing_leaves_bp_and_field_bit_identical(runs):
    plain, traced, _ = runs
    assert torch.equal(plain["bp"], traced["bp"])
    for lvl in (0, 1):
        assert torch.equal(plain["nnf"][lvl], traced["nnf"][lvl])
        assert torch.equal(plain["dist"][lvl], traced["dist"][lvl])


def test_sentinel_em_iter_check_holds_on_the_new_tree(runs):
    _, _, tracer = runs
    tree = tracer.to_dict()
    assert check_span_tree(tree)["status"] == "ok"
    # One EM step lost from a level is caught.
    (run,) = tree["spans"]
    level = [s for s in run["children"] if s["name"] == "level"][0]
    level["children"] = level["children"][:1]
    got = check_span_tree(tree)
    assert got["status"] == "violated"
    assert got["observed"]["em_iter_mismatch"][0]["recorded"] == 1


def test_batch_runner_nests_em_steps_under_a_live_level_span():
    a, ap, b = _images()
    frames = np.stack([b, b[::-1].copy()])
    cfg = SynthConfig(**CFG)
    tracer = spans.Tracer()
    out = synthesize_batch(a, ap, frames, cfg, progress=tracer)
    assert torch.equal(out, synthesize_batch(a, ap, frames, cfg))
    assert [s.name for s in tracer.roots] == [
        "prologue", "run_plan", "level", "level"]
    for lv in tracer.roots[2:]:
        assert lv.wall_ms is not None and lv.attrs["em_iters"] == 2
        assert lv.attrs["shape"] == [128 >> lv.attrs["level"]] * 2
        assert [e.name for e in lv.children] == ["em_iter"] * 2
        for em in lv.children:
            assert _names(em) == ["assemble", "match", "render"]
            assert em.t_start >= lv.t_start and em.t_end <= lv.t_end
    tile = [lv for lv in tracer.roots[2:] if lv.attrs["level"] == 0][0]
    match = tile.children[1].children[1]
    # One K1 sweep phase for both frames; the tail frame by frame.
    assert _names(match) == ["prep", "sweep", "merge", "polish", "kappa",
                             "merge", "polish", "kappa", "dist"]
    tails = [(c.name, c.attrs["frame"]) for c in match.children
             if "frame" in c.attrs]
    assert tails == [("merge", 0), ("polish", 0), ("kappa", 0),
                     ("merge", 1), ("polish", 1), ("kappa", 1)]
    pixel = [lv for lv in tracer.roots[2:] if lv.attrs["level"] == 1][0]
    assert [(c.name, c.attrs["frame"])
            for c in pixel.children[0].children[1].children] == [
        ("pixel", 0), ("kappa", 0), ("pixel", 1), ("kappa", 1)]
    assert check_span_tree(tracer.to_dict())["status"] == "ok"


@pytest.mark.parametrize("with_tracer", [False, True],
                         ids=["profiler", "profiler+tracer"])
def test_every_range_appears_under_a_cpu_profiler(with_tracer):
    from torch.profiler import ProfilerActivity, profile

    a, ap, b = _images()
    tracer = spans.Tracer() if with_tracer else None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        create_image_analogy(a, ap, b, SynthConfig(**CFG), progress=tracer)
    names = {e.name for e in prof.events()}
    assert ALL_RANGES <= names
    if with_tracer:
        # Under a profiler the tracer's tree is the same tree.
        em1 = _levels(tracer.roots)[0].children[1]
        assert _names(em1.children[1]) == [
            "prep", "sweep", "merge", "polish", "kappa", "dist"]


def test_tracing_off_builds_nothing(monkeypatch):
    made = {"span": 0, "event": 0}

    class Counted(spans.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made["span"] += 1
            super().__init__(*a, **kw)

    def event(device):
        made["event"] += 1

    monkeypatch.setattr(spans, "Span", Counted)
    monkeypatch.setattr(spans, "_record_event", event)
    a, ap, b = _images()
    create_image_analogy(a, ap, b, SynthConfig(**CFG))
    synthesize_batch(a, ap, b[None], SynthConfig(**CFG))
    assert made == {"span": 0, "event": 0}
    assert spans.scope("tlm_match", "match") is spans._NULL_SPAN
    assert spans.scope("tlm_L0") is spans._NULL_SPAN
    spans.NULL_TRACER.bind_device(torch.device("cuda"))
    assert spans.NULL_TRACER.device is None
    # A traced CPU run builds spans and still records no event.
    create_image_analogy(a, ap, b, SynthConfig(**CFG),
                         progress=spans.Tracer())
    assert made["span"] > 20 and made["event"] == 0


class _FakeDevice:
    """A device clock and the timing events recorded on it: each event
    takes the clock's reading when recorded; `reached` is how far the
    device has run."""

    def __init__(self):
        self.now = 5.0
        self.reached = float("inf")
        self.recorded = []
        self.syncs = 0
        self.waits = 0
        self.on_wait = None

    def record(self, device):
        dev = self

        class Event:
            t = self.now

            def elapsed_time(self, other):
                return (other.t - self.t) * 1000.0

            def query(self):
                return self.t <= dev.reached

            def synchronize(self):
                dev.waits += 1
                if dev.on_wait is not None:
                    dev.on_wait()

        self.recorded.append(Event())
        return self.recorded[-1]

    def sync(self, device):
        self.syncs += 1


@pytest.fixture
def fake(monkeypatch):
    dev = _FakeDevice()
    host = [100.0]
    monkeypatch.setattr(spans, "_record_event", dev.record)
    monkeypatch.setattr(spans, "_device_sync", dev.sync)
    monkeypatch.setattr(spans.time, "perf_counter", lambda: host[0])
    return dev, host


def test_anchor_arithmetic_on_a_fake_clock(fake):
    dev, host = fake
    tracer = spans.Tracer()
    t0 = tracer._t0
    tracer.bind_device(torch.device("cuda"))
    # The device runs 2 s behind the host's clock offset, and lags.
    with tracer.span("level", level=0) as lvl:
        host[0], dev.now = 100.5, 5.75
        with spans.scope("tlm_match", "match") as match:
            host[0], dev.now = 100.6, 6.25
        host[0], dev.now = 100.7, 6.5
    host[0] = 101.0
    assert dev.syncs == 1  # the anchor, at the first span
    anchor, ev_lvl0, ev_m0, ev_m1, ev_lvl1 = dev.recorded
    assert anchor.t == ev_lvl0.t == 5.0
    assert tracer._anchor == (anchor, 100.0)
    # Host times: no sync inside, the host's own clock.
    assert match.host_ms == pytest.approx(100.0)
    assert lvl.host_ms == pytest.approx(700.0)
    # Device times: the anchor's host time plus the distance from it.
    assert match.dev_t0 is None  # resolved lazily
    assert match.device_ms == pytest.approx(500.0)
    assert dev.waits == 1  # one wait, on the newest end event
    assert match.dev_t0 == pytest.approx(100.0 + 0.75)
    assert match.dev_t1 == pytest.approx(100.0 + 1.25)
    assert lvl.dev_t0 == pytest.approx(100.0)
    assert lvl.device_ms == pytest.approx(1500.0)
    assert dev.waits == 1 and dev.syncs == 1
    rec = tracer.to_dict()["spans"][0]
    assert rec["device_ms"] == pytest.approx(1500.0)
    assert rec["device_t"] == pytest.approx(100.0 - t0)
    assert rec["device_end_t"] == pytest.approx(101.5 - t0)
    assert rec["host_ms"] == pytest.approx(700.0)
    assert rec["children"][0]["device_t"] == pytest.approx(100.75 - t0)


def test_resolving_without_waiting_takes_what_the_device_reached(fake):
    dev, host = fake
    tracer = spans.Tracer()
    tracer.bind_device("cuda")
    with tracer.span("a") as a:
        dev.now = 6.0
    with tracer.span("b") as b:
        dev.now = 7.0
    dev.reached = 6.5  # a's end, not b's
    tracer.resolve(wait=False)
    assert dev.waits == 0
    assert a.dev_t0 is not None and b.dev_t0 is None
    assert "device_ms" not in tracer.to_dict()["spans"][1]  # no wait
    assert dev.waits == 0
    assert b.device_ms == pytest.approx(1000.0)  # a read waits once
    assert dev.waits == 1


def test_lean_and_cpu_tracers_record_no_events(fake):
    dev, _ = fake
    for tracer, device in ((spans.Tracer(lean=True), "cuda"),
                           (spans.Tracer(), "cpu"),
                           (spans.Tracer(), None)):
        tracer.bind_device(device)
        with tracer.span("level") as sp:
            with spans.scope("tlm_match", "match"):
                pass
        assert tracer.device is None
        assert sp.device_ms is None
        # A lean tracer records nothing below its level.
        assert _names(sp) == ([] if tracer.lean else ["match"])
    assert dev.recorded == [] and dev.syncs == 0


def test_a_device_read_during_another_threads_resolve_waits_for_it(fake):
    dev, _ = fake
    tracer = spans.Tracer()
    tracer.bind_device("cuda")
    with tracer.span("a") as a:
        dev.now = 6.0
    with tracer.span("b"):
        dev.now = 7.0
    inside, release = threading.Event(), threading.Event()

    def held():
        inside.set()
        release.wait(10)

    dev.on_wait = held
    resolver = threading.Thread(target=tracer.resolve)
    resolver.start()
    assert inside.wait(10)
    got = []
    reader = threading.Thread(target=lambda: got.append(a.device_ms))
    reader.start()
    reader.join(0.2)
    assert reader.is_alive()  # waiting for the resolution under way
    release.set()
    resolver.join(10)
    reader.join(10)
    assert not resolver.is_alive() and not reader.is_alive()
    assert got == [pytest.approx(1000.0)]


def test_closed_spans_read_their_device_time_under_concurrent_readers(
        fake):
    """The live exporter resolves (`to_dict`) while the run closes spans
    and other readers read them: no closed span ever reads None."""
    import sys

    tracer = spans.Tracer()
    tracer.bind_device("cuda")
    closed, misses, stop = [], [], threading.Event()

    def read():
        while not stop.is_set():
            tracer.to_dict()
            for sp in list(closed[-20:]):
                if sp.device_ms is None:
                    misses.append(sp.name)

    readers = [threading.Thread(target=read) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in readers:
            t.start()
        with tracer.span("run"):
            for i in range(400):
                with tracer.span(f"s{i}") as sp:
                    pass
                closed.append(sp)
    finally:
        stop.set()
        for t in readers:
            t.join(10)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in readers)
    assert misses == []
    assert all(sp.device_ms is not None for sp in closed)


def test_a_tracer_is_current_only_inside_its_own_open_span():
    outer, inner = spans.Tracer(), spans.Tracer()
    assert spans.scope("tlm_match", "match") is spans._NULL_SPAN
    with outer.span("run") as run:
        with spans.scope("tlm_em0", "em_iter", em=0):
            with inner.span("level") as lvl:
                with spans.scope("tlm_match", "match"):
                    pass
            with spans.scope("tlm_render", "render"):
                pass
        # A lean tracer's span leaves no tracer current below it.
        lean = spans.Tracer(lean=True)
        with lean.span("level") as lean_lvl:
            assert spans.scope("tlm_match", "match") is spans._NULL_SPAN
    assert spans.scope("tlm_match", "match") is spans._NULL_SPAN
    assert _names(run) == ["em_iter"]
    assert _names(run.children[0]) == ["render"]
    assert _names(lvl) == ["match"] and _names(lean_lvl) == []


def test_a_lean_batch_tree_keeps_its_declared_em_steps_only():
    """The serving daemon's per-dispatch tracer is lean: its tree holds
    the level spans and their declared EM steps and nothing below them,
    so the trees the daemon keeps grow by the same few spans a dispatch
    whatever the matcher records."""
    a, ap, b = _images()
    frames = np.stack([b, b[::-1].copy()])
    tracer = spans.Tracer(lean=True)
    synthesize_batch(a, ap, frames, SynthConfig(**CFG), progress=tracer)
    levels = [s for s in tracer.roots if s.name == "level"]
    assert [lv.attrs["level"] for lv in levels] == [1, 0]
    for lv in levels:
        assert lv.wall_ms is not None and lv.attrs["nnf_energy"] is None
        assert [(e.name, e.attrs["em"], e.wall_ms, e.children)
                for e in lv.children] == [("em_iter", 0, None, []),
                                          ("em_iter", 1, None, [])]
    tree = tracer.to_dict()
    assert check_span_tree(tree)["status"] == "ok"

    def count(sps):
        return sum(1 + count(sp.get("children", [])) for sp in sps)

    # The prologue, its plan mark, and two levels of 1 + 2 spans.
    assert count(tree["spans"]) == 8


def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class _Tree:
    def __init__(self, **by_name):
        self.by_name = by_name

    def find(self, name):
        return self.by_name.get(name, [])


def _sp(device_ms, host_ms=None):
    return types.SimpleNamespace(device_ms=device_ms, host_ms=host_ms)


@pytest.mark.parametrize("name,span", [
    ("em_step_ms_per_frame", "em_iter"),
    ("polish_ms_per_frame", "polish"),
])
def test_device_readers_sum_per_frame(name, span):
    read = _reader(name)
    tree = _Tree(**{span: [_sp(3.0), _sp(5.0), _sp(0.5)],
                    "match": [_sp(100.0, 100.0)]})
    ctx = {"traced": {"tracer": tree, "span_frames": 2}}
    assert read(ctx) == pytest.approx(4.25)
    # No device fields (a CPU run), no spans, or the parent's spans
    # (no such attribute): nothing, and no raise.
    tree.by_name[span] = [_sp(3.0), _sp(None)]
    assert read(ctx) is None
    tree.by_name[span] = []
    assert read(ctx) is None
    tree.by_name[span] = [types.SimpleNamespace(wall_ms=None)]
    assert read(ctx) is None


def test_match_host_reader_sums_host_time_per_frame():
    read = _reader("match_host_ms_per_frame")
    tree = _Tree(match=[_sp(9.0, 40.0), _sp(7.0, 20.0)],
                 em_iter=[_sp(1.0, 1.0)])
    ctx = {"traced": {"tracer": tree, "span_frames": 4}}
    assert read(ctx) == pytest.approx(15.0)
    tree.by_name["match"] = [_sp(None, 40.0)]
    assert read(ctx) is None
    tree.by_name["match"] = [types.SimpleNamespace(wall_ms=None)]
    assert read(ctx) is None


def test_readers_on_a_real_traced_cpu_run_read_nothing(runs):
    _, _, tracer = runs
    ctx = {"traced": {"tracer": tracer, "span_frames": 1}}
    for name in ("em_step_ms_per_frame", "polish_ms_per_frame",
                 "match_host_ms_per_frame"):
        assert _reader(name)(ctx) is None
