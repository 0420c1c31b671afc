"""The port's spans and host-sync counter, on the CPU.

``runtime.span`` opens a profiler range only while a profiler runs; the
streaming engine's spans lie on its calling thread and fill its events;
``HOST_SYNCS`` counts each site that blocks the host on the card, the same
on the CPU; the trainer's step shows its four phases.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, record_function

from pointwise_torch import streaming
from pointwise_torch.data import synthetic
from pointwise_torch.infer import layered_apply
from pointwise_torch.kernels import pointwise_conv_cuda as tk
from pointwise_torch.models import PointwiseSegmenter
from pointwise_torch.models.segmenter import segmentation_loss
from pointwise_torch.ops import pointwise_conv
from pointwise_torch.train import trainer as tt
from pointwise_torch.train.configs import OptimizerConfig
from pointwise_torch.utils import runtime

RADII = (0.25, 0.5)
KW = dict(radii=RADII, tile_size=2.0, out_dim=5, buckets=(256, 512, 1024),
          tile_batch=2)
ENGINE_SPANS = {"engine.presort", "engine.grid", "engine.build",
                "engine.plan", "engine.wait_packer", "engine.dispatch",
                "engine.fetch", "engine.scatter"}
# the engine's phases on its calling thread (pack_s runs on the packer's)
PHASES = ("presort_s", "grid_s", "build_s", "plan_s", "wait_packer_s",
          "dispatch_s", "flush_fetch_s", "flush_scatter_s")
TRAIN_SPANS = {"train.forward", "train.backward", "train.clip",
               "train.optimizer"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return PointwiseSegmenter(5, 3, channels=(8, 8), radii=RADII,
                              head_dims=(16,), dropout_rate=0.0,
                              precision="float32", use_global_context=False,
                              device="cpu").eval()


@pytest.fixture(scope="module")
def scene():
    xyz, rgb, _ = synthetic.segmentation_scene(3, num_objects=3,
                                               points_per_obj=128)
    return xyz, rgb


def _serve(model, scene, events):
    return streaming.stream_apply_layered(layered_apply(model), *scene,
                                          device="cpu", events=events, **KW)


def _profiled(fn):
    """(the events of ``fn()`` under the CPU profiler, the thread that
    called it)."""
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.caller"):
            fn()
    events = prof.events()
    caller = next(e for e in events if e.name == "test.caller")
    return events, caller.thread


def test_span_opens_no_range_without_a_profiler(monkeypatch, model, scene):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(runtime, "record_function", refuse)
    acc = {"phase_s": 0.0}
    with runtime.span("test.phase", acc, "phase_s"):
        pass
    assert acc["phase_s"] >= 0.0
    ev = {}
    _serve(model, scene, ev)          # every engine span, no profiler
    assert ev["plan_s"] >= 0.0
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="test.phase"):
            with runtime.span("test.phase"):
                pass


def test_span_adds_its_seconds():
    acc = {"phase_s": 1.0}
    with runtime.span("test.phase", acc, "phase_s"):
        torch.ones(8).sum()
    assert acc["phase_s"] > 1.0
    with runtime.span("test.phase"):  # no store: times nothing
        pass


def test_engine_spans_on_the_calling_thread(monkeypatch, model, scene):
    ev = {}
    events, caller = _profiled(lambda: _serve(model, scene, ev))
    spans = [e for e in events if e.name.startswith("engine.")]
    assert {e.name for e in spans} == ENGINE_SPANS
    assert {e.thread for e in spans} == {caller}
    # the profiler may not follow other threads: take every range the
    # spans would open, on any thread, with the profiler's check forced on
    opened = []

    @contextlib.contextmanager
    def recorder(name):
        opened.append((name, threading.get_ident()))
        yield

    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(runtime, "record_function", recorder)
    _serve(model, scene, {})
    assert {n for n, _ in opened} == ENGINE_SPANS
    assert {t for _, t in opened} == {threading.get_ident()}
    # one fetch and one scatter span per chunk, one wait more than chunks
    chunks = sum(e.name == "engine.fetch" for e in spans)
    assert chunks >= 2
    assert sum(e.name == "engine.scatter" for e in spans) == chunks
    assert sum(e.name == "engine.dispatch" for e in spans) == chunks
    assert sum(e.name == "engine.wait_packer" for e in spans) == chunks + 1


def test_engine_phases_within_the_call(model, scene):
    ev = {}
    _serve(model, scene, ev)
    for k in PHASES:
        assert ev[k] >= 0.0, k
    # each event is rounded to 0.1 ms
    assert sum(ev[k] for k in PHASES) <= ev["total_s"] + 5e-5 * len(PHASES)
    assert ev["plan_s"] > 0.0


def test_engine_counts_its_syncs(model, scene):
    tk.reset_launches()
    ev = {}
    _serve(model, scene, ev)
    assert isinstance(ev["host_syncs"], int)
    assert ev["host_syncs"] == sum(tk.HOST_SYNCS.values())
    chunks = tk.HOST_SYNCS["engine_fetch"]
    # a chunk's index arrays: candidates, centers, sizes, counts, and a
    # selection and a skip list per layer
    assert tk.HOST_SYNCS["engine_put"] == chunks * (4 + 2 * len(RADII))
    assert tk.HOST_SYNCS["engine_resident"] == 2
    before = ev["host_syncs"]
    ev = {}
    _serve(model, scene, ev)            # the count is the call's own
    assert ev["host_syncs"] == before
    assert sum(tk.HOST_SYNCS.values()) == 2 * before


def _cloud(n=640, cin=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((1, n, 3), generator=g) * 2.0
    feats = torch.rand((1, n, cin), generator=g)
    w = torch.randn((27, cin, 8), generator=g) * 0.2
    return pts, feats, w


def test_csr_conv_counts_its_tile_lists():
    pts, feats, w = _cloud()
    feats.requires_grad_(True)
    tk.reset_launches()
    y = pointwise_conv(pts, feats, w, radius=0.3, csr=True)
    # a list: the two sides' tile boxes, then its nonzero
    assert tk.HOST_SYNCS["tile_lists"] == 1
    assert tk.HOST_SYNCS["tile_boxes"] == 2
    y.sum().backward()                  # dX walks the transposed list
    assert tk.HOST_SYNCS["tile_lists"] == 2
    assert sum(tk.HOST_SYNCS.values()) == 6
    tk.reset_launches()
    pointwise_conv(pts, feats.detach(), w, radius=0.3, csr=False)
    assert sum(tk.HOST_SYNCS.values()) == 0      # the dense walk has none


@pytest.mark.parametrize("site,kw", [
    ("check_coordinates", dict(validate=True)),
    ("subblock_cap", dict(subblock=2, csr=False)),
])
def test_host_branch_counts_once(site, kw):
    pts, feats, w = _cloud(n=256)
    tk.reset_launches()
    pointwise_conv(pts, feats, w, radius=0.3, **kw)
    assert tk.HOST_SYNCS == dict.fromkeys(tk.HOST_SYNCS, 0) | {site: 1}


def test_reset_launches_zeroes_both_counters():
    tk.LAUNCHES["fwd_csr"] += 3
    tk.count_sync("tile_lists")
    tk.count_sync("engine_put")
    tk.reset_launches()
    assert not any(tk.LAUNCHES.values())
    assert not any(tk.HOST_SYNCS.values())
    with pytest.raises(KeyError):
        tk.count_sync("no_such_site")


def test_trainer_step_spans():
    net = PointwiseSegmenter(5, 6, channels=(8, 8), radii=(0.3, 0.6),
                             head_dims=(16,), dropout_rate=0.0,
                             precision="float32", use_global_context=False,
                             device="cpu")

    def loss_fn(model, b, gen, train):
        logits = model(b["points"], b["features"], b["mask"])
        loss, acc = segmentation_loss(logits, b["label"], b["mask"])
        return loss, {"accuracy": acc}

    rng = np.random.RandomState(0)
    batch = {"points": rng.uniform(0, 1.2, (2, 200, 3)),
             "features": rng.uniform(0, 1, (2, 200, 6)),
             "label": rng.randint(0, 5, (2, 200)),
             "mask": (rng.rand(2, 200) > 0.2)}
    batch = {k: torch.from_numpy(v.astype(np.int64 if k == "label"
                                          else np.float32))
             for k, v in batch.items()}
    trainer = tt.Trainer(net, loss_fn, OptimizerConfig(
        learning_rate=1e-2, warmup_steps=2, decay_steps=10))
    events, caller = _profiled(lambda: trainer.step(batch, 0))
    spans = [e for e in events if e.name.startswith("train.")]
    assert sorted(e.name for e in spans) == sorted(TRAIN_SPANS)
    assert {e.thread for e in spans} == {caller}
    # the phases run in order and the optimizer's own range is inside
    start = {e.name: e.time_range.start for e in spans}
    assert (start["train.forward"] < start["train.backward"]
            < start["train.clip"] < start["train.optimizer"])
    opt = next(e for e in spans if e.name == "train.optimizer")
    assert any(e.name.startswith("Optimizer.step")
               and opt.time_range.start <= e.time_range.start
               and e.time_range.end <= opt.time_range.end for e in events)
